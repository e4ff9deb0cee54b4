import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cudapathtracer.accel import bvh as bvh_mod
from cudapathtracer.models import procedural
from cudapathtracer.ops import traversal
from cudapathtracer.ops.vecmath import Vec3
from cudapathtracer.utils.constants import MAX_BVH_DEPTH


def _random_tris(rng, n, spread=10.0, size=0.5):
    base = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    offs = rng.normal(size=(n, 2, 3)).astype(np.float32) * size
    verts = np.concatenate(
        [base, base + offs[:, 0], base + offs[:, 1]], axis=0
    ).astype(np.float32)
    idx = np.stack(
        [np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], axis=1
    ).astype(np.int32)
    return verts, idx


def _scene_from(verts, idx):
    from cudapathtracer.models.scene import make_scene

    mats = np.zeros(idx.shape[0], np.int32)
    alb = np.array([[0.5, 0.5, 0.5]], np.float32)
    emi = np.array([[0.0, 0.0, 0.0]], np.float32)
    return make_scene(verts, idx, mats, alb, emi)


@pytest.mark.parametrize("n,leaf_size", [(1, 4), (2, 1), (7, 2), (100, 4),
                                         (257, 8)])
def test_build_invariants(n, leaf_size):
    rng = np.random.default_rng(n)
    verts, idx = _random_tris(rng, n)
    flat, meta = bvh_mod.build_bvh(verts, idx, leaf_size)
    assert bvh_mod.validate(flat, meta)
    assert meta.depth < MAX_BVH_DEPTH

    # parent boxes contain every triangle assigned beneath them: check leaf
    # boxes contain their triangles.
    leaf_id = np.asarray(flat.node_leaf)
    lo = np.stack([np.asarray(flat.node_lo_x), np.asarray(flat.node_lo_y),
                   np.asarray(flat.node_lo_z)], 1)
    hi = np.stack([np.asarray(flat.node_hi_x), np.asarray(flat.node_hi_y),
                   np.asarray(flat.node_hi_z)], 1)
    leaf_tri = np.asarray(flat.leaf_tri)
    v0 = verts[idx[:, 0]]
    v1 = verts[idx[:, 1]]
    v2 = verts[idx[:, 2]]
    tlo = np.minimum(np.minimum(v0, v1), v2)
    thi = np.maximum(np.maximum(v0, v1), v2)
    for node in np.nonzero(leaf_id >= 0)[0]:
        tris = leaf_tri[leaf_id[node]]
        tris = tris[tris < n]
        assert np.all(tlo[tris] >= lo[node] - 1e-4)
        assert np.all(thi[tris] <= hi[node] + 1e-4)


def _random_rays(rng, r, spread=12.0):
    o = rng.uniform(-spread, spread, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (
        Vec3(jnp.asarray(o[:, 0]), jnp.asarray(o[:, 1]), jnp.asarray(o[:, 2])),
        Vec3(jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1]), jnp.asarray(d[:, 2])),
    )


@pytest.mark.parametrize("n,leaf_size", [(5, 1), (60, 4), (300, 4)])
def test_trace_matches_bruteforce(n, leaf_size):
    rng = np.random.default_rng(n * 7)
    verts, idx = _random_tris(rng, n)
    scene = _scene_from(verts, idx)
    flat, meta = bvh_mod.build_bvh(verts, idx, leaf_size)
    td = traversal.make_trace_data(scene, flat)
    o, d = _random_rays(rng, 512)
    h_bvh = traversal.trace(o, d, td)
    h_bf = traversal.trace_bruteforce(o, d, scene, chunk=64)
    np.testing.assert_array_equal(np.asarray(h_bvh.tri), np.asarray(h_bf.tri))
    np.testing.assert_allclose(np.asarray(h_bvh.t), np.asarray(h_bf.t))


def test_trace_mask_skips_lanes():
    rng = np.random.default_rng(3)
    verts, idx = _random_tris(rng, 50)
    scene = _scene_from(verts, idx)
    flat, _ = bvh_mod.build_bvh(verts, idx, 4)
    td = traversal.make_trace_data(scene, flat)
    o, d = _random_rays(rng, 64)
    mask = jnp.asarray(rng.uniform(size=64) < 0.5)
    h = traversal.trace(o, d, td, mask=mask)
    h_full = traversal.trace(o, d, td)
    m = np.asarray(mask)
    np.testing.assert_array_equal(np.asarray(h.tri)[m], np.asarray(h_full.tri)[m])
    assert np.all(np.asarray(h.tri)[~m] == -1)


def test_trace_stats_histogram():
    desc = procedural.cornell_box()
    scene = procedural.to_scene(desc)
    verts = np.stack([np.asarray(scene.verts.x), np.asarray(scene.verts.y),
                      np.asarray(scene.verts.z)], 1)
    idx = np.stack([np.asarray(scene.tri_v0), np.asarray(scene.tri_v1),
                    np.asarray(scene.tri_v2)], 1)
    flat, _ = bvh_mod.build_bvh(verts, idx, 4)
    td = traversal.make_trace_data(scene, flat)
    rng = np.random.default_rng(0)
    o, d = _random_rays(rng, 128, spread=0.9)
    hit, stats = traversal.trace(o, d, td, with_stats=True)
    visits = np.asarray(stats.tri_visits)
    assert visits.shape[0] == scene.num_tris + 1
    assert visits[: scene.num_tris].sum() > 0  # someone got tested
    assert int(stats.steps) > 0


def test_trace_under_jit_and_grad_safety():
    rng = np.random.default_rng(5)
    verts, idx = _random_tris(rng, 20)
    scene = _scene_from(verts, idx)
    flat, _ = bvh_mod.build_bvh(verts, idx, 2)
    td = traversal.make_trace_data(scene, flat)
    o, d = _random_rays(rng, 32)
    jitted = jax.jit(lambda o, d: traversal.trace(o, d, td))
    h1 = jitted(o, d)
    h2 = traversal.trace(o, d, td)
    np.testing.assert_array_equal(np.asarray(h1.tri), np.asarray(h2.tri))


def test_trace_stats_under_jit():
    """with_stats works under jit when num_tris_static is passed (the
    histogram size must be static; td.num_tris is a tracer under jit)."""
    import jax

    from cudapathtracer.models import procedural
    from cudapathtracer.render.renderer import build_bvh_for_scene
    from cudapathtracer import make_camera
    from cudapathtracer.ops.rng import pixel_keys, sample_key
    from cudapathtracer.render.camera import camera_rays

    scene = procedural.to_scene(procedural.cornell_box())
    accel = build_bvh_for_scene(scene, 4)
    td = traversal.make_trace_data(scene, accel.fine)
    cam = make_camera(width=8, height=8)
    idx = jnp.arange(64, dtype=jnp.uint32)
    keys = pixel_keys(sample_key(jax.random.PRNGKey(0), 0), idx)
    o, d = camera_rays(cam, idx, keys)
    T = scene.num_tris

    @jax.jit
    def f(o, d):
        return traversal.trace(o, d, td, with_stats=True,
                               num_tris_static=T)

    hit, stats = f(o, d)
    assert stats.tri_visits.shape == (T + 1,)
    assert int(stats.steps) > 0
    assert stats.ray_visits.shape == (64,)
    assert int(stats.ray_visits.min()) > 0
