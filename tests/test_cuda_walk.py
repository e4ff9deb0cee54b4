"""The CUDA closest-hit walk (ops/cuda_walk.py, native/closest_hit.cu).

The kernel itself runs only on a GPU (the ``gpu``-marked test; chip_smoke.py
runs the same check at full size). On the CPU: the operand layout, the
platform choice, and a NumPy transcription of the kernel's loop run over the
packed operands, checked against the XLA walk it must agree with."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cudapathtracer import RenderConfig, make_camera
from cudapathtracer.accel.bvh import as_fine
from cudapathtracer.models import procedural
from cudapathtracer.ops import cuda_walk, traversal
from cudapathtracer.ops.intersect import bw_precompute
from cudapathtracer.ops.rng import pixel_keys, sample_key
from cudapathtracer.ops.vecmath import Vec3
from cudapathtracer.render import renderer
from cudapathtracer.render.camera import camera_rays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup():
    scene = procedural.to_scene(procedural.cornell_with_sphere_mesh(subdiv=1))
    accel = renderer.build_bvh_for_scene(scene, leaf_size=4)
    td = traversal.make_trace_data(scene, as_fine(accel))
    cam = make_camera(width=16, height=16)
    idx = jnp.arange(256, dtype=jnp.uint32)
    # jittered: an unjittered 16x16 pinhole lands rays exactly on the box's
    # quad diagonals, where any rounding difference flips the seam triangle
    o, d = camera_rays(cam, idx, pixel_keys(sample_key(
        jax.random.PRNGKey(0), 0), idx), jitter=True)
    # plus incoherent rays from inside the box
    ko, kd = jax.random.split(jax.random.PRNGKey(3))
    o2 = Vec3.from_array(jax.random.uniform(ko, (128, 3), minval=0.1,
                                            maxval=0.9))
    d2 = Vec3.from_array(jax.random.normal(kd, (128, 3)) + 1e-3)
    o = Vec3(*(jnp.concatenate([a, b]) for a, b in zip(o, o2)))
    d = Vec3(*(jnp.concatenate([a, b]) for a, b in zip(d, d2)))
    return scene, td, o, d


def _nan_min(a, b):
    return np.float32(np.nan) if (a != a or b != b) else min(a, b)


def _nan_max(a, b):
    return np.float32(np.nan) if (a != a or b != b) else max(a, b)


def _emulate(rays, nodes, links, tris, tri_ids, bw):
    """closest_hit_kernel, one ray at a time, in float32 NumPy."""
    f = np.float32
    rays, nodes, tris = (np.asarray(a, np.float32)
                         for a in (rays, nodes, tris))
    links, tri_ids = np.asarray(links), np.asarray(tri_ids)
    R, N, L = rays.shape[1], nodes.shape[0], tri_ids.shape[1]
    t_out = np.full(R, f(1e5), np.float32)
    tri_out = np.full(R, -1, np.int32)
    with np.errstate(all="ignore"):
        for i in range(R):
            o = rays[:3, i]
            d = rays[3:6, i]
            cap = rays[6, i]
            inv = f(1) / d
            best_t, best_tri = f(1e5), -1
            cur = 0 if cap > 0 else N
            while cur < N:
                lo, hi = nodes[cur, :3], nodes[cur, 3:6]
                t0 = (lo - o) * inv
                t1 = (hi - o) * inv
                tmin = _nan_max(_nan_max(_nan_min(t0[0], t1[0]),
                                         _nan_min(t0[1], t1[1])),
                                _nan_min(t0[2], t1[2]))
                tmax = _nan_min(_nan_min(_nan_max(t0[0], t1[0]),
                                         _nan_max(t0[1], t1[1])),
                                _nan_max(t0[2], t1[2]))
                hit = tmin <= tmax and tmax >= 0 and tmin <= best_t
                skip, leaf = links[cur]
                if hit and leaf >= 0:
                    for j in range(L):
                        tri = tri_ids[leaf, j]
                        if tri < 0:
                            continue
                        r = tris[leaf * L + j]
                        v0 = r[0:3]
                        if bw:
                            n, m1, m2 = r[3:6], r[6:9], r[9:12]
                            sx = o - v0
                            nd = np.dot(d, n)
                            if abs(nd) < f(1e-5):
                                continue
                            t = -np.dot(sx, n) * (f(1) / nd)
                            w = sx + d * t
                            bu, bv = np.dot(m1, w), np.dot(m2, w)
                            if bu < 0 or bv < 0 or f(1) - bu - bv < 0:
                                continue
                        else:
                            e1, e2 = r[3:6], r[6:9]
                            q = np.cross(d, e2)
                            a = np.dot(e1, q)
                            if abs(a) < f(1e-5):
                                continue
                            s = (o - v0) * (f(1) / a)
                            rr = np.cross(s, e1)
                            b0, b1 = np.dot(s, q), np.dot(rr, d)
                            if b0 < 0 or b1 < 0 or f(1) - b0 - b1 < 0:
                                continue
                            t = np.dot(e2, rr)
                        if 0 < t < f(1e5) and t < cap and (
                                t < best_t or (t == best_t
                                               and tri < best_tri)):
                            best_t, best_tri = t, tri
                    cur = skip
                else:
                    cur = cur + 1 if hit else skip
            t_out[i], tri_out[i] = best_t, best_tri
    return t_out, tri_out


@pytest.mark.parametrize("intersector", ["bw", "mt"])
def test_kernel_loop_matches_xla_walk(setup, intersector):
    """The kernel's loop over the packed operands gives the XLA walk's
    answer, with a lane mask and per-ray caps."""
    scene, td, o, d = setup
    R = o.x.shape[0]
    mask = (jnp.arange(R) % 5) != 0
    ref = traversal.trace(o, d, td, mask=mask, intersector=intersector)
    cap = jnp.where(jnp.arange(R) % 2 == 0, 0.5 * ref.t + 0.1, jnp.inf)
    ref_c = traversal.apply_t_cap(ref, cap)

    t, tri = _emulate(cuda_walk.pack_rays(o, d, mask, cap),
                      *cuda_walk.pack_scene(td, intersector),
                      bw=intersector == "bw")
    tri_ref = np.asarray(ref_c.tri)
    same = tri == tri_ref
    # float32 NumPy rounds without FMA contraction; XLA contracts, which
    # can flip an exact tie on a shared edge
    assert same.mean() >= 0.99, same.mean()
    hit = same & (tri >= 0)
    assert hit.sum() > R // 4
    np.testing.assert_allclose(t[hit], np.asarray(ref_c.t)[hit], rtol=1e-5)
    m = np.asarray(mask)
    assert (tri[~m] == -1).all()


def test_pack_rays_folds_mask_and_cap():
    o = Vec3(*(jnp.arange(4.0) + k for k in (0, 10, 20)))
    d = Vec3(*(jnp.arange(4.0) + k for k in (30, 40, 50)))
    rays = cuda_walk.pack_rays(o, d)
    assert rays.shape == (7, 4) and rays.dtype == jnp.float32
    np.testing.assert_array_equal(rays[0], o.x)
    np.testing.assert_array_equal(rays[5], d.z)
    assert np.isinf(np.asarray(rays[6])).all()
    mask = jnp.array([True, False, True, True])
    cap = jnp.array([1.0, 2.0, 3.0, -1.0])
    rays = cuda_walk.pack_rays(o, d, mask, cap)
    np.testing.assert_array_equal(rays[6], [1.0, 0.0, 3.0, -1.0])
    rays = cuda_walk.pack_rays(o, d, t_cap=2.5)
    np.testing.assert_array_equal(rays[6], [2.5] * 4)


@pytest.mark.parametrize("intersector", ["bw", "mt"])
def test_pack_scene_layout(setup, intersector):
    _, td, _, _ = setup
    nodes, links, tris, tri_ids = cuda_walk.pack_scene(td, intersector)
    N = td.node_skip.shape[0]
    NL, L = td.leaf_tri.shape
    assert nodes.shape == (N, 8) and links.shape == (N, 2)
    assert tris.shape == (NL * L, 12) and tri_ids.shape == (NL, L)
    assert links.dtype == jnp.int32 and tri_ids.dtype == jnp.int32
    np.testing.assert_array_equal(nodes[:, 4], td.node_hi.y)
    np.testing.assert_array_equal(nodes[:, 6:], 0.0)
    np.testing.assert_array_equal(links[:, 0], td.node_skip)
    np.testing.assert_array_equal(links[:, 1], td.node_leaf)
    rec = np.asarray(tris).reshape(NL, L, 12)
    np.testing.assert_array_equal(rec[..., 0], td.leaf_v0.x)
    if intersector == "bw":
        n, m1, m2 = bw_precompute(td.leaf_e1, td.leaf_e2)
        np.testing.assert_array_equal(rec[..., 3], n.x)
        np.testing.assert_array_equal(rec[..., 8], m1.z)
        np.testing.assert_array_equal(rec[..., 11], m2.z)
    else:
        np.testing.assert_array_equal(rec[..., 4], td.leaf_e1.y)
        np.testing.assert_array_equal(rec[..., 8], td.leaf_e2.z)
        np.testing.assert_array_equal(rec[..., 9:], 0.0)
    lt = np.asarray(td.leaf_tri)
    pad = lt >= int(td.num_tris)
    assert pad.any()
    np.testing.assert_array_equal(np.asarray(tri_ids)[pad], -1)
    np.testing.assert_array_equal(np.asarray(tri_ids)[~pad], lt[~pad])


def test_kernel_refuses_cpu(setup):
    _, td, o, d = setup
    with pytest.raises(RuntimeError, match="needs a GPU"):
        cuda_walk.closest_hit(o, d, td)


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_walk_choice_by_platform(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    on_gpu = backend == "gpu"
    assert (renderer._per_ray_walk("packets")
            is cuda_walk.closest_hit) == on_gpu
    assert renderer._per_ray_walk("cuda") is cuda_walk.closest_hit
    assert renderer._per_ray_walk("bvh") is not cuda_walk.closest_hit
    assert renderer.resolve_traversal(RenderConfig()) == (
        "cuda" if on_gpu else "packets")


def test_cpu_placement_on_a_gpu_machine(monkeypatch):
    """A computation placed on the CPU with jax.default_device gets the
    CPU's engine even where the default backend is a GPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert cuda_walk.current_platform() == "gpu"
    with jax.default_device(jax.devices("cpu")[0]):
        assert cuda_walk.current_platform() == "cpu"
        assert renderer.resolve_traversal(RenderConfig()) == "packets"
        assert renderer._per_ray_walk("packets") is not cuda_walk.closest_hit


@pytest.mark.gpu
def test_kernel_matches_xla_walk_on_card(gpu_device, capsys):
    """The kernel against traversal.trace on the card (chip_smoke.py runs
    this check at 1M rays on 20k and 328k tris)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke

    chip_smoke.phase_kernel(subdivs=(2,), size=128, subset=4096)
    assert "kernel vs per-ray walk" in capsys.readouterr().out
