"""Multi-chip sharding tests on the 8-device virtual CPU mesh
(SURVEY.md §4: multi-host story tested single-host via virtual devices)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cudapathtracer import RenderConfig, init_accum, make_camera, render
from cudapathtracer.diff import render_grad as rg
from cudapathtracer.models import procedural
from cudapathtracer.parallel import mesh as mesh_mod
from cudapathtracer.parallel import shard as shard_mod
from cudapathtracer.render.renderer import build_bvh_for_scene


@pytest.fixture(scope="module")
def setup():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    scene = procedural.to_scene(procedural.cornell_box())
    cam = make_camera(width=16, height=16)
    bvh = build_bvh_for_scene(scene, 4)
    return scene, cam, bvh


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_render_matches_single_ulp(setup, n_dev):
    """Sharded render == single-chip render, to within XLA fusion ULPs.

    The RNG keys on pixel index (not array position), the trace engines are
    mask/shard-independent, and per-pixel work is elementwise — so the
    PATHS are identical. The residual tolerance exists because XLA fuses
    the (identical) radiance arithmetic differently at different shard
    SHAPES, changing FMA contraction: observed <=1 ULP deltas on ~1% of
    pixels (4.5e-8 at radiance ~0.1). Trace-level bit-identity is asserted
    engine-vs-oracle in tests/test_packets.py."""
    scene, cam, bvh = setup
    cfg = RenderConfig(width=16, height=16, spp=3, integrator="pt_nee",
                       samples_per_call=3)
    m = mesh_mod.make_tile_mesh(n_dev)
    base_key = jax.random.PRNGKey(4)
    st = shard_mod.render_sharded_jit(
        scene, bvh, cam, cfg, base_key, init_accum(cfg), 3, m
    )
    ref = render(scene, cam, cfg, seed=4)
    np.testing.assert_allclose(np.asarray(st.img.x), np.asarray(ref.img.x),
                               rtol=3e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(st.img.z), np.asarray(ref.img.z),
                               rtol=3e-6, atol=1e-7)
    assert int(st.n) == 3


def test_sharded_bdpt_matches(setup):
    scene, cam, bvh = setup
    cfg = RenderConfig(width=16, height=16, spp=1, integrator="bdpt",
                       samples_per_call=1)
    m = mesh_mod.make_tile_mesh(8)
    st = shard_mod.render_sharded_jit(
        scene, bvh, cam, cfg, jax.random.PRNGKey(1), init_accum(cfg), 1, m
    )
    ref = render(scene, cam, cfg, seed=1)
    np.testing.assert_array_equal(np.asarray(st.img.y), np.asarray(ref.img.y))


def test_train_step_grads_match_single_device(setup):
    """psum'd sharded gradients == single-device gradients."""
    scene, cam, bvh = setup
    cfg = RenderConfig(width=16, height=16, spp=1, integrator="pt_nee",
                       samples_per_call=1)
    key = jax.random.PRNGKey(0)
    target = rg.render_image_diff(scene, cam, cfg, jax.random.PRNGKey(9), 1,
                                  bvh=bvh)

    # single-device reference grads (same sum-based loss)
    def loss_single(p):
        s = rg.scene_with(scene, p)
        img = rg.render_image_diff(s, cam, cfg, key, 1, bvh=bvh)
        dx = img.x - target.x
        dy = img.y - target.y
        dz = img.z - target.z
        return jnp.sum(dx * dx + dy * dy + dz * dz) / cfg.num_pixels

    p0 = rg.targets_of(scene)
    loss_ref, grads_ref = jax.value_and_grad(loss_single)(p0)

    m = mesh_mod.make_tile_mesh(8)
    step = shard_mod.make_train_step(scene, cam, cfg, m, spp=1, bvh=bvh,
                                     learning_rate=0.0)
    loss_sh, params_out, _ = step(p0, None, target, key)

    np.testing.assert_allclose(float(loss_sh), float(loss_ref), rtol=1e-5)
    # lr=0: params unchanged
    np.testing.assert_array_equal(
        np.asarray(params_out.albedo.x), np.asarray(p0.albedo.x)
    )


def test_train_step_descends(setup):
    scene, cam, bvh = setup
    cfg = RenderConfig(width=16, height=16, spp=1, integrator="pt_nee",
                       samples_per_call=1)
    key = jax.random.PRNGKey(0)
    # target: same scene but brighter light — recoverable by gradient
    desc = procedural.cornell_box(light_scale=1.5)
    target_scene = procedural.to_scene(desc)
    target = rg.render_image_diff(target_scene, cam, cfg, key, 1, bvh=bvh)

    m = mesh_mod.make_tile_mesh(4)
    step = shard_mod.make_train_step(scene, cam, cfg, m, spp=1, bvh=bvh,
                                     learning_rate=0.0)
    params = rg.targets_of(scene)
    loss0, _, _ = step(params, None, target, key)

    # the gradient must point toward brighter emission (target light is
    # 1.5x ours) ...
    _, grads = jax.value_and_grad(
        lambda p: _single_loss(scene, cam, cfg, bvh, key, p, target)
    )(params)
    g_light = float(np.asarray(grads.emission.x)[3])
    assert g_light < 0, g_light

    # ... and an emission-only step along -grad must reduce the loss.
    scale = 0.5 / max(abs(g_light), 1e-9)
    params2 = params._replace(
        emission=params.emission._replace(
            x=params.emission.x - scale * grads.emission.x,
            y=params.emission.y - scale * grads.emission.y,
            z=params.emission.z - scale * grads.emission.z,
        )
    )
    loss1, _, _ = step(params2, None, target, key)
    assert float(loss1) < float(loss0), (float(loss0), float(loss1))


def _single_loss(scene, cam, cfg, bvh, key, p, target):
    s = rg.scene_with(scene, p)
    img = rg.render_image_diff(s, cam, cfg, key, 1, bvh=bvh)
    dx = img.x - target.x
    dy = img.y - target.y
    dz = img.z - target.z
    return jnp.sum(dx * dx + dy * dy + dz * dz) / cfg.num_pixels


def test_train_step_with_optax(setup):
    import optax

    scene, cam, bvh = setup
    cfg = RenderConfig(width=16, height=16, spp=1, integrator="pt_nee",
                       samples_per_call=1)
    key = jax.random.PRNGKey(2)
    target = rg.render_image_diff(scene, cam, cfg, jax.random.PRNGKey(5), 1,
                                  bvh=bvh)
    m = mesh_mod.make_tile_mesh(2)
    tx = optax.adam(1e-3)
    step = shard_mod.make_train_step(scene, cam, cfg, m, spp=1, bvh=bvh,
                                     optimizer=tx)
    params = rg.targets_of(scene)
    opt_state = tx.init(params)
    loss, params, opt_state = step(params, opt_state, target, key)
    assert np.isfinite(float(loss))


def test_train_step_edge_grads_match_single_device(setup):
    """Sharded boundary-term gradients == single-device (r3 verdict #5).

    Each chip draws the same global edge samples and scatters only into its
    own Morton tile, so the psum'd silhouette gradient must match the
    single-device one to summation-order ULPs.
    """
    import numpy as np_

    from cudapathtracer.diff.edge_sampling import build_edge_table
    from cudapathtracer.models.scene import host_geometry

    scene, cam, bvh = setup
    cfg = RenderConfig(width=16, height=16, spp=1, integrator="pt_nee",
                       samples_per_call=1)
    key = jax.random.PRNGKey(0)
    target = rg.render_image_diff(scene, cam, cfg, jax.random.PRNGKey(9), 1,
                                  bvh=bvh)

    _, tris_h = host_geometry(scene)
    etab = build_edge_table(np_.asarray(tris_h))

    ES, SES = 64, 64

    def loss_single(p):
        s = rg.scene_with(scene, p)
        img = rg.render_image_diff(s, cam, cfg, key, 1, bvh=bvh,
                                   edge_samples=ES, edge_table=etab,
                                   shadow_edge_samples=SES)
        dx = img.x - target.x
        dy = img.y - target.y
        dz = img.z - target.z
        return jnp.sum(dx * dx + dy * dy + dz * dz) / cfg.num_pixels

    p0 = rg.targets_of(scene)
    loss_ref, grads_ref = jax.value_and_grad(loss_single)(p0)

    m = mesh_mod.make_tile_mesh(8)
    grad_fn = shard_mod.make_sharded_grad_fn(
        scene, cam, cfg, m, spp=1, bvh=bvh,
        edge_samples=ES, shadow_edge_samples=SES)
    idx_all = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)
    loss_sh, grads_sh = jax.jit(grad_fn)(p0, target, idx_all, key)

    np.testing.assert_allclose(float(loss_sh), float(loss_ref), rtol=1e-5)
    g_ref = np.asarray(grads_ref.verts.x)
    g_sh = np.asarray(grads_sh.verts.x)
    assert np.abs(g_ref).max() > 0  # the edge terms must actually fire
    np.testing.assert_allclose(g_sh, g_ref, rtol=2e-4,
                               atol=1e-6 * np.abs(g_ref).max())
    np.testing.assert_allclose(np.asarray(grads_sh.verts.y),
                               np.asarray(grads_ref.verts.y), rtol=2e-4,
                               atol=1e-6 * np.abs(g_ref).max())
