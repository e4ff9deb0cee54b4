"""Gradient correctness: finite-difference validation (the
"grad-check max abs err" metric). The reference has no gradients; these
tests define the contract for the new capability."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cudapathtracer import RenderConfig, make_camera
from cudapathtracer.diff import render_grad as rg
from cudapathtracer.models import procedural
from cudapathtracer.render.renderer import build_bvh_for_scene


@pytest.fixture(scope="module")
def setup():
    scene = procedural.to_scene(procedural.cornell_box(with_boxes=False))
    cam = make_camera(width=8, height=8)
    cfg = RenderConfig(width=8, height=8, spp=2, integrator="pt_nee",
                       samples_per_call=2)
    bvh = build_bvh_for_scene(scene, 4)
    key = jax.random.PRNGKey(0)
    return scene, cam, cfg, bvh, key


def _fd_check(f, x0, g, eps, indices, rtol, atol):
    """Central finite differences on a few coordinates of a flat array."""
    max_err = 0.0
    for i in indices:
        xp = x0.at[i].add(eps)
        xm = x0.at[i].add(-eps)
        fd = (f(xp) - f(xm)) / (2 * eps)
        err = abs(float(fd) - float(g[i]))
        denom = max(abs(float(fd)), abs(float(g[i])), atol)
        assert err <= rtol * denom + atol, (
            f"coord {i}: fd={float(fd):.6g} ad={float(g[i]):.6g} err={err:.3g}"
        )
        max_err = max(max_err, err)
    return max_err


def test_grad_albedo_fd(setup):
    scene, cam, cfg, bvh, key = setup
    target = rg.render_image_diff(scene, cam, cfg, jax.random.PRNGKey(99), 1,
                                  bvh=bvh)
    loss_fn = rg.make_loss_fn(scene, cam, cfg, key, spp=2, bvh=bvh)
    p0 = rg.targets_of(scene)
    loss, grads = jax.value_and_grad(loss_fn)(p0, target)
    assert np.isfinite(float(loss))

    def f_alb(ax):
        p = p0._replace(albedo=p0.albedo._replace(x=ax))
        return loss_fn(p, target)

    g = grads.albedo.x
    _fd_check(f_alb, p0.albedo.x, g, eps=1e-3,
              indices=range(scene.num_mats), rtol=2e-2, atol=1e-5)


def test_grad_emission_fd(setup):
    scene, cam, cfg, bvh, key = setup
    target = rg.render_image_diff(scene, cam, cfg, jax.random.PRNGKey(7), 1,
                                  bvh=bvh)
    loss_fn = rg.make_loss_fn(scene, cam, cfg, key, spp=2, bvh=bvh)
    p0 = rg.targets_of(scene)
    _, grads = jax.value_and_grad(loss_fn)(p0, target)

    def f_em(ex):
        p = p0._replace(emission=p0.emission._replace(y=ex))
        return loss_fn(p, target)

    # light material is index 3; its emission.y gradient must match FD
    _fd_check(f_em, p0.emission.y, grads.emission.y, eps=1e-2,
              indices=[3], rtol=2e-2, atol=1e-6)


def test_grad_verts_fd_interior(setup):
    """Vertex gradients through the continuous estimator: perturb a light
    vertex along its plane (interior-dominant; silhouette term small at
    this scale) and compare to FD."""
    scene, cam, cfg, bvh, key = setup
    target = rg.render_image_diff(scene, cam, cfg, jax.random.PRNGKey(3), 1,
                                  bvh=bvh)
    loss_fn = rg.make_loss_fn(scene, cam, cfg, key, spp=2, bvh=bvh)
    p0 = rg.targets_of(scene)
    _, grads = jax.value_and_grad(loss_fn)(p0, target)
    g = np.asarray(grads.verts.y)
    assert np.isfinite(g).all()
    # some vertex must matter
    assert np.abs(g).max() > 0

    # FD on the ceiling-light height (vertex of the light quad, y coord):
    light_tri = int(np.asarray(scene.lights)[0])
    vid = int(np.asarray(scene.tri_v0)[light_tri])

    def f_v(vy):
        p = p0._replace(verts=p0.verts._replace(y=vy))
        return loss_fn(p, target)

    err = _fd_check(f_v, p0.verts.y, grads.verts.y, eps=5e-3,
                    indices=[vid], rtol=0.15, atol=1e-4)
    print("vertex grad-check max abs err:", err)


def test_grads_zero_for_unseen_material(setup):
    """A material no triangle references gets exactly zero gradient."""
    scene, cam, cfg, bvh, key = setup
    # append an unused material
    import jax.numpy as jnp
    from cudapathtracer.ops.vecmath import Vec3

    def cat(v, val):
        return Vec3(jnp.concatenate([v.x, jnp.asarray([val])]),
                    jnp.concatenate([v.y, jnp.asarray([val])]),
                    jnp.concatenate([v.z, jnp.asarray([val])]))

    s2 = scene._replace(mat_albedo=cat(scene.mat_albedo, 0.5),
                        mat_emission=cat(scene.mat_emission, 0.0))
    target = rg.render_image_diff(s2, cam, cfg, jax.random.PRNGKey(1), 1,
                                  bvh=bvh)
    loss_fn = rg.make_loss_fn(s2, cam, cfg, key, spp=1, bvh=bvh)
    _, grads = jax.value_and_grad(loss_fn)(rg.targets_of(s2), target)
    assert float(jnp.abs(grads.albedo.x[-1])) == 0.0


def test_bdpt_also_differentiable(setup):
    scene, cam, _, bvh, key = setup
    cfg = RenderConfig(width=8, height=8, spp=1, integrator="bdpt",
                       samples_per_call=1)
    target = rg.render_image_diff(scene, cam, cfg, jax.random.PRNGKey(2), 1,
                                  bvh=bvh)
    loss_fn = rg.make_loss_fn(scene, cam, cfg, key, spp=1, bvh=bvh)
    loss, grads = jax.value_and_grad(loss_fn)(rg.targets_of(scene), target)
    assert np.isfinite(float(loss))
    assert np.isfinite(np.asarray(grads.albedo.x)).all()
    assert np.isfinite(np.asarray(grads.verts.x)).all()
