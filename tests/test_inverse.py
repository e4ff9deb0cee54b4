"""Inverse rendering end-to-end: gradient descent through the
differentiable renderer must RECOVER a perturbed scene parameter, not just
descend — the capability the whole diff/ stack exists for."""

import numpy as np
import jax
import jax.numpy as jnp

from cudapathtracer import RenderConfig, make_camera
from cudapathtracer.diff import render_grad as rg
from cudapathtracer.models import procedural
from cudapathtracer.render.renderer import build_bvh_for_scene


def test_recover_wall_albedo():
    """Perturb the red wall's albedo, optimize it back from the image."""
    import optax

    scene = procedural.to_scene(procedural.cornell_box(with_boxes=False))
    cam = make_camera(width=16, height=16)
    cfg = RenderConfig(width=16, height=16, spp=4, integrator="pt_nee",
                       samples_per_call=4)
    bvh = build_bvh_for_scene(scene, 4)
    key = jax.random.PRNGKey(0)

    target = rg.render_image_diff(scene, cam, cfg, key, 4, bvh=bvh)
    loss_fn = rg.make_loss_fn(scene, cam, cfg, key, spp=4, bvh=bvh)

    p_true = rg.targets_of(scene)
    red = 1  # material index of the red wall
    true_val = float(p_true.albedo.x[red])

    # perturb red wall albedo.x well away from truth
    p = p_true._replace(
        albedo=p_true.albedo._replace(
            x=p_true.albedo.x.at[red].set(0.15)
        )
    )

    opt = optax.adam(0.05)
    opt_state = opt.init(p)
    vg = jax.jit(jax.value_and_grad(loss_fn))

    losses = []
    for _ in range(40):
        loss, g = vg(p, target)
        losses.append(float(loss))
        # only optimize the albedo (keep geometry fixed: this test is about
        # parameter recovery, not silhouettes)
        g = rg.GradTargets(
            verts=jax.tree_util.tree_map(jnp.zeros_like, g.verts),
            albedo=g.albedo,
            emission=jax.tree_util.tree_map(jnp.zeros_like, g.emission),
            sph_center=g.sph_center,
            sph_radius=g.sph_radius,
        )
        updates, opt_state = opt.update(g, opt_state, p)
        p = optax.apply_updates(p, updates)

    recovered = float(p.albedo.x[red])
    assert losses[-1] < 0.2 * losses[0], (losses[0], losses[-1])
    assert abs(recovered - true_val) < 0.08, (recovered, true_val)
