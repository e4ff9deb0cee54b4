"""Differentiable rendering: pixel gradients w.r.t. scene parameters.

The reference has no gradients at all — this module is the north-star
extension ("hand-derived backward pass ... pixel gradients
w.r.t. vertex positions, sphere params, and BSDF albedo/emission").

Design — the detach trick (standard in differentiable rendering, cf. Dr.Jit
PAPERS.md): the BVH hit *search* is discrete and wrapped in stop_gradient
(ops/traversal.py), but once the hit triangle id is known, its intersection
distance is re-evaluated analytically (``ray_triangle_t_unchecked``) as a
differentiable function of the ray and the triangle's vertices. Everything
downstream — hit position, face normal (via ``recompute_derived``), BSDF,
light-pick areas/pdfs, geometric factors — is plain JAX math, so reverse
mode delivers d(pixel)/d(verts, albedo, emission) through the *continuous*
part of the estimator exactly.

Visibility discontinuities (silhouette motion) are covered by two
boundary terms: ``edge_samples > 0`` adds the PRIMARY term
(camera-silhouette edges, Li et al. 2018 edge sampling) and
``shadow_edge_samples > 0`` adds the SECONDARY term for the NEE direct
shadow (occluder silhouettes projected onto the light plane,
diff/edge_sampling.shadow_boundary_image). Both add value-zero images
whose cotangents carry the (L- − L+) x boundary-velocity line integrals,
so the primal is untouched. With the defaults (0) the estimator is
interior-only. Deeper-bounce indirect silhouettes remain
interior-estimated. All modes are validated against finite differences
(tests/test_diff.py, tests/test_edge_sampling.py).

RNG note: gradients are taken with the SAME sample keys as the primal
render (common random numbers), so d(loss)/d(param) finite-difference
checks converge without Monte-Carlo noise dominating.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..integrators.bdpt import BDPTParams, radiance_bdpt
from ..integrators.pt_nee import PTParams, radiance_pt_nee
from ..models.scene import Scene, recompute_derived
from ..ops.intersect import ray_sphere_t_unchecked, ray_triangle_t_unchecked
from ..ops.rng import pixel_keys, sample_key
from ..ops.traversal import Hit
from ..ops.vecmath import Vec3, gather
from ..render.camera import camera_rays
from ..utils.config import RenderConfig


def make_diff_trace_fn(scene: Scene, base_trace_fn):
    """Wrap a discrete trace so the returned t is differentiable.

    base_trace_fn(o, d, mask) -> Hit with stop-grad t. The wrapper gathers
    the hit triangle's vertices from the (differentiable) scene and
    re-evaluates t; misses keep the MAX_FLOAT sentinel with zero tangent.
    """

    T = scene.num_tris
    S = scene.num_spheres

    def diff_trace(o: Vec3, d: Vec3, mask, t_cap=None, vis_band=0.0) -> Hit:
        hit = base_trace_fn(o, d, mask, t_cap=t_cap, vis_band=vis_band)
        tri = jnp.maximum(hit.tri, 0)
        tric = jnp.minimum(tri, max(T - 1, 0))  # sphere ids out of range
        v0 = gather(scene.verts, jnp.take(scene.tri_v0, tric, mode="clip"))
        v1 = gather(scene.verts, jnp.take(scene.tri_v1, tric, mode="clip"))
        v2 = gather(scene.verts, jnp.take(scene.tri_v2, tric, mode="clip"))
        t_re = ray_triangle_t_unchecked(o, d, v0, v1, v2)
        if S > 0:
            # sphere hits re-evaluate against the (differentiable) sphere
            # params instead — d(t)/d(center, radius) for the grad targets
            s = jnp.clip(tri - T, 0, S - 1)
            c = gather(scene.sph_center, s)
            r = jnp.take(scene.sph_radius, s, mode="clip")
            t_sph = ray_sphere_t_unchecked(o, d, c, r)
            t_re = jnp.where(tri >= T, t_sph, t_re)
        t = jnp.where(hit.tri >= 0, t_re, hit.t)
        return Hit(tri=hit.tri, t=t)

    return diff_trace


def render_image_diff(scene: Scene, cam, cfg: RenderConfig, base_key,
                      spp: int, bvh=None, trace_data=None, idx=None,
                      edge_samples: int = 0, edge_table=None,
                      shadow_edge_samples: int = 0) -> Vec3:
    """Differentiable expected-radiance image (Morton order, (R,) Vec3).

    Renders ``spp`` samples under ``lax.scan`` with per-sample
    rematerialization (jax.checkpoint) so backward memory is O(1 sample),
    and averages. The scene's derived quantities (face normals, light area)
    are recomputed from verts inside this function so vertex gradients flow
    through shading and light pdfs.

    ``idx``: optional Morton pixel tile (the sharded gradient pass gives
    each chip its own tile; RNG keys on pixel index, so results are
    position-independent).
    """
    scene = recompute_derived(scene)

    # The hit SEARCH is detached (stop_gradient) in every engine, so the
    # fast packet path (ops/packets.py) is legal here too — the diff
    # wrapper below re-evaluates t differentiably from the chosen
    # triangle id regardless of which engine found it.
    # renderer.make_trace_fn builds the identical trace closure the
    # forward renderer uses (cuda/packets/bvh/brute + analytic spheres);
    # prep stays None so the packet blocks are re-gathered from the
    # CURRENT (perturbed) vertices inside this trace — geometry updates
    # flow into the search. Engines agree on the chosen triangle
    # everywhere (tests/test_packets.py), so gradients are
    # engine-independent. Reference anchor: the trace IS the hot loop
    # (kernel.cu:112-161); in a train step it runs 3+ times per bounce.
    from ..render.renderer import make_trace_fn

    if cfg.traversal != "brute" and bvh is None and trace_data is not None:
        # legacy escape hatch: a caller with only a fine TraceData gets the
        # per-ray walk (packets need the Accel cluster bundle)
        from ..ops import traversal as trav

        def tri_trace(o, d, mask, t_cap=None, vis_band=0.0):
            h = trav.trace(o, d, trace_data, mask=mask,
                           intersector=cfg.intersector)
            return h if t_cap is None else trav.apply_t_cap(h, t_cap)

        if scene.num_spheres > 0:
            def base_trace(o, d, mask, t_cap=None, vis_band=0.0):
                h = tri_trace(o, d, mask, t_cap=t_cap)
                h = trav.trace_spheres(o, d, scene, h.t, h.tri, mask=mask)
                return h if t_cap is None else trav.apply_t_cap(h, t_cap)
        else:
            base_trace = tri_trace
    else:
        base_trace, _ = make_trace_fn(scene, cfg, bvh)

    trace_fn = make_diff_trace_fn(scene, base_trace)
    if idx is None:
        idx = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)
    r = idx.shape[0]

    if cfg.integrator == "pt_nee":
        params = PTParams(
            num_bounces=cfg.num_bounces,
            orthonormal_frame=cfg.orthonormal_frame,
            light_normal_mode=cfg.light_normal_mode,
            branch_pdf_correction=cfg.branch_pdf_correction,
        )

        def radiance(o, d, keys):
            return radiance_pt_nee(o, d, scene, trace_fn, keys, params)
    else:
        bparams = BDPTParams(orthonormal_frame=cfg.orthonormal_frame)

        def radiance(o, d, keys):
            return radiance_bdpt(o, d, scene, trace_fn, keys, bparams)

    @jax.checkpoint
    def one_sample(acc: Vec3, s):
        keys = pixel_keys(sample_key(base_key, s), idx)
        o, d = camera_rays(cam, idx, keys, jitter=cfg.jitter)
        return acc + radiance(o, d, keys), None

    acc, _ = jax.lax.scan(one_sample, Vec3.zeros((r,)), jnp.arange(spp))
    img = acc * (1.0 / spp)

    # Tile sharding of the boundary terms: every chip draws the SAME global
    # edge samples (fixed fold-in keys below) and scatters only the ones
    # landing in its own Morton-contiguous pixel range [idx[0], idx[0]+r).
    # Per-chip contributions are disjoint and sum to exactly the full-image
    # term, so sharded == single-chip without any collective. (idx must be
    # a contiguous Morton range — the parallel/shard.py layout.)
    tile_offset = idx[0] if r != cfg.num_pixels else 0

    if edge_samples > 0:
        assert edge_table is not None, (
            "edge_samples > 0 needs a prebuilt EdgeTable "
            "(diff/edge_sampling.build_edge_table — host-side)"
        )
        from .edge_sampling import boundary_image

        def boundary_radiance(o, d, kidx):
            # one-sample detached estimate; decorrelated sample index
            keys = pixel_keys(sample_key(base_key, jnp.int32(1 << 20)), kidx)
            return radiance(o, d, keys)

        img = img + boundary_image(
            scene, cam, edge_table, boundary_radiance,
            jax.random.fold_in(base_key, 0xED6E),
            edge_samples, cfg.num_pixels,
            tile_offset=tile_offset, tile_pixels=r,
        )

    if shadow_edge_samples > 0:
        assert edge_table is not None, (
            "shadow_edge_samples > 0 needs a prebuilt EdgeTable"
        )
        assert cfg.integrator == "pt_nee", (
            "the shadow boundary term models the PT+NEE direct term"
        )
        from ..ops.shading import make_shade_table, tri_shading
        from .edge_sampling import shadow_boundary_image

        stab = make_shade_table(scene)

        def shade_normal_fn(tri):
            n, alb, _emi, _m = tri_shading(stab, tri)
            return (Vec3(*(jax.lax.stop_gradient(c) for c in n)),
                    Vec3(*(jax.lax.stop_gradient(c) for c in alb)))

        img = img + shadow_boundary_image(
            scene, cam, edge_table, base_trace, shade_normal_fn,
            jax.random.fold_in(base_key, 0x5AD0),
            shadow_edge_samples, cfg.num_pixels,
            branch_factor=1.0 if cfg.branch_pdf_correction else 0.5,
            light_normal_mode=cfg.light_normal_mode,
            tile_offset=tile_offset, tile_pixels=r,
        )
    return img


class GradTargets(NamedTuple):
    """The differentiable parameter bundle (the gradient targets)."""

    verts: Vec3
    albedo: Vec3
    emission: Vec3
    sph_center: Vec3
    sph_radius: jnp.ndarray


def targets_of(scene: Scene) -> GradTargets:
    return GradTargets(
        verts=scene.verts,
        albedo=scene.mat_albedo,
        emission=scene.mat_emission,
        sph_center=scene.sph_center,
        sph_radius=scene.sph_radius,
    )


def scene_with(scene: Scene, p: GradTargets) -> Scene:
    return scene._replace(
        verts=p.verts,
        mat_albedo=p.albedo,
        mat_emission=p.emission,
        sph_center=p.sph_center,
        sph_radius=p.sph_radius,
    )


def l2_loss(img: Vec3, target: Vec3):
    dx = img.x - target.x
    dy = img.y - target.y
    dz = img.z - target.z
    return jnp.mean(dx * dx + dy * dy + dz * dz)


def make_loss_fn(scene: Scene, cam, cfg: RenderConfig, base_key, spp: int,
                 bvh=None, edge_samples: int = 0):
    """loss(params, target_image) -> scalar, differentiable in params.

    ``edge_samples > 0`` adds the primary-visibility boundary gradient
    (diff/edge_sampling.py); the edge table is built here (host side) from
    the scene's cached geometry.

    NOTE the BVH topology is frozen from the input scene: vertex gradients
    are valid for perturbations small enough not to escape their (padded)
    leaf boxes — re-build the BVH between optimizer steps (inverse-rendering
    loops do this on host; the reference has no analogue).
    """
    edge_table = None
    if edge_samples > 0:
        import numpy as np

        from ..models.scene import host_geometry
        from .edge_sampling import build_edge_table

        cached = host_geometry(scene)
        if cached is not None:
            _, tris = cached
        else:
            tris = np.stack(
                [np.asarray(scene.tri_v0), np.asarray(scene.tri_v1),
                 np.asarray(scene.tri_v2)], axis=1)
        edge_table = build_edge_table(tris)

    def loss(params: GradTargets, target: Vec3):
        s = scene_with(scene, params)
        img = render_image_diff(s, cam, cfg, base_key, spp, bvh=bvh,
                                edge_samples=edge_samples,
                                edge_table=edge_table)
        return l2_loss(img, target)

    return loss


def render_and_grad(scene: Scene, cam, cfg: RenderConfig, base_key,
                    spp: int, target: Vec3, bvh=None):
    """(loss, GradTargets cotangents) — the backward pass entry point."""
    loss_fn = make_loss_fn(scene, cam, cfg, base_key, spp, bvh=bvh)
    return jax.value_and_grad(loss_fn)(targets_of(scene), target)
