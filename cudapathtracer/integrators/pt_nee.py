"""Unidirectional path tracer with next-event estimation.

Vectorized re-derivation of the reference's ``radianceAlongSingleStep2``
(kernel.cu:417-515) — the integrator behind the cornell-original and sponza
keepers. The per-thread bounce loop becomes a ``lax.scan`` over bounce index
with (R,)-batched state; every branch is a masked select, so all R lanes run
the same elementwise program.

Reference semantics preserved exactly (each with its file:line):

* hit bookkeeping: t -= 0.001; t < 0.001 kills the path weight; miss
  (t > MAX_FLOAT-1) kills weight and clamps to triangle 0 (kernel.cu:431-441).
* emission: accumulate weight*emission then kill the path — tested via
  ``emission.r != 0`` only (kernel.cu:453-457).
* 50/50 branch between a cosine-weighted BRDF bounce (weight *= albedo;
  the 2x branch-probability compensation is ABSENT in the reference and so
  absent here by default — ``branch_pdf_correction`` adds it;
  kernel.cu:459-464) and an explicit light sample (kernel.cu:467-507).
* the light sample does NOT trace a shadow ray: it relies on the next
  bounce's trace hitting the light, and forces the loop to run exactly one
  more iteration via ``i = max(i, NUM_BOUNCES-2)`` (kernel.cu:507) — modeled
  here with a ``remaining`` counter clamped to 1.
* the light-side cosine uses a HARD-CODED light normal (0,-1,0)
  (kernel.cu:503) — our cornell light faces down so this is exact;
  ``light_normal_mode='true'`` generalizes to the sampled triangle's actual
  normal (SURVEY.md §7: "replicate for cornell parity; generalize behind a
  flag").
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.rng import SiteGroups, uniform_sites
from ..ops.traversal import Hit
from ..ops.sampling import (
    cosine_hemisphere,
    sample_triangle_point,
    triangle_areas,
)
from ..ops.shading import (
    hit_shading,
    light_lookup,
    make_light_table,
    make_shade_table,
    make_sphere_table,
    pick_light_slot,
)
from ..ops.vecmath import Vec3, dot, normalized_safe, where
from ..utils.constants import EPS_HIT, MAX_FLOAT, PI_REF


class PTParams(NamedTuple):
    num_bounces: int = 3
    orthonormal_frame: bool = False      # reference: unnormalized (quirk)
    light_normal_mode: str = "fixed"     # 'fixed' = (0,-1,0) quirk; 'true'
    branch_pdf_correction: bool = False  # reference omits the 2x (quirk)


def radiance_pt_nee(o: Vec3, d: Vec3, scene, trace_fn, keys,
                    params: PTParams = PTParams(),
                    primary_hit=None) -> Vec3:
    """Estimate radiance for R rays. trace_fn(o, d, mask) -> Hit.

    ``keys``: per-pixel key batch for this sample (ops/rng.pixel_keys).
    ``primary_hit``: optional precomputed Hit for the incoming rays —
    with a pinhole camera and no pixel jitter the primary rays are
    identical every sample, so the renderer traces them ONCE per batch
    and hands the result in (bounce 0 is peeled out of the bounce scan
    to allow this; the RNG site streams are unchanged).
    """
    R = o.x.shape[0]
    areas = triangle_areas(scene, scene.lights)  # (L,) differentiable
    total_area = scene.total_light_area
    # Row-packed lookup tables (ops/shading.py): one 16-wide row gather per
    # lookup instead of ~10 scalar gathers. Loop-invariant; XLA hoists.
    shade_tab = make_shade_table(scene)
    light_tab = make_light_table(scene)
    num_tris = scene.num_tris  # static
    sph_tab = make_sphere_table(scene) if scene.num_spheres > 0 else None

    zero = Vec3.zeros((R,))
    one = Vec3.full((R,), 1.0, 1.0, 1.0)

    def bounce(carry, b, hit=None):
        o, d, weight, accum, remaining = carry
        active = remaining > 0

        if hit is None:
            # dead-path compaction: a lane whose weight is already all-zero
            # (miss, near-hit, emission stop) can never contribute again —
            # mask it out of the trace (after the packet sort, dead lanes
            # compact into all-masked tiles that cost nothing). Everything
            # downstream still uses `active`, so the carry evolves exactly
            # as before and the accumulated image is bit-identical.
            alive = active & (
                (weight.x != 0.0) | (weight.y != 0.0) | (weight.z != 0.0)
            )
            hit = trace_fn(o, d, alive)

        t = hit.t - EPS_HIT                       # kernel.cu:431
        near = t < EPS_HIT                        # kernel.cu:432-435
        missed = t > MAX_FLOAT - 1.0              # kernel.cu:436-441
        weight = where(near | missed, zero, weight)
        tri = jnp.where(missed, 0, jnp.maximum(hit.tri, 0))
        t = jnp.where(missed, 0.0, t)

        pos = o + d * t
        normal, albedo, emission = hit_shading(
            shade_tab, sph_tab, num_tris, tri, pos
        )

        # emission accumulation + path kill (kernel.cu:453-457)
        is_emissive = emission.x != 0.0
        add = where(active & is_emissive, weight * emission, zero)
        accum = accum + add
        weight = where(is_emissive, zero, weight)

        # all six of this bounce's draws in one batched derivation
        # (ops/rng.uniform_sites: ~4x cheaper than per-site folding)
        us = uniform_sites(keys, SiteGroups.PT_BOUNCE, 6, bounce=b)

        # 50/50 branch (kernel.cu:459-460)
        a = us[0]
        brdf_branch = a < 0.5

        # --- branch A: cosine BRDF bounce (kernel.cu:462-464) -------------
        u1 = us[1]
        u2 = us[2]
        l_brdf = cosine_hemisphere(normal, u1, u2, params.orthonormal_frame)
        w_brdf = weight * albedo  # BRDF * pi = albedo (kernel.cu:463)
        if params.branch_pdf_correction:
            w_brdf = w_brdf * 2.0

        # --- branch B: explicit light sample (kernel.cu:467-507) ----------
        u = us[3]
        slot = pick_light_slot(total_area * u, areas)
        lu = us[4]
        lv = us[5]
        lv0, la1, la2, lnorm, _ltri = light_lookup(light_tab, slot)
        # no normal offset in the PT light sample (kernel.cu:497)
        p1 = sample_triangle_point(lv0, la1, la2, lu, lv)
        dvec = p1 - pos
        l_nee = normalized_safe(dvec)
        if params.light_normal_mode == "fixed":
            light_n = Vec3.full((R,), 0.0, -1.0, 0.0)  # kernel.cu:503 quirk
        else:
            light_n = lnorm
        cos_l = jnp.maximum(0.0, dot(l_nee, normal))
        cos_o1 = jnp.maximum(0.0, dot(light_n, -l_nee))
        d2 = dot(dvec, dvec)
        g = cos_l * cos_o1 / jnp.where(d2 > 0.0, d2, 1.0)
        w_nee = weight * albedo * ((1.0 / PI_REF) * g * total_area)
        if params.branch_pdf_correction:
            w_nee = w_nee * 2.0

        # select branch, advance ray (kernel.cu:510-511)
        l_dir = where(brdf_branch, l_brdf, l_nee)
        new_weight = where(brdf_branch, w_brdf, w_nee)

        new_remaining = remaining - 1
        # kernel.cu:507 ``i = max(i, NUM_BOUNCES - 2)``: exactly one more
        # bounce after a light sample.
        new_remaining = jnp.where(
            brdf_branch, new_remaining, jnp.minimum(new_remaining, 1)
        )

        o = where(active, pos, o)
        d = where(active, l_dir, d)
        weight = where(active, new_weight, weight)
        remaining = jnp.where(active, new_remaining, remaining)
        return (o, d, weight, accum, remaining), None

    carry = (o, d, one, zero, jnp.full((R,), params.num_bounces, jnp.int32))
    # bounce 0 peeled: lets the renderer inject the (sample-invariant)
    # primary hit; identical RNG streams since sites key on the bounce index
    carry, _ = bounce(carry, 0, hit=primary_hit)
    if params.num_bounces > 1:
        carry, _ = jax.lax.scan(
            bounce, carry, jnp.arange(1, params.num_bounces)
        )
    return carry[3]  # accum
