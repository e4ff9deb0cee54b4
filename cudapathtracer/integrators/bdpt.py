"""Fixed 2+3-vertex bidirectional path tracer.

Vectorized re-derivation of the reference's live integrator
``radianceAlongSingleStep`` (kernel.cu:217-415): a 2-vertex light subpath,
a 3-vertex camera subpath (vertex 4 is the camera itself), and an
UNWEIGHTED sum over the four (i, j) in {0,1}x{2,3} connection strategies —
the reference applies no MIS, and adds the camera-first-hit emission once
per connection (4x total, kernel.cu:410), which brightens by strategy
count. Non-physical, but it is what produced the BDPT-FirstAttempt keeper,
so it is replicated exactly (SURVEY.md §7: "replicate for parity, flag as
non-physical").

The path arrays x[0..4]/norm/mat/invProb (kernel.cu:224-227) become static
Python lists of (R,)-batched values; the connection double loop is unrolled
at trace time (4 combinations), each with one masked shadow trace gated by
the reference's throughput cutoff (max channel > 0.01, kernel.cu:394-398 —
note contributions below the cutoff are ZEROED, not passed through).

Deviation from the reference (documented): at the second camera bounce the
reference reads ``scene.tris[intersect.triIndex]`` without a miss check
(kernel.cu:336) — triIndex is -1 on miss, an out-of-bounds read returning
garbage. We clamp to triangle 0; the numeric effect is already suppressed
by the reference's own G guards (G==0 or NaN -> 1, kernel.cu:339-342).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..ops.rng import SiteGroups, uniform_sites
from ..ops.sampling import (
    cosine_hemisphere,
    sample_triangle_point,
    triangle_areas,
    uniform_hemisphere,
)
from ..ops.shading import (
    light_lookup,
    make_light_table,
    make_shade_table,
    pick_light_slot,
    tri_shading,
)
from ..ops.vecmath import (
    Vec3,
    dot,
    max_component,
    normalized_safe,
    safe_div,
    safe_length,
    where,
)
from ..utils.constants import (
    EPS_HIT,
    EPS_VISIBILITY,
    MAX_FLOAT,
    PI_REF,
    THROUGHPUT_CUTOFF,
)


class BDPTParams(NamedTuple):
    orthonormal_frame: bool = False  # reference: unnormalized frame (quirk)


LIGHT_PATH_SIZE = 2   # kernel.cu:219
CAMERA_PATH_SIZE = 3  # kernel.cu:220
PATH_SIZE = LIGHT_PATH_SIZE + CAMERA_PATH_SIZE
CAM_IND = PATH_SIZE - 1


def radiance_bdpt(o: Vec3, d: Vec3, scene, trace_fn, keys,
                  params: BDPTParams = BDPTParams(),
                  primary_hit=None) -> Vec3:
    """Estimate radiance for R camera rays. trace_fn(o, d, mask) -> Hit.

    ``primary_hit``: optional precomputed Hit for the camera rays (the
    x[3] trace, kernel.cu:306-328) — sample-invariant under a pinhole
    camera with no jitter, so the renderer traces it once per batch."""
    if scene.num_spheres > 0:
        raise NotImplementedError(
            "the BDPT integrator is triangles-only (like the reference's — "
            "sphere.h predates its BDPT and was never wired in, "
            "kernel.cu:21); render spheres with integrator='pt_nee'"
        )
    R = o.x.shape[0]
    areas = triangle_areas(scene, scene.lights)
    total_area = scene.total_light_area
    all_on = jnp.ones((R,), bool)
    # row-packed lookup tables (ops/shading.py): one row gather per lookup
    shade_tab = make_shade_table(scene)
    light_tab = make_light_table(scene)

    x = [None] * PATH_SIZE
    norm = [None] * PATH_SIZE
    albedo = [None] * PATH_SIZE
    inv_prob = [None] * PATH_SIZE

    # ---- light subpath vertex 0: point on a light (kernel.cu:230-267) ----
    # all seven of the sample's draws in one batched derivation
    # (ops/rng.uniform_sites: ~4x cheaper than per-site folding)
    _us = uniform_sites(keys, SiteGroups.BDPT, 7)
    u_pick = _us[0]
    slot = pick_light_slot(total_area * u_pick, areas)
    lu = _us[1]
    lv = _us[2]
    lv0, la1, la2, lnorm, _ltri, l_e = light_lookup(light_tab, slot,
                                                    with_emission=True)
    # offset by normal*0.001 (kernel.cu:261)
    p = sample_triangle_point(lv0, la1, la2, lu, lv)
    x[0] = p + lnorm * EPS_HIT
    norm[0] = lnorm
    albedo[0] = None  # vertex 0's BRDF is never evaluated (kernel.cu:362)
    inv_prob[0] = jnp.broadcast_to(total_area, (R,))

    # ---- camera vertex 4: the camera itself (kernel.cu:301-305) ----------
    x[CAM_IND] = o
    norm[CAM_IND] = d  # stores the *direction* (reference quirk)
    albedo[CAM_IND] = None  # never read (see module doc)
    inv_prob[CAM_IND] = jnp.ones((R,))

    # ---- camera vertex 3: first hit (kernel.cu:306-328) ------------------
    hit = primary_hit if primary_hit is not None else trace_fn(o, d, all_on)
    t = hit.t - EPS_HIT
    missed = t > MAX_FLOAT - 1.0
    tri = jnp.where(missed, 0, jnp.maximum(hit.tri, 0))
    t = jnp.where(missed, 0.0, t)
    x[3] = o + d * t
    n3, alb3, cam_hit_emission, _ = tri_shading(shade_tab, tri)
    norm[3] = n3
    albedo[3] = alb3
    inv_prob[3] = jnp.ones((R,))

    # ---- subpath bounces, ONE batched trace ------------------------------
    # The light-subpath bounce (kernel.cu:273) and the camera second bounce
    # (kernel.cu:333) are mutually independent once the primary hit is
    # known, so they trace as a single (2R,) batch: one packet sort window
    # instead of two, double the ray density per tile. Per-ray results are
    # identical to separate calls (lane math is elementwise; the packet
    # engine's dropped-candidate bound makes results batch-independent), so
    # radiance is bit-identical to the unbatched form.
    u1 = _us[3]
    u2 = _us[4]
    o_dir = uniform_hemisphere(norm[0], u1, u2, params.orthonormal_frame)
    cu1 = _us[5]
    cu2 = _us[6]
    d2dir = cosine_hemisphere(norm[3], cu1, cu2, params.orthonormal_frame)

    def _cat(a, b):
        return Vec3(jnp.concatenate([a.x, b.x]),
                    jnp.concatenate([a.y, b.y]),
                    jnp.concatenate([a.z, b.z]))

    hit_b = trace_fn(_cat(x[0], x[3]), _cat(o_dir, d2dir),
                     jnp.ones((2 * R,), bool))

    # ---- light subpath vertex 1: one uniform bounce (kernel.cu:268-298) --
    t = hit_b.t[:R] - EPS_HIT
    missed = t > MAX_FLOAT - 1.0
    tri = jnp.where(missed, 0, jnp.maximum(hit_b.tri[:R], 0))
    t = jnp.where(missed, 0.0, t)
    n2, alb1, _, _ = tri_shading(shade_tab, tri)
    g = jnp.abs(dot(n2, o_dir)) / jnp.maximum(EPS_HIT, t * t)  # kernel.cu:292
    x[1] = x[0] + o_dir * t
    norm[1] = n2
    albedo[1] = alb1
    # reference: 2π/g would be inf at g==0; downstream that inf meets a 0 and
    # becomes NaN→0 via its nan guard. safe_div reaches the same 0 directly
    # (and keeps the VJP NaN-free).
    inv_prob[1] = safe_div(2.0 * PI_REF, g)

    # ---- camera vertex 2: cosine bounce (kernel.cu:329-348) --------------
    t2 = hit_b.t[R:] - EPS_HIT  # kernel.cu:334 — note: NO miss reset here
    tri2 = jnp.maximum(hit_b.tri[R:], 0)  # clamp (ref reads OOB on miss)
    n22, alb2, _, _ = tri_shading(shade_tab, tri2)
    g2 = safe_div(jnp.abs(dot(norm[3], d2dir) * dot(n22, d2dir)), t2 * t2)
    g2 = jnp.where(g2 == 0.0, 1.0, g2)   # kernel.cu:339-342 (0 and NaN -> 1)
    x[2] = x[3] + d2dir * t2
    norm[2] = n22
    albedo[2] = alb2
    inv_prob[2] = PI_REF / g2

    # ---- connections (kernel.cu:350-412) ---------------------------------
    albedos = albedo  # per-vertex, captured at hit time (row lookups)

    accum = Vec3.zeros((R,))

    def seg_factor(k):
        """f_s * G * invProb for path segment (k-1, k) (kernel.cu:362-371)."""
        seg = x[k] - x[k - 1]
        ray = normalized_safe(seg)
        g = jnp.abs(dot(ray, norm[k]) * dot(ray, norm[k - 1]))
        g = safe_div(g, dot(seg, seg))  # NaN->0 (kernel.cu:367-368), grad-safe
        f_s = albedos[k] * (1.0 / PI_REF)
        return f_s * (g * inv_prob[k])

    # All four (i, j) strategies' shadow rays are independent, so they
    # trace as ONE (4R,) batch (one sort window; the bright-gate masks
    # compact into dead tiles under the packet sort). Bit-identical to four
    # separate masked traces — see the subpath-batch note above.
    conns = []
    for i in range(LIGHT_PATH_SIZE):           # i in {0, 1}
        for j in range(LIGHT_PATH_SIZE, PATH_SIZE - 1):  # j in {2, 3}
            weight = l_e * inv_prob[0]
            for k in range(1, i + 1):           # light side
                weight = weight * seg_factor(k)
            for k in range(j + 1, PATH_SIZE - 1):  # camera side
                weight = weight * seg_factor(k)

            # middle link (kernel.cu:384-407)
            seg = x[j] - x[i]
            seg_len = safe_length(seg)
            ray = normalized_safe(seg)
            g = jnp.maximum(0.0, dot(ray, norm[j]) * dot(-ray, norm[i]))
            g = safe_div(g, dot(seg, seg))
            f_s = albedos[j] * (1.0 / PI_REF)
            weight = weight * (f_s * (g * inv_prob[j]))

            m = max_component(weight)
            bright = m > THROUGHPUT_CUTOFF      # kernel.cu:394-398
            conns.append((weight, x[i], ray, seg_len, bright))

    def _catn(vs):
        return Vec3(jnp.concatenate([v.x for v in vs]),
                    jnp.concatenate([v.y for v in vs]),
                    jnp.concatenate([v.z for v in vs]))

    # visibility queries: the decision is |t - len| <= EPS_VISIBILITY
    # (kernel.cu:402-405), so hits beyond len + 2*eps are irrelevant — a
    # per-ray t_cap lets the packet engine skip the overflow fallback for
    # beyond-cap stragglers. vis_band marks the call site as
    # visibility-only (render/renderer.make_trace_fn: it may pick its own
    # tile size); the answer is still the closest hit.
    seg_cat = jnp.concatenate([c[3] for c in conns])
    sh = trace_fn(_catn([c[1] for c in conns]), _catn([c[2] for c in conns]),
                  jnp.concatenate([c[4] for c in conns]),
                  t_cap=seg_cat + 2.0 * EPS_VISIBILITY,
                  vis_band=3.0 * EPS_VISIBILITY)

    for ci, (weight, _, _, seg_len, bright) in enumerate(conns):
        sh_t = sh.t[ci * R:(ci + 1) * R]
        visible = jnp.abs(sh_t - seg_len) <= EPS_VISIBILITY
        v = (bright & visible).astype(jnp.float32)
        weight = weight * v

        accum = accum + weight
        accum = accum + cam_hit_emission        # kernel.cu:410 (4x quirk)

    return accum
