"""Row-packed shading lookups.

The integrators look up per-hit shading data (normal, albedo, emission) and
per-pick light geometry many times per bounce. Packing each table into
(N, 16) f32 rows turns every lookup into ONE row gather plus column slices
instead of ~10 scalar gathers. The layout was chosen before the GPU port;
whether plain per-field gathers are faster on the H100 has not been
measured.

Tables are built under jit from the live scene arrays, so they are
differentiable w.r.t. vertices/albedo/emission and get hoisted out of the
sample/bounce loops by XLA (loop-invariant).

Integer fields (material/triangle ids) travel as exact float VALUES
(id + 2^23), never as bitcasts: a small int bitcast to f32 is a denormal,
which hardware may flush to zero.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .vecmath import Vec3, cross, gather

_ID_OFFSET = float(1 << 23)


def _unpackable(r):
    """Make a gathered (R, 16) row block cheap to column-slice.

    Multiplying by an f32 identity turns the 16 column extractions into one
    matrix product whose output the column slices read directly. The trick
    was chosen before the GPU port; its cost on the H100 has not been
    measured.

    precision=HIGHEST is required for bit-exactness (verified exact:
    products by 1.0/0.0 and additions of 0.0 are exact for finite table
    values, and the f32_f32_f32 pass keeps all 24 mantissa bits; DEFAULT
    may run in reduced precision, TF32 on a GPU, and lose low bits).
    Tables are finite by construction (positions, albedo, emission,
    id + 2^23), so no NaN*0 hazard.
    """
    eye = jnp.eye(r.shape[-1], dtype=r.dtype)
    return jax.lax.dot_general(
        r, eye, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )


class ShadeTable(NamedTuple):
    """(T+1, 16) per-triangle rows: [n.xyz, albedo.xyz, emission.xyz,
    mat+2^23, pad...]. Row T is a harmless default (triangle 0's data is
    NOT used for padding — miss lanes clamp to triangle 0 per the
    reference's semantics before lookup, kernel.cu:437)."""

    tri_rows: jnp.ndarray


class LightTable(NamedTuple):
    """(L+1, 16) per-light rows: [v0.xyz, a1.xyz, a2.xyz, n.xyz,
    tri+2^23, emission.xyz] where a1 = v1-v0, a2 = v2-v0. Row L is the
    no-match fallback: the reference's scan falls through to *scene
    triangle 0* (kernel.cu:232), so row L carries triangle 0's data."""

    light_rows: jnp.ndarray
    num_lights: int  # static


def make_shade_table(scene) -> ShadeTable:
    mat = scene.tri_mat
    alb = gather(scene.mat_albedo, mat)
    emi = gather(scene.mat_emission, mat)
    matf = mat.astype(jnp.float32) + _ID_OFFSET
    z = jnp.zeros_like(matf)
    rows = jnp.stack(
        [scene.tri_norm.x, scene.tri_norm.y, scene.tri_norm.z,
         alb.x, alb.y, alb.z,
         emi.x, emi.y, emi.z,
         matf, z, z, z, z, z, z], axis=1
    )
    rows = jnp.concatenate([rows, jnp.zeros((1, 16), jnp.float32)], axis=0)
    return ShadeTable(tri_rows=rows)


def tri_shading(table: ShadeTable, tri):
    """tri: (R,) i32 >= 0. Returns (normal, albedo, emission, mat)."""
    r = _unpackable(jnp.take(table.tri_rows, tri, axis=0, mode="clip"))
    n = Vec3(r[:, 0], r[:, 1], r[:, 2])
    alb = Vec3(r[:, 3], r[:, 4], r[:, 5])
    emi = Vec3(r[:, 6], r[:, 7], r[:, 8])
    mat = (r[:, 9] - _ID_OFFSET).astype(jnp.int32)
    return n, alb, emi, mat


def make_light_table(scene) -> LightTable:
    li = scene.lights
    L = int(li.shape[0])
    # fallback row: scene triangle 0 (the reference's no-match fallthrough)
    idx = jnp.concatenate([li.astype(jnp.int32), jnp.zeros((1,), jnp.int32)])
    tv0 = jnp.take(scene.tri_v0, idx, mode="clip")
    tv1 = jnp.take(scene.tri_v1, idx, mode="clip")
    tv2 = jnp.take(scene.tri_v2, idx, mode="clip")
    v0 = gather(scene.verts, tv0)
    v1 = gather(scene.verts, tv1)
    v2 = gather(scene.verts, tv2)
    n = gather(scene.tri_norm, idx)
    trif = idx.astype(jnp.float32) + _ID_OFFSET
    emi = gather(scene.mat_emission, jnp.take(scene.tri_mat, idx,
                                              mode="clip"))
    a1 = v1 - v0
    a2 = v2 - v0
    rows = jnp.stack(
        [v0.x, v0.y, v0.z, a1.x, a1.y, a1.z, a2.x, a2.y, a2.z,
         n.x, n.y, n.z, trif, emi.x, emi.y, emi.z], axis=1
    )
    return LightTable(light_rows=rows, num_lights=L)


def light_lookup(table: LightTable, slot, with_emission: bool = False):
    """slot: (R,) i32 in [0, L] (L = fallback). Returns
    (v0, a1, a2, normal, tri[, emission]) for the picked lights.

    Small tables (<= 32 rows — every cornell/colonnade-class scene) use a
    one-hot matmul instead of a row gather (chosen before the GPU port; not
    yet measured on the H100). Bit-exact:
    exactly one 1.0 per one-hot row (slot is in [0, L] by construction),
    HIGHEST precision keeps full f32 mantissas, and x*1.0 + 0.0*y sums
    are exact for finite table values (worst case a -0.0 normalizes to
    +0.0, indistinguishable downstream)."""
    rows = table.light_rows
    n_rows = int(rows.shape[0])
    if n_rows <= 32:
        onehot = (
            slot[..., None]
            == jnp.arange(n_rows, dtype=slot.dtype)[None, :]
        ).astype(rows.dtype)
        r = jax.lax.dot_general(
            onehot, rows, (((onehot.ndim - 1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )
    else:
        r = _unpackable(jnp.take(rows, slot, axis=0, mode="clip"))
    v0 = Vec3(r[:, 0], r[:, 1], r[:, 2])
    a1 = Vec3(r[:, 3], r[:, 4], r[:, 5])
    a2 = Vec3(r[:, 6], r[:, 7], r[:, 8])
    n = Vec3(r[:, 9], r[:, 10], r[:, 11])
    tri = (r[:, 12] - _ID_OFFSET).astype(jnp.int32)
    if with_emission:
        return v0, a1, a2, n, tri, Vec3(r[:, 13], r[:, 14], r[:, 15])
    return v0, a1, a2, n, tri


class SphereTable(NamedTuple):
    """(S+1, 16) per-sphere rows: [center.xyz, radius, albedo.xyz,
    emission.xyz, mat+2^23, pad...] (sentinel last row)."""

    sph_rows: jnp.ndarray


def make_sphere_table(scene) -> SphereTable:
    from .vecmath import gather as vgather

    alb = vgather(scene.mat_albedo, scene.sph_mat)
    emi = vgather(scene.mat_emission, scene.sph_mat)
    matf = scene.sph_mat.astype(jnp.float32) + _ID_OFFSET
    z = jnp.zeros_like(matf)
    rows = jnp.stack(
        [scene.sph_center.x, scene.sph_center.y, scene.sph_center.z,
         scene.sph_radius, alb.x, alb.y, alb.z, emi.x, emi.y, emi.z,
         matf, z, z, z, z, z], axis=1
    )
    rows = jnp.concatenate([rows, jnp.zeros((1, 16), jnp.float32)], axis=0)
    return SphereTable(sph_rows=rows)


def hit_shading(shade_tab: ShadeTable, sph_tab, num_tris: int, tri, pos):
    """Shading lookup for a mixed triangle/sphere hit id.

    tri: (R,) i32 hit ids (already clamped >= 0); ids >= num_tris are
    sphere hits (id - num_tris = sphere index). pos: (R,) Vec3 hit points
    (needed for the analytic sphere normal (p - c)/|p - c|). ``sph_tab``
    may be None when the scene has no spheres (static fast path).
    Returns (normal, albedo, emission)."""
    from .vecmath import normalized_safe, where as vwhere

    n, alb, emi, _mat = tri_shading(shade_tab, tri)
    if sph_tab is None:
        return n, alb, emi
    is_s = tri >= num_tris
    r = _unpackable(
        jnp.take(sph_tab.sph_rows, jnp.clip(tri - num_tris, 0, None),
                 axis=0, mode="clip"))
    c = Vec3(r[:, 0], r[:, 1], r[:, 2])
    sn = normalized_safe(pos - c)
    n = vwhere(is_s, sn, n)
    alb = vwhere(is_s, Vec3(r[:, 4], r[:, 5], r[:, 6]), alb)
    emi = vwhere(is_s, Vec3(r[:, 7], r[:, 8], r[:, 9]), emi)
    return n, alb, emi


def pick_light_slot(rand_area, areas):
    """The reference's light-pick scan (kernel.cu:231-244) returning the
    LIGHT SLOT (index into the light table) instead of a scene-triangle id;
    no match -> slot L (the fallback row). Semantics identical to
    sampling.pick_light.

    Two implementations with IDENTICAL results (tested):

    * L <= 64: the (R, L) broadcast form of the scan — fuses well and is
      cheapest for the common few-lights scene.
    * L > 64: binary search over the cumulative-area table — O(R log L)
      instead of the O(R*L) broadcast, which at sponza-class light counts
      (hundreds of emissive tris) is a memory cliff at R=1M. Pathwise
      equal to the scan INCLUDING the boundary cases: the scan matches
      bin j iff prev_cum[j] < x < cum[j] strictly, so x exactly on a bin
      boundary (or <= 0, or >= total) falls through to slot L — exactly
      what the searchsorted(side='left') + strict-bounds check yields.
    """
    L = areas.shape[0]
    if L == 0:
        return jnp.full(rand_area.shape, 0, jnp.int32)  # only row: fallback
    cum = jnp.cumsum(areas)
    if L <= 64:
        prev_cum = cum - areas
        rem = rand_area[:, None] - prev_cum[None, :]
        match = (rem > 0.0) & (rem < areas[None, :])
        any_match = jnp.any(match, axis=1)
        j = jnp.argmax(match, axis=1).astype(jnp.int32)
        return jnp.where(any_match, j, L)

    j = jnp.searchsorted(cum, rand_area, side="left").astype(jnp.int32)
    jc = jnp.clip(j, 0, L - 1)
    area_j = jnp.take(areas, jc, mode="clip")
    prev_j = jnp.take(cum, jc, mode="clip") - area_j
    # the exact comparisons of the broadcast scan row jc (same f32
    # rounding: rem = x - prev, strict bounds) so both paths agree
    # bitwise except within one-ULP bin-boundary windows
    rem = rand_area - prev_j
    matched = (rem > 0.0) & (rem < area_j)
    return jnp.where(matched, jc, L)
