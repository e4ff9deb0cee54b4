"""Vectorized ray-primitive intersection ops.

These are the reference's device intersection routines re-derived as
batched, branch-free vector ops (everything is a masked select — there is no
data-dependent control flow, so XLA maps each op onto full-width
elementwise work):

* ``ray_aabb``        — the 3-slab test (reference: BVH.h:51-83). The
  reference returns a bare bool with no positive-t or t-best clipping; we
  additionally clip against [0, t_best] which is provably result-identical
  for BVH traversal (a leaf box entirely behind the origin can only contain
  t<0 triangle hits, which the caller rejects via its ``0 < t`` filter
  anyway, kernel.cu:127) and skips more subtrees.
* ``ray_triangle``    — Moller-Trumbore with the reference's exact epsilon
  semantics (modelLoader.h:49-123): near-parallel cutoff |a| < 1e-5, reject
  on any negative barycentric, NO ``t > 0`` check (callers filter), miss
  sentinel MAX_FLOAT = 1e5.
* ``ray_sphere``      — the reference ships a dormant sphere primitive
  (sphere.h:7-13, include commented out at kernel.cu:21); the north-star
  config list keeps ray-sphere as a capability, so it is live here.

All functions broadcast: rays and primitives may each carry batch dims as
long as they broadcast together (typical shapes: rays (R,), triangles (R, L)
after a leaf gather, giving (R, L) results).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.constants import EPS_PARALLEL, MAX_FLOAT
from .vecmath import Vec3, cross, dot


# ENGINE BIT-PARITY AND FMA CONTRACTION (measured, do not re-derive):
# XLA contracts `a*b - c*d` / dot-product chains into FMAs under jit —
# deterministically BY EXPRESSION STRUCTURE, so two different jit programs
# computing the same formula on the same bits agree bitwise (this is why
# the engines' assert_array_equal parity holds). EAGER execution however
# runs one op per program and cannot contract, so eagerly-computed values
# differ from jit-computed ones in the last ULP (~30% of elements for the
# BW attribute table). `jax.lax.optimization_barrier` does NOT stop the
# contraction (verified: barriers are gone from the compiled HLO and the
# FMA result survives). Rule: any value that must match across engines is
# computed under jit — `bw_precompute` below is jit-wrapped so even eager
# callers (tests building PacketData/TraceData outside jit) get the same
# contracted bits the in-jit engines compute.


def ray_aabb(o: Vec3, inv_d: Vec3, lo: Vec3, hi: Vec3, t_best=None, clip: bool = True):
    """Slab test. Returns a bool mask of box overlaps.

    ``inv_d`` is the precomputed reciprocal direction (shared across every
    node test for a ray — the division in the reference's inner loop,
    BVH.h:53-74, is hoisted out here).

    With ``clip=False`` this is bit-compatible with the reference's
    unclipped test (boxes fully behind the origin still "hit").
    """
    tx0 = (lo.x - o.x) * inv_d.x
    tx1 = (hi.x - o.x) * inv_d.x
    ty0 = (lo.y - o.y) * inv_d.y
    ty1 = (hi.y - o.y) * inv_d.y
    tz0 = (lo.z - o.z) * inv_d.z
    tz1 = (hi.z - o.z) * inv_d.z

    tmin = jnp.maximum(
        jnp.maximum(jnp.minimum(tx0, tx1), jnp.minimum(ty0, ty1)),
        jnp.minimum(tz0, tz1),
    )
    tmax = jnp.minimum(
        jnp.minimum(jnp.maximum(tx0, tx1), jnp.maximum(ty0, ty1)),
        jnp.maximum(tz0, tz1),
    )
    hit = tmin <= tmax
    if clip:
        hit = hit & (tmax >= 0.0)
        if t_best is not None:
            hit = hit & (tmin <= t_best)
    return hit


def ray_triangle(o: Vec3, d: Vec3, v0: Vec3, e1: Vec3, e2: Vec3):
    """Moller-Trumbore. Returns t with MAX_FLOAT as the miss sentinel.

    Matches modelLoader.h:49-123 exactly: the returned t may be negative
    (no ``t > 0`` filter here — the traversal applies ``0 < t < closest``,
    kernel.cu:127); barycentric rejections are strict ``< 0`` tests.
    ``e1 = v1 - v0``, ``e2 = v2 - v0`` are precomputed by callers (they are
    loop-invariant per triangle).
    """
    q = cross(d, e2)
    a = dot(e1, q)
    parallel = jnp.abs(a) < EPS_PARALLEL
    # The reference divides s by a (modelLoader.h:67); guard the div for
    # masked lanes so no NaN/Inf escapes into selects.
    inv_a = jnp.where(parallel, 0.0, 1.0 / jnp.where(parallel, 1.0, a))
    s = (o - v0) * inv_a
    r = cross(s, e1)
    b0 = dot(s, q)
    b1 = dot(r, d)
    b2 = 1.0 - b0 - b1
    reject = parallel | (b0 < 0.0) | (b1 < 0.0) | (b2 < 0.0)
    t = dot(e2, r)
    return jnp.where(reject, MAX_FLOAT, t)


@jax.jit
def bw_precompute(e1: Vec3, e2: Vec3):
    """Baldwin-Weber precomputed triangle attributes (n, m1, m2).

    ``n = e1 x e2`` (unnormalized geometric normal); ``m1 = (e2 x n)/|n|^2``
    and ``m2 = (n x e1)/|n|^2`` are the barycentric row functionals: for a
    point p on the triangle's plane, ``u = m1.(p - v0)`` and
    ``v = m2.(p - v0)`` are its barycentric coordinates (Baldwin & Weber
    2016, JCGT — the world-space form; we anchor at v0 instead of storing a
    plane offset because the offset form ``-(n.v0)`` measured 4.5e-5
    relative t error from catastrophic cancellation at sponza-scale
    coordinates, while the v0-anchored form matches Moller-Trumbore to
    ~2e-7).

    Degenerate triangles (|n| = 0, incl. all-zero padding) yield
    m1 = m2 = 0 and reject in ``ray_triangle_bw`` via the parallel test.
    This is THE single source of the precompute formula: every XLA engine
    calls it so all engines share one rounding profile — and it is
    ``jax.jit``-wrapped so an EAGER caller (tests packing PacketData /
    TraceData outside jit) gets the identical FMA-contracted bits the
    in-jit engines compute (see the contraction note above; without the
    wrapper, eager per-op execution skips the contraction and ~30% of
    attribute elements differ in the last ULP, breaking engine
    bit-parity). Cost: runs once per scene over (T,)-sized arrays.
    """
    n = cross(e1, e2)
    nn = dot(n, n)
    inv_nn = jnp.where(nn > 0.0, 1.0 / jnp.where(nn > 0.0, nn, 1.0), 0.0)
    m1 = cross(e2, n) * inv_nn
    m2 = cross(n, e1) * inv_nn
    return n, m1, m2


def ray_triangle_bw(o: Vec3, d: Vec3, v0: Vec3, n: Vec3, m1: Vec3, m2: Vec3):
    """Baldwin-Weber intersection on precomputed (n, m1, m2) attributes.

    Decision-equivalent to ``ray_triangle`` in exact arithmetic — the
    parallel predicate |n.d| < eps equals MT's |a| < eps since the MT
    determinant is a = e1.(d x e2) = -(n.d); the barycentric sign tests
    match b0/b1/b2 one-to-one — with fewer operations per test (the two
    cross products moved to precompute time). Same contract as
    ``ray_triangle``: t may be negative (callers filter ``0 < t``),
    MAX_FLOAT is the miss sentinel, strict ``< 0`` barycentric rejects.
    Measured rounding agreement with MT: |t| to ~2e-7 relative; ~0.65% of
    rays on a shared-edge-heavy mesh flip the chosen triangle on exact-tie
    edges (t agrees to ULPs — radiometrically invisible).

    XLA engines (brute oracle, per-ray walk, packet slot scan) agree
    bitwise because XLA's FMA contraction is deterministic by expression
    structure (see the module contraction note) and they all run this one
    function under jit.
    """
    sx = o - v0
    nd = dot(d, n)
    parallel = jnp.abs(nd) < EPS_PARALLEL
    inv = jnp.where(parallel, 0.0, 1.0 / jnp.where(parallel, 1.0, nd))
    t = -dot(sx, n) * inv
    w = sx + d * t
    bu = dot(m1, w)
    bv = dot(m2, w)
    bw = 1.0 - bu - bv
    reject = parallel | (bu < 0.0) | (bv < 0.0) | (bw < 0.0)
    return jnp.where(reject, MAX_FLOAT, t)


def ray_triangle_any(o: Vec3, d: Vec3, v0: Vec3, e1: Vec3, e2: Vec3,
                     intersector: str = "bw"):
    """Triangle test with a selectable intersector ('bw' | 'mt').

    'bw' computes the Baldwin-Weber attributes inline from the edges —
    callers that test each triangle against many rays should instead
    ``bw_precompute`` once and call ``ray_triangle_bw`` directly.
    """
    if intersector == "mt":
        return ray_triangle(o, d, v0, e1, e2)
    n, m1, m2 = bw_precompute(e1, e2)
    return ray_triangle_bw(o, d, v0, n, m1, m2)


def ray_triangle_verts(o: Vec3, d: Vec3, v0: Vec3, v1: Vec3, v2: Vec3):
    """Convenience wrapper taking raw vertices (used by the differentiable
    re-evaluation path, where edges must be functions of vertex params)."""
    return ray_triangle(o, d, v0, v1 - v0, v2 - v0)


def ray_triangle_t_unchecked(o: Vec3, d: Vec3, v0: Vec3, v1: Vec3, v2: Vec3):
    """Moller-Trumbore t WITHOUT hit tests — for a triangle already known to
    be hit (found by the discrete trace). Fully differentiable w.r.t. every
    input: this is how the detach-trick backward pass attaches d(t)/d(verts)
    and d(t)/d(ray) after the non-differentiable BVH search
    (diff/render_grad.py; cf. Dr.Jit's attached/detached intersection
    split, PAPERS.md)."""
    e1 = v1 - v0
    e2 = v2 - v0
    q = cross(d, e2)
    a = dot(e1, q)
    safe_a = jnp.where(jnp.abs(a) < 1e-12, 1e-12, a)
    s = (o - v0) * (1.0 / safe_a)
    r = cross(s, e1)
    return dot(e2, r)


def ray_sphere_t_unchecked(o: Vec3, d: Vec3, center: Vec3, radius):
    """Nearest-positive sphere t WITHOUT hit tests, for a sphere already
    known to be hit — the sphere analogue of ray_triangle_t_unchecked:
    fully differentiable w.r.t. ray, center and radius (the detach-trick
    re-evaluation used by diff/render_grad.py)."""
    oc = o - center
    a = dot(d, d)
    b = 2.0 * dot(oc, d)
    c = dot(oc, oc) - radius * radius
    disc = jnp.maximum(b * b - 4.0 * a * c, 1e-12)  # known hit: disc > 0
    sq = jnp.sqrt(disc)
    inv2a = 0.5 / jnp.maximum(a, 1e-20)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    return jnp.where(t0 > 0.0, t0, t1)


def ray_sphere(o: Vec3, d: Vec3, center: Vec3, radius):
    """Ray-sphere intersection (sphere.h:7-13 capability).

    Returns the nearest t >= 0, MAX_FLOAT on miss. Assumes |d| = 1 is NOT
    required (handles general d).
    """
    oc = o - center
    a = dot(d, d)
    b = 2.0 * dot(oc, d)
    c = dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    miss = disc < 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv2a = 0.5 / a
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    t = jnp.where(t0 > 0.0, t0, t1)
    return jnp.where(miss | (t <= 0.0), MAX_FLOAT, t)
