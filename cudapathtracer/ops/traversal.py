"""Batched, stackless BVH traversal — the per-ray closest-hit walk.

The reference traverses with a per-thread 64-deep stack inside a divergent
while loop (kernel.cu:112-161) — one ray per CUDA thread. Here a *batch* of
R rays walks a threaded (skip-link) flat BVH (see accel/bvh.py) in one
``lax.while_loop``: per-ray traversal state is one int32 preorder cursor,
so no ray needs a stack. Each step does, for all R lanes at once:

  1. gather the cursor node's AABB          (6 x 1-D gather)
  2. slab test                              (~20 flops/lane)
  3. gather the leaf's L-triangle block     (9 x row gather, contiguous rows)
  4. L triangle tests per lane              (masked)
  5. advance cursors: interior hit -> +1, otherwise -> skip

Cursors strictly increase, so the loop terminates in <= N steps; in practice
it runs until the *slowest lane* finishes — which is why rays are issued in
Morton order (utils/morton.py): coherent batches finish together. Triangle
data is pre-packed per leaf (``TraceData``) so step 3 reads contiguous
blocks instead of chasing index indirections.

``trace`` is non-differentiable by design (hit search is discrete); the
differentiable pass re-evaluates the found primitive analytically
(diff/render_grad.py), the standard detach trick from differentiable
rendering (cf. Dr.Jit, PAPERS.md).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.constants import MAX_FLOAT
from .intersect import (
    bw_precompute,
    ray_aabb,
    ray_sphere,
    ray_triangle,
    ray_triangle_any,
    ray_triangle_bw,
)
from .vecmath import Vec3, gather


class TraceData(NamedTuple):
    """BVH + pre-packed leaf triangle data, ready for traversal.

    Components of leaf_* are (NL, L) arrays (SoA Vec3 over two batch dims).
    Row NL-1 may be a real leaf; padding *slots* inside rows hold the
    degenerate triangle (all vertices 0 -> Moller-Trumbore parallel-rejects).
    """

    node_lo: Vec3        # (N,)
    node_hi: Vec3        # (N,)
    node_skip: jnp.ndarray   # (N,) i32
    node_leaf: jnp.ndarray   # (N,) i32, -1 = interior
    leaf_v0: Vec3        # (NL, L)
    leaf_e1: Vec3        # (NL, L)
    leaf_e2: Vec3        # (NL, L)
    leaf_tri: jnp.ndarray    # (NL, L) i32, pad = num_tris
    num_tris: jnp.ndarray    # () i32 (for pad detection)

    @property
    def num_nodes(self):
        return self.node_skip.shape[0]


def make_trace_data(scene, bvh) -> TraceData:
    """Pack (scene, FlatBVH) into TraceData. Runs under jit; differentiable
    w.r.t. scene.verts (the packing is pure gathers)."""
    T = scene.num_tris
    # Explicit sentinel pad: index T maps to vertex 0 for all three corners
    # -> degenerate triangle -> guaranteed miss. (mode='clip' would alias
    # the last *real* triangle instead.)
    pad = jnp.zeros((1,), jnp.int32)
    v0i = jnp.concatenate([scene.tri_v0, pad])
    v1i = jnp.concatenate([scene.tri_v1, pad])
    v2i = jnp.concatenate([scene.tri_v2, pad])
    lt = bvh.leaf_tri  # (NL, L)
    i0 = jnp.take(v0i, lt, mode="clip")
    i1 = jnp.take(v1i, lt, mode="clip")
    i2 = jnp.take(v2i, lt, mode="clip")
    v0 = gather(scene.verts, i0)
    v1 = gather(scene.verts, i1)
    v2 = gather(scene.verts, i2)
    # Zero out pad slots so even vertex-0 geometry can't phantom-hit.
    is_pad = lt >= T
    z = jnp.where(is_pad, 0.0, 1.0)
    v0 = v0 * z
    v1 = v1 * z
    v2 = v2 * z
    return TraceData(
        node_lo=Vec3(bvh.node_lo_x, bvh.node_lo_y, bvh.node_lo_z),
        node_hi=Vec3(bvh.node_hi_x, bvh.node_hi_y, bvh.node_hi_z),
        node_skip=bvh.node_skip,
        node_leaf=bvh.node_leaf,
        leaf_v0=v0,
        leaf_e1=v1 - v0,
        leaf_e2=v2 - v0,
        leaf_tri=lt,
        num_tris=jnp.asarray(T, jnp.int32),
    )


class Hit(NamedTuple):
    tri: jnp.ndarray  # (R,) i32, -1 = miss
    t: jnp.ndarray    # (R,) f32, MAX_FLOAT = miss (reference sentinel)


# plain int (not jnp.int32): a module-level jnp constant would
# initialize the XLA backend at import, which breaks
# jax.distributed.initialize in multi-process programs
_TRI_SENTINEL = 0x7FFFFFFF


def _closest_update(ts, tri_ids, t_best, tri_best):
    """Fold a (R, L) candidate block into the running closest hit.

    Exact-t ties are broken toward the LOWER triangle index — a documented
    deviation from the reference (which keeps the first hit in traversal
    order, kernel.cu:127): deterministic tie-breaking makes the BVH,
    brute-force and Pallas paths agree bit-for-bit, which the reference's
    order-dependent rule cannot. Candidates must already be masked to
    MAX_FLOAT where invalid.
    """
    t_new = jnp.min(ts, axis=1)
    is_min = ts == t_new[:, None]
    tri_new = jnp.min(
        jnp.where(is_min & (ts < MAX_FLOAT), tri_ids, _TRI_SENTINEL), axis=1
    )
    better = (t_new < t_best) | (
        (t_new == t_best) & (tri_new < tri_best.astype(jnp.int32))
        & (tri_new < _TRI_SENTINEL) & (tri_best >= 0)
    )
    t_out = jnp.where(better, t_new, t_best)
    tri_out = jnp.where(better, tri_new, tri_best)
    return t_out, tri_out


class TraceStats(NamedTuple):
    """Instrumentation mirroring the reference's per-triangle visit counter
    (kernel.cu:133, dumped to out.csv at kernel.cu:742-750) plus step count
    and a per-RAY node-visit count (the BVH falsecolor visualization of the
    'sponza bvh' keeper)."""

    tri_visits: jnp.ndarray  # (T+1,) i32 — slot T collects pad visits
    steps: jnp.ndarray       # () i32 — while-loop iterations for the batch
    ray_visits: jnp.ndarray  # (R,) i32 — nodes visited per ray


class _LoopState(NamedTuple):
    cursor: jnp.ndarray
    t_best: jnp.ndarray
    tri_best: jnp.ndarray
    tri_visits: jnp.ndarray
    steps: jnp.ndarray
    ray_visits: jnp.ndarray


def trace(o: Vec3, d: Vec3, td: TraceData, mask=None, t_clip: bool = True,
          with_stats: bool = False, num_tris_static: int | None = None,
          intersector: str = "bw"):
    """Closest-hit trace for a batch of rays.

    o, d: Vec3 with (R,) components. Returns Hit (and TraceStats when
    ``with_stats``). Semantics match the reference ``trace``
    (kernel.cu:112-161): keep the closest triangle with ``0 < t < closest``;
    miss leaves t = MAX_FLOAT, tri = -1.

    ``intersector``: 'bw' (Baldwin-Weber, the default everywhere — see
    intersect.ray_triangle_bw) or 'mt' (the reference's Moller-Trumbore).
    Decision-equivalent in exact arithmetic; all engines must run the SAME
    choice for bit-parity.

    ``mask``: optional (R,) bool — lanes with False start at the done
    cursor (they report a miss and cost no traversal steps). The batch
    runs until the slowest *enabled* lane finishes.
    """
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    # TraceData is derived from scene.verts and may carry tangents under
    # jax.grad; while_loop has no transpose rule, so sever them here — the
    # differentiable path re-evaluates the found primitive analytically
    # (diff/render_grad.py).
    td = jax.lax.stop_gradient(td)
    R = o.x.shape[0]
    N = td.num_nodes
    L = td.leaf_tri.shape[1]

    inv_d = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    o_b = Vec3(o.x[:, None], o.y[:, None], o.z[:, None])
    d_b = Vec3(d.x[:, None], d.y[:, None], d.z[:, None])

    # The visit-histogram size must be static; under jit td.num_tris is a
    # tracer, so callers must pass num_tris_static explicitly there.
    if not with_stats:
        nvis = 1
    elif num_tris_static is not None:
        nvis = int(num_tris_static) + 1
    else:
        nvis = int(td.num_tris) + 1

    def cond(s: _LoopState):
        return jnp.any(s.cursor < N)

    def body(s: _LoopState):
        cur = s.cursor
        active = cur < N
        curc = jnp.minimum(cur, N - 1)
        lo = gather(td.node_lo, curc)
        hi = gather(td.node_hi, curc)
        box_hit = ray_aabb(o, inv_d, lo, hi,
                           t_best=s.t_best if t_clip else None,
                           clip=t_clip) & active

        leaf = jnp.take(td.node_leaf, curc, mode="clip")
        is_leaf = leaf >= 0
        do_leaf = is_leaf & box_hit
        lid = jnp.maximum(leaf, 0)

        v0 = gather(td.leaf_v0, lid)   # (R, L)
        e1 = gather(td.leaf_e1, lid)
        e2 = gather(td.leaf_e2, lid)
        tri_ids = jnp.take(td.leaf_tri, lid, axis=0, mode="clip")  # (R, L)

        ts = ray_triangle_any(o_b, d_b, v0, e1, e2,
                              intersector=intersector)  # (R, L)
        valid = (
            do_leaf[:, None]
            & (tri_ids < td.num_tris)
            & (ts > 0.0)                      # kernel.cu:127 ``0 < t``
            & (ts <= s.t_best[:, None])       # <= : ties resolved below
        )
        ts = jnp.where(valid, ts, MAX_FLOAT)
        t_best, tri_best = _closest_update(
            ts, tri_ids, s.t_best, s.tri_best
        )

        skip = jnp.take(td.node_skip, curc, mode="clip")
        nxt = jnp.where(is_leaf | ~box_hit, skip, curc + 1)
        cursor = jnp.where(active, nxt, cur)

        if with_stats:
            visits = s.tri_visits.at[
                jnp.where(do_leaf[:, None], tri_ids, nvis - 1)
            ].add(1, mode="drop")
            rvis = s.ray_visits + active.astype(jnp.int32)
        else:
            visits = s.tri_visits
            rvis = s.ray_visits
        return _LoopState(cursor, t_best, tri_best, visits, s.steps + 1,
                          rvis)

    start = jnp.zeros((R,), jnp.int32)
    if mask is not None:
        start = jnp.where(mask, 0, N).astype(jnp.int32)
    init = _LoopState(
        cursor=start,
        t_best=jnp.full((R,), MAX_FLOAT, jnp.float32),
        tri_best=jnp.full((R,), -1, jnp.int32),
        tri_visits=jnp.zeros((nvis,), jnp.int32),
        steps=jnp.zeros((), jnp.int32),
        ray_visits=jnp.zeros((R if with_stats else 1,), jnp.int32),
    )
    out = jax.lax.while_loop(cond, body, init)
    hit = Hit(tri=out.tri_best, t=out.t_best)
    if with_stats:
        return hit, TraceStats(tri_visits=out.tri_visits,
                               steps=out.steps,
                               ray_visits=out.ray_visits)
    return hit


# ---------------------------------------------------------------------------
# brute-force oracle (and small-scene fast path)
# ---------------------------------------------------------------------------

def trace_bruteforce(o: Vec3, d: Vec3, scene, mask=None, chunk: int = 512,
                     intersector: str = "bw"):
    """All-pairs closest hit: every ray against every triangle, in chunks.

    ``mask`` is accepted for API parity with ``trace``; brute force does
    all lanes regardless (fixed work), masked lanes simply report a miss.
    ``intersector``: 'bw' (default; attributes precomputed ONCE over the
    triangle SoA via intersect.bw_precompute, so the chunk fold runs the
    cheap precomputed form) or 'mt'.

    Zero gathers in the inner loop (triangle chunks are contiguous slices) —
    this is pure elementwise work and serves both as the correctness
    oracle for the BVH path and as the fast path for scenes small enough
    that O(R*T) beats gather-bound traversal.
    """
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    scene = jax.lax.stop_gradient(scene)  # hit search is discrete
    T = scene.num_tris
    # Pre-pack triangle SoA, padded to a chunk multiple with degenerates.
    Tp = ((T + chunk - 1) // chunk) * chunk
    padn = Tp - T

    def padv(a):
        return jnp.concatenate([a, jnp.zeros((padn,), a.dtype)])

    v0 = gather(scene.verts, scene.tri_v0)
    v1 = gather(scene.verts, scene.tri_v1)
    v2 = gather(scene.verts, scene.tri_v2)
    v0 = Vec3(padv(v0.x), padv(v0.y), padv(v0.z))
    # (build e1/e2 after padding so pad slots stay degenerate: e1 = e2 = 0)
    v1 = Vec3(padv(v1.x), padv(v1.y), padv(v1.z))
    v2 = Vec3(padv(v2.x), padv(v2.y), padv(v2.z))
    e1 = v1 - v0
    e2 = v2 - v0
    tri_ids = jnp.concatenate(
        [jnp.arange(T, dtype=jnp.int32), jnp.full((padn,), -1, jnp.int32)]
    )

    o_b = Vec3(o.x[:, None], o.y[:, None], o.z[:, None])
    d_b = Vec3(d.x[:, None], d.y[:, None], d.z[:, None])

    bw = intersector == "bw"
    if bw:
        # precompute once over the padded SoA (degenerate pads: n = m = 0
        # -> parallel-reject, same guarantee as MT's zero edges), so the
        # chunk fold runs the cheap precomputed form
        attrs = bw_precompute(e1, e2)
    else:
        attrs = (e1, e2)

    def chunk_fn(carry, args):
        t_best, tri_best = carry
        cv0, cids = args[0], args[-1]

        def b(v):
            return Vec3(v.x[None, :], v.y[None, :], v.z[None, :])

        if bw:
            ts = ray_triangle_bw(o_b, d_b, b(cv0),
                                 b(args[1]), b(args[2]), b(args[3]))
        else:
            ts = ray_triangle(o_b, d_b, b(cv0), b(args[1]), b(args[2]))
        valid = (cids[None, :] >= 0) & (ts > 0.0) & (ts <= t_best[:, None])
        ts = jnp.where(valid, ts, MAX_FLOAT)
        t_best, tri_best = _closest_update(
            ts, jnp.broadcast_to(cids[None, :], ts.shape), t_best, tri_best
        )
        return (t_best, tri_best), None

    def resh(a):
        return a.reshape(-1, chunk)

    def reshv(v):
        return Vec3(resh(v.x), resh(v.y), resh(v.z))

    args = (reshv(v0), *(reshv(a) for a in attrs), resh(tri_ids))
    R = o.x.shape[0]
    init = (
        jnp.full((R,), MAX_FLOAT, jnp.float32),
        jnp.full((R,), -1, jnp.int32),
    )
    (t_best, tri_best), _ = jax.lax.scan(chunk_fn, init, args)
    if mask is not None:
        t_best = jnp.where(mask, t_best, MAX_FLOAT)
        tri_best = jnp.where(mask, tri_best, -1)
    return Hit(tri=tri_best, t=t_best)


def apply_t_cap(hit: Hit, t_cap) -> Hit:
    """Capped-query contract (see ops/packets.trace_packets ``t_cap``):
    hits with t >= cap report as the canonical miss (MAX_FLOAT, -1). Used
    to give the fine/brute engines the identical semantics the packet
    engine implements natively via its fold-init cap."""
    beyond = hit.t >= jnp.asarray(t_cap, jnp.float32)
    return Hit(tri=jnp.where(beyond, -1, hit.tri),
               t=jnp.where(beyond, MAX_FLOAT, hit.t))


def trace_spheres(o: Vec3, d: Vec3, scene, t_best, id_best, mask=None):
    """Fold the sphere block into a hit result: sphere s reports hit id
    = num_tris + s. Brute force over S spheres (S is small; the reference's
    sphere.h primitive, revived as a first-class capability).

    Spheres win only on strictly smaller t (triangles keep exact ties)."""
    S = scene.num_spheres
    if S == 0:
        return Hit(tri=id_best, t=t_best)
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    o_b = Vec3(o.x[:, None], o.y[:, None], o.z[:, None])
    d_b = Vec3(d.x[:, None], d.y[:, None], d.z[:, None])
    c = Vec3(
        scene.sph_center.x[None, :],
        scene.sph_center.y[None, :],
        scene.sph_center.z[None, :],
    )
    sph = jax.lax.stop_gradient((c, scene.sph_radius))
    ts = ray_sphere(o_b, d_b, sph[0], sph[1][None, :])  # (R, S)
    j = jnp.argmin(ts, axis=1)
    t_new = jnp.min(ts, axis=1)
    upd = t_new < t_best
    if mask is not None:
        upd = upd & mask
    T = scene.num_tris
    return Hit(
        tri=jnp.where(upd, (T + j).astype(jnp.int32), id_best),
        t=jnp.where(upd, t_new, t_best),
    )
