"""Packet (ray-tile) traversal: closest-hit over ray tiles and triangle
clusters, in plain XLA.

The reference walks a BVH per CUDA thread with its own stack
(kernel.cu:112-161). This engine restructures the search into dense,
gather-light array work instead:

1. Rays are processed in **tiles** of P consecutive rays (already coherent:
   the renderer issues rays in Morton pixel order, camera.h:57-75 analogue).
2. The scene is cut into **clusters** — the leaves of a coarse SAH BVH
   (accel/bvh.py with leaf_size = C), each holding up to C triangles stored
   contiguously.
3. Per tile, a conservative **frustum-vs-AABB interval test** (elementwise
   math, no gathers) selects candidate clusters and their conservative
   entry distances.
4. The M nearest candidates per tile form a fixed-size **shortlist**
   (``lax.top_k``); each slot is then intersected densely — all P rays
   against all C triangles of the cluster, one contiguous block load and a
   (P, C) triangle sweep per slot.
5. **Correctness is unconditional**: every tile also computes U = the
   smallest conservative entry distance among *dropped* candidates. A ray
   whose best hit satisfies ``t <= U`` provably cannot be beaten by a
   dropped cluster. The rare rays with ``t > U`` (shortlist overflow) are
   re-traced through the fine per-ray BVH (ops/traversal.py) under a mask.
6. **Straggler splitting** (``rounds > 1``): a tile runs to its slowest
   lane, yet most rays resolve within the first couple of entry-sorted
   candidates. Early rounds cap every tile at a tiny candidate budget and
   reuse the U bound to identify unresolved rays, which re-sort and
   compact into far fewer live tiles for the next round.

Results are bit-identical to the brute-force oracle (tests/test_packets.py):
each (ray, triangle) test computes the same f32 value as
``trace_bruteforce``, and the closest-fold uses the same deterministic
lower-index tie-break (ops/traversal._closest_update).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.constants import MAX_FLOAT
from .intersect import bw_precompute, ray_triangle, ray_triangle_bw
from .traversal import Hit, TraceData, _closest_update, trace
from .vecmath import Vec3, gather


class PacketData(NamedTuple):
    """Cluster-level scene layout for packet traversal (a JAX pytree).

    cl_lo / cl_hi: (K,) cluster AABBs (SoA).
    v0 / e1 / e2:  (K+1, C) pre-packed triangle blocks; row K is an all-
                   degenerate sentinel so shortlist padding is harmless.
    tri:           (K+1, C) i32 scene triangle ids; pad slots hold T.
    num_tris:      () i32.
    """

    cl_lo: Vec3
    cl_hi: Vec3
    v0: Vec3
    e1: Vec3
    e2: Vec3
    tri: jnp.ndarray
    num_tris: jnp.ndarray

    @property
    def num_clusters(self):
        return self.cl_lo.x.shape[0]

    @property
    def cluster_size(self):
        return self.tri.shape[1]


def make_packet_data(scene, cl_lo: Vec3, cl_hi: Vec3, cl_tri) -> PacketData:
    """Pack cluster triangle blocks from the scene's vertex SoA.

    ``cl_tri``: (K, C) i32 triangle ids per cluster, padded with T (the
    leaf_tri layout of a coarse FlatBVH). Runs under jit — pure gathers, so
    vertex updates (differentiable pass) flow into the packed blocks exactly
    as in traversal.make_trace_data.
    """
    T = scene.num_tris
    C = cl_tri.shape[1]
    cl_tri = jnp.asarray(cl_tri, jnp.int32)
    tri = jnp.concatenate(
        [cl_tri, jnp.full((1, C), T, jnp.int32)], axis=0
    )  # sentinel row K

    # Sentinel vertex index T -> vertex 0 for all corners -> degenerate.
    pad = jnp.zeros((1,), jnp.int32)
    v0i = jnp.concatenate([scene.tri_v0, pad])
    v1i = jnp.concatenate([scene.tri_v1, pad])
    v2i = jnp.concatenate([scene.tri_v2, pad])
    i0 = jnp.take(v0i, tri, mode="clip")
    i1 = jnp.take(v1i, tri, mode="clip")
    i2 = jnp.take(v2i, tri, mode="clip")
    v0 = gather(scene.verts, i0)
    v1 = gather(scene.verts, i1)
    v2 = gather(scene.verts, i2)
    z = jnp.where(tri >= T, 0.0, 1.0)  # zero pad slots entirely
    v0 = v0 * z
    v1 = v1 * z
    v2 = v2 * z
    return PacketData(
        cl_lo=cl_lo,
        cl_hi=cl_hi,
        v0=v0,
        e1=v1 - v0,
        e2=v2 - v0,
        tri=tri,
        num_tris=jnp.asarray(T, jnp.int32),
    )


def _axis_interval(ol, oh, dl, dh, bl, bh):
    """Conservative per-axis [tmin, tmax] hull over the tile's origin
    interval [ol, oh] and direction interval [dl, dh] against slab [bl, bh].

    Interval arithmetic: the hull of all endpoint quotients covers every
    (o, d) in the tile when the direction interval is sign-pure; a
    mixed-sign interval gets (-inf, +inf) (fully conservative)."""
    mixed = (dl <= 0.0) & (dh >= 0.0)
    tiny = jnp.float32(1e-30)
    dls = jnp.where(jnp.abs(dl) < tiny, jnp.where(dl < 0, -tiny, tiny), dl)
    dhs = jnp.where(jnp.abs(dh) < tiny, jnp.where(dh < 0, -tiny, tiny), dh)

    n0 = bl - ol
    n1 = bl - oh
    n2 = bh - ol
    n3 = bh - oh
    qs = [n / s for n in (n0, n1, n2, n3) for s in (dls, dhs)]
    tmin = qs[0]
    tmax = qs[0]
    for q in qs[1:]:
        tmin = jnp.minimum(tmin, q)
        tmax = jnp.maximum(tmax, q)
    inf = jnp.float32(jnp.inf)
    tmin = jnp.where(mixed, -inf, tmin)
    tmax = jnp.where(mixed, inf, tmax)
    return tmin, tmax


def tile_cull(olo: Vec3, ohi: Vec3, dlo: Vec3, dhi: Vec3,
              cl_lo: Vec3, cl_hi: Vec3):
    """Frustum-vs-AABB candidates. Tile bounds are (Tl, 1) SoA, clusters
    (1, K). Returns (hit (Tl, K) bool, entry (Tl, K) f32 >= 0)."""
    tx0, tx1 = _axis_interval(olo.x, ohi.x, dlo.x, dhi.x, cl_lo.x, cl_hi.x)
    ty0, ty1 = _axis_interval(olo.y, ohi.y, dlo.y, dhi.y, cl_lo.y, cl_hi.y)
    tz0, tz1 = _axis_interval(olo.z, ohi.z, dlo.z, dhi.z, cl_lo.z, cl_hi.z)
    tmin = jnp.maximum(jnp.maximum(tx0, ty0), tz0)
    tmax = jnp.minimum(jnp.minimum(tx1, ty1), tz1)
    hit = (tmin <= tmax) & (tmax >= 0.0)
    entry = jnp.maximum(tmin, 0.0)
    return hit, entry


def _part1by2(x):
    """Spread the low 7 bits of x so consecutive bits are 3 apart."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def ray_sort_keys(o: Vec3, d: Vec3, mask, lo: Vec3, hi: Vec3):
    """Coherence keys: direction octant (major) then 21-bit Morton code of
    the origin within the scene bounds. Masked lanes get the max key so
    they compact into all-masked tiles at the end (which cost nothing).

    Sorting a bounce/shadow batch by this key is what keeps the per-tile
    direction and origin intervals tight: an unsorted diffuse-bounce tile
    spans the full hemisphere and its frustum covers most of the scene.
    """
    oct_ = (
        (d.x < 0).astype(jnp.int32) * 4
        + (d.y < 0).astype(jnp.int32) * 2
        + (d.z < 0).astype(jnp.int32)
    )
    # 2 more direction bits: dominant axis within the octant — tightens the
    # per-tile direction cone from a full octant to roughly a third of one
    ax, ay, az = jnp.abs(d.x), jnp.abs(d.y), jnp.abs(d.z)
    major = jnp.where(
        (ax >= ay) & (ax >= az), 0, jnp.where(ay >= az, 1, 2)
    ).astype(jnp.int32)

    def q(v, l, h):
        ext = jnp.maximum(h - l, 1e-20)
        cell = jnp.clip((v - l) / ext * 127.0, 0.0, 127.0)
        return cell.astype(jnp.int32)

    mx = _part1by2(q(o.x, lo.x, hi.x))
    my = _part1by2(q(o.y, lo.y, hi.y))
    mz = _part1by2(q(o.z, lo.z, hi.z))
    morton = (mx << 2) | (my << 1) | mz
    key = (oct_ << 23) | (major << 21) | morton
    return jnp.where(mask, key, jnp.int32(0x7FFFFFFF))


def trace_packets(o: Vec3, d: Vec3, pd: PacketData,
                  fine_td: TraceData | None = None, walk=None, mask=None,
                  tile_size: int = 128, max_clusters: int = 32,
                  sort: bool = False,
                  rounds: int = 1, first_round_slots: int = 3,
                  sort_window: int = 0,
                  two_level: bool | None = None,
                  super_factor: int = 8, super_slots: int = 16,
                  t_cap=None, intersector: str = "bw",
                  _need_out: bool = False):
    """Closest-hit for R rays via tile-packet traversal.

    Semantics identical to ``traversal.trace`` / ``trace_bruteforce``:
    closest triangle with 0 < t, MAX_FLOAT/-1 on miss, exact-t ties to the
    lower triangle index. ``fine_td`` enables the overflow fallback; without
    it, results are exact only when no tile drops a candidate cluster (the
    caller must then size ``max_clusters`` >= the worst-case candidate
    count — fine for tests, not recommended in production). ``walk``: the
    per-ray walk the fallback runs, walk(o, d, td, mask=, intersector=)
    -> Hit; None = ``traversal.trace`` (the renderer passes the CUDA
    kernel on a GPU).

    ``two_level``: False = flat cull; True = two-level cull (supercluster
    shortlist + member expansion under a slot cap of ``super_slots``
    supers of ``super_factor`` clusters each); None = auto (flat up to
    2048 clusters).

    ``t_cap``: optional (R,) f32 per-ray search cap. Hits with t >= cap are
    reported as a MISS (MAX_FLOAT/-1); hits below it are exact. For
    visibility-style queries (BDPT shadow connections: the decision is
    |t - len| <= eps, kernel.cu:402-405) a cap of len + 2*eps yields the
    identical decision while skipping the fine-BVH fallback for rays whose
    dropped candidates all lie beyond it.

    ``intersector``: 'bw' (Baldwin-Weber precomputed form, the default) or
    'mt' (the reference's Moller-Trumbore, modelLoader.h:49-123). Both are
    decision-equivalent in exact arithmetic (intersect.ray_triangle_bw);
    the engine and its fallback run the selected one so results stay
    engine-independent.
    """
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    pd = jax.lax.stop_gradient(pd)

    if rounds > 1:
        # Straggler splitting: most rays resolve within the first few
        # entry-sorted candidates, but a tile runs to its SLOWEST lane.
        # Early rounds cap every tile at a small candidate budget
        # (first_round_slots, growing 4x per round); rays whose best hit
        # exceeds the dropped-candidate bound carry into the next round,
        # where sorting compacts them into far fewer live tiles. The final
        # round runs the full shortlist (plus the fine-BVH fallback).
        #
        # The dense fold costs per TILE x SLOT regardless of how many
        # lanes are live, so each round re-sorts to COMPACT the stragglers
        # into fewer tiles rather than re-running them in place.
        m_cur = mask if mask is not None else jnp.ones((o.x.shape[0],), bool)
        acc_t = jnp.full((o.x.shape[0],), MAX_FLOAT, jnp.float32)
        acc_tri = jnp.full((o.x.shape[0],), -1, jnp.int32)
        budget = int(first_round_slots)
        for _ in range(rounds - 1):
            hi, need = trace_packets(
                o, d, pd, fine_td=None, mask=m_cur, tile_size=tile_size,
                max_clusters=min(budget, int(max_clusters)),
                sort=sort, rounds=1,
                sort_window=sort_window, two_level=two_level,
                super_factor=super_factor, super_slots=super_slots,
                t_cap=t_cap, intersector=intersector,
                _need_out=True,
            )
            done = m_cur & jnp.logical_not(need)
            acc_t = jnp.where(done, hi.t, acc_t)
            acc_tri = jnp.where(done, hi.tri, acc_tri)
            m_cur = need
            budget *= 4
        hf = trace_packets(
            o, d, pd, fine_td=fine_td, walk=walk, mask=m_cur,
            tile_size=tile_size,
            max_clusters=max_clusters, sort=sort, rounds=1,
            sort_window=sort_window, two_level=two_level,
            super_factor=super_factor, super_slots=super_slots,
            t_cap=t_cap, intersector=intersector,
        )
        return Hit(
            tri=jnp.where(m_cur, hf.tri, acc_tri),
            t=jnp.where(m_cur, hf.t, acc_t),
        )

    R = o.x.shape[0]
    P = int(tile_size)
    K = pd.num_clusters
    C = pd.cluster_size
    Rp = -(-R // P) * P
    Tl = Rp // P

    if mask is None:
        mask = jnp.ones((R,), bool)

    if sort:
        # Group incoherent rays (diffuse bounces, connections) into coherent
        # tiles. The permutation is applied by carrying every per-ray column
        # as a PAYLOAD OPERAND of one multi-operand ``lax.sort``. The
        # original lane index travels as one more payload; the results are
        # scattered back to it afterwards (no inverse permutation, no
        # gathers — tri ids stay int operands end to end).
        lo = Vec3(pd.cl_lo.x.min(), pd.cl_lo.y.min(), pd.cl_lo.z.min())
        hi = Vec3(pd.cl_hi.x.max(), pd.cl_hi.y.max(), pd.cl_hi.z.max())
        key = ray_sort_keys(o, d, mask, lo, hi)
        # every payload column costs sort bandwidth, so the mask does not
        # travel as a column: real keys are clamped one below the masked
        # sentinel (merging two grouping buckets — ordering is irrelevant
        # to exactness) and the mask is recovered from the sorted key. The per-ray cap column
        # only rides when the caller actually passed one.
        key = jnp.where(mask, jnp.minimum(key, 0x7FFFFFFE), key)
        iota = jnp.arange(R, dtype=jnp.int32)
        cols = (key, iota, o.x, o.y, o.z, d.x, d.y, d.z)
        if t_cap is not None:
            cols = cols + (jnp.broadcast_to(
                jnp.asarray(t_cap, jnp.float32), o.x.shape),)

        W = int(sort_window)
        windowed = W > 0 and W % P == 0 and R > W
        if windowed:
            # WINDOWED sort: sort independent windows of W rays instead of
            # all R at once. Sorting cost is superlinear in length and tile
            # grouping only needs LOCAL coherence — rays that land in the
            # same P-tile must be similar, but the order of tiles is
            # irrelevant. The input is in pixel-Morton order, so a window
            # covers a compact screen region whose bounce rays already
            # share origin locality; sorting within it captures almost all
            # of the key's tile-tightening power at a fraction of the sort
            # cost. Results are bit-identical to the global sort: every
            # (ray, triangle) test computes the same f32 everywhere, and
            # the U-bound/fallback makes the hit exact under ANY grouping.
            Rw = -(-R // W) * W
            if Rw != R:
                # pad lanes: masked (max key), unit direction.
                # The index payload pads with R..Rw-1 (NOT a constant): the
                # un-sort scatters to it, so pad results land past every
                # real lane and are sliced off.
                pads = (0x7FFFFFFF, None, 0.0, 0.0, 0.0, 1.0, 1.0, 1.0,
                        0.0)[:len(cols)]
                cols = tuple(
                    jnp.concatenate([
                        c,
                        jnp.arange(R, Rw, dtype=jnp.int32) if p is None
                        else jnp.full((Rw - R,), p, c.dtype),
                    ])
                    for c, p in zip(cols, pads)
                )
            NW = Rw // W
            cols = jax.lax.sort(
                tuple(c.reshape(NW, W) for c in cols),
                dimension=1, num_keys=1, is_stable=False,
            )
            cols = tuple(c.reshape(Rw) for c in cols)
        else:
            cols = jax.lax.sort(cols, num_keys=1, is_stable=False)
        (skey, sidx, sox, soy, soz, sdx, sdy, sdz) = cols[:8]
        scap = cols[8] if t_cap is not None else None
        smask = skey < 0x7FFFFFFF  # masked lanes carry the sentinel key

        out = trace_packets(
            Vec3(sox, soy, soz), Vec3(sdx, sdy, sdz),
            pd, fine_td=fine_td, walk=walk, mask=smask,
            tile_size=tile_size, max_clusters=max_clusters,
            sort=False, two_level=two_level,
            super_factor=super_factor, super_slots=super_slots,
            t_cap=scap, intersector=intersector, _need_out=_need_out,
        )
        hit, need = out if _need_out else (out, None)
        # un-sort: scatter each result back to its carried original lane
        # index (a permutation, so every slot is written once). Windowed:
        # the pad lanes carry indices R..Rw-1 and are sliced off.
        def unsort(v):
            out = jnp.zeros(sidx.shape, v.dtype)
            return out.at[sidx].set(v, unique_indices=True)[:R]

        hit = Hit(tri=unsort(hit.tri), t=unsort(hit.t))
        if _need_out:
            return hit, unsort(need)
        return hit

    def padv(a, fill):
        if Rp == R:
            return a
        return jnp.concatenate(
            [a, jnp.full((Rp - R,), fill, a.dtype)]
        )

    ox = padv(o.x, 0.0).reshape(Tl, P)
    oy = padv(o.y, 0.0).reshape(Tl, P)
    oz = padv(o.z, 0.0).reshape(Tl, P)
    dx = padv(d.x, 1.0).reshape(Tl, P)
    dy = padv(d.y, 1.0).reshape(Tl, P)
    dz = padv(d.z, 1.0).reshape(Tl, P)
    m = padv(mask, False).reshape(Tl, P)

    # ---- tile bounds (masked lanes excluded) ------------------------------
    # one stacked (Tl, 6, P) reduction pair instead of 12 separate
    # (Tl, P) reduces
    arr = jnp.stack([ox, oy, oz, dx, dy, dz], axis=1)  # (Tl, 6, P)
    m3 = m[:, None, :]
    inf_ = jnp.float32(jnp.inf)
    mins = jnp.min(jnp.where(m3, arr, inf_), axis=2, keepdims=True)
    maxs = jnp.max(jnp.where(m3, arr, -inf_), axis=2, keepdims=True)
    olo = Vec3(mins[:, 0], mins[:, 1], mins[:, 2])
    ohi = Vec3(maxs[:, 0], maxs[:, 1], maxs[:, 2])
    dlo = Vec3(mins[:, 3], mins[:, 4], mins[:, 5])
    dhi = Vec3(maxs[:, 3], maxs[:, 4], maxs[:, 5])

    any_lane = jnp.any(m, axis=1, keepdims=True)
    inf = jnp.float32(jnp.inf)

    F = int(super_factor)
    Ms = min(int(super_slots), -(-K // F))

    if two_level is None:
        # auto: the flat (Tl, K) cull up to K = 2048 clusters; past that
        # the two-level cull keeps the (Tl, K) arrays from growing with
        # the scene (its expansion cap may drop close members, which costs
        # fine-BVH fallback work, never correctness)
        two_level = K > 2048

    if two_level and K > F:
        # ---- level 1: supercluster cull -------------------------------
        # Superclusters = F preorder-consecutive clusters (spatial
        # neighbors by construction of the flat BVH), boxes merged on the
        # fly (cheap: one (S, F) min/max reduce per axis per call).
        S = -(-K // F)
        KP = S * F

        def padc(a, fill):
            if KP == K:
                return a
            return jnp.concatenate([a, jnp.full((KP - K,), fill, a.dtype)])

        # pad with inverted boxes: min over +inf / max over -inf is
        # identity, and the padded CLUSTER slots cull to entry = inf below
        clx0 = padc(pd.cl_lo.x, inf)
        cly0 = padc(pd.cl_lo.y, inf)
        clz0 = padc(pd.cl_lo.z, inf)
        clx1 = padc(pd.cl_hi.x, -inf)
        cly1 = padc(pd.cl_hi.y, -inf)
        clz1 = padc(pd.cl_hi.z, -inf)
        sup_lo = Vec3(clx0.reshape(S, F).min(1), cly0.reshape(S, F).min(1),
                      clz0.reshape(S, F).min(1))
        sup_hi = Vec3(clx1.reshape(S, F).max(1), cly1.reshape(S, F).max(1),
                      clz1.reshape(S, F).max(1))
        hit_s, entry_s = tile_cull(
            olo, ohi, dlo, dhi,
            Vec3(sup_lo.x[None, :], sup_lo.y[None, :], sup_lo.z[None, :]),
            Vec3(sup_hi.x[None, :], sup_hi.y[None, :], sup_hi.z[None, :]),
        )  # (Tl, S)
        entry_s = jnp.where(hit_s & any_lane, entry_s, inf)
        if S > Ms:
            negs, sup_ids = jax.lax.top_k(-entry_s, Ms + 1)
            # a dropped super's entry lower-bounds every member cluster's
            # (its box contains theirs) — fold it into the U bound
            U_s = -negs[:, Ms]
            sup_ids = sup_ids[:, :Ms]
            sup_ok = -negs[:, :Ms] < inf
        else:
            negs, sup_ids = jax.lax.top_k(-entry_s, Ms)
            U_s = jnp.full((Tl,), inf)
            sup_ok = -negs < inf

        # ---- expand members + level 2: cluster cull -------------------
        # Member boxes travel as (S, 6, F) ROW blocks — one row gather per
        # tile-slot instead of Tl*Ms*F scalar gathers.
        box_rows = jnp.stack(
            [clx0, cly0, clz0, clx1, cly1, clz1], axis=0
        ).reshape(6, S, F).transpose(1, 0, 2)          # (S, 6, F)
        cand = jnp.take(box_rows, sup_ids, axis=0)     # (Tl, Ms, 6, F)
        cand = cand.reshape(Tl, Ms, 6, F)
        bl = Vec3(cand[:, :, 0].reshape(Tl, Ms * F),
                  cand[:, :, 1].reshape(Tl, Ms * F),
                  cand[:, :, 2].reshape(Tl, Ms * F))
        bh = Vec3(cand[:, :, 3].reshape(Tl, Ms * F),
                  cand[:, :, 4].reshape(Tl, Ms * F),
                  cand[:, :, 5].reshape(Tl, Ms * F))
        cl_ids = (sup_ids[:, :, None] * F
                  + jnp.arange(F, dtype=jnp.int32)[None, None, :]
                  ).reshape(Tl, Ms * F)                # (Tl, Ms*F)
        hit2, entry2 = tile_cull(olo, ohi, dlo, dhi, bl, bh)
        valid2 = (hit2 & any_lane & (cl_ids < K)
                  & jnp.repeat(sup_ok, F, axis=1))
        entry = jnp.where(valid2, entry2, inf)         # (Tl, Ms*F)

        M = min(int(max_clusters), Ms * F)
        if Ms * F > M:
            negv, idxs = jax.lax.top_k(-entry, M + 1)
            U = jnp.minimum(U_s, -negv[:, M])
            negv = negv[:, :M]
            idxs = idxs[:, :M]
        else:
            negv, idxs = jax.lax.top_k(-entry, M)
            U = U_s
        entries = -negv
        slot_ok = entries < inf
        ids = jnp.where(
            slot_ok, jnp.take_along_axis(cl_ids, idxs, axis=1), K
        ).astype(jnp.int32)                            # K = sentinel row
    else:
        cl_lo = Vec3(pd.cl_lo.x[None, :], pd.cl_lo.y[None, :],
                     pd.cl_lo.z[None, :])
        cl_hi = Vec3(pd.cl_hi.x[None, :], pd.cl_hi.y[None, :],
                     pd.cl_hi.z[None, :])

        hit, entry = tile_cull(olo, ohi, dlo, dhi, cl_lo, cl_hi)  # (Tl, K)
        entry = jnp.where(hit & any_lane, entry, inf)

        # ---- shortlist: M nearest candidates (entry-ascending) + dropped-
        # candidate bound U --------------------------------------------------
        M = min(int(max_clusters), K)
        if K > M:
            negv, idxs = jax.lax.top_k(-entry, M + 1)
            U = -negv[:, M]       # min entry among dropped candidates
            negv = negv[:, :M]
            idxs = idxs[:, :M]
        else:
            negv, idxs = jax.lax.top_k(-entry, M)
            U = jnp.full((Tl,), inf)
        entries = -negv           # ascending (top_k of -entry)
        slot_ok = entries < inf
        ids = jnp.where(slot_ok, idxs, K).astype(jnp.int32)  # K = sentinel

    # ---- dense per-slot intersection --------------------------------------
    T = pd.num_tris

    o_b = Vec3(ox[:, :, None], oy[:, :, None], oz[:, :, None])
    d_b = Vec3(dx[:, :, None], dy[:, :, None], dz[:, :, None])

    if intersector == "bw":
        # one-time (K+1, C) precompute; the slot scan then gathers the
        # cheap precomputed rows (intersect.bw_precompute, the one source
        # of the formula)
        p_n, p_m1, p_m2 = bw_precompute(pd.e1, pd.e2)

    def slot(carry, sid):  # sid: (Tl,)
        t_best, tri_best = carry  # (Tl, P)
        tids = jnp.take(pd.tri, sid, axis=0)  # (Tl, C)

        def mid(v):
            g = gather(v, sid)    # (Tl, C)
            return Vec3(g.x[:, None, :], g.y[:, None, :], g.z[:, None, :])

        if intersector == "bw":
            ts = ray_triangle_bw(o_b, d_b, mid(pd.v0),
                                 mid(p_n), mid(p_m1), mid(p_m2))
        else:
            ts = ray_triangle(o_b, d_b, mid(pd.v0), mid(pd.e1), mid(pd.e2))
        # ts: (Tl, P, C)
        valid = (
            (tids[:, None, :] < T)
            & (ts > 0.0)
            & (ts <= t_best[:, :, None])
            & m[:, :, None]
        )
        ts = jnp.where(valid, ts, MAX_FLOAT)
        tids_b = jnp.broadcast_to(tids[:, None, :], ts.shape)
        t_new, tri_new = _closest_update(
            ts.reshape(-1, C), tids_b.reshape(-1, C),
            t_best.reshape(-1), tri_best.reshape(-1),
        )
        return (t_new.reshape(Tl, P), tri_new.reshape(Tl, P)), None

    init = (
        jnp.full((Tl, P), MAX_FLOAT, jnp.float32),
        jnp.full((Tl, P), -1, jnp.int32),
    )
    (t_best, tri_best), _ = jax.lax.scan(slot, init, ids.T)
    return _finish(o, d, t_best, tri_best, mask, U, fine_td, walk, R, Tl, P,
                   t_cap=t_cap, intersector=intersector,
                   need_out=_need_out)


def _finish(o, d, t_best, tri_best, mask, U, fine_td, walk, R, Tl, P,
            t_cap=None, intersector: str = "bw", need_out: bool = False):
    """Trim padding, apply the lane mask, the t-cap, and the fallback.

    ``need_out=True`` skips the fallback and instead returns the mask of
    rays whose result could still be beaten by a dropped candidate (the
    multi-round splitting in trace_packets re-traces exactly those)."""
    t_flat = t_best.reshape(-1)[:R]
    tri_flat = tri_best.reshape(-1)[:R]
    t_flat = jnp.where(mask, t_flat, MAX_FLOAT)
    tri_flat = jnp.where(mask, tri_flat, -1)
    u_ray = jnp.broadcast_to(U[:, None], (Tl, P)).reshape(-1)[:R]
    # >= (not >): when the best hit t EQUALS a dropped cluster's conservative
    # entry, an equal-t triangle with a lower index could live in that
    # cluster, and the lower-index tie-break contract requires checking it.
    # With a caller t_cap the comparison uses min(t, cap): dropped clusters
    # whose entry is at/beyond the cap can only hold hits the capped query
    # reports as miss anyway — no fallback needed for those rays.
    t_eff = t_flat if t_cap is None else \
        jnp.minimum(t_flat, jnp.asarray(t_cap, jnp.float32))
    need_fb = mask & (t_eff >= u_ray)

    def _apply_cap(t_f, tri_f):
        if t_cap is None:
            return t_f, tri_f
        beyond = t_f >= jnp.asarray(t_cap, jnp.float32)
        return (jnp.where(beyond, MAX_FLOAT, t_f),
                jnp.where(beyond, -1, tri_f))

    if need_out:
        t_flat, tri_flat = _apply_cap(t_flat, tri_flat)
        return Hit(tri=tri_flat, t=t_flat), need_fb

    # ---- overflow fallback (unconditional correctness) ---------------------
    if fine_td is not None:
        if walk is None:
            fb = trace(o, d, fine_td, mask=need_fb, intersector=intersector)
        else:
            fb = walk(o, d, fine_td, mask=need_fb, intersector=intersector)
        t_flat = jnp.where(need_fb, fb.t, t_flat)
        tri_flat = jnp.where(need_fb, fb.tri, tri_flat)

    t_flat, tri_flat = _apply_cap(t_flat, tri_flat)
    return Hit(tri=tri_flat, t=t_flat)
