"""Binned-SAH BVH build + threaded (skip-link) flat encoding.

Build (host side, NumPy; a C++ twin lives in native/bvh_builder.cpp):
replicates the reference algorithm (BVH.h:133-328) — top-down recursion,
leaf-centroid binning into a 3x3x3 grid (gridDim=3, BVH.h:166), all
3 axes x 3 slice planes scored with the binned SAH
``countL*areaL/areaTotal + countR*areaR/areaTotal`` (BVH.h:246-248),
centroid-cell partitioning (BVH.h:295-313) and an arbitrary-halving fallback
for degenerate splits (BVH.h:263-288). The reference's grid-fill bug
(``nodes[i].box`` instead of ``nodes[workingList[i]].box``, BVH.h:190) is
FIXED here (SURVEY.md §7 quirks ledger: build quality only, not
correctness). Unlike the reference's one-triangle leaves (BVH.h:451-462) we
support multi-triangle leaves (``leaf_size``), which turns leaf intersection
into fixed-shape vector work.

Encoding: the reference flattens to a breadth-first array of
``{box, left, right}`` with bit-31 leaf flags and traverses with a
per-thread stack (BVH.h:331-382, kernel.cu:112-161). A per-lane stack is
the antithesis of a vector machine, so our flat layout is a *threaded*
(skip-link) DFS encoding: nodes in preorder; an interior node hit continues
to ``i+1`` (its first child), a miss jumps to ``skip[i]`` (the next subtree
in preorder); leaves intersect their triangle block then jump to ``skip[i]``.
Per-ray traversal state collapses to a single int32 cursor — uniform control
flow, no stacks, no divergence beyond early lane exit. Triangles are
permuted so each leaf's block is contiguous and padded to exactly
``leaf_size`` with a sentinel (degenerate) slot.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from ..utils.constants import MAX_BVH_DEPTH


GRID_DIM = 3  # reference gridDim (BVH.h:166); metricsForSponza.txt:14-20
# records 3 as the best split count of {2..7}.


# ---------------------------------------------------------------------------
# host-side build tree
# ---------------------------------------------------------------------------

@dataclass
class _Node:
    lo: np.ndarray
    hi: np.ndarray
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None
    tri_ids: Optional[np.ndarray] = None  # leaf payload
    depth: int = 1

    @property
    def is_leaf(self):
        return self.tri_ids is not None


def _surface(lo, hi):
    d = hi - lo
    return 2.0 * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2])


def _union_bounds(lo, hi):
    return lo.min(axis=0), hi.max(axis=0)


def _build_recurse(lo, hi, centers, ids, leaf_size):
    """lo/hi/centers: (n,3) leaf boxes + centroids for tri ids (n,)."""
    n = ids.shape[0]
    if n <= leaf_size:
        blo, bhi = _union_bounds(lo, hi)
        return _Node(blo, bhi, tri_ids=ids, depth=1)

    blo, bhi = _union_bounds(lo, hi)
    # double-precision SAH throughout (matches native/bvh_builder.cpp and
    # the reference's double score, BVH.h:196)
    total_w = _surface(blo.astype(np.float64), bhi.astype(np.float64))

    # Bin centroids into the 3x3x3 grid (BVH.h:181-192, with the wrong-box
    # bug fixed: bins union the *working set's* boxes).
    dim_units = (bhi - blo) / GRID_DIM
    safe_units = np.where(dim_units == 0, 1.0, dim_units)
    cell = ((centers - blo) / safe_units).astype(np.int64)
    cell = np.clip(cell, 0, GRID_DIM - 1)

    # Per-cell counts and union boxes.
    flat = (cell[:, 0] * GRID_DIM + cell[:, 1]) * GRID_DIM + cell[:, 2]
    counts = np.bincount(flat, minlength=GRID_DIM**3).reshape(
        GRID_DIM, GRID_DIM, GRID_DIM
    )
    INF = np.inf
    glo = np.full((GRID_DIM**3, 3), INF)
    ghi = np.full((GRID_DIM**3, 3), -INF)
    np.minimum.at(glo, flat, lo)
    np.maximum.at(ghi, flat, hi)
    glo = glo.reshape(GRID_DIM, GRID_DIM, GRID_DIM, 3)
    ghi = ghi.reshape(GRID_DIM, GRID_DIM, GRID_DIM, 3)

    best = None  # (score, axis, slice, countL, countR)
    for axis in range(3):
        for sl in range(GRID_DIM):
            sel_l = [slice(None)] * 3
            sel_l[axis] = slice(0, sl)
            sel_r = [slice(None)] * 3
            sel_r[axis] = slice(sl, GRID_DIM)
            cl = int(counts[tuple(sel_l)].sum())
            cr = int(counts[tuple(sel_r)].sum())

            def side_weight(sel, cnt):
                if cnt == 0:
                    # reference: makeNegative() box has weight of the
                    # inverted sentinel box; empty side contributes
                    # cnt * w = 0 regardless, so the weight value is moot.
                    return 0.0
                m = counts[tuple(sel)].reshape(-1) > 0
                slo = glo[tuple(sel)].reshape(-1, 3)[m].min(axis=0)
                shi = ghi[tuple(sel)].reshape(-1, 3)[m].max(axis=0)
                return _surface(slo, shi)

            wl = side_weight(sel_l, cl)
            wr = side_weight(sel_r, cr)
            # double-precision score, exactly like the native twin
            # (native/bvh_builder.cpp) and the reference (BVH.h:196,246-248
            # uses double) — float32 here would tie-break differently and
            # produce a structurally different (equally valid) tree.
            score = (
                float(cl) * float(wl) / float(total_w)
                + float(cr) * float(wr) / float(total_w)
            )
            if best is None or score < best[0]:
                best = (score, axis, sl, cl, cr)

    _, axis, sl, cl, cr = best
    if cl == 0 or cr == 0:
        # Degenerate split: arbitrary halving (BVH.h:263-288).
        half = n // 2
        left_sel = np.zeros(n, bool)
        left_sel[:half] = True
    else:
        left_sel = cell[:, axis] < sl

    ln = _build_recurse(
        lo[left_sel], hi[left_sel], centers[left_sel], ids[left_sel], leaf_size
    )
    rn = _build_recurse(
        lo[~left_sel], hi[~left_sel], centers[~left_sel], ids[~left_sel], leaf_size
    )
    return _Node(blo, bhi, left=ln, right=rn, depth=max(ln.depth, rn.depth) + 1)


# ---------------------------------------------------------------------------
# flat threaded encoding (device layout)
# ---------------------------------------------------------------------------

class FlatBVH(NamedTuple):
    """Threaded flat BVH, a JAX pytree. N nodes in DFS preorder.

    node_lo_{x,y,z} / node_hi_{x,y,z}: (N,) f32 box planes (SoA — see
    ops/vecmath.py for why not (N, 3)).
    node_skip: (N,) i32 — next preorder node when this subtree is done/missed
    (sentinel N = traversal complete).
    node_leaf: (N,) i32 — leaf id, or -1 for interior nodes.
    leaf_tri:  (NL, L) i32 — scene triangle ids per leaf, padded with T
    (a sentinel that gathers a degenerate triangle; see traversal).
    """

    node_lo_x: jnp.ndarray
    node_lo_y: jnp.ndarray
    node_lo_z: jnp.ndarray
    node_hi_x: jnp.ndarray
    node_hi_y: jnp.ndarray
    node_hi_z: jnp.ndarray
    node_skip: jnp.ndarray
    node_leaf: jnp.ndarray
    leaf_tri: jnp.ndarray

    @property
    def num_nodes(self):
        return self.node_skip.shape[0]

    @property
    def num_leaves(self):
        return self.leaf_tri.shape[0]

    @property
    def leaf_size(self):
        return self.leaf_tri.shape[1]


class BVHMeta(NamedTuple):
    """Static (host) metadata kept out of the pytree."""

    depth: int
    num_tris: int


class Accel(NamedTuple):
    """Full acceleration bundle (a JAX pytree): the fine per-ray BVH plus
    the coarse cluster level consumed by packet traversal (ops/packets.py).

    The cluster level is simply the leaves of a second SAH build with
    ``leaf_size = cluster_size``: cl_lo/cl_hi are the (K,) leaf boxes in
    leaf-id order and cl_tri the (K, C) contiguous triangle blocks."""

    fine: "FlatBVH"
    cl_lo_x: jnp.ndarray
    cl_lo_y: jnp.ndarray
    cl_lo_z: jnp.ndarray
    cl_hi_x: jnp.ndarray
    cl_hi_y: jnp.ndarray
    cl_hi_z: jnp.ndarray
    cl_tri: jnp.ndarray


def as_fine(bvh) -> "FlatBVH":
    """Accept either an Accel bundle or a bare FlatBVH."""
    return bvh.fine if isinstance(bvh, Accel) else bvh


def clusters_from_flat(coarse: "FlatBVH"):
    """Extract (cl_lo (K,3), cl_hi (K,3), cl_tri (K,C)) host arrays from a
    coarse FlatBVH: its leaves, in leaf-id order."""
    nl = np.asarray(coarse.node_leaf)
    sel = np.flatnonzero(nl >= 0)
    sel = sel[np.argsort(nl[sel])]  # preorder assignment => already sorted
    lo = np.stack(
        [np.asarray(coarse.node_lo_x)[sel],
         np.asarray(coarse.node_lo_y)[sel],
         np.asarray(coarse.node_lo_z)[sel]], axis=1
    )
    hi = np.stack(
        [np.asarray(coarse.node_hi_x)[sel],
         np.asarray(coarse.node_hi_y)[sel],
         np.asarray(coarse.node_hi_z)[sel]], axis=1
    )
    return lo, hi, np.asarray(coarse.leaf_tri)


def _subtree_size(node: _Node) -> int:
    """Number of flat nodes in this subtree (memoized on the node)."""
    sz = getattr(node, "_size", None)
    if sz is None:
        sz = 1 if node.is_leaf else 1 + _subtree_size(node.left) + _subtree_size(node.right)
        node._size = sz
    return sz


def _flatten_threaded(root: _Node, num_tris: int, leaf_size: int):
    nodes = []   # list of (lo, hi, leaf_id)
    skips = []
    leaf_blocks = []

    def rec(node: _Node, skip_to: int):
        idx = len(nodes)
        skips.append(skip_to)
        if node.is_leaf:
            lid = len(leaf_blocks)
            block = np.full(leaf_size, num_tris, np.int32)
            block[: node.tri_ids.shape[0]] = node.tri_ids
            leaf_blocks.append(block)
            nodes.append((node.lo, node.hi, lid))
        else:
            nodes.append((node.lo, node.hi, -1))
            # Preorder: left child at idx+1, right child after the whole
            # left subtree — computable up front, so every skip is final
            # when emitted (left subtree skips may target the right child).
            right_idx = idx + 1 + _subtree_size(node.left)
            rec(node.left, skip_to=right_idx)
            assert len(nodes) == right_idx
            rec(node.right, skip_to=skip_to)
        return idx

    # Recursion depth can exceed Python default for big scenes; the tree
    # depth is bounded by MAX_BVH_DEPTH in practice, but set a margin.
    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10 * (root.depth + 50)))
    try:
        total = _subtree_size(root)
        rec(root, skip_to=total)  # root's miss = traversal done
    finally:
        sys.setrecursionlimit(old)

    n = len(nodes)
    assert n == total

    lo = np.stack([nd[0] for nd in nodes]).astype(np.float32)
    hi = np.stack([nd[1] for nd in nodes]).astype(np.float32)
    leaf_id = np.array([nd[2] for nd in nodes], np.int32)
    skip = np.array(skips, np.int32)
    leaf_tri = (
        np.stack(leaf_blocks)
        if leaf_blocks
        else np.zeros((0, leaf_size), np.int32)
    )
    return lo, hi, skip, leaf_id, leaf_tri


def build_bvh(verts, tri_indices, leaf_size: int = 4):
    """Build from host arrays. verts: (V,3) f32, tri_indices: (T,3) i32.

    Returns (FlatBVH pytree, BVHMeta). Equivalent role to the reference's
    ``buildBVH()`` (BVH.h:443-474) + flattening, with the threaded encoding
    described in the module docstring.
    """
    verts = np.asarray(verts, np.float32)
    tri_indices = np.asarray(tri_indices, np.int64)
    T = tri_indices.shape[0]
    assert T >= 1, "empty scene"

    v0 = verts[tri_indices[:, 0]]
    v1 = verts[tri_indices[:, 1]]
    v2 = verts[tri_indices[:, 2]]
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    centers = 0.5 * (lo + hi)
    ids = np.arange(T, dtype=np.int32)

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    try:
        root = _build_recurse(lo, hi, centers, ids, leaf_size)
    finally:
        sys.setrecursionlimit(old)
    if root.depth >= MAX_BVH_DEPTH:
        # reference aborts (kernel.cu:627-631); with multi-tri leaves and a
        # fixed binning this should never trigger, but keep the guard.
        raise RuntimeError(f"BVH depth {root.depth} >= {MAX_BVH_DEPTH}")

    nlo, nhi, skip, leaf_id, leaf_tri = _flatten_threaded(root, T, leaf_size)
    flat = FlatBVH(
        node_lo_x=jnp.asarray(nlo[:, 0]),
        node_lo_y=jnp.asarray(nlo[:, 1]),
        node_lo_z=jnp.asarray(nlo[:, 2]),
        node_hi_x=jnp.asarray(nhi[:, 0]),
        node_hi_y=jnp.asarray(nhi[:, 1]),
        node_hi_z=jnp.asarray(nhi[:, 2]),
        node_skip=jnp.asarray(skip),
        node_leaf=jnp.asarray(leaf_id),
        leaf_tri=jnp.asarray(leaf_tri),
    )
    return flat, BVHMeta(depth=root.depth, num_tris=T)


# ---------------------------------------------------------------------------
# validation helpers (test support; reference has only visual checks)
# ---------------------------------------------------------------------------

def validate(flat: FlatBVH, meta: BVHMeta):
    """Structural invariants: every triangle reachable exactly once from
    leaves; skip links strictly increase; boxes contain their leaf tris'
    boxes is checked in tests against the source geometry."""
    leaf_tri = np.asarray(flat.leaf_tri)
    tri_seen = leaf_tri[leaf_tri < meta.num_tris]
    assert tri_seen.size == meta.num_tris, (tri_seen.size, meta.num_tris)
    assert np.unique(tri_seen).size == meta.num_tris
    skip = np.asarray(flat.node_skip)
    n = skip.shape[0]
    idx = np.arange(n)
    assert np.all(skip > idx), "skip links must move forward"
    assert np.all(skip <= n)
    leaf_id = np.asarray(flat.node_leaf)
    lids = leaf_id[leaf_id >= 0]
    assert np.unique(lids).size == lids.size
    assert lids.size == leaf_tri.shape[0]
    return True
