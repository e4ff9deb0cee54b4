// Native binned-SAH BVH builder — the host-side hot loop, in C++.
//
// The reference builds its BVH on the host in C++ (BVH.h:133-328: recursive
// top-down, 3x3x3 centroid grid, SAH-scored axis/slice sweep, BFS
// flattening). This is its equivalent for this JAX framework: same
// algorithm family (binned SAH, gridDim=3 per metricsForSponza.txt's sweep),
// with the reference's grid-fill box bug (BVH.h:190) fixed, multi-triangle
// leaves, and the *threaded* (skip-link, preorder) flat encoding the
// traversal consumes (see accel/bvh.py for the encoding rationale).
//
// Exposed via a plain C ABI for ctypes (accel/native.py). The Python
// builder (accel/bvh.py) is the semantics twin; tests assert identical
// output on identical input.
//
// Build: make -C cudapathtracer/native   (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <array>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kGridDim = 3;  // BVH.h:166; best-of-sweep metricsForSponza.txt

struct V3 {
  float x, y, z;
};

static inline V3 vmin(const V3& a, const V3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3& a, const V3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float surface(const V3& lo, const V3& hi) {
  float dx = hi.x - lo.x, dy = hi.y - lo.y, dz = hi.z - lo.z;
  return 2.0f * (dx * dy + dx * dz + dy * dz);
}

// SAH scoring is done entirely in double (like the reference's double
// score, BVH.h:196) AND like the python twin, whose numpy bin boxes are
// float64 — near-tied symmetric splits otherwise resolve differently
// between the two builders.
static inline double surface_d(const V3& lo, const V3& hi) {
  double dx = (double)hi.x - lo.x, dy = (double)hi.y - lo.y,
         dz = (double)hi.z - lo.z;
  return 2.0 * (dx * dy + dx * dz + dy * dz);
}

struct BuildCtx {
  std::vector<V3> lo, hi;      // per-triangle leaf boxes
  std::vector<V3> center;      // centroids
  int leaf_size;
  // flat output (built directly during the recursion — preorder)
  std::vector<float> node_lo, node_hi;  // 3*N
  std::vector<int32_t> node_skip, node_leaf;
  std::vector<int32_t> leaf_tri;        // NL * leaf_size, pad = n_tris
  int32_t n_tris;
  int depth = 0;
};

// Recursive build. Emits nodes in preorder into c.node_*; returns the
// number of flat nodes emitted for this subtree. ``skip_to`` is the
// preorder index to jump to when this subtree is done/missed — but at call
// time the subtree's own size (and hence the right child's index) is
// unknown, so we patch skips after children return.
static int64_t build_recurse(BuildCtx& c, int32_t* ids, int64_t n,
                             int64_t skip_to_placeholder, int depth) {
  const int64_t my_index = static_cast<int64_t>(c.node_skip.size());
  if (depth > c.depth) c.depth = depth;

  // union bounds
  V3 blo = c.lo[ids[0]], bhi = c.hi[ids[0]];
  for (int64_t i = 1; i < n; ++i) {
    blo = vmin(blo, c.lo[ids[i]]);
    bhi = vmax(bhi, c.hi[ids[i]]);
  }

  // emit slot
  c.node_lo.insert(c.node_lo.end(), {blo.x, blo.y, blo.z});
  c.node_hi.insert(c.node_hi.end(), {bhi.x, bhi.y, bhi.z});
  c.node_skip.push_back(-1);  // patched by caller/below
  c.node_leaf.push_back(-1);

  if (n <= c.leaf_size) {
    int32_t leaf_id = static_cast<int32_t>(c.leaf_tri.size() / c.leaf_size);
    for (int k = 0; k < c.leaf_size; ++k)
      c.leaf_tri.push_back(k < n ? ids[k] : c.n_tris);
    c.node_leaf[my_index] = leaf_id;
    return 1;
  }

  // --- binned SAH (BVH.h:156-259, box bug fixed) ---
  const double total_w = surface_d(blo, bhi);
  V3 units = {(bhi.x - blo.x) / kGridDim, (bhi.y - blo.y) / kGridDim,
              (bhi.z - blo.z) / kGridDim};
  if (units.x == 0) units.x = 1;
  if (units.y == 0) units.y = 1;
  if (units.z == 0) units.z = 1;

  V3 glo[kGridDim][kGridDim][kGridDim];
  V3 ghi[kGridDim][kGridDim][kGridDim];
  int64_t cnt[kGridDim][kGridDim][kGridDim];
  for (auto& a : glo)
    for (auto& b : a)
      for (auto& v : b) v = {FLT_MAX, FLT_MAX, FLT_MAX};
  for (auto& a : ghi)
    for (auto& b : a)
      for (auto& v : b) v = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  memset(cnt, 0, sizeof(cnt));

  auto cell_of = [&](const V3& cc) {
    int cx = std::min<int>(kGridDim - 1,
                           std::max(0, (int)((cc.x - blo.x) / units.x)));
    int cy = std::min<int>(kGridDim - 1,
                           std::max(0, (int)((cc.y - blo.y) / units.y)));
    int cz = std::min<int>(kGridDim - 1,
                           std::max(0, (int)((cc.z - blo.z) / units.z)));
    return std::array<int, 3>{cx, cy, cz};
  };

  for (int64_t i = 0; i < n; ++i) {
    auto cc = cell_of(c.center[ids[i]]);
    auto& g0 = glo[cc[0]][cc[1]][cc[2]];
    auto& g1 = ghi[cc[0]][cc[1]][cc[2]];
    g0 = vmin(g0, c.lo[ids[i]]);   // the FIXED box union (not nodes[i])
    g1 = vmax(g1, c.hi[ids[i]]);
    cnt[cc[0]][cc[1]][cc[2]]++;
  }

  int best_axis = 0, best_slice = 0;
  double best_score = DBL_MAX;
  int64_t best_cl = 0, best_cr = 0;
  for (int axis = 0; axis < 3; ++axis) {
    for (int slice = 0; slice < kGridDim; ++slice) {
      V3 llo = {FLT_MAX, FLT_MAX, FLT_MAX};
      V3 lhi = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      V3 rlo = llo, rhi = lhi;
      int64_t cl = 0, cr = 0;
      for (int i = 0; i < kGridDim; ++i)
        for (int j = 0; j < kGridDim; ++j)
          for (int k = 0; k < kGridDim; ++k) {
            if (!cnt[i][j][k]) continue;
            int coord = axis == 0 ? i : (axis == 1 ? j : k);
            if (coord < slice) {
              cl += cnt[i][j][k];
              llo = vmin(llo, glo[i][j][k]);
              lhi = vmax(lhi, ghi[i][j][k]);
            } else {
              cr += cnt[i][j][k];
              rlo = vmin(rlo, glo[i][j][k]);
              rhi = vmax(rhi, ghi[i][j][k]);
            }
          }
      double wl = cl ? surface_d(llo, lhi) : 0.0;
      double wr = cr ? surface_d(rlo, rhi) : 0.0;
      double score = cl * wl / total_w + cr * wr / total_w;
      if (score < best_score) {
        best_score = score;
        best_axis = axis;
        best_slice = slice;
        best_cl = cl;
        best_cr = cr;
      }
    }
  }

  // partition (stable, like the python twin's boolean-mask split)
  std::vector<int32_t> left, right;
  if (best_cl == 0 || best_cr == 0) {
    // degenerate: arbitrary halving (BVH.h:263-288)
    int64_t half = n / 2;
    left.assign(ids, ids + half);
    right.assign(ids + half, ids + n);
  } else {
    left.reserve(best_cl);
    right.reserve(best_cr);
    for (int64_t i = 0; i < n; ++i) {
      auto cc = cell_of(c.center[ids[i]]);
      if (cc[best_axis] < best_slice)
        left.push_back(ids[i]);
      else
        right.push_back(ids[i]);
    }
  }

  int64_t left_sz =
      build_recurse(c, left.data(), (int64_t)left.size(), -1, depth + 1);
  int64_t right_index = my_index + 1 + left_sz;
  // left child's miss target is its right sibling
  c.node_skip[my_index + 1] = static_cast<int32_t>(right_index);
  int64_t right_sz =
      build_recurse(c, right.data(), (int64_t)right.size(), -1, depth + 1);
  // right child's miss target is this subtree's skip — patched by caller;
  // store our own placeholder resolution: caller sets node_skip[my_index],
  // and we set right child's to the same once known. To avoid a second
  // pass, the caller patches BOTH via patch_skip below.
  (void)skip_to_placeholder;
  return 1 + left_sz + right_sz;
}

// After the preorder build, every node's skip is: leaf/left-child rules set
// inline; what remains unresolved (-1) is "inherit the parent's skip",
// which resolves in one forward pass with an explicit stack of (end, skip)
// ranges — but simpler: a node at index i with subtree size s has skip
// i + s. We recover sizes by a single reverse scan using node_leaf/skip
// structure... Simplest correct approach: recompute via recursion mirror.
// Instead we patch inline: build_recurse returns sizes, so the top caller
// walks again. To keep it O(N) and simple we store sizes during build.

}  // namespace

extern "C" {

struct BVHOut {
  int64_t n_nodes;
  int64_t n_leaves;
  int32_t leaf_size;
  int32_t depth;
  float* node_lo;     // 3*n_nodes
  float* node_hi;     // 3*n_nodes
  int32_t* node_skip; // n_nodes
  int32_t* node_leaf; // n_nodes
  int32_t* leaf_tri;  // n_leaves*leaf_size
};

// Builds the threaded flat BVH. Returns 0 on success.
int cpt_build_bvh(const float* verts, int64_t n_verts, const int32_t* tris,
                  int64_t n_tris, int32_t leaf_size, BVHOut* out) {
  if (n_tris <= 0 || leaf_size <= 0) return 1;
  BuildCtx c;
  c.leaf_size = leaf_size;
  c.n_tris = static_cast<int32_t>(n_tris);
  c.lo.resize(n_tris);
  c.hi.resize(n_tris);
  c.center.resize(n_tris);
  for (int64_t t = 0; t < n_tris; ++t) {
    V3 v[3];
    for (int k = 0; k < 3; ++k) {
      int32_t vi = tris[3 * t + k];
      if (vi < 0 || vi >= n_verts) return 2;
      v[k] = {verts[3 * vi], verts[3 * vi + 1], verts[3 * vi + 2]};
    }
    c.lo[t] = vmin(vmin(v[0], v[1]), v[2]);
    c.hi[t] = vmax(vmax(v[0], v[1]), v[2]);
    c.center[t] = {(c.lo[t].x + c.hi[t].x) * 0.5f,
                   (c.lo[t].y + c.hi[t].y) * 0.5f,
                   (c.lo[t].z + c.hi[t].z) * 0.5f};
  }
  std::vector<int32_t> ids(n_tris);
  for (int64_t i = 0; i < n_tris; ++i) ids[i] = static_cast<int32_t>(i);

  c.node_lo.reserve(6 * n_tris);
  c.node_hi.reserve(6 * n_tris);
  c.node_skip.reserve(2 * n_tris);
  c.node_leaf.reserve(2 * n_tris);
  c.leaf_tri.reserve(n_tris + leaf_size);

  int64_t total = build_recurse(c, ids.data(), n_tris, -1, 1);
  const int64_t n_nodes = static_cast<int64_t>(c.node_skip.size());
  if (total != n_nodes) return 3;

  // Resolve remaining skips. After the build, LEFT children are patched
  // (their skip = right sibling's index, set in build_recurse); right
  // children and the root still hold -1 and must inherit their parent's
  // skip (= next preorder index after the parent's subtree). One preorder
  // walk with an explicit (index, inherited-skip) stack resolves all:
  {
    std::vector<int64_t> stack_idx;
    std::vector<int32_t> stack_skip;
    stack_idx.push_back(0);
    stack_skip.push_back(static_cast<int32_t>(n_nodes));
    while (!stack_idx.empty()) {
      int64_t i = stack_idx.back(); stack_idx.pop_back();
      int32_t sk = stack_skip.back(); stack_skip.pop_back();
      if (c.node_skip[i] == -1) c.node_skip[i] = sk;
      if (c.node_leaf[i] == -1) {
        // internal: left child at i+1 (its skip = right child's index,
        // already patched), right child at that index (inherits sk)
        int32_t right_index = c.node_skip[i + 1];
        stack_idx.push_back(i + 1);
        stack_skip.push_back(right_index);
        stack_idx.push_back(right_index);
        stack_skip.push_back(sk);
      }
    }
  }

  const int64_t n_leaves =
      static_cast<int64_t>(c.leaf_tri.size()) / leaf_size;

  out->n_nodes = n_nodes;
  out->n_leaves = n_leaves;
  out->leaf_size = leaf_size;
  out->depth = c.depth;
  out->node_lo = (float*)malloc(sizeof(float) * 3 * n_nodes);
  out->node_hi = (float*)malloc(sizeof(float) * 3 * n_nodes);
  out->node_skip = (int32_t*)malloc(sizeof(int32_t) * n_nodes);
  out->node_leaf = (int32_t*)malloc(sizeof(int32_t) * n_nodes);
  out->leaf_tri = (int32_t*)malloc(sizeof(int32_t) * n_leaves * leaf_size);
  memcpy(out->node_lo, c.node_lo.data(), sizeof(float) * 3 * n_nodes);
  memcpy(out->node_hi, c.node_hi.data(), sizeof(float) * 3 * n_nodes);
  memcpy(out->node_skip, c.node_skip.data(), sizeof(int32_t) * n_nodes);
  memcpy(out->node_leaf, c.node_leaf.data(), sizeof(int32_t) * n_nodes);
  memcpy(out->leaf_tri, c.leaf_tri.data(),
         sizeof(int32_t) * n_leaves * leaf_size);
  return 0;
}

void cpt_free_bvh(BVHOut* out) {
  free(out->node_lo);
  free(out->node_hi);
  free(out->node_skip);
  free(out->node_leaf);
  free(out->leaf_tri);
  memset(out, 0, sizeof(BVHOut));
}

}  // extern "C"
