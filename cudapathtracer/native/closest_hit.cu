// Per-ray closest-hit walk over the skip-link flat BVH, one CUDA thread per
// ray — the reference's trace() (kernel.cu:112-161) on Hopper, without its
// per-thread stack: the BVH is threaded (accel/bvh.py), so a ray's whole
// traversal state is one preorder cursor.
//
// Called from JAX through the XLA FFI (ops/cuda_walk.py). The contract is
// ops/traversal.trace's, test for test:
//   * slab test with [0, t_best] clipping and NaN-propagating min/max
//     (XLA's jnp.minimum / jnp.maximum);
//   * the 'bw' (Baldwin-Weber on precomputed n, m1, m2) or 'mt'
//     (Moller-Trumbore on e1, e2) triangle test of ops/intersect.py, same
//     expression order;
//   * a hit needs 0 < t < MAX_FLOAT and t < the ray's cap; exact-t ties go
//     to the lower triangle index; a miss is (MAX_FLOAT, -1).
// A ray whose cap is <= 0 is masked: it reports a miss and walks nothing.
//
// Build (native/Makefile, target `cuda`):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I<jax.ffi.include_dir()> closest_hit.cu

#include <cuda_runtime.h>

#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float kMaxFloat = 1e5f;      // utils/constants.MAX_FLOAT
constexpr float kEpsParallel = 1e-5f;  // utils/constants.EPS_PARALLEL
constexpr int kBlock = 128;

// XLA's min/max propagate NaN; fminf/fmaxf drop it.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// Triangle records: 12 floats each.
//   bw: v0.xyz, n.xyz, m1.xyz, m2.xyz   (intersect.bw_precompute)
//   mt: v0.xyz, e1.xyz, e2.xyz, 0 0 0
template <bool kBW>
__device__ __forceinline__ float tri_test(const float* __restrict__ r,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(r));
  const float4 b = __ldg(reinterpret_cast<const float4*>(r) + 1);
  const float4 c = __ldg(reinterpret_cast<const float4*>(r) + 2);
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  if (kBW) {
    // ray_triangle_bw
    const float nx = a.w, ny = b.x, nz = b.y;
    const float m1x = b.z, m1y = b.w, m1z = c.x;
    const float m2x = c.y, m2y = c.z, m2z = c.w;
    const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
    const float nd = dot3(dx, dy, dz, nx, ny, nz);
    const bool parallel = fabsf(nd) < kEpsParallel;
    const float inv = parallel ? 0.0f : 1.0f / nd;
    const float t = -dot3(sx, sy, sz, nx, ny, nz) * inv;
    const float wx = sx + dx * t, wy = sy + dy * t, wz = sz + dz * t;
    const float bu = dot3(m1x, m1y, m1z, wx, wy, wz);
    const float bv = dot3(m2x, m2y, m2z, wx, wy, wz);
    const float bw = 1.0f - bu - bv;
    const bool reject = parallel || bu < 0.0f || bv < 0.0f || bw < 0.0f;
    return reject ? kMaxFloat : t;
  } else {
    // ray_triangle (Moller-Trumbore, modelLoader.h:49-123)
    const float e1x = a.w, e1y = b.x, e1z = b.y;
    const float e2x = b.z, e2y = b.w, e2z = c.x;
    const float qx = dy * e2z - dz * e2y;
    const float qy = dz * e2x - dx * e2z;
    const float qz = dx * e2y - dy * e2x;
    const float det = dot3(e1x, e1y, e1z, qx, qy, qz);
    const bool parallel = fabsf(det) < kEpsParallel;
    const float inv = parallel ? 0.0f : 1.0f / det;
    const float sx = (ox - v0x) * inv, sy = (oy - v0y) * inv,
                sz = (oz - v0z) * inv;
    const float rx = sy * e1z - sz * e1y;
    const float ry = sz * e1x - sx * e1z;
    const float rz = sx * e1y - sy * e1x;
    const float b0 = dot3(sx, sy, sz, qx, qy, qz);
    const float b1 = dot3(rx, ry, rz, dx, dy, dz);
    const float b2 = 1.0f - b0 - b1;
    const bool reject = parallel || b0 < 0.0f || b1 < 0.0f || b2 < 0.0f;
    return reject ? kMaxFloat : dot3(e2x, e2y, e2z, rx, ry, rz);
  }
}

// rays: (7, R) SoA — ox oy oz dx dy dz cap.
// nodes: (N, 8) — lo.xyz, hi.xyz, 2 pad.  links: (N, 2) — skip, leaf.
// tris: (NL * L, 12) records; tri_ids: (NL * L,), pad slots < 0.
template <bool kBW>
__global__ void __launch_bounds__(kBlock)
    closest_hit_kernel(const float* __restrict__ rays,
                       const float* __restrict__ nodes,
                       const int2* __restrict__ links,
                       const float* __restrict__ tris,
                       const int* __restrict__ tri_ids, int64_t R, int N,
                       int L, float* __restrict__ t_out,
                       int* __restrict__ tri_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= R) return;
  const float ox = rays[i], oy = rays[R + i], oz = rays[2 * R + i];
  const float dx = rays[3 * R + i], dy = rays[4 * R + i],
              dz = rays[5 * R + i];
  const float cap = rays[6 * R + i];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;

  float best_t = kMaxFloat;
  int best_tri = -1;
  int cur = cap > 0.0f ? 0 : N;
  while (cur < N) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(nodes) + 2 * cur);
    const float4 hi =
        __ldg(reinterpret_cast<const float4*>(nodes) + 2 * cur + 1);
    // lo = (lo.x, lo.y, lo.z, hi.x), hi = (hi.y, hi.z, pad, pad)
    const float tx0 = (lo.x - ox) * ix, tx1 = (lo.w - ox) * ix;
    const float ty0 = (lo.y - oy) * iy, ty1 = (hi.x - oy) * iy;
    const float tz0 = (lo.z - oz) * iz, tz1 = (hi.y - oz) * iz;
    const float tmin = nan_max(nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
                               nan_min(tz0, tz1));
    const float tmax = nan_min(nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
                               nan_max(tz0, tz1));
    const bool box_hit = tmin <= tmax && tmax >= 0.0f && tmin <= best_t;
    const int2 link = __ldg(links + cur);
    if (box_hit && link.y >= 0) {
      const int64_t base = static_cast<int64_t>(link.y) * L;
      for (int j = 0; j < L; ++j) {
        const int tri = __ldg(tri_ids + base + j);
        if (tri < 0) continue;
        const float t =
            tri_test<kBW>(tris + (base + j) * 12, ox, oy, oz, dx, dy, dz);
        if (t > 0.0f && t < kMaxFloat && t < cap &&
            (t < best_t || (t == best_t && tri < best_tri))) {
          best_t = t;
          best_tri = tri;
        }
      }
      cur = link.x;
    } else {
      cur = box_hit ? cur + 1 : link.x;
    }
  }
  t_out[i] = best_t;
  tri_out[i] = best_tri;
}

ffi::Error ClosestHitImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> rays,
                          ffi::Buffer<ffi::F32> nodes,
                          ffi::Buffer<ffi::S32> links,
                          ffi::Buffer<ffi::F32> tris,
                          ffi::Buffer<ffi::S32> tri_ids,
                          ffi::ResultBuffer<ffi::F32> t_out,
                          ffi::ResultBuffer<ffi::S32> tri_out, int32_t bw) {
  const int64_t R = t_out->element_count();
  const auto nd = nodes.dimensions();
  const auto td = tris.dimensions();
  if (rays.element_count() != 7 * R || nd.size() != 2 || nd[1] != 8 ||
      links.element_count() != 2 * nd[0] || td.size() != 2 || td[1] != 12 ||
      tri_ids.element_count() != td[0]) {
    return ffi::Error::InvalidArgument("closest_hit: bad operand shapes");
  }
  const int N = static_cast<int>(nd[0]);
  const auto ld = tri_ids.dimensions();
  const int L = ld.size() == 2 ? static_cast<int>(ld[1]) : 1;
  if (R == 0) return ffi::Error::Success();
  const dim3 grid(static_cast<unsigned>((R + kBlock - 1) / kBlock));
  const int2* lk = reinterpret_cast<const int2*>(links.typed_data());
  if (bw) {
    closest_hit_kernel<true><<<grid, kBlock, 0, stream>>>(
        rays.typed_data(), nodes.typed_data(), lk, tris.typed_data(),
        tri_ids.typed_data(), R, N, L, t_out->typed_data(),
        tri_out->typed_data());
  } else {
    closest_hit_kernel<false><<<grid, kBlock, 0, stream>>>(
        rays.typed_data(), nodes.typed_data(), lk, tris.typed_data(),
        tri_ids.typed_data(), R, N, L, t_out->typed_data(),
        tri_out->typed_data());
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(CptClosestHit, ClosestHitImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // rays
                                  .Arg<ffi::Buffer<ffi::F32>>()  // nodes
                                  .Arg<ffi::Buffer<ffi::S32>>()  // links
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tris
                                  .Arg<ffi::Buffer<ffi::S32>>()  // tri_ids
                                  .Ret<ffi::Buffer<ffi::F32>>()  // t
                                  .Ret<ffi::Buffer<ffi::S32>>()  // tri
                                  .Attr<int32_t>("bw"));
