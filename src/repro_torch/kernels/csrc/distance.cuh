// Device code shared by the assign and Lloyd kernels: loading points and
// centers (f32 or bf16, upcast to f32), staging a center tile in shared
// memory, and the running argmin of one point over a staged tile.
//
// Semantics (held by the plain versions in repro_torch/kernels/ref.py):
//   d2 = max(|x|^2 + |c|^2 - 2 x.c, 0) in fp32, the expanded form of the JAX
//   package's kernels, so `dist` and near-ties match it; centers are scanned
//   in increasing index order with a strict `<`, so ties go to the lowest
//   index; centers past K are never visited, so they never win.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro {

// One point per thread; a block walks the points kThreads at a time.
constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const void* p, int64_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// Floats per staged center.  DP > 0: the point is held in DP registers and
// each center is DP coordinates (zero-padded past d), then |c|^2, padded to
// whole float4s.  DP == 0 (d > 128): d coordinates, then |c|^2.
__host__ __device__ constexpr int center_stride(int dp, int d) {
  return dp > 0 ? (dp + 4) / 4 * 4 : d + 1;
}

// Stage centers [k0, k0 + nk) of one batch entry (rows of d values from
// element offset cbase) into shared memory, with |c|^2 after each row.
template <int DP>
__device__ void stage_centers(float* cs, const void* c, int64_t cbase, int k0,
                              int nk, int d, int c_bf16) {
  const int S = center_stride(DP, d);
  for (int kk = threadIdx.x; kk < nk; kk += blockDim.x) {
    const int64_t row = cbase + static_cast<int64_t>(k0 + kk) * d;
    float* dst = cs + kk * S;
    float c2 = 0.f;
    for (int j = 0; j < d; ++j) {
      const float v = load_f32(c, row + j, c_bf16);
      dst[j] = v;
      c2 = fmaf(v, v, c2);
    }
    for (int j = d; j < S; ++j) dst[j] = 0.f;
    dst[DP > 0 ? DP : d] = c2;
  }
}

// Load one point into registers (DP > 0, zero-padded) and return |x|^2.
template <int DP>
__device__ __forceinline__ float load_point(float* xr, const void* x,
                                            int64_t xrow, int d, int x_bf16,
                                            bool valid) {
  float x2 = 0.f;
  if constexpr (DP > 0) {
#pragma unroll
    for (int j = 0; j < DP; ++j) {
      const float v = (valid && j < d) ? load_f32(x, xrow + j, x_bf16) : 0.f;
      xr[j] = v;
      x2 = fmaf(v, v, x2);
    }
  } else {
    if (valid)
      for (int j = 0; j < d; ++j) {
        const float v = load_f32(x, xrow + j, x_bf16);
        x2 = fmaf(v, v, x2);
      }
  }
  return x2;
}

// Fold staged centers [0, nk) (global ids k0 + kk) into the running
// (best, best_k) of one point.  DP == 0 reads the point from global memory.
template <int DP>
__device__ __forceinline__ void argmin_tile(const float* cs, int nk, int k0,
                                            const float* xr, float x2,
                                            const void* x, int64_t xrow, int d,
                                            int x_bf16, float& best,
                                            int& best_k) {
  if constexpr (DP > 0) {
    constexpr int S = center_stride(DP, 0);
#pragma unroll 4
    for (int kk = 0; kk < nk; ++kk) {
      const float4* c4 = reinterpret_cast<const float4*>(cs + kk * S);
      float dot = 0.f, c2 = 0.f;
#pragma unroll
      for (int q = 0; q < S / 4; ++q) {
        const float4 v = c4[q];
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 4 * q + r;
          if (j < DP) dot = fmaf(xr[j], e[r], dot);
          else if (j == DP) c2 = e[r];
        }
      }
      const float d2 = fmaxf(x2 + c2 - 2.f * dot, 0.f);
      if (d2 < best) {
        best = d2;
        best_k = k0 + kk;
      }
    }
  } else {
    const int S = d + 1;
    for (int kk = 0; kk < nk; ++kk) {
      const float* cr = cs + kk * S;
      float dot = 0.f;
      for (int j = 0; j < d; ++j)
        dot = fmaf(load_f32(x, xrow + j, x_bf16), cr[j], dot);
      const float d2 = fmaxf(x2 + cr[d] - 2.f * dot, 0.f);
      if (d2 < best) {
        best = d2;
        best_k = k0 + kk;
      }
    }
  }
}

}  // namespace repro

// Dispatch a template on the register width DP chosen by the Python side
// (repro_torch/kernels/tiles.py::register_dim).
#define REPRO_DISPATCH_DP(dp, FN, ...)                         \
  switch (dp) {                                                \
    case 2: return FN<2>(__VA_ARGS__);                         \
    case 4: return FN<4>(__VA_ARGS__);                         \
    case 8: return FN<8>(__VA_ARGS__);                         \
    case 16: return FN<16>(__VA_ARGS__);                       \
    case 32: return FN<32>(__VA_ARGS__);                       \
    case 64: return FN<64>(__VA_ARGS__);                       \
    case 128: return FN<128>(__VA_ARGS__);                     \
    case 0: return FN<0>(__VA_ARGS__);                         \
    default: return static_cast<int>(cudaErrorInvalidValue);   \
  }
