// Device code of the Lloyd kernel's SIMT route (small d): per-block
// weighted per-cluster statistics without float atomics, and the
// fixed-order reduction of the blocks' partials.
//
// The TPU kernels carry their (K, d) accumulators across a sequential grid.
// Hopper blocks run in parallel in no order, so here:
//   1. a fixed number G of blocks per batch entry each walk the 256-point
//      tiles g, g + G, ... in order, keeping private partial statistics;
//   2. per tile, the block stages each point's cluster (-1 = adds nothing)
//      and weight in shared memory, and thread t adds, in point order, the
//      tile's points whose cluster is t, t + 256, ...: every cluster has
//      exactly one writer, so no atomics are needed.  Thread t finds its
//      points through ownership masks: each warp groups its lanes by owner
//      with one ballot per bit of the owner (equal_lanes, warp.cuh), and
//      the group's first lane writes the lane mask to owners[warp][owner],
//      so the owner reads 8 masks per tile instead of testing all 256
//      points;
//   3. a second small kernel sums the G partials of every output element,
//      g = 0, 1, ... in order.
// So a repeated launch on the same inputs is bit-identical.  The
// accumulator lives in shared memory when K (d + 1) floats fit, else in the
// block's slice of the global scratch, through the same pointer.
#pragma once

#include "distance.cuh"
#include "warp.cuh"

namespace repro {

constexpr int kWarps = kThreads / 32;

// Zero this thread's column of the (kWarps, kThreads) ownership masks (once
// per kernel: each owner clears its masks again as it consumes them).
__device__ __forceinline__ void zero_owners(uint32_t* owners) {
  for (int w = 0; w < kWarps; ++w) owners[w * kThreads + threadIdx.x] = 0u;
}

// Before the tile's barrier: every thread registers its point's cluster k
// (-1 = adds nothing); owners are k mod 256, keyed owner + 1 below 2^nbits
// (nbits = bit length of min(K, 256)).  Called by all threads of the block.
__device__ __forceinline__ void register_point(uint32_t* owners, int k,
                                               int nbits) {
  const unsigned key = k >= 0 ? (k & (kThreads - 1)) + 1u : 0u;
  const unsigned group = equal_lanes(key, nbits);
  const int lane = threadIdx.x & 31;
  if (key && lane == __ffs(group) - 1)
    owners[(threadIdx.x >> 5) * kThreads + key - 1] = group;
}

// Zero this thread's clusters t, t + 256, ... of a block's accumulator.
__device__ __forceinline__ void zero_acc(float* sums, float* counts, int K,
                                         int d) {
  for (int k = threadIdx.x; k < K; k += kThreads) {
    for (int j = 0; j < d; ++j) sums[static_cast<int64_t>(k) * d + j] = 0.f;
    counts[k] = 0.f;
  }
}

// Owner-computes accumulation of one staged tile, between barriers: thread
// t adds, in increasing p, every point p registered to it: sw[p] * x_p to
// cluster sidx[p] (row p of the tile starts at element row0 of x).
__device__ __forceinline__ void accumulate_tile(float* sums, float* counts,
                                                uint32_t* owners,
                                                const int* sidx,
                                                const float* sw, const void* x,
                                                int64_t row0, int d,
                                                int x_bf16) {
  const int t = threadIdx.x;
  for (int w = 0; w < kWarps; ++w) {
    unsigned mask = owners[w * kThreads + t];
    if (!mask) continue;
    owners[w * kThreads + t] = 0u;
    for (; mask; mask &= mask - 1) {
      const int p = w * 32 + __ffs(mask) - 1;
      const int k = sidx[p];
      const float wp = sw[p];
      const int64_t prow = row0 + static_cast<int64_t>(p) * d;
      float* acc = sums + static_cast<int64_t>(k) * d;
      for (int j = 0; j < d; ++j) acc[j] += wp * load_f32(x, prow + j, x_bf16);
      counts[k] += wp;
    }
  }
}

// Owners copy their own clusters of a shared-memory accumulator out to the
// block's partial slot (no barrier needed: each cluster has one owner).
__device__ __forceinline__ void store_partials(const float* sums,
                                               const float* counts,
                                               float* part_sums,
                                               float* part_counts,
                                               int64_t slot, int K, int d) {
  for (int k = threadIdx.x; k < K; k += kThreads) {
    for (int j = 0; j < d; ++j)
      part_sums[(slot * K + k) * d + j] = sums[static_cast<int64_t>(k) * d + j];
    part_counts[slot * K + k] = counts[k];
  }
}

// Sum the G per-block partials of every output element, g = 0, 1, ... in
// order (statistics and SSE).
__global__ void reduce_partials_kernel(const float* __restrict__ part_sums,
                                       const float* __restrict__ part_counts,
                                       const float* __restrict__ part_sse,
                                       int B, int G, int K, int d,
                                       float* __restrict__ sums,
                                       float* __restrict__ counts,
                                       float* __restrict__ sse) {
  const int64_t kd = static_cast<int64_t>(K) * d;
  const int64_t n_sums = B * kd;
  const int64_t n_counts = static_cast<int64_t>(B) * K;
  const int64_t total = n_sums + n_counts + B;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    if (i < n_sums) {
      const int64_t b = i / kd, r = i % kd;
      for (int g = 0; g < G; ++g) acc += part_sums[(b * G + g) * kd + r];
      sums[i] = acc;
    } else if (i < n_sums + n_counts) {
      const int64_t i2 = i - n_sums, b = i2 / K, r = i2 % K;
      for (int g = 0; g < G; ++g) acc += part_counts[(b * G + g) * K + r];
      counts[i2] = acc;
    } else {
      const int64_t b = i - n_sums - n_counts;
      for (int g = 0; g < G; ++g) acc += part_sse[b * G + g];
      sse[b] = acc;
    }
  }
}

inline int launch_reduce(const float* part_sums, const float* part_counts,
                         const float* part_sse, int B, int G, int K, int d,
                         float* sums, float* counts, float* sse,
                         cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(B) * K * (d + 1) + B;
  const int blocks = static_cast<int>(
      total / kThreads + 1 < 4096 ? total / kThreads + 1 : 4096);
  reduce_partials_kernel<<<blocks, kThreads, 0, stream>>>(
      part_sums, part_counts, part_sse, B, G, K, d, sums, counts, sse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro
