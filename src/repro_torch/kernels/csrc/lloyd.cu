// Fused Lloyd step on Hopper (sm_90a): in one pass over the points of each
// batch entry, the nearest center of every point (idx, dist) and the raw
// weighted per-cluster statistics (sums, counts) and weighted SSE.
//
// Replaces the TPU kernel repro/kernels/lloyd.py::_lloyd_kernel
// (lloyd_step_pallas).  That kernel zeroes its (K, d) accumulators at grid
// step (0, 0) and carries them across a *sequential* grid.  Hopper blocks
// run in parallel in no order, so here each block owns private partial
// statistics and a second small kernel sums them over the blocks in a fixed
// order.  No float atomics anywhere: a repeated step is bit-identical.
//
// What bounds it: FP32 CUDA-core work, as for assign.cu (about seven
// operations per (point, center) pair at d=2; the bytes are tiny).  The
// distance pass is assign.cu's: one thread owns one point in registers and
// walks the centers staged in shared memory with |c|^2 precomputed.  The
// accumulation adds O(M (d + 1)) work on top of O(M K d):
//   1. a fixed number G of blocks per batch entry, each walking the 256-point
//      tiles g, g + G, ... in order, so the scratch is O(B G K (d + 1)),
//      not O(M / 256 K d);
//   2. per tile, the block stages (idx, w, w * dist) in shared memory and
//      reduces the SSE with a fixed-shape tree;
//   3. thread t then adds, in point order, the tile's points whose cluster
//      is t, t + 256, ... into the block's accumulator: every cluster has
//      exactly one writer, so no atomics are needed.  The accumulator lives
//      in shared memory when K (d + 1) floats fit (the paper's shapes), else
//      in the block's global scratch slice, through the same pointer.
// Rows with w = 0 (capacity padding) get idx/dist and add nothing.
//
// Layout: x (B, M, d) and w (B, M) with batch strides (0 lets restarts share
// one pool), c (B, K, d) with a batch stride; idx/dist (B, M), scratch
// (B, G, K, d) / (B, G, K) / (B, G), sums (B, K, d), counts (B, K), sse (B,)
// contiguous f32 (idx int32).
#include "distance.cuh"

namespace repro {
namespace {

template <int DP>
__global__ void __launch_bounds__(kThreads)
lloyd_partial_kernel(const void* __restrict__ x, int64_t x_bs, int x_bf16,
                     const void* __restrict__ w, int64_t w_bs, int w_bf16,
                     const void* __restrict__ c, int64_t c_bs, int c_bf16,
                     int M, int K, int d, int bk, int acc_smem,
                     int32_t* __restrict__ idx, float* __restrict__ dist,
                     float* __restrict__ part_sums,
                     float* __restrict__ part_counts,
                     float* __restrict__ part_sse) {
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);  // bk centers
  int* sidx = reinterpret_cast<int*>(cs + bk * center_stride(DP, d));
  float* sw = reinterpret_cast<float*>(sidx + kThreads);
  float* sred = sw + kThreads;
  float* sacc = sred + kThreads;  // K * d sums, then K counts (acc_smem)

  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int g = blockIdx.x;
  const int G = gridDim.x;
  const int64_t slot = static_cast<int64_t>(b) * G + g;
  float* acc_sums = acc_smem ? sacc : part_sums + slot * K * d;
  float* acc_counts =
      acc_smem ? sacc + static_cast<int64_t>(K) * d : part_counts + slot * K;
  // each thread zeroes (and later alone updates) clusters t, t + 256, ...
  for (int k = t; k < K; k += kThreads) {
    for (int j = 0; j < d; ++j) acc_sums[static_cast<int64_t>(k) * d + j] = 0.f;
    acc_counts[k] = 0.f;
  }

  const int64_t xbase = static_cast<int64_t>(b) * x_bs;
  const int64_t cbase = static_cast<int64_t>(b) * c_bs;
  const bool resident = bk >= K;  // every center staged once per block
  if (resident) stage_centers<DP>(cs, c, cbase, 0, K, d, c_bf16);
  __syncthreads();

  float block_sse = 0.f;  // thread 0's running sum over its tiles, in order
  const int n_tiles = (M + kThreads - 1) / kThreads;
  for (int tile = g; tile < n_tiles; tile += G) {
    const int m = tile * kThreads + t;
    const bool valid = m < M;
    const int64_t xrow = xbase + static_cast<int64_t>(valid ? m : 0) * d;
    float xr[DP > 0 ? DP : 1];
    const float x2 = load_point<DP>(xr, x, xrow, d, x_bf16, valid);
    const float wv =
        valid ? load_f32(w, static_cast<int64_t>(b) * w_bs + m, w_bf16) : 0.f;

    float best = INFINITY;
    int best_k = 0;
    for (int k0 = 0; k0 < K; k0 += bk) {
      const int nk = min(bk, K - k0);
      if (!resident) {
        __syncthreads();
        stage_centers<DP>(cs, c, cbase, k0, nk, d, c_bf16);
        __syncthreads();
      }
      if (valid)
        argmin_tile<DP>(cs, nk, k0, xr, x2, x, xrow, d, x_bf16, best, best_k);
    }
    if (valid) {
      const int64_t o = static_cast<int64_t>(b) * M + m;
      idx[o] = best_k;
      dist[o] = best;
    }
    const bool live = valid && wv != 0.f;
    sidx[t] = live ? best_k : -1;
    sw[t] = wv;
    sred[t] = live ? wv * best : 0.f;
    __syncthreads();

    // the tile's weighted SSE: a tree of fixed shape, so a fixed order
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (t < s) sred[t] += sred[t + s];
      __syncthreads();
    }
    if (t == 0) block_sse += sred[0];

    // owner-computes accumulation, in point order
    for (int p = 0; p < kThreads; ++p) {
      const int k = sidx[p];
      if (k >= 0 && (k & (kThreads - 1)) == t) {
        const float wp = sw[p];
        const int64_t prow =
            xbase + static_cast<int64_t>(tile * kThreads + p) * d;
        float* acc = acc_sums + static_cast<int64_t>(k) * d;
        for (int j = 0; j < d; ++j) acc[j] += wp * load_f32(x, prow + j, x_bf16);
        acc_counts[k] += wp;
      }
    }
    __syncthreads();  // sidx / sw / sred are rewritten by the next tile
  }

  if (acc_smem) {  // owners copy their own clusters out: no barrier needed
    for (int k = t; k < K; k += kThreads) {
      for (int j = 0; j < d; ++j)
        part_sums[(slot * K + k) * d + j] = acc_sums[static_cast<int64_t>(k) * d + j];
      part_counts[slot * K + k] = acc_counts[k];
    }
  }
  if (t == 0) part_sse[slot] = block_sse;
}

// Sum the G per-block partials of every output element, g = 0, 1, ... in
// order (the fixed order that makes the step deterministic).
__global__ void lloyd_reduce_kernel(const float* __restrict__ part_sums,
                                    const float* __restrict__ part_counts,
                                    const float* __restrict__ part_sse, int B,
                                    int G, int K, int d,
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

template <int DP>
int launch(const void* x, int64_t x_bs, int x_bf16, const void* w,
           int64_t w_bs, int w_bf16, const void* c, int64_t c_bs, int c_bf16,
           int B, int M, int K, int d, int bk, int G, int acc_smem,
           int32_t* idx, float* dist, float* part_sums, float* part_counts,
           float* part_sse, float* sums, float* counts, float* sse,
           cudaStream_t stream) {
  size_t smem = static_cast<size_t>(bk) * center_stride(DP, d) * sizeof(float) +
                3 * kThreads * sizeof(float);
  if (acc_smem) smem += static_cast<size_t>(K) * (d + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lloyd_partial_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  lloyd_partial_kernel<DP><<<dim3(G, B), kThreads, smem, stream>>>(
      x, x_bs, x_bf16, w, w_bs, w_bf16, c, c_bs, c_bf16, M, K, d, bk, acc_smem,
      idx, dist, part_sums, part_counts, part_sse);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t total = static_cast<int64_t>(B) * K * (d + 1) + B;
  const int blocks = static_cast<int>(
      total / kThreads + 1 < 4096 ? total / kThreads + 1 : 4096);
  lloyd_reduce_kernel<<<blocks, kThreads, 0, stream>>>(
      part_sums, part_counts, part_sse, B, G, K, d, sums, counts, sse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// Strides are in elements.  dp (register width), bk (centers per staged
// tile), G (blocks per batch entry) and acc_smem come from
// repro_torch/kernels/tiles.py.  Returns the launches' cudaGetLastError().
extern "C" int repro_lloyd_step(const void* x, long long x_bs, int x_bf16,
                                const void* w, long long w_bs, int w_bf16,
                                const void* c, long long c_bs, int c_bf16,
                                int B, int M, int K, int d, int dp, int bk,
                                int G, int acc_smem, int32_t* idx, float* dist,
                                float* part_sums, float* part_counts,
                                float* part_sse, float* sums, float* counts,
                                float* sse, void* stream) {
  REPRO_DISPATCH_DP(dp, repro::launch, x, x_bs, x_bf16, w, w_bs, w_bf16, c,
                    c_bs, c_bf16, B, M, K, d, bk, G, acc_smem, idx, dist,
                    part_sums, part_counts, part_sse, sums, counts, sse,
                    static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_lloyd_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
