// Fused Lloyd step on Hopper (sm_90a): in one pass over the points of each
// batch entry, the nearest center of every point (idx, dist) and the raw
// weighted per-cluster statistics (sums, counts) and weighted SSE.
//
// Replaces the TPU kernel repro/kernels/lloyd.py::_lloyd_kernel
// (lloyd_step_pallas), which zeroes its (K, d) accumulators at grid step
// (0, 0) and carries them across a *sequential* grid.  Here the statistics
// are per-block partials summed in a fixed order (accumulate.cuh), with no
// float atomics anywhere: a repeated step is bit-identical.
//
// What bounds it: FP32 CUDA-core work, as for assign.cu (about seven
// operations per (point, center) pair at d=2; the bytes are tiny).  The
// distance pass is assign.cu's: one thread owns one point in registers and
// walks the centers staged in shared memory with |c|^2 precomputed.  The
// accumulation (accumulate.cuh) adds O(M (d + 1)) work on top of O(M K d);
// per tile the block also stages w * dist and reduces the SSE with a
// fixed-shape tree.  Rows with w = 0 (capacity padding) get idx/dist and add
// nothing.
//
// Layout: x (B, M, d) and w (B, M) with batch strides (0 lets restarts share
// one pool), c (B, K, d) with a batch stride; idx/dist (B, M), scratch
// (B, G, K, d) / (B, G, K) / (B, G), sums (B, K, d), counts (B, K), sse (B,)
// contiguous f32 (idx int32).
#include "accumulate.cuh"

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
  uint32_t* owners = reinterpret_cast<uint32_t*>(sred + kThreads);
  float* sacc = reinterpret_cast<float*>(owners + kWarps * kThreads);
  // sacc: K * d sums, then K counts (acc_smem)

  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int g = blockIdx.x;
  const int G = gridDim.x;
  const int64_t slot = static_cast<int64_t>(b) * G + g;
  float* acc_sums = acc_smem ? sacc : part_sums + slot * K * d;
  float* acc_counts =
      acc_smem ? sacc + static_cast<int64_t>(K) * d : part_counts + slot * K;
  zero_acc(acc_sums, acc_counts, K, d);
  zero_owners(owners);

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
    register_point(owners, live ? best_k : -1);
    __syncthreads();

    // the tile's weighted SSE: a tree of fixed shape, so a fixed order
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (t < s) sred[t] += sred[t + s];
      __syncthreads();
    }
    if (t == 0) block_sse += sred[0];

    accumulate_tile(acc_sums, acc_counts, owners, sidx, sw, x,
                    xbase + static_cast<int64_t>(tile) * kThreads * d, d,
                    x_bf16);
    __syncthreads();  // sidx / sw / sred are rewritten by the next tile
  }

  if (acc_smem)
    store_partials(acc_sums, acc_counts, part_sums, part_counts, slot, K, d);
  if (t == 0) part_sse[slot] = block_sse;
}

template <int DP>
int launch(const void* x, int64_t x_bs, int x_bf16, const void* w,
           int64_t w_bs, int w_bf16, const void* c, int64_t c_bs, int c_bf16,
           int B, int M, int K, int d, int bk, int G, int acc_smem,
           int32_t* idx, float* dist, float* part_sums, float* part_counts,
           float* part_sse, float* sums, float* counts, float* sse,
           cudaStream_t stream) {
  size_t smem = static_cast<size_t>(bk) * center_stride(DP, d) * sizeof(float) +
                (3 + kWarps) * kThreads * sizeof(float);
  if (acc_smem) smem += static_cast<size_t>(K) * (d + 1) * sizeof(float);
  cudaError_t e = allow_smem(lloyd_partial_kernel<DP>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  lloyd_partial_kernel<DP><<<dim3(G, B), kThreads, smem, stream>>>(
      x, x_bs, x_bf16, w, w_bs, w_bf16, c, c_bs, c_bf16, M, K, d, bk, acc_smem,
      idx, dist, part_sums, part_counts, part_sse);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_reduce(part_sums, part_counts, part_sse, B, G, K, d, sums,
                       counts, sse, stream);
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
