// Lloyd step on Hopper (sm_90a): for every batch entry, the nearest center
// of every point (idx, dist) and the raw weighted per-cluster statistics
// (sums, counts) and weighted SSE.
//
// Replaces the TPU kernel repro/kernels/lloyd.py::_lloyd_kernel
// (lloyd_step_pallas), which zeroes its (K, d) accumulators at grid step
// (0, 0) and carries them across a *sequential* grid.  Two routes, chosen by
// shape in repro_torch/kernels/tiles.py (lloyd_route):
//
//   * Tensor-core route, d >= 32 (the KV-cache refresh: 256 lanes x 9216
//     points x 8192 centers at llama's d = 128, 64 lanes at gemma's
//     d = 256; the index's coarse fits).  Bound by the tensor cores' TF32
//     rate: the cross term runs in three TF32 passes (tc_argmin.cuh), a
//     pre-pass splits the points and the centers into TF32 planes of whole
//     32-dim chunks with their norms (what the argmin streams), a
//     small reduction sums the blocks' SSE partials in block order, and the
//     statistics come from the centroid update's kernels (centroid.cu,
//     launched by the Python wrapper) on the labels this route wrote: they
//     sum each cluster's points in point order, with no (B, G, K, d)
//     scratch.
//
//   * SIMT route, small d (the paper's d = 2 local and merge stages, the PQ
//     codebooks at d = 1).  Bound by FP32 issue, while the bytes are tiny.
//     One thread owns one point in registers and walks the centers staged
//     in shared memory with |c|^2, by the assign kernel's distance scan
//     (distance.cuh: the clamped expanded-form distance, the plain
//     version's expression); the block then adds its tile's points to
//     private per-cluster partials (accumulate.cuh: owners found by
//     ballots), reduces the tile's weighted SSE with warp shuffles and a
//     fixed-order sum of the eight warp sums, and a second small kernel sums
//     the G blocks' partials in block order.  G is sized from the blocks
//     the card holds at once (the occupancy the runtime reports), so no
//     launch has a partial second wave.
//
// Ties go to the lowest center index on both routes (a strict < in center
// order; lexicographic (d2, k) merges on the tensor cores).  There are no
// float atomics anywhere: a repeated step is bit-identical.  Rows with
// w = 0 (capacity padding) get idx/dist and add nothing.
//
// Layout: x (B, M, d) and w (B, M) with batch strides (0 lets restarts share
// one pool), c (B, K, d) with a batch stride; idx/dist (B, M), sums
// (B, K, d), counts (B, K), sse (B,) contiguous f32 (idx int32).  SIMT
// scratch: (B, G, K, d) / (B, G, K) / (B, G); tensor-core scratch: |c|^2
// (B, K), the SSE partials (B, ceil(M / 128)) and the center copy
// (B, K, dims(d)).
#include "accumulate.cuh"
#include "tc_argmin.cuh"

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
  uint32_t* owners = reinterpret_cast<uint32_t*>(sw + kThreads);
  float* wsse = reinterpret_cast<float*>(owners + kWarps * kThreads);
  float* sacc = wsse + kWarps;
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
  const int nbits = 32 - __clz(min(K, kThreads));

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
    register_point(owners, live ? best_k : -1, nbits);
    const float wsum = warp_sum(live ? wv * best : 0.f);
    if ((t & 31) == 0) wsse[t >> 5] = wsum;
    __syncthreads();

    if (t == 0) {  // the tile's weighted SSE: warp sums in warp order
      float s = 0.f;
      for (int v = 0; v < kWarps; ++v) s += wsse[v];
      block_sse += s;
    }
    accumulate_tile(acc_sums, acc_counts, owners, sidx, sw, x,
                    xbase + static_cast<int64_t>(tile) * kThreads * d, d,
                    x_bf16);
    __syncthreads();  // sidx / sw / wsse are rewritten by the next tile
  }

  if (acc_smem)
    store_partials(acc_sums, acc_counts, part_sums, part_counts, slot, K, d);
  if (t == 0) part_sse[slot] = block_sse;
}

template <int DP>
size_t simt_smem(int K, int d, int bk, int acc_smem) {
  size_t smem = static_cast<size_t>(bk) * center_stride(DP, d) * sizeof(float) +
                ((2 + kWarps) * kThreads + kWarps) * sizeof(float);
  if (acc_smem) smem += static_cast<size_t>(K) * (d + 1) * sizeof(float);
  return smem;
}

template <int DP>
int launch(const void* x, int64_t x_bs, int x_bf16, const void* w,
           int64_t w_bs, int w_bf16, const void* c, int64_t c_bs, int c_bf16,
           int B, int M, int K, int d, int bk, int G, int acc_smem,
           int32_t* idx, float* dist, float* part_sums, float* part_counts,
           float* part_sse, float* sums, float* counts, float* sse,
           cudaStream_t stream) {
  const size_t smem = simt_smem<DP>(K, d, bk, acc_smem);
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

// Blocks of the SIMT kernel resident on one SM, and its shared memory.
template <int DP>
int occupancy(int K, int d, int bk, int acc_smem, int* per_sm, int* smem) {
  const size_t bytes = simt_smem<DP>(K, d, bk, acc_smem);
  *smem = static_cast<int>(bytes);
  cudaError_t e = allow_smem(lloyd_partial_kernel<DP>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, lloyd_partial_kernel<DP>, kThreads, bytes));
}

}  // namespace
}  // namespace repro

// SIMT route.  Strides are in elements.  dp (register width), bk (centers
// per staged tile), G (blocks per batch entry) and acc_smem come from
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

// The SIMT kernel's blocks per SM (as the runtime's occupancy calculator
// reports them) and its shared memory per block, for the launch
// repro_lloyd_step would make.
extern "C" int repro_lloyd_simt_occupancy(int K, int d, int dp, int bk,
                                          int acc_smem, int* per_sm,
                                          int* smem) {
  REPRO_DISPATCH_DP(dp, repro::occupancy, K, d, bk, acc_smem, per_sm, smem);
}

// Tensor-core route, up to the statistics: the pre-pass and the argmin in
// the workspace work (n_work floats, tiles.tc_work_floats), with per-block
// SSE partials (part_sse (B, ceil(M / 128))), and their sum in block order.
extern "C" int repro_lloyd_tc(const void* x, long long x_bs, int x_bf16,
                              const void* w, long long w_bs, int w_bf16,
                              const void* c, long long c_bs, int c_bf16,
                              int B, int M, int K, int d, float* work,
                              long long n_work, int32_t* idx, float* dist,
                              float* part_sse, float* sse, void* stream) {
  using namespace repro;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = tc::launch_argmin(
      x, x_bs, x_bf16, w, w_bs, w_bf16, c, c_bs, c_bf16, B, M, K, d, work,
      n_work, idx, dist, part_sse, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_reduce(nullptr, nullptr, part_sse, B,
                       (M + tc::kRows - 1) / tc::kRows, 0, d, nullptr,
                       nullptr, sse, s);
}

extern "C" const char* repro_lloyd_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
