// Nearest-center assignment on Hopper (sm_90a): for each point of each batch
// entry, the id of its nearest center and the squared distance to it.
//
// Replaces the TPU kernel repro/kernels/assign.py::_assign_kernel
// (assign_argmin_pallas), which walks K tiles in a sequential grid carrying
// a running (min, argmin) in its VMEM output blocks.  Two routes, chosen by
// shape in repro_torch/kernels/tiles.py (assign_route):
//
//   * SIMT route (d < 32: the paper's d = 2 predict and fit).  What bounds
//     it: FP32 issue and the ALU pipe, which runs the clamp, compares and
//     selects at half the FMA pipe's rate, while the bytes are tiny.  A
//     one-pass argmin spends d + 6 instructions a pair, four of them on
//     the ALU pipe (the clamp, the compare and two selects).  The design
//     keeps every pair on chip and moves the compare and the selects off
//     the pair:
//       - a register tile: each thread holds P points, so one broadcast
//         shared-memory load of a center (its coordinates and |c|^2, staged
//         once per block by distance.cuh's stage_centers) feeds P pairs;
//       - a block of kBlock centers costs each pair only its unclamped
//         distance and a running min (d + 3 instructions, one on the ALU
//         pipe), in Q independent streams (center kk in stream kk % Q); at
//         the block's end the streams' mins are combined, clamped at 0
//         (the clamp is monotonic, so it commutes with the min) and
//         compared with the point's best by a strict <, blocks in
//         increasing center order, so best is the smallest distance and
//         blk the first block holding it;
//       - the index is then the first center of that block whose distance
//         equals best, by the same arithmetic again: exactly the answer of
//         one strict-< scan in increasing order (ties to the lowest index);
//       - the per-pair arithmetic is distance.cuh's argmin_tile's, which
//         the Lloyd kernel's SIMT route runs, so idx and dist equal that
//         route's bit for bit; only the subtract of 2 x.c is written as one
//         fused multiply-add, which nvcc does not form from argmin_tile's
//         expression (one instruction a pair less, the same value: see
//         pair_raw);
//       - one wave: a warp's work item is 32 * P consecutive points, item i
//         goes to block i % G of its entry, and G is sized so the B entries'
//         blocks fill the slots the runtime's occupancy reports, so every
//         block, and every SM, gets the same work to within one item;
//       - a batch too small to give every warp scheduler two such items,
//         or a point wider than 16 registers, takes one point per thread
//         and argmin_tile's one-pass scan instead (tiles.assign_points).
//
//   * Tensor-core route (d >= 32, where it measured faster: the index's
//     routing of chunks to cells, the sampler's assignment at d = 32, and
//     every d past 128, where the SIMT scan would read the point from
//     device memory for each center).  The Lloyd kernel's tensor-core
//     argmin (tc_argmin.cuh: three TF32 passes, fp32-class distances, ties
//     by a lexicographic merge) without its SSE partials.
//
// Ragged M is masked; ragged K is never visited.  No atomics: a repeated
// launch is bit-identical.
//
// Layout: x (B, M, d) with a batch stride (0 lets B restarts share one point
// set), c (B, K, d) with a batch stride, idx/dist (B, M) contiguous.
#include "tc_argmin.cuh"

namespace repro {
namespace {

constexpr int kWarps = kThreads / 32;

// argmin_tile's squared distance of one point (DP registers, |x|^2 = x2) to
// one staged center (S / 4 float4s: DP coordinates, then |c|^2) before its
// clamp: |x|^2 + |c|^2 - 2 x.c, the cross term one coordinate at a time in
// increasing order.  argmin_tile's (|x|^2 + |c|^2) - 2 x.c compiles to a
// doubling and a subtract; 2 x.c is exact, so the fused multiply-add below
// rounds the same exact value once, as that subtract does.
template <int DP>
__device__ __forceinline__ float pair_raw(const float4* e, const float* xr,
                                          float x2) {
  constexpr int S = center_stride(DP, 0);
  float dot = 0.f, c2 = 0.f;
#pragma unroll
  for (int q = 0; q < S / 4; ++q) {
    const float v[4] = {e[q].x, e[q].y, e[q].z, e[q].w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 4 * q + r;
      if (j < DP) dot = fmaf(xr[j], v[r], dot);
      else if (j == DP) c2 = v[r];
    }
  }
  return fmaf(-2.f, dot, x2 + c2);
}

constexpr int kBlock = 32;  // centers per block of the SIMT route's min scan

// The smallest distance of each of the thread's P points over the staged
// centers [0, nk) (global ids k0 + kk), kBlock centers at a time: within a
// block a running min of pair_raw per point and stream (center kk in
// stream kk % Q); the clamp at 0, monotonic, is applied once to the
// block's min (the min of the clamped distances, for any finite one); then
// one strict-< compare per point with its best; blk is set to the global
// id of the first center of the block where best last fell.
template <int DP, int P, int Q>
__device__ __forceinline__ void min_blocks(const float* cs, int nk, int k0,
                                           const float (&xr)[P][DP],
                                           const float (&x2)[P],
                                           float (&best)[P], int (&blk)[P]) {
  constexpr int S = center_stride(DP, 0);
  for (int kb = 0; kb < nk; kb += kBlock) {
    float bm[P][Q];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int q = 0; q < Q; ++q) bm[p][q] = INFINITY;
    auto fold = [&](int kk, int q) {
      float4 e[S / 4];
      const float4* c4 = reinterpret_cast<const float4*>(cs + kk * S);
#pragma unroll
      for (int i = 0; i < S / 4; ++i) e[i] = c4[i];
#pragma unroll
      for (int p = 0; p < P; ++p)
        bm[p][q] = fminf(bm[p][q], pair_raw<DP>(e, xr[p], x2[p]));
    };
    if (kb + kBlock <= nk) {
#pragma unroll 2
      for (int kk = 0; kk < kBlock; kk += Q)
#pragma unroll
        for (int q = 0; q < Q; ++q) fold(kb + kk + q, q);
    } else {
      for (int kk = kb; kk < nk; ++kk) fold(kk, 0);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float m = bm[p][0];
#pragma unroll
      for (int q = 1; q < Q; ++q) m = fminf(m, bm[p][q]);
      m = fmaxf(m, 0.f);
      if (m < best[p]) {
        best[p] = m;
        blk[p] = k0 + kb;
      }
    }
  }
}

// The global id of the first staged center (from k0) of the block starting
// at blk whose (clamped) distance to the point is best.
template <int DP>
__device__ __forceinline__ int first_at(const float* cs, int nk, int k0,
                                        int blk, const float* xr, float x2,
                                        float best) {
  constexpr int S = center_stride(DP, 0);
  const int end = min(blk - k0 + kBlock, nk);
  int kk = blk - k0;
  while (kk + 1 < end &&
         fmaxf(pair_raw<DP>(reinterpret_cast<const float4*>(cs + kk * S), xr,
                            x2),
               0.f) != best)
    ++kk;
  return k0 + kk;
}

template <int DP, int P, int Q>
__global__ void __launch_bounds__(kThreads)
assign_kernel(const void* __restrict__ x, int64_t x_bs, int x_bf16,
              const void* __restrict__ c, int64_t c_bs, int c_bf16, int M,
              int K, int d, int bk, int32_t* __restrict__ idx,
              float* __restrict__ dist) {
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);
  constexpr int DR = DP > 0 ? DP : 1;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.y, g = blockIdx.x, G = gridDim.x;
  const int n_items = (M + 32 * P - 1) / (32 * P);
  const int per_round = G * kWarps;
  const int rounds = (n_items + per_round - 1) / per_round;
  const int64_t xbase = static_cast<int64_t>(b) * x_bs;
  const int64_t cbase = static_cast<int64_t>(b) * c_bs;
  const bool resident = bk >= K;  // every center staged once per block
  if (resident) {
    stage_centers<DP>(cs, c, cbase, 0, K, d, c_bf16);
    __syncthreads();
  }

  for (int r = 0; r < rounds; ++r) {
    const int item = g + G * (warp + kWarps * r);
    const bool live = item < n_items;  // warp-uniform
    float xr[P][DR], x2[P];
    int64_t xrow[P];
    bool valid[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int m = item * 32 * P + 32 * p + lane;
      valid[p] = live && m < M;
      xrow[p] = xbase + static_cast<int64_t>(valid[p] ? m : 0) * d;
      x2[p] = load_point<DP>(xr[p], x, xrow[p], d, x_bf16, valid[p]);
    }
    float best[P];
    int best_k[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      best[p] = INFINITY;
      best_k[p] = 0;
    }
    for (int k0 = 0; k0 < K; k0 += bk) {
      const int nk = min(bk, K - k0);
      if (!resident) {
        __syncthreads();  // the previous tile is no longer read
        stage_centers<DP>(cs, c, cbase, k0, nk, d, c_bf16);
        __syncthreads();
      }
      if (!live) continue;
      if constexpr (DP > 0 && P * Q > 1) {
        int blk[P];
#pragma unroll
        for (int p = 0; p < P; ++p) blk[p] = -1;
        min_blocks<DP, P, Q>(cs, nk, k0, xr, x2, best, blk);
#pragma unroll
        for (int p = 0; p < P; ++p)  // the index, while the tile is staged
          if (blk[p] >= 0)
            best_k[p] = first_at<DP>(cs, nk, k0, blk[p], xr[p], x2[p],
                                     best[p]);
      } else {
        argmin_tile<DP>(cs, nk, k0, xr[0], x2[0], x, xrow[0], d, x_bf16,
                        best[0], best_k[0]);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (valid[p]) {
        const int64_t o =
            static_cast<int64_t>(b) * M + item * 32 * P + 32 * p + lane;
        idx[o] = best_k[p];
        dist[o] = best[p];
      }
  }
}

// The kernel at register width DP: with the register tile of 4 points and
// 4 streams (`wide`, DP <= 16 only), else one point per thread and
// argmin_tile's one-pass scan (fewer points than fill the card with
// 128-point items, wider d, or the point read from device memory).
template <int DP>
auto kernel_of(int wide) {
  if constexpr (DP > 0 && DP <= 16)
    if (wide) return assign_kernel<DP, 4, 4>;
  return assign_kernel<DP, 1, 1>;
}

template <int DP>
int launch(const void* x, int64_t x_bs, int x_bf16, const void* c,
           int64_t c_bs, int c_bf16, int B, int M, int K, int d, int bk,
           int wide, int G, int32_t* idx, float* dist, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(bk) * center_stride(DP, d) * sizeof(float);
  auto kernel = kernel_of<DP>(wide);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(G, B), kThreads, smem, stream>>>(
      x, x_bs, x_bf16, c, c_bs, c_bf16, M, K, d, bk, idx, dist);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int occupancy(int d, int bk, int wide, int* per_sm) {
  const size_t smem =
      static_cast<size_t>(bk) * center_stride(DP, d) * sizeof(float);
  auto kernel = kernel_of<DP>(wide);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kernel, kThreads, smem));
}

}  // namespace
}  // namespace repro

// SIMT route.  Strides are in elements.  dp is the register width (2..128,
// or 0 for d > 128, which only route_argmin's forced route reaches), bk the
// centers staged per tile, wide whether each thread holds 4 points, and G
// the blocks per batch entry, all from repro_torch/kernels/tiles.py.
// Returns the launch's cudaGetLastError().
extern "C" int repro_assign_argmin(const void* x, long long x_bs, int x_bf16,
                                   const void* c, long long c_bs, int c_bf16,
                                   int B, int M, int K, int d, int dp, int bk,
                                   int wide, int G, int32_t* idx, float* dist,
                                   void* stream) {
  REPRO_DISPATCH_DP(dp, repro::launch, x, x_bs, x_bf16, c, c_bs, c_bf16, B, M,
                    K, d, bk, wide, G, idx, dist,
                    static_cast<cudaStream_t>(stream));
}

// The SIMT kernel's blocks per SM, as the runtime's occupancy calculator
// reports them, for the launch repro_assign_argmin would make.
extern "C" int repro_assign_occupancy(int d, int dp, int bk, int wide,
                                      int* per_sm) {
  REPRO_DISPATCH_DP(dp, repro::occupancy, d, bk, wide, per_sm);
}

// Tensor-core route: the pre-pass and the argmin in the workspace work
// (n_work floats, tiles.tc_work_floats).
extern "C" int repro_assign_tc(const void* x, long long x_bs, int x_bf16,
                               const void* c, long long c_bs, int c_bf16,
                               int B, int M, int K, int d, float* work,
                               long long n_work, int32_t* idx, float* dist,
                               void* stream) {
  return static_cast<int>(repro::tc::launch_argmin(
      x, x_bs, x_bf16, nullptr, 0, 0, c, c_bs, c_bf16, B, M, K, d, work,
      n_work, idx, dist, nullptr, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* repro_assign_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
