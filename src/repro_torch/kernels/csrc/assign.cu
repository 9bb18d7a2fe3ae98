// Nearest-center assignment on Hopper (sm_90a): for each point of each batch
// entry, the id of its nearest center and the squared distance to it.
//
// Replaces the TPU kernel repro/kernels/assign.py::_assign_kernel
// (assign_argmin_pallas), which walks K tiles in a sequential grid carrying
// a running (min, argmin) in its VMEM output blocks.
//
// What bounds it here: FP32 CUDA-core work.  At the paper's d=2 the cross
// term is two FMAs per (point, center) pair, too thin for the tensor cores;
// with the norm add, the clamp and the compare it is about seven operations
// a pair, while the bytes (x, c and the (M,) outputs) are tiny.  The design
// keeps every pair on chip: one thread owns one point in registers and walks
// the centers, which the block stages in shared memory with |c|^2
// precomputed (one broadcast float4 load per pair at d=2), keeping the
// running (min, argmin) in registers.  The (M, K) distance matrix never
// exists.  Ragged M is masked per thread; ragged K is never visited.
//
// Layout: x (B, M, d) with a batch stride (0 lets B restarts share one point
// set), c (B, K, d) with a batch stride, idx/dist (B, M) contiguous.
// Grid (ceil(M / 256), B), one point per thread.
#include "distance.cuh"

namespace repro {
namespace {

template <int DP>
__global__ void __launch_bounds__(kThreads)
assign_kernel(const void* __restrict__ x, int64_t x_bs, int x_bf16,
              const void* __restrict__ c, int64_t c_bs, int c_bf16, int M,
              int K, int d, int bk, int32_t* __restrict__ idx,
              float* __restrict__ dist) {
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y;
  const int m = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = m < M;
  const int64_t xrow =
      static_cast<int64_t>(b) * x_bs + static_cast<int64_t>(valid ? m : 0) * d;

  float xr[DP > 0 ? DP : 1];
  const float x2 = load_point<DP>(xr, x, xrow, d, x_bf16, valid);
  float best = INFINITY;
  int best_k = 0;
  for (int k0 = 0; k0 < K; k0 += bk) {
    const int nk = min(bk, K - k0);
    __syncthreads();  // the previous tile is no longer read
    stage_centers<DP>(cs, c, static_cast<int64_t>(b) * c_bs, k0, nk, d,
                      c_bf16);
    __syncthreads();
    if (valid)
      argmin_tile<DP>(cs, nk, k0, xr, x2, x, xrow, d, x_bf16, best, best_k);
  }
  if (valid) {
    const int64_t o = static_cast<int64_t>(b) * M + m;
    idx[o] = best_k;
    dist[o] = best;
  }
}

template <int DP>
int launch(const void* x, int64_t x_bs, int x_bf16, const void* c,
           int64_t c_bs, int c_bf16, int B, int M, int K, int d, int bk,
           int32_t* idx, float* dist, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(bk) * center_stride(DP, d) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        assign_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((M + kThreads - 1) / kThreads, B);
  assign_kernel<DP><<<grid, kThreads, smem, stream>>>(
      x, x_bs, x_bf16, c, c_bs, c_bf16, M, K, d, bk, idx, dist);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// Strides are in elements.  dp is the register width (2..128, or 0 for
// d > 128) and bk the centers staged per tile, both from
// repro_torch/kernels/tiles.py.  Returns the launch's cudaGetLastError().
extern "C" int repro_assign_argmin(const void* x, long long x_bs, int x_bf16,
                                   const void* c, long long c_bs, int c_bf16,
                                   int B, int M, int K, int d, int dp, int bk,
                                   int32_t* idx, float* dist, void* stream) {
  REPRO_DISPATCH_DP(dp, repro::launch, x, x_bs, x_bf16, c, c_bs, c_bf16, B, M,
                    K, d, bk, idx, dist, static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_assign_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
