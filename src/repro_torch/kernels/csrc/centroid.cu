// Weighted centroid update (segment sum) on Hopper (sm_90a): for each batch
// entry, the raw weighted per-cluster sums of the points and their weights,
// given each point's cluster id.
//
// Replaces the TPU kernel repro/kernels/centroid.py::_centroid_kernel
// (centroid_update_pallas).  The TPU has no fast scatter, so that kernel
// multiplies a (block, K) one-hot matrix into the points on the MXU and
// carries the (K, d) sums across a sequential grid.  Hopper scatters into
// shared memory directly, so there is no one-hot matrix here: the Lloyd
// kernel's accumulation (accumulate.cuh) without its distance pass.  Each
// block walks its 256-point tiles in order, stages each point's cluster and
// weight, and thread t adds the tile's points of clusters t, t + 256, ...,
// found through per-warp ownership masks;
// a second small kernel sums the blocks' partials in a fixed order.  No
// float atomics: two launches on the same inputs are bit-identical.
//
// What bounds it: bytes (x, idx and w are read once; the partials are
// written and read once), about (d + 2) operations per point.  The design
// reads each point once, in the block that owns its tile: for d <= 32 each
// thread also stages its own point's row in shared memory (a coalesced
// read), so the owner loop adds from shared memory instead of waiting on
// one scattered global load per point.
//
// A point adds nothing when its weight is 0 or its id lies outside [0, K)
// (masked capacity slots), as with the JAX package's one-hot.
//
// Layout: x (B, M, d), idx (B, M) and w (B, M) with batch strides; scratch
// (B, G, K, d) / (B, G, K), sums (B, K, d), counts (B, K) contiguous f32.
#include "accumulate.cuh"

namespace repro {
namespace {

// Widest point staged in shared memory per tile (256 x 32 f32 = 32 KB).
constexpr int kStageDims = 32;

__global__ void __launch_bounds__(kThreads)
centroid_partial_kernel(const void* __restrict__ x, int64_t x_bs, int x_bf16,
                        const int32_t* __restrict__ idx, int64_t idx_bs,
                        const void* __restrict__ w, int64_t w_bs, int w_bf16,
                        int M, int K, int d, int acc_smem, int stage_x,
                        float* __restrict__ part_sums,
                        float* __restrict__ part_counts) {
  extern __shared__ float4 smem4[];
  int* sidx = reinterpret_cast<int*>(smem4);
  float* sw = reinterpret_cast<float*>(sidx + kThreads);
  uint32_t* owners = reinterpret_cast<uint32_t*>(sw + kThreads);
  float* sx = reinterpret_cast<float*>(owners + kWarps * kThreads);
  // sx: the tile's rows, f32 (stage_x); sacc: K * d sums, then K counts
  float* sacc = sx + (stage_x ? kThreads * d : 0);

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
  __syncthreads();

  const int64_t xbase = static_cast<int64_t>(b) * x_bs;
  const int n_tiles = (M + kThreads - 1) / kThreads;
  for (int tile = g; tile < n_tiles; tile += G) {
    const int m = tile * kThreads + t;
    const bool valid = m < M;
    const float wv =
        valid ? load_f32(w, static_cast<int64_t>(b) * w_bs + m, w_bf16) : 0.f;
    const int k = valid ? idx[static_cast<int64_t>(b) * idx_bs + m] : -1;
    const bool live = valid && wv != 0.f && k >= 0 && k < K;
    sidx[t] = live ? k : -1;
    sw[t] = wv;
    register_point(owners, live ? k : -1);
    if (stage_x && live) {
      const int64_t row = xbase + static_cast<int64_t>(m) * d;
      for (int j = 0; j < d; ++j) sx[t * d + j] = load_f32(x, row + j, x_bf16);
    }
    __syncthreads();
    if (stage_x)
      accumulate_tile(acc_sums, acc_counts, owners, sidx, sw, sx, 0, d, 0);
    else
      accumulate_tile(acc_sums, acc_counts, owners, sidx, sw, x,
                      xbase + static_cast<int64_t>(tile) * kThreads * d, d,
                      x_bf16);
    __syncthreads();  // sidx / sw / sx are rewritten by the next tile
  }

  if (acc_smem)
    store_partials(acc_sums, acc_counts, part_sums, part_counts, slot, K, d);
}

}  // namespace
}  // namespace repro

// Strides are in elements.  G (blocks per batch entry) and acc_smem come
// from repro_torch/kernels/tiles.py.  Returns the launches'
// cudaGetLastError().
extern "C" int repro_centroid_update(const void* x, long long x_bs, int x_bf16,
                                     const int32_t* idx, long long idx_bs,
                                     const void* w, long long w_bs, int w_bf16,
                                     int B, int M, int K, int d, int G,
                                     int acc_smem, float* part_sums,
                                     float* part_counts, float* sums,
                                     float* counts, void* stream) {
  using namespace repro;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int stage_x = d <= kStageDims;
  size_t smem = (2 + kWarps + (stage_x ? d : 0)) * kThreads * sizeof(float);
  if (acc_smem) smem += static_cast<size_t>(K) * (d + 1) * sizeof(float);
  cudaError_t e = allow_smem(centroid_partial_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  centroid_partial_kernel<<<dim3(G, B), kThreads, smem, s>>>(
      x, x_bs, x_bf16, idx, idx_bs, w, w_bs, w_bf16, M, K, d, acc_smem,
      stage_x, part_sums, part_counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_reduce(part_sums, part_counts, nullptr, B, G, K, d, sums,
                       counts, nullptr, s);
}

extern "C" const char* repro_centroid_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
