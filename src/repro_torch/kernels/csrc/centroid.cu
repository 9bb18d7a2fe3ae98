// Weighted centroid update (segment sum) on Hopper (sm_90a): for each batch
// entry (lane), the raw weighted per-cluster sums of the points and their
// weights, given each point's cluster id.
//
// Replaces the TPU kernel repro/kernels/centroid.py::_centroid_kernel
// (centroid_update_pallas).  The TPU has no fast scatter, so that kernel
// multiplies a (block, K) one-hot matrix into the points on the MXU and
// carries the (K, d) sums across a sequential grid.  Here there is no
// one-hot matrix and no float atomic, so a repeated launch is bit-identical.
// Two designs, chosen by shape in repro_torch/kernels/tiles.py
// (centroid_sorts):
//
//   * Warp-private accumulators in shared memory, ONE launch, when a lane's
//     (K, d+1) accumulator fits shared memory (the clustering fit's local
//     and merge stages, the PQ codebooks).  Each warp of a block keeps its
//     own accumulator and walks its share of the lane's 32-point tiles in
//     order (the ids, weights and rows of the next 2 to 4 tiles load while
//     the current one is added).  The warp groups its 32 points by
//     cluster (one ballot per bit of the id) and adds them in rounds, one
//     point of each group per round in lane order, so the points of one
//     round go to distinct clusters: no atomics, no block barrier in the
//     loop.  The block sums
//     its warps' accumulators in warp order into its partial; the last
//     block of the lane to finish, found with an integer counter, sums the
//     G partials in block order g = 0, 1, ... and resets the counter.
//
//   * Counting sort, then a segmented sum, when it does not (the KV-cache
//     refresh's values: K = 8192, d = 128, 4.2 MB per lane).  Work scales
//     with M d, not G K d:
//       1. one block per lane takes the histogram of its live ids and an
//          exclusive scan of it (each cluster's segment), then puts every
//          live point into its cluster's segment; both with integer
//          shared-memory atomics, so the counts and each segment's set of
//          points do not depend on order (only their places inside it);
//       2. a group of lanes sized to d takes one cluster: it puts a segment
//          of more than one point in increasing point order (each point's
//          rank among the segment's ids), then sums the rows in that order
//          with coalesced loads and writes the cluster's row of sums and its
//          count exactly once.  No zeroing, no per-block partials, no
//          reduction pass, no float atomics.
//
// What bounds it: bytes (x, idx and w are read once, sums and counts written
// once; about 2 d + 1 operations per point).  The sort path adds a second
// read of the ids and weights and the (B, M) permutation and its weights
// (8 to 16 bytes per point beside 4 d of row).
//
// A point adds nothing when its weight is 0 or its id lies outside [0, K)
// (masked capacity slots), as with the JAX package's one-hot.
//
// Layout: x (B, M, d), idx (B, M) and w (B, M) with batch strides; sums
// (B, K, d), counts (B, K) contiguous f32.  Warp path scratch: partials
// (B, G, K (d + 1)) f32 and done (B,) int32, zero on entry and left zero.
// Sort path scratch: offsets (B, K + 1) int32, and two (B, M) int32
// permutations with their (B, M) f32 weights.
#include "distance.cuh"
#include "warp.cuh"

namespace repro {
namespace {

// Widest point the warp path holds in registers; wider rows are read from
// device memory as they are added.
constexpr int kStageDims = 32;
constexpr int kOwnerWarps = 8;   // most warps (accumulators) per block
constexpr int kSortThreads = 1024;
constexpr int kSegThreads = 256;
constexpr int kSegCols = 4;      // columns per lane per pass of a segment

// ---------------------------------------------------------------------------
// warp-accumulator path
// ---------------------------------------------------------------------------

// DS: registers for a point's row (>= d), or 0 (d > kStageDims: the row is
// read from device memory when it is added).  Block (g, b) has W warps, each
// with its own (K, d+1) accumulator in shared memory; warp w of block g
// takes the lane's 32-point tiles g W + w, (g + G) W + w, ... in order.
template <int DS>
__global__ void __launch_bounds__(kOwnerWarps * 32)
centroid_warps_kernel(const void* __restrict__ x, int64_t x_bs, int x_bf16,
                      const int32_t* __restrict__ idx, int64_t idx_bs,
                      const void* __restrict__ w, int64_t w_bs, int w_bf16,
                      int M, int K, int d, float* __restrict__ part,
                      int* __restrict__ done, float* __restrict__ sums,
                      float* __restrict__ counts) {
  // W x (K d sums, then K counts), each padded to whole float4s
  extern __shared__ float4 sacc4[];
  float* sacc = reinterpret_cast<float*>(sacc4);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int W = blockDim.x >> 5;
  const int b = blockIdx.y;
  const int g = blockIdx.x;
  const int G = gridDim.x;
  const int64_t kd = static_cast<int64_t>(K) * d;
  const int64_t kd1 = kd + K;
  const int64_t kq4 = (kd1 + 3) / 4;   // float4s per accumulator
  float* acc = sacc + warp * 4 * kq4;
  for (int64_t i = t; i < W * kq4; i += blockDim.x)
    sacc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int nbits = 32 - __clz(K);     // keys: 0 = adds nothing, k + 1
  const int64_t ib = static_cast<int64_t>(b) * idx_bs;
  const int64_t wb = static_cast<int64_t>(b) * w_bs;
  const int64_t xb = static_cast<int64_t>(b) * x_bs;
  const int n_tiles = (M + 31) / 32;
  const int stride = G * W;
  // this lane's points of the warp's next PF tiles, loaded ahead of use
  constexpr int PF = DS <= 8 ? 4 : 2;
  constexpr int DR = DS > 0 ? DS : 1;
  int kq[PF];
  float wq[PF], xq[PF][DR];
  auto fetch = [&](int p, int tile) {
    const int m = tile * 32 + lane;
    kq[p] = -1;
    wq[p] = 0.f;
    if (tile >= n_tiles || m >= M) return;
    kq[p] = idx[ib + m];
    wq[p] = load_f32(w, wb + m, w_bf16);
#pragma unroll
    for (int j = 0; j < DS; ++j)
      if (j < d)
        xq[p][j] = load_f32(x, xb + static_cast<int64_t>(m) * d + j, x_bf16);
  };
  const int first = g * W + warp;
#pragma unroll
  for (int p = 0; p < PF; ++p) fetch(p, first + p * stride);
  for (int tile0 = first; tile0 < n_tiles; tile0 += PF * stride) {
#pragma unroll
    for (int p = 0; p < PF; ++p) {
      const int tile = tile0 + p * stride;   // warp-uniform
      if (tile >= n_tiles) break;
      const int k = kq[p];
      const float wv = wq[p];
      float xr[DR];
#pragma unroll
      for (int j = 0; j < DS; ++j) xr[j] = xq[p][j];
      fetch(p, tile + PF * stride);
      const bool live = wv != 0.f && k >= 0 && k < K;
      // the warp's points of one cluster add in lane order, one per round;
      // the points of one round belong to distinct clusters
      const unsigned grp = equal_lanes(live ? k + 1u : 0u, nbits);
      const unsigned rank = __popc(grp & ((1u << lane) - 1u));
      const unsigned rounds =
          __reduce_max_sync(0xffffffffu, live ? rank + 1u : 0u);
      for (unsigned r = 0; r < rounds; ++r) {
        if (live && rank == r) {
          float* a = acc + static_cast<int64_t>(k) * d;
          if constexpr (DS > 0) {
#pragma unroll
            for (int j = 0; j < DS; ++j)
              if (j < d) a[j] = fmaf(wv, xr[j], a[j]);
          } else {
            const int64_t row =
                xb + static_cast<int64_t>(tile * 32 + lane) * d;
            for (int j = 0; j < d; ++j)
              a[j] = fmaf(wv, load_f32(x, row + j, x_bf16), a[j]);
          }
          acc[kd + k] += wv;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // the block's partial: its warps' accumulators summed w = 0, 1, ...
  float4* pg =
      reinterpret_cast<float4*>(part) + (static_cast<int64_t>(b) * G + g) * kq4;
  for (int64_t i = t; i < kq4; i += blockDim.x) {
    float4 a = sacc4[i];
    for (int v = 1; v < W; ++v) {
      const float4 u = sacc4[v * kq4 + i];
      a.x += u.x;
      a.y += u.y;
      a.z += u.z;
      a.w += u.w;
    }
    pg[i] = a;
  }

  // the lane's last block to finish sums the G partials in block order
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (t == 0) is_last = atomicAdd(&done[b], 1) == G - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // two float4s per thread at a time, their G loads in flight together
  const float4* pb =
      reinterpret_cast<const float4*>(part) + static_cast<int64_t>(b) * G * kq4;
  const int nt = blockDim.x;
  for (int64_t i0 = t; i0 < kq4; i0 += 2 * nt) {
    float4 a[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                   make_float4(0.f, 0.f, 0.f, 0.f)};
#pragma unroll 4
    for (int j = 0; j < G; ++j) {
      float4 v[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int64_t i = i0 + c * nt;
        v[c] = i < kq4 ? __ldcg(pb + j * kq4 + i)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        a[c].x += v[c].x;
        a[c].y += v[c].y;
        a[c].z += v[c].z;
        a[c].w += v[c].w;
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float e4[4] = {a[c].x, a[c].y, a[c].z, a[c].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int64_t i = 4 * (i0 + c * nt) + q;
        if (i < kd) sums[b * kd + i] = e4[q];
        else if (i < kd1) counts[static_cast<int64_t>(b) * K + (i - kd)] = e4[q];
      }
    }
  }
  if (t == 0) done[b] = 0;
}

// ---------------------------------------------------------------------------
// counting-sort path
// ---------------------------------------------------------------------------

// One block per lane: histogram, exclusive scan and placement of the lane's
// live points.  Integer atomics on shared memory count and place; the place
// a point takes inside its cluster's segment depends on their order, the
// segment's contents do not (the segmented sum orders them).  Shared
// memory: K + 1 cursors (the last is the total) and 32 warp sums.
__global__ void __launch_bounds__(kSortThreads)
centroid_sort_kernel(const int32_t* __restrict__ idx, int64_t idx_bs,
                     const void* __restrict__ w, int64_t w_bs, int w_bf16,
                     int M, int K, int* __restrict__ offsets,
                     int* __restrict__ perm, float* __restrict__ wsorted) {
  extern __shared__ int cur[];
  int* wsum = cur + K + 1;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int b = blockIdx.x;
  const int32_t* ib = idx + static_cast<int64_t>(b) * idx_bs;
  const int64_t wb = static_cast<int64_t>(b) * w_bs;
  for (int i = t; i < K; i += kSortThreads) cur[i] = 0;
  __syncthreads();

  // 1. histogram
#pragma unroll 4
  for (int m = t; m < M; m += kSortThreads) {
    const int k = ib[m];
    if (load_f32(w, wb + m, w_bf16) != 0.f && k >= 0 && k < K)
      atomicAdd(&cur[k], 1);
  }
  __syncthreads();

  // 2. exclusive scan: each thread a contiguous run of clusters
  const int per = (K + kSortThreads - 1) / kSortThreads;
  const int lo = min(K, t * per), hi = min(K, lo + per);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += cur[i];
  int incl = local;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = wsum[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    wsum[lane] = v;
  }
  __syncthreads();
  int base = (warp ? wsum[warp - 1] : 0) + incl - local;
  for (int i = lo; i < hi; ++i) {
    const int c = cur[i];
    cur[i] = base;
    base += c;
  }
  if (t == 0) cur[K] = wsum[31];
  __syncthreads();
  int* off = offsets + static_cast<int64_t>(b) * (K + 1);
  for (int i = t; i <= K; i += kSortThreads) off[i] = cur[i];
  __syncthreads();

  // 3. placement: every live point into its cluster's segment
  int* pb = perm + static_cast<int64_t>(b) * M;
  float* sb = wsorted + static_cast<int64_t>(b) * M;
#pragma unroll 4
  for (int m = t; m < M; m += kSortThreads) {
    const int k = ib[m];
    const float wv = load_f32(w, wb + m, w_bf16);
    if (wv != 0.f && k >= 0 && k < K) {
      const int pos = atomicAdd(&cur[k], 1);
      pb[pos] = m;
      sb[pos] = wv;
    }
  }
}

// Block (c, b) sums clusters [c * cpb, (c + 1) * cpb) of lane b; a group of
// gs lanes (a power of two, the smallest >= d, at most 32) takes one
// cluster at a time, lane e holding columns e, e + gs, ... of a row.  A
// segment of more than one point is first put in increasing point order
// (each point's rank among the segment's ids: by shuffles for up to gs
// points, through perm2/wsorted2 beyond), so the sum runs over the
// cluster's points in their original order.
__global__ void __launch_bounds__(kSegThreads)
centroid_segsum_kernel(const void* __restrict__ x, int64_t x_bs, int x_bf16,
                       const int* __restrict__ offsets,
                       const int* __restrict__ perm,
                       const float* __restrict__ wsorted,
                       int* __restrict__ perm2, float* __restrict__ wsorted2,
                       int M, int K, int d, int gs, int cpb,
                       float* __restrict__ sums, float* __restrict__ counts) {
  extern __shared__ int soff[];  // cpb + 1 offsets
  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * cpb;
  const int k1 = min(K, k0 + cpb);
  const int* ob = offsets + static_cast<int64_t>(b) * (K + 1) + k0;
  for (int i = t; i <= k1 - k0; i += kSegThreads) soff[i] = ob[i];
  __syncthreads();

  const int lane = t & 31;
  const int e = t % gs;
  const unsigned gmask =
      gs == 32 ? 0xffffffffu : ((1u << gs) - 1u) << (lane & ~(gs - 1));
  const int64_t lb = static_cast<int64_t>(b) * M;
  const int64_t xbase = static_cast<int64_t>(b) * x_bs;
  for (int k = k0 + t / gs; k < k1; k += kSegThreads / gs) {
    const int s0 = soff[k - k0], s1 = soff[k - k0 + 1];
    const int n = s1 - s0;         // the same for the whole group
    const int* pb = perm + lb;
    const float* wb = wsorted + lb;
    // a segment of at most gs points: one per lane, put in increasing
    // point order by shuffles (each point's rank among the segment's ids)
    int my_p = 0x7fffffff;
    float my_w = 0.f;
    if (n <= gs) {
      if (e < n) {
        my_p = pb[s0 + e];
        my_w = wb[s0 + e];
      }
      if (n > 1) {
        int rank = 0;
        for (int q = 0; q < n; ++q)
          rank += __shfl_sync(gmask, my_p, q, gs) < my_p;
        int src = 0;
        for (int q = 0; q < n; ++q)
          if (__shfl_sync(gmask, rank, q, gs) == e) src = q;
        const int p2 = __shfl_sync(gmask, my_p, src, gs);
        const float w2 = __shfl_sync(gmask, my_w, src, gs);
        if (e < n) {
          my_p = p2;
          my_w = w2;
        }
      }
    } else {
      // a longer one: each point's rank found against the whole segment,
      // the points written in that order to perm2 / wsorted2
      for (int i0 = s0; i0 < s1; i0 += gs) {
        const int i = i0 + e;
        const int pi = i < s1 ? pb[i] : 0x7fffffff;
        int rank = 0;
        for (int j0 = s0; j0 < s1; j0 += gs) {
          const int pj_mine = j0 + e < s1 ? pb[j0 + e] : 0x7fffffff;
          const int nj = min(gs, s1 - j0);
          for (int q = 0; q < nj; ++q)
            rank += __shfl_sync(gmask, pj_mine, q, gs) < pi;
        }
        if (i < s1) {
          perm2[lb + s0 + rank] = pi;
          wsorted2[lb + s0 + rank] = wb[i];
        }
      }
      __syncwarp(gmask);
      pb = perm2 + lb;
      wb = wsorted2 + lb;
    }
    for (int c0 = 0; c0 < d; c0 += gs * kSegCols) {
      float acc[kSegCols] = {};
      float cnt = 0.f;
      for (int base = s0; base < s1; base += gs) {
        const int nb = min(gs, s1 - base);
        const int bp = n <= gs ? my_p : (e < nb ? pb[base + e] : 0);
        const float bw = n <= gs ? my_w : (e < nb ? wb[base + e] : 0.f);
#pragma unroll 4
        for (int j = 0; j < nb; ++j) {
          const int p = __shfl_sync(gmask, bp, j, gs);
          const float wp = __shfl_sync(gmask, bw, j, gs);
          const int64_t row = xbase + static_cast<int64_t>(p) * d;
#pragma unroll
          for (int c = 0; c < kSegCols; ++c) {
            const int col = c0 + e + c * gs;
            if (col < d)
              acc[c] = fmaf(wp, load_f32(x, row + col, x_bf16), acc[c]);
          }
          cnt += wp;
        }
      }
      float* out = sums + (static_cast<int64_t>(b) * K + k) * d;
#pragma unroll
      for (int c = 0; c < kSegCols; ++c) {
        const int col = c0 + e + c * gs;
        if (col < d) out[col] = acc[c];
      }
      if (c0 == 0 && e == 0) counts[static_cast<int64_t>(b) * K + k] = cnt;
    }
  }
}

}  // namespace
}  // namespace repro

namespace repro {
namespace {

template <int DS>
int launch_warps(const void* x, int64_t x_bs, int x_bf16, const int32_t* idx,
                 int64_t idx_bs, const void* w, int64_t w_bs, int w_bf16,
                 int B, int M, int K, int d, int G, int W, float* part,
                 int* done, float* sums, float* counts, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(W) * ((static_cast<size_t>(K) * (d + 1) + 3) / 4) *
      sizeof(float4);
  cudaError_t e = allow_smem(centroid_warps_kernel<DS>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  centroid_warps_kernel<DS><<<dim3(G, B), 32 * W, smem, stream>>>(
      x, x_bs, x_bf16, idx, idx_bs, w, w_bs, w_bf16, M, K, d, part, done,
      sums, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// Warp-accumulator path.  Strides are in elements; G (blocks per lane) and
// W (warps per block, at most 8) come from repro_torch/kernels/tiles.py
// (centroid_blocks, centroid_warps).  Returns the launch's cudaGetLastError().
extern "C" int repro_centroid_warps(const void* x, long long x_bs, int x_bf16,
                                    const int32_t* idx, long long idx_bs,
                                    const void* w, long long w_bs, int w_bf16,
                                    int B, int M, int K, int d, int G, int W,
                                    float* part, int* done, float* sums,
                                    float* counts, void* stream) {
  using namespace repro;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ds = d <= 2 ? 2 : d <= 4 ? 4 : d <= 8 ? 8 : d <= 16 ? 16
               : d <= kStageDims ? kStageDims : 0;
#define REPRO_WARPS(DS)                                                    \
  launch_warps<DS>(x, x_bs, x_bf16, idx, idx_bs, w, w_bs, w_bf16, B, M, K, \
                   d, G, W, part, done, sums, counts, s)
  switch (ds) {
    case 2: return REPRO_WARPS(2);
    case 4: return REPRO_WARPS(4);
    case 8: return REPRO_WARPS(8);
    case 16: return REPRO_WARPS(16);
    case kStageDims: return REPRO_WARPS(kStageDims);
    default: return REPRO_WARPS(0);
  }
#undef REPRO_WARPS
}

// Sort path: two launches (sort, then segmented sum).  gs (lanes per
// cluster) and cpb (clusters per block) come from tiles.py.
extern "C" int repro_centroid_sorted(const void* x, long long x_bs, int x_bf16,
                                     const int32_t* idx, long long idx_bs,
                                     const void* w, long long w_bs, int w_bf16,
                                     int B, int M, int K, int d, int gs,
                                     int cpb, int* offsets, int* perm,
                                     float* wsorted, int* perm2,
                                     float* wsorted2, float* sums,
                                     float* counts, void* stream) {
  using namespace repro;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sort_smem = (static_cast<size_t>(K) + 1 + 32) * sizeof(int);
  cudaError_t e = allow_smem(centroid_sort_kernel, sort_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  centroid_sort_kernel<<<B, kSortThreads, sort_smem, s>>>(
      idx, idx_bs, w, w_bs, w_bf16, M, K, offsets, perm, wsorted);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t seg_smem = (static_cast<size_t>(cpb) + 1) * sizeof(int);
  centroid_segsum_kernel<<<dim3((K + cpb - 1) / cpb, B), kSegThreads,
                           seg_smem, s>>>(x, x_bs, x_bf16, offsets, perm,
                                          wsorted, perm2, wsorted2, M, K, d,
                                          gs, cpb, sums, counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_centroid_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
