// Decode attention over a clustered KV cache on Hopper (sm_90a): the query
// heads of one decoded token attend to k-means centroids of the old keys and
// values, with a log(count) bias on every centroid's logit.  Returns the
// unnormalised online-softmax state
//   m[b, h, g]      = max over n of logit[n]
//   l[b, h, g]      = sum over n of exp(logit[n] - m)
//   acc[b, h, g, :] = sum over n of exp(logit[n] - m) * vc[b, h, n, :]
// with logit[n] = (q[b, h * G + g] . kc[b, h, n]) * scale + bias[n], and
// bias[n] = log(max(count, 1e-9)) for count > 0, else the sentinel -1e30
// (never -inf: a split with only dead centroids would give exp(-inf + inf)).
//
// Replaces the TPU kernel repro/kernels/cluster_attn.py::_cluster_attn_kernel
// (cluster_attn_decode_pallas), which walks the centroid tiles of one
// (batch, kv head) sequentially and carries (m, l, acc) in its output blocks.
// On the card a block per (batch, kv head) would be 8 blocks on 132 SMs at
// batch 1, so the centroid axis is split across blocks (flash-decoding):
//   * block (s, h, b) takes centroids [s * chunk, (s + 1) * chunk) of kv
//     head h and keeps (m, l, acc) for the G query heads that share it, so
//     each centroid row is read once for all G heads;
//   * inside the block, `lpr` lanes share one centroid row, each loading 16
//     bytes of the key row and of the value row (8 bf16 or 4 f32 values),
//     so a warp reads 32 / lpr whole rows per step with full-width loads;
//     the dot product is reduced over those lanes by shuffles, and every
//     group of lanes carries its own online-softmax state in registers;
//   * the block merges its groups' states in shared memory, in a fixed
//     order, into one partial state per split;
//   * a second small kernel merges the splits' partial states, one block
//     per (batch, kv head, query head), in a fixed order.  There are no
//     float atomics: a repeated launch is bit-identical.
//
// What bounds it: bytes.  Every key and value row and every count is read
// once (two dot products of dh per row and query head are far below the
// card's FP32 rate).  Ragged Nc is never padded: rows past Nc are not
// visited, so an all-dead row's l is Nc (the Pallas kernel's is the padded
// count).
//
// Layout: q (B, H, dh) f32 or bf16 with batch and head strides, each head's
// row contiguous; kc and vc (B, Hkv, Nc, dh), both f32 or both bf16, with
// batch and head strides, rows contiguous and 16-byte aligned; counts
// (B, Hkv, Nc) f32 with batch and head strides; scratch part_acc
// (B, Hkv, S, G, dh), part_m and part_l (B, Hkv, S, G); outputs acc
// (B, Hkv, G, dh), m and l (B, Hkv, G), contiguous f32.
#include "distance.cuh"

namespace repro {
namespace {

constexpr int kAttnThreads = 128;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kCombineThreads = 512;
constexpr float kNeg = -1.0e30f;

// One 16-byte load of a row, as f32 values.
template <typename T>
struct Row16;

template <>
struct Row16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Row16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// Rows each group of lanes takes per step (two loads in flight per lane;
// more cost registers, hence resident blocks, and ran slower).
constexpr int kUnroll = 2;

template <typename T, int G>
__global__ void __launch_bounds__(kAttnThreads)
cluster_attn_split_kernel(const void* __restrict__ q, int64_t q_bs,
                          int64_t q_hs, int q_bf16, const T* __restrict__ kc,
                          int64_t kc_bs, int64_t kc_hs,
                          const T* __restrict__ vc, int64_t vc_bs,
                          int64_t vc_hs, const float* __restrict__ counts,
                          int64_t cnt_bs, int64_t cnt_hs, int Nc, int dh,
                          int lpr, int chunk, float scale,
                          float* __restrict__ part_acc,
                          float* __restrict__ part_m,
                          float* __restrict__ part_l) {
  constexpr int V = Row16<T>::N;
  const int s = blockIdx.x, S = gridDim.x;
  const int h = blockIdx.y, Hkv = gridDim.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows_per_warp = 32 / lpr;
  const int r = lane / lpr;       // this lane's row within the warp's step
  const int e = lane % lpr;       // its 16 bytes of the row: [e V, e V + V)
  const int group = warp * rows_per_warp + r;
  const int n_groups = kAttnWarps * rows_per_warp;

  float qr[G][V];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < V; ++j)
      qr[gi][j] = load_f32(q, b * q_bs + (h * G + gi) * q_hs + e * V + j,
                           q_bf16);

  float m[G], l[G], acc[G][V];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNeg;
    l[gi] = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) acc[gi][j] = 0.f;
  }

  const T* kb = kc + b * kc_bs + h * kc_hs + e * V;
  const T* vb = vc + b * vc_bs + h * vc_hs + e * V;
  const float* cb = counts + b * cnt_bs + h * cnt_hs;
  const int n0 = s * chunk;
  const int n1 = min(Nc, n0 + chunk);
  // warp-uniform trip count: every lane takes part in every shuffle
  for (int base = n0 + warp * rows_per_warp; base < n1;
       base += kUnroll * n_groups) {
    float kr[kUnroll][V], vr[kUnroll][V], bias[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int n = base + u * n_groups + r;
      valid[u] = n < n1;
      if (valid[u]) {
        Row16<T>::load(kb + static_cast<int64_t>(n) * dh, kr[u]);
        Row16<T>::load(vb + static_cast<int64_t>(n) * dh, vr[u]);
        const float cnt = cb[n];
        bias[u] = cnt > 0.f ? logf(fmaxf(cnt, 1e-9f)) : kNeg;
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) kr[u][j] = vr[u][j] = 0.f;
        bias[u] = kNeg;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dot[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        dot[gi] = 0.f;
#pragma unroll
        for (int j = 0; j < V; ++j) dot[gi] = fmaf(qr[gi][j], kr[u][j], dot[gi]);
      }
      for (int off = lpr / 2; off > 0; off >>= 1)
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
          dot[gi] += __shfl_xor_sync(0xffffffffu, dot[gi], off);
      if (!valid[u]) continue;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float logit = dot[gi] * scale + bias[u];
        const float m_new = fmaxf(m[gi], logit);
        const float alpha = expf(m[gi] - m_new);
        const float p = expf(logit - m_new);
        l[gi] = l[gi] * alpha + p;
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[gi][j] = fmaf(p, vr[u][j], acc[gi][j] * alpha);
        m[gi] = m_new;
      }
    }
  }

  // merge the groups' states, group 0, 1, ... in order
  extern __shared__ float smem[];
  float* s_acc = smem;                          // (n_groups, G, dh)
  float* s_m = s_acc + n_groups * G * dh;       // (n_groups, G)
  float* s_l = s_m + n_groups * G;              // (n_groups, G)
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int j = 0; j < V; ++j)
      s_acc[(group * G + gi) * dh + e * V + j] = acc[gi][j];
    if (e == 0) {
      s_m[group * G + gi] = m[gi];
      s_l[group * G + gi] = l[gi];
    }
  }
  __syncthreads();
  const int64_t slot = (static_cast<int64_t>(b) * Hkv + h) * S + s;
  for (int i = threadIdx.x; i < G * dh; i += kAttnThreads) {
    const int gi = i / dh;
    float mx = kNeg;
    for (int w = 0; w < n_groups; ++w) mx = fmaxf(mx, s_m[w * G + gi]);
    float a = 0.f, den = 0.f;
    for (int w = 0; w < n_groups; ++w) {
      const float sc = expf(s_m[w * G + gi] - mx);
      a = fmaf(s_acc[(w * G + gi) * dh + i % dh], sc, a);
      den = fmaf(s_l[w * G + gi], sc, den);
    }
    part_acc[slot * G * dh + i] = a;
    if (i % dh == 0) {
      part_m[slot * G + gi] = mx;
      part_l[slot * G + gi] = den;
    }
  }
}

// Merge the S splits' partial states, one block per (batch, kv head, query
// head): the block finds the largest split max (exact in any order) and puts
// each split's rescale factor exp(m_s - max) in shared memory once; then
// kCombineGroups groups of threads each sum the splits s = g, g + groups, ...
// in order, and the group sums are added g = 0, 1, ... in order.
constexpr int kCombineGroups = 4;
constexpr int kCombineLanes = kCombineThreads / kCombineGroups;

__global__ void __launch_bounds__(kCombineThreads)
cluster_attn_combine_kernel(const float* __restrict__ part_acc,
                            const float* __restrict__ part_m,
                            const float* __restrict__ part_l, int S, int dh,
                            float* __restrict__ acc, float* __restrict__ m,
                            float* __restrict__ l) {
  extern __shared__ float smem[];
  float* s_scale = smem;                    // (S,)
  float* s_part = smem + S;                 // (kCombineGroups, dh + 1)
  __shared__ float s_max[kCombineThreads / 32];
  const int G = gridDim.y;
  const int64_t bh = blockIdx.x;
  const int gi = blockIdx.y;
  const int t = threadIdx.x;
  const float* pm = part_m + bh * S * G + gi;  // split s at pm[s * G]
  float mx = kNeg;
  for (int s = t; s < S; s += kCombineThreads) mx = fmaxf(mx, pm[s * G]);
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((t & 31) == 0) s_max[t >> 5] = mx;
  __syncthreads();
  mx = s_max[0];
  for (int w = 1; w < kCombineThreads / 32; ++w) mx = fmaxf(mx, s_max[w]);
  for (int s = t; s < S; s += kCombineThreads)
    s_scale[s] = expf(pm[s * G] - mx);
  __syncthreads();

  // column j < dh of acc, and column dh of l
  const int grp = t / kCombineLanes;
  const int64_t step = static_cast<int64_t>(G) * dh;  // from split s to s+1
  for (int j = t % kCombineLanes; j <= dh; j += kCombineLanes) {
    const float* src = j < dh ? part_acc + bh * S * step + gi * dh + j
                              : part_l + bh * S * G + gi;
    const int64_t stride = j < dh ? step : G;
    float a = 0.f;
#pragma unroll 4
    for (int s = grp; s < S; s += kCombineGroups)
      a = fmaf(src[s * stride], s_scale[s], a);
    s_part[grp * (dh + 1) + j] = a;
  }
  __syncthreads();
  for (int j = t; j <= dh; j += kCombineThreads) {
    float a = s_part[j];
    for (int g = 1; g < kCombineGroups; ++g) a += s_part[g * (dh + 1) + j];
    if (j < dh) acc[(bh * G + gi) * dh + j] = a;
    else l[bh * G + gi] = a;
  }
  if (t == 0) m[bh * G + gi] = mx;
}

template <typename T, int G>
int launch(const void* q, int64_t q_bs, int64_t q_hs, int q_bf16,
           const void* kc, int64_t kc_bs, int64_t kc_hs, const void* vc,
           int64_t vc_bs, int64_t vc_hs, const float* counts, int64_t cnt_bs,
           int64_t cnt_hs, int B, int Hkv, int Nc, int dh, int lpr, int S,
           int chunk, float scale, float* part_acc, float* part_m,
           float* part_l, float* acc, float* m, float* l,
           cudaStream_t stream) {
  const int n_groups = kAttnWarps * (32 / lpr);
  const size_t smem =
      static_cast<size_t>(n_groups) * G * (dh + 2) * sizeof(float);
  cluster_attn_split_kernel<T, G><<<dim3(S, Hkv, B), kAttnThreads, smem,
                                    stream>>>(
      q, q_bs, q_hs, q_bf16, static_cast<const T*>(kc), kc_bs, kc_hs,
      static_cast<const T*>(vc), vc_bs, vc_hs, counts, cnt_bs, cnt_hs, Nc, dh,
      lpr, chunk, scale, part_acc, part_m, part_l);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t combine_smem = (S + kCombineGroups * (dh + 1)) * sizeof(float);
  cluster_attn_combine_kernel<<<dim3(B * Hkv, G), kCombineThreads,
                                combine_smem, stream>>>(
      part_acc, part_m, part_l, S, dh, acc, m, l);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_group(int G, const void* q, int64_t q_bs, int64_t q_hs,
                   int q_bf16, const void* kc, int64_t kc_bs, int64_t kc_hs,
                   const void* vc, int64_t vc_bs, int64_t vc_hs,
                   const float* counts, int64_t cnt_bs, int64_t cnt_hs, int B,
                   int Hkv, int Nc, int dh, int lpr, int S, int chunk,
                   float scale, float* part_acc, float* part_m, float* part_l,
                   float* acc, float* m, float* l, cudaStream_t stream) {
#define REPRO_ATTN_CASE(g)                                                     \
  case g:                                                                      \
    return launch<T, g>(q, q_bs, q_hs, q_bf16, kc, kc_bs, kc_hs, vc, vc_bs,    \
                        vc_hs, counts, cnt_bs, cnt_hs, B, Hkv, Nc, dh, lpr, S, \
                        chunk, scale, part_acc, part_m, part_l, acc, m, l,     \
                        stream);
  switch (G) {
    REPRO_ATTN_CASE(1)
    REPRO_ATTN_CASE(2)
    REPRO_ATTN_CASE(3)
    REPRO_ATTN_CASE(4)
    REPRO_ATTN_CASE(5)
    REPRO_ATTN_CASE(6)
    REPRO_ATTN_CASE(7)
    REPRO_ATTN_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_ATTN_CASE
}

}  // namespace
}  // namespace repro

// Strides are in elements.  G (query heads per kv head, 1..8), lpr (lanes
// per row: dh * element size / 16, a power of two up to 32), S (splits) and
// chunk (centroids per split) come from repro_torch/kernels/tiles.py.
// Returns the launches' cudaGetLastError().
extern "C" int repro_cluster_attn(
    const void* q, long long q_bs, long long q_hs, int q_bf16, const void* kc,
    long long kc_bs, long long kc_hs, const void* vc, long long vc_bs,
    long long vc_hs, int kv_bf16, const float* counts, long long cnt_bs,
    long long cnt_hs, int B, int Hkv, int G, int Nc, int dh, int lpr, int S,
    int chunk, float scale, float* part_acc, float* part_m, float* part_l,
    float* acc, float* m, float* l, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bf16)
    return repro::dispatch_group<__nv_bfloat16>(
        G, q, q_bs, q_hs, q_bf16, kc, kc_bs, kc_hs, vc, vc_bs, vc_hs, counts,
        cnt_bs, cnt_hs, B, Hkv, Nc, dh, lpr, S, chunk, scale, part_acc,
        part_m, part_l, acc, m, l, st);
  return repro::dispatch_group<float>(
      G, q, q_bs, q_hs, q_bf16, kc, kc_bs, kc_hs, vc, vc_bs, vc_hs, counts,
      cnt_bs, cnt_hs, B, Hkv, Nc, dh, lpr, S, chunk, scale, part_acc, part_m,
      part_l, acc, m, l, st);
}

extern "C" const char* repro_cluster_attn_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
