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
// batch 1, so the centroid axis is split across blocks (flash-decoding), and
// the whole reduction stays in ONE launch:
//   * block (s, h, b) takes centroids [s * chunk, (s + 1) * chunk) of kv
//     head h and keeps (m, l, acc) for the G query heads that share it, so
//     each centroid row is read once for all G heads;
//   * the split's key rows and its value rows are each one contiguous range.
//     One thread streams them into a ring of kStages shared-memory stages
//     with bulk asynchronous copies (cp.async.bulk), each stage completing on
//     its own mbarrier; with two blocks per SM that keeps 64 KB per SM in
//     flight at the long_500k shape while the warps compute on the stage
//     that has arrived (deeper rings measured slower); the thread refills a
//     stage once every warp is done with it (a block barrier);
//   * `lpr` lanes share one centroid row, each reading 16 bytes of the key
//     row and of the value row from shared memory (lpr is the row's pieces
//     of 16 bytes rounded up to a power of two; a lane past the row's last
//     piece, as at dh = 80 in bf16, 10 pieces on 16 lanes, loads nothing,
//     adds 0 to the dot product and writes no part of acc); the dot
//     product is reduced over those lanes by shuffles, and every group of
//     lanes carries
//     its own online-softmax state in registers, folding in two rows per
//     step with one rescale; the block merges its groups' states in a fixed
//     order (by shuffles within each warp, then warp by warp in shared
//     memory) into the split's partial state;
//   * the last block of a (batch, kv head) to finish, found with an integer
//     counter, merges all S partial states in split order s = 0, 1, ... and
//     writes the result, then resets the counter for the next launch (it
//     loads the first kMergeAhead splits' values while it reads the states'
//     maxima, so the two wait on memory once).
// There are no float atomics: a repeated launch is bit-identical.
//
// What bounds it: bytes.  Every key and value row and every count is read
// once (two dot products of dh per row and query head are far below the
// card's FP32 rate).  The design keeps enough bytes in flight per SM to
// cover the memory latency.  Ragged Nc is never padded: rows past Nc are not
// visited, so an all-dead row's l is Nc (the Pallas kernel's is the padded
// count).
//
// Layout: q (B, H, dh) f32 or bf16 with batch and head strides, each head's
// row contiguous; kc and vc (B, Hkv, Nc, dh), both f32 or both bf16, with
// batch and head strides, rows contiguous and 16-byte aligned; counts
// (B, Hkv, Nc) f32 with batch and head strides; scratch part_acc
// (B, Hkv, S, G, dh), part_m and part_l (B, Hkv, S, G), done (B * Hkv)
// int32, zero on entry and left zero; outputs acc (B, Hkv, G, dh), m and l
// (B, Hkv, G), contiguous f32.
#include "distance.cuh"

namespace repro {
namespace {

constexpr int kAttnThreads = 256;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kStages = 2;       // ring stages in flight per block
constexpr int kMergeAhead = 16;  // splits the last block loads at once
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Block until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename T, int G>
__global__ void __launch_bounds__(kAttnThreads, 2)
cluster_attn_kernel(const void* __restrict__ q, int64_t q_bs, int64_t q_hs,
                    int q_bf16, const T* __restrict__ kc, int64_t kc_bs,
                    int64_t kc_hs, const T* __restrict__ vc, int64_t vc_bs,
                    int64_t vc_hs, const float* __restrict__ counts,
                    int64_t cnt_bs, int64_t cnt_hs, int Nc, int dh, int lpr,
                    int chunk, int stage_rows, float scale,
                    float* __restrict__ part_acc, float* __restrict__ part_m,
                    float* __restrict__ part_l, int* __restrict__ done,
                    float* __restrict__ acc_out, float* __restrict__ m_out,
                    float* __restrict__ l_out) {
  constexpr int V = Row16<T>::N;
  const int s = blockIdx.x, S = gridDim.x;
  const int h = blockIdx.y, Hkv = gridDim.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int rows_per_warp = 32 / lpr;
  const int r = lane / lpr;       // this lane's row within the warp's step
  const int e = lane % lpr;       // its 16 bytes of the row: [e V, e V + V)
  const bool has_piece = e * V < dh;  // false past the row's last piece
  const int n_groups = kAttnWarps * rows_per_warp;

  // shared memory: kStages mbarriers, the split's biases, then the ring
  // (kStages key stages, kStages value stages), reused for the merges
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* bias = reinterpret_cast<float*>(smem + 128);
  const int bias_floats = (chunk + 31) / 32 * 32;
  unsigned char* ring = smem + 128 + bias_floats * sizeof(float);
  const int64_t stage_elems = static_cast<int64_t>(stage_rows) * dh;
  T* ring_k = reinterpret_cast<T*>(ring);
  T* ring_v = ring_k + kStages * stage_elems;

  const int n0 = s * chunk;
  const int n_rows = min(Nc, n0 + chunk) - n0;
  const int n_st = (n_rows + stage_rows - 1) / stage_rows;
  const T* kb = kc + b * kc_bs + h * kc_hs + static_cast<int64_t>(n0) * dh;
  const T* vb = vc + b * vc_bs + h * vc_hs + static_cast<int64_t>(n0) * dh;
  auto load_stage = [&](int i) {  // stage i into ring slot i % kStages
    const int slot = i % kStages;
    const int rows = min(stage_rows, n_rows - i * stage_rows);
    const uint32_t bytes = rows * dh * sizeof(T);
    const int64_t off = static_cast<int64_t>(i) * stage_elems;
    mbar_expect_tx(&bars[slot], 2 * bytes);
    bulk_copy(ring_k + slot * stage_elems, kb + off, bytes, &bars[slot]);
    bulk_copy(ring_v + slot * stage_elems, vb + off, bytes, &bars[slot]);
  };
  if (t == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(kStages, n_st); ++i) load_stage(i);
  }
  const float* cb = counts + b * cnt_bs + h * cnt_hs + n0;
  for (int i = t; i < n_rows; i += kAttnThreads) {
    const float cnt = cb[i];
    bias[i] = cnt > 0.f ? logf(fmaxf(cnt, 1e-9f)) : kNeg;
  }

  float qr[G][V];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int j = 0; j < V; ++j)
      qr[gi][j] = has_piece ? load_f32(q, b * q_bs + (h * G + gi) * q_hs +
                                               e * V + j,
                                       q_bf16)
                            : 0.f;
  float m[G], l[G], acc[G][V];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNeg;
    l[gi] = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) acc[gi][j] = 0.f;
  }
  __syncthreads();               // the barriers' init and the biases

  for (int i = 0; i < n_st; ++i) {
    const int slot = i % kStages;
    const int row0 = i * stage_rows;
    const int rows = min(stage_rows, n_rows - row0);
    mbar_wait(&bars[slot], (i / kStages) & 1);
    const T* ks = ring_k + slot * stage_elems + e * V;
    const T* vs = ring_v + slot * stage_elems + e * V;
    // two rows per group per step (n and n + n_groups), folded into the
    // state with one rescale; warp-uniform trip count: every lane takes
    // part in every shuffle
    for (int base = warp * rows_per_warp; base < rows; base += 2 * n_groups) {
      float kr[2][V], vr[2][V], dot[2][G];
      bool valid[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int n = base + u * n_groups + r;
        valid[u] = n < rows;
        if (valid[u] && has_piece) {
          Row16<T>::load(ks + n * dh, kr[u]);
          Row16<T>::load(vs + n * dh, vr[u]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) kr[u][j] = vr[u][j] = 0.f;
        }
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          dot[u][gi] = 0.f;
#pragma unroll
          for (int j = 0; j < V; ++j)
            dot[u][gi] = fmaf(qr[gi][j], kr[u][j], dot[u][gi]);
        }
      }
      for (int off = lpr / 2; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int gi = 0; gi < G; ++gi)
            dot[u][gi] += __shfl_xor_sync(0xffffffffu, dot[u][gi], off);
      if (!valid[0]) continue;
      const int n0r = base + r;
      const float b0 = bias[row0 + n0r];
      const float b1 = valid[1] ? bias[row0 + n0r + n_groups] : 0.f;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float l0 = dot[0][gi] * scale + b0;
        const float l1 = valid[1] ? dot[1][gi] * scale + b1 : kNeg;
        const float m_new = fmaxf(m[gi], fmaxf(l0, l1));
        const float alpha = expf(m[gi] - m_new);
        const float p0 = expf(l0 - m_new);
        const float p1 = valid[1] ? expf(l1 - m_new) : 0.f;
        l[gi] = l[gi] * alpha + p0 + p1;
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[gi][j] =
              fmaf(p1, vr[1][j], fmaf(p0, vr[0][j], acc[gi][j] * alpha));
        m[gi] = m_new;
      }
    }
    __syncthreads();             // every warp is done with this slot
    if (t == 0 && i + kStages < n_st) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load_stage(i + kStages);
    }
  }

  // merge the groups' states: first the warp's groups by shuffles (group
  // r with r + 1, then r with r + 2, ...), then the warps' states 0, 1, ...
  // in order in the ring's memory (every copy has landed and been read)
  for (int off = lpr; off < 32; off <<= 1) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[gi], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[gi], off);
      const float mx = fmaxf(m[gi], m2);
      const float sc = expf(m[gi] - mx), sc2 = expf(m2 - mx);
      l[gi] = fmaf(l2, sc2, l[gi] * sc);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float a2 = __shfl_xor_sync(0xffffffffu, acc[gi][j], off);
        acc[gi][j] = fmaf(a2, sc2, acc[gi][j] * sc);
      }
      m[gi] = mx;
    }
  }
  float* s_acc = reinterpret_cast<float*>(ring);  // (kAttnWarps, G, dh)
  float* s_m = s_acc + kAttnWarps * G * dh;       // (kAttnWarps, G)
  float* s_l = s_m + kAttnWarps * G;              // (kAttnWarps, G)
  if (r == 0 && has_piece) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        s_acc[(warp * G + gi) * dh + e * V + j] = acc[gi][j];
      if (e == 0) {
        s_m[warp * G + gi] = m[gi];
        s_l[warp * G + gi] = l[gi];
      }
    }
  }
  float* s_sc = s_l + kAttnWarps * G;            // (kAttnWarps, G) scales
  float* s_mx = s_sc + kAttnWarps * G;           // (G,)
  __syncthreads();
  if (t < G) {
    float mx = kNeg;
    for (int v = 0; v < kAttnWarps; ++v) mx = fmaxf(mx, s_m[v * G + t]);
    s_mx[t] = mx;
  }
  __syncthreads();
  if (t < kAttnWarps * G) s_sc[t] = expf(s_m[t] - s_mx[t % G]);
  __syncthreads();
  const int64_t bh = static_cast<int64_t>(b) * Hkv + h;
  const int64_t slot = bh * S + s;
  for (int i = t; i < G * dh; i += kAttnThreads) {
    const int gi = i / dh;
    float a = 0.f;
#pragma unroll
    for (int v = 0; v < kAttnWarps; ++v)
      a = fmaf(s_acc[(v * G + gi) * dh + i % dh], s_sc[v * G + gi], a);
    part_acc[slot * G * dh + i] = a;
  }
  if (t < G) {
    float den = 0.f;
    for (int v = 0; v < kAttnWarps; ++v)
      den = fmaf(s_l[v * G + t], s_sc[v * G + t], den);
    part_m[slot * G + t] = s_mx[t];
    part_l[slot * G + t] = den;
  }

  // the last split of this (batch, kv head) to finish merges them all
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (t == 0) is_last = atomicAdd(&done[bh], 1) == S - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // two columns of acc per thread at a time; the first kMergeAhead splits'
  // values go to registers while (the first time) the partial states'
  // (m, l) go to shared memory: one round trip for both
  float* s_pm = s_acc;                            // (S, G)
  float* s_pl = s_pm + S * G;                     // (S, G)
  float* s_scale = s_pl + S * G;                  // (S, G)
  float* s_max = s_scale + S * G;                 // (G,)
  const float* pm = part_m + bh * S * G;
  const float* pl = part_l + bh * S * G;
  const float* pa = part_acc + bh * S * G * dh;
  const int n_cols = G * dh;
  for (int base = 0; base < n_cols; base += 2 * kAttnThreads) {
    const int i0 = base + t, i1 = base + t + kAttnThreads;
    const int c0 = min(i0, n_cols - 1), c1 = min(i1, n_cols - 1);
    float v0[kMergeAhead], v1[kMergeAhead];
#pragma unroll
    for (int k = 0; k < kMergeAhead; ++k) {
      v0[k] = k < S ? __ldcg(pa + k * n_cols + c0) : 0.f;
      v1[k] = k < S ? __ldcg(pa + k * n_cols + c1) : 0.f;
    }
    if (base == 0) {
      for (int i = t; i < S * G; i += kAttnThreads) {
        s_pm[i] = __ldcg(pm + i);
        s_pl[i] = __ldcg(pl + i);
      }
      __syncthreads();
      if (warp < G) {                            // warp gi: head gi's max
        float mx = kNeg;
        for (int k = lane; k < S; k += 32) mx = fmaxf(mx, s_pm[k * G + warp]);
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        if (lane == 0) s_max[warp] = mx;
      }
      __syncthreads();
      for (int i = t; i < S * G; i += kAttnThreads)
        s_scale[i] = expf(s_pm[i] - s_max[i % G]);
      __syncthreads();
    }
    const int g0 = c0 / dh, g1 = c1 / dh;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int k = 0; k < kMergeAhead; ++k) {
      if (k < S) {
        a0 = fmaf(v0[k], s_scale[k * G + g0], a0);
        a1 = fmaf(v1[k], s_scale[k * G + g1], a1);
      }
    }
#pragma unroll 8
    for (int k = kMergeAhead; k < S; ++k) {
      a0 = fmaf(__ldcg(pa + k * n_cols + c0), s_scale[k * G + g0], a0);
      a1 = fmaf(__ldcg(pa + k * n_cols + c1), s_scale[k * G + g1], a1);
    }
    if (i0 < n_cols) acc_out[bh * n_cols + i0] = a0;
    if (i1 < n_cols) acc_out[bh * n_cols + i1] = a1;
  }
  if (t < G) {
    float a = 0.f;
    for (int k = 0; k < S; ++k) a = fmaf(s_pl[k * G + t], s_scale[k * G + t], a);
    l_out[bh * G + t] = a;
    m_out[bh * G + t] = s_max[t];
  }
  if (t == 0) done[bh] = 0;
}

// Shared memory of one block: barriers, biases, and the larger of the ring
// and the two merges' scratch.
size_t smem_bytes(int G, int dh, int chunk, int stage_rows, int elem_bytes,
                  int S) {
  const size_t bias = static_cast<size_t>((chunk + 31) / 32 * 32) * 4;
  const size_t ring =
      2 * static_cast<size_t>(kStages) * stage_rows * dh * elem_bytes;
  const size_t groups =
      (static_cast<size_t>(kAttnWarps) * G * (dh + 3) + G) * 4;
  const size_t splits = static_cast<size_t>(G) * (3 * S + 1) * 4;
  size_t body = ring > groups ? ring : groups;
  body = body > splits ? body : splits;
  return 128 + bias + body;
}

template <typename T, int G>
int launch(const void* q, int64_t q_bs, int64_t q_hs, int q_bf16,
           const void* kc, int64_t kc_bs, int64_t kc_hs, const void* vc,
           int64_t vc_bs, int64_t vc_hs, const float* counts, int64_t cnt_bs,
           int64_t cnt_hs, int B, int Hkv, int Nc, int dh, int lpr, int S,
           int chunk, int stage_rows, float scale, float* part_acc,
           float* part_m, float* part_l, int* done, float* acc, float* m,
           float* l, cudaStream_t stream) {
  const size_t smem =
      smem_bytes(G, dh, chunk, stage_rows, sizeof(T), S);
  cudaError_t e = allow_smem(cluster_attn_kernel<T, G>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cluster_attn_kernel<T, G><<<dim3(S, Hkv, B), kAttnThreads, smem, stream>>>(
      q, q_bs, q_hs, q_bf16, static_cast<const T*>(kc), kc_bs, kc_hs,
      static_cast<const T*>(vc), vc_bs, vc_hs, counts, cnt_bs, cnt_hs, Nc, dh,
      lpr, chunk, stage_rows, scale, part_acc, part_m, part_l, done, acc, m,
      l);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_group(int G, const void* q, int64_t q_bs, int64_t q_hs,
                   int q_bf16, const void* kc, int64_t kc_bs, int64_t kc_hs,
                   const void* vc, int64_t vc_bs, int64_t vc_hs,
                   const float* counts, int64_t cnt_bs, int64_t cnt_hs, int B,
                   int Hkv, int Nc, int dh, int lpr, int S, int chunk,
                   int stage_rows, float scale, float* part_acc, float* part_m,
                   float* part_l, int* done, float* acc, float* m, float* l,
                   cudaStream_t stream) {
#define REPRO_ATTN_CASE(g)                                                     \
  case g:                                                                      \
    return launch<T, g>(q, q_bs, q_hs, q_bf16, kc, kc_bs, kc_hs, vc, vc_bs,    \
                        vc_hs, counts, cnt_bs, cnt_hs, B, Hkv, Nc, dh, lpr, S, \
                        chunk, stage_rows, scale, part_acc, part_m, part_l,    \
                        done, acc, m, l, stream);
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
// per row: the row's dh * element size / 16 pieces rounded up to a power of
// two, at most 32), S (splits),
// chunk (centroids per split) and stage_rows (rows per ring stage) come from
// repro_torch/kernels/tiles.py.  Returns the launch's cudaGetLastError().
extern "C" int repro_cluster_attn(
    const void* q, long long q_bs, long long q_hs, int q_bf16, const void* kc,
    long long kc_bs, long long kc_hs, const void* vc, long long vc_bs,
    long long vc_hs, int kv_bf16, const float* counts, long long cnt_bs,
    long long cnt_hs, int B, int Hkv, int G, int Nc, int dh, int lpr, int S,
    int chunk, int stage_rows, float scale, float* part_acc, float* part_m,
    float* part_l, int* done, float* acc, float* m, float* l, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bf16)
    return repro::dispatch_group<__nv_bfloat16>(
        G, q, q_bs, q_hs, q_bf16, kc, kc_bs, kc_hs, vc, vc_bs, vc_hs, counts,
        cnt_bs, cnt_hs, B, Hkv, Nc, dh, lpr, S, chunk, stage_rows, scale,
        part_acc, part_m, part_l, done, acc, m, l, st);
  return repro::dispatch_group<float>(
      G, q, q_bs, q_hs, q_bf16, kc, kc_bs, kc_hs, vc, vc_bs, vc_hs, counts,
      cnt_bs, cnt_hs, B, Hkv, Nc, dh, lpr, S, chunk, stage_rows, scale,
      part_acc, part_m, part_l, done, acc, m, l, st);
}

extern "C" const char* repro_cluster_attn_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
