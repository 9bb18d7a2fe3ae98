// ADC (asymmetric distance computation) scan on Hopper (sm_90a), the IVF/PQ
// query hot loop: out[b, l] = sum over j of lut[b, j, code[b, l, j]].
//
// Replaces the TPU kernel repro/kernels/scan.py::_adc_kernel
// (adc_scan_pallas).  VMEM has no fast random gather, so that kernel turns
// every lookup into a one-hot compare and an MXU matvec.  Hopper gathers
// from shared memory directly, so here the lookups stay lookups.
//
// What bounds it: bytes (each candidate's m code bytes read once, one f32
// written, each entry's table read once), then the shared-memory gathers:
// m per row, each a random 4-byte read, and the 32 lanes of a warp read 32
// random entries of one 256-entry row, which replay about 3.2 times on bank
// conflicts.  The design:
//   * one wave: G blocks per batch entry b, as many as the card holds at
//     once for all B entries (the occupancy the runtime reports for this
//     block's table), walking b's kThreads-row tiles g, g + G, ..., so every
//     block walks as many tiles as any other, within one;
//   * b's (m, C) table is staged in shared memory in its own type (a bf16
//     table stays bf16 and is upcast at the gather), by the block's threads
//     with 16-byte loads where the table is so aligned;
//   * each thread owns one row of a tile and reads up to 64 of its codes at
//     once (16-byte loads, or 4- or 1-byte loads where the rows are not so
//     aligned), and loads its next piece, or its row of the next tile,
//     before the gathers of the current one, so two rows' codes are in
//     flight per thread (the first while the table is staged); it sums
//     lut[j][code_j] in increasing j in f32.
// Measured slower on the H100 (PERF.md §6): bulk copies of the table
// (cp.async.bulk), also multicast across a thread-block cluster of an
// entry's blocks; cp.async staging; 1024-thread blocks on contiguous runs of
// rows; the codes streamed through a shared-memory ring by bulk copies.
//
// Codes must lie in [0, C); the caller masks invalid candidate slots (the
// kernel scans whatever codes they hold).
//
// Layout: luts (B, m, C) f32 or bf16 with a batch stride, each table
// contiguous; codes (B, L, m) uint8 with a batch stride, rows contiguous;
// out (B, L) contiguous f32.
#include "distance.cuh"

namespace repro {
namespace {

__device__ __forceinline__ float upcast(float v) { return v; }
__device__ __forceinline__ float upcast(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// VEC code bytes read at once: a uint4, a 32-bit word or one byte; a row is
// read kBatch of them at a time (64 codes; 16 one byte at a time).
template <int VEC> struct Piece;
template <> struct Piece<16> {
  using type = uint4;
  static constexpr int kBatch = 4;
};
template <> struct Piece<4> {
  using type = uint32_t;
  static constexpr int kBatch = 16;
};
template <> struct Piece<1> {
  using type = uint8_t;
  static constexpr int kBatch = 16;
};

__device__ __forceinline__ uint32_t word_of(uint4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc + lut[j0 + s][code_s] for the VEC codes of piece p, in increasing s.
template <int VEC, typename T>
__device__ __forceinline__ float add_piece(float acc, const T* tab,
                                           typename Piece<VEC>::type p,
                                           int j0, int C) {
  if constexpr (VEC == 1) {
    acc += upcast(tab[j0 * C + p]);
  } else {
#pragma unroll
    for (int s = 0; s < VEC; ++s) {
      uint32_t w;
      if constexpr (VEC == 16) w = word_of(p, s >> 2);
      else w = p;
      acc += upcast(tab[(j0 + s) * C + ((w >> (8 * (s & 3))) & 0xffu)]);
    }
  }
  return acc;
}

template <int VEC, typename T>
__global__ void __launch_bounds__(kThreads)
adc_scan_kernel(const T* __restrict__ luts, int64_t lut_bs,
                const uint8_t* __restrict__ codes, int64_t code_bs, int L,
                int m, int C, int vec_table, float* __restrict__ out) {
  using P = typename Piece<VEC>::type;
  constexpr int NB = Piece<VEC>::kBatch;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);
  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int G = gridDim.x;
  const T* src = luts + static_cast<int64_t>(b) * lut_bs;
  const int n = m * C;
  if (vec_table) {
    const int n16 = n * static_cast<int>(sizeof(T)) / 16;
    for (int i = t; i < n16; i += kThreads)
      reinterpret_cast<uint4*>(tab)[i] =
          reinterpret_cast<const uint4*>(src)[i];
  } else {
    for (int i = t; i < n; i += kThreads) tab[i] = src[i];
  }

  // this thread's row of tile `tile`, pieces [p0, p0 + NB) (zero past the
  // row or past L)
  const uint8_t* entry = codes + static_cast<int64_t>(b) * code_bs;
  const int np = m / VEC;  // pieces per row
  const int n_tiles = (L + kThreads - 1) / kThreads;
  auto load = [&](int tile, int p0, P (&pc)[NB]) {
    const int l = tile * kThreads + t;
    const P* row = reinterpret_cast<const P*>(
        entry + static_cast<int64_t>(l < L ? l : 0) * m);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      pc[i] = l < L && p0 + i < np ? row[p0 + i] : P{};
  };
  P cur[NB], nxt[NB];
  if (blockIdx.x < n_tiles) load(blockIdx.x, 0, cur);
  __syncthreads();  // the table is staged

  for (int tile = blockIdx.x; tile < n_tiles; tile += G) {
    const bool warp_live = tile * kThreads + (t & ~31) < L;
    float acc = 0.f;
    for (int p0 = 0; p0 < np; p0 += NB) {
      if (p0 + NB < np) load(tile, p0 + NB, nxt);         // the row's rest
      else if (tile + G < n_tiles) load(tile + G, 0, nxt);  // the next row
      if (warp_live)
#pragma unroll
        for (int i = 0; i < NB; ++i)
          if (p0 + i < np)
            acc = add_piece<VEC, T>(acc, tab, cur[i], (p0 + i) * VEC, C);
#pragma unroll
      for (int i = 0; i < NB; ++i) cur[i] = nxt[i];
    }
    const int l = tile * kThreads + t;
    if (l < L) out[static_cast<int64_t>(b) * L + l] = acc;
  }
}

template <int VEC, typename T>
int launch(const void* luts, int64_t lut_bs, const uint8_t* codes,
           int64_t code_bs, int B, int L, int m, int C, int G, int vec_table,
           float* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(m) * C * sizeof(T);
  const cudaError_t e = allow_smem(adc_scan_kernel<VEC, T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  adc_scan_kernel<VEC, T><<<dim3(G, B), kThreads, smem, stream>>>(
      static_cast<const T*>(luts), lut_bs, codes, code_bs, L, m, C, vec_table,
      out);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC, typename T>
int occupancy(int m, int C, int* per_sm) {
  const size_t smem = static_cast<size_t>(m) * C * sizeof(T);
  const cudaError_t e = allow_smem(adc_scan_kernel<VEC, T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, adc_scan_kernel<VEC, T>, kThreads, smem));
}

// FN<VEC, T>(args...) for the runtime code load width and table type.
#define REPRO_SCAN_DISPATCH(vec, bf16, FN, ...)                 \
  switch (2 * (vec) + ((bf16) ? 1 : 0)) {                       \
    case 32: return FN<16, float>(__VA_ARGS__);                 \
    case 33: return FN<16, __nv_bfloat16>(__VA_ARGS__);         \
    case 8: return FN<4, float>(__VA_ARGS__);                   \
    case 9: return FN<4, __nv_bfloat16>(__VA_ARGS__);           \
    case 2: return FN<1, float>(__VA_ARGS__);                   \
    case 3: return FN<1, __nv_bfloat16>(__VA_ARGS__);           \
    default: return static_cast<int>(cudaErrorInvalidValue);    \
  }

}  // namespace
}  // namespace repro

// Strides are in elements (bytes for the codes).  vec (16, 4 or 1 bytes per
// code load), G (blocks per batch entry) and vec_table (1: the tables are
// staged with 16-byte loads) come from repro_torch/kernels/tiles.py
// (scan_plan).  Returns the launch's cudaGetLastError().
extern "C" int repro_adc_scan(const void* luts, long long lut_bs, int lut_bf16,
                              const uint8_t* codes, long long code_bs, int B,
                              int L, int m, int C, int vec, int G,
                              int vec_table, float* out, void* stream) {
  REPRO_SCAN_DISPATCH(vec, lut_bf16, repro::launch, luts, lut_bs, codes,
                      code_bs, B, L, m, C, G, vec_table, out,
                      static_cast<cudaStream_t>(stream));
}

// Blocks of the scan one SM holds at once (the runtime's occupancy, by
// shared memory, registers and threads) for an (m, C) table.
extern "C" int repro_adc_scan_occupancy(int m, int C, int lut_bf16, int vec,
                                        int* per_sm) {
  REPRO_SCAN_DISPATCH(vec, lut_bf16, repro::occupancy, m, C, per_sm);
}

extern "C" const char* repro_adc_scan_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
