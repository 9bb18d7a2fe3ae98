// ADC (asymmetric distance computation) scan on Hopper (sm_90a), the IVF/PQ
// query hot loop: out[b, l] = sum over j of lut[b, j, code[b, l, j]].
//
// Replaces the TPU kernel repro/kernels/scan.py::_adc_kernel
// (adc_scan_pallas).  VMEM has no fast random gather, so that kernel turns
// every lookup into a one-hot compare and an MXU matvec.  Hopper gathers
// from shared memory directly, so here the lookups stay lookups:
//   * one block per (batch entry b, group of 256-row tiles): it stages b's
//     (m, C) table in shared memory as f32 (bf16 tables are upcast), once,
//     then walks its tiles g, g + G, ... (G blocks per entry, so the table is
//     staged G times per entry, not once per tile);
//   * each thread owns one candidate row: it reads the row's m uint8 codes
//     with 16- or 4-byte vector loads where the rows are so aligned, and
//     sums lut[j][code_j] in increasing j in f32.
//
// What bounds it: bytes.  Each candidate's m code bytes are read once and
// one f32 is written; the table is read G times per entry (from L2 after the
// first), against once in the bound.  The shared-memory gathers are m per
// row, far below the card's shared-memory bandwidth at these sizes.
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

// Add lut[j][code_j] for the 4 codes packed little-endian in `word`,
// j = j0 .. j0 + 3, in increasing j.
__device__ __forceinline__ float add_word(float acc, const float* slut,
                                          uint32_t word, int j0, int C) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
    acc += slut[(j0 + s) * C + ((word >> (8 * s)) & 0xffu)];
  return acc;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
adc_scan_kernel(const void* __restrict__ luts, int64_t lut_bs, int lut_bf16,
                const uint8_t* __restrict__ codes, int64_t code_bs, int L,
                int m, int C, float* __restrict__ out) {
  extern __shared__ float slut[];  // (m, C) f32
  const int b = blockIdx.y;
  const int g = blockIdx.x;
  const int G = gridDim.x;
  const int n = m * C;
  const int64_t lbase = static_cast<int64_t>(b) * lut_bs;
  for (int i = threadIdx.x; i < n; i += kThreads)
    slut[i] = load_f32(luts, lbase + i, lut_bf16);
  __syncthreads();

  const uint8_t* entry = codes + static_cast<int64_t>(b) * code_bs;
  const int n_tiles = (L + kThreads - 1) / kThreads;
  for (int tile = g; tile < n_tiles; tile += G) {
    const int l = tile * kThreads + threadIdx.x;
    if (l >= L) continue;
    const uint8_t* row = entry + static_cast<int64_t>(l) * m;
    float acc = 0.f;
    if constexpr (VEC == 16) {
      const uint4* r4 = reinterpret_cast<const uint4*>(row);
      for (int q = 0; q < m / 16; ++q) {
        const uint4 v = r4[q];
        acc = add_word(acc, slut, v.x, 16 * q, C);
        acc = add_word(acc, slut, v.y, 16 * q + 4, C);
        acc = add_word(acc, slut, v.z, 16 * q + 8, C);
        acc = add_word(acc, slut, v.w, 16 * q + 12, C);
      }
    } else if constexpr (VEC == 4) {
      const uint32_t* r1 = reinterpret_cast<const uint32_t*>(row);
      for (int q = 0; q < m / 4; ++q) acc = add_word(acc, slut, r1[q], 4 * q, C);
    } else {
      for (int j = 0; j < m; ++j) acc += slut[j * C + row[j]];
    }
    out[static_cast<int64_t>(b) * L + l] = acc;
  }
}

template <int VEC>
int launch(const void* luts, int64_t lut_bs, int lut_bf16,
           const uint8_t* codes, int64_t code_bs, int B, int L, int m, int C,
           int G, float* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(m) * C * sizeof(float);
  cudaError_t e = allow_smem(adc_scan_kernel<VEC>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  adc_scan_kernel<VEC><<<dim3(G, B), kThreads, smem, stream>>>(
      luts, lut_bs, lut_bf16, codes, code_bs, L, m, C, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// Strides are in elements (bytes for the codes).  vec (16, 4 or 1 bytes per
// code load) and G (blocks per batch entry) come from
// repro_torch/kernels/tiles.py.  Returns the launch's cudaGetLastError().
extern "C" int repro_adc_scan(const void* luts, long long lut_bs, int lut_bf16,
                              const uint8_t* codes, long long code_bs, int B,
                              int L, int m, int C, int vec, int G, float* out,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 16: return repro::launch<16>(luts, lut_bs, lut_bf16, codes, code_bs,
                                      B, L, m, C, G, out, s);
    case 4: return repro::launch<4>(luts, lut_bs, lut_bf16, codes, code_bs, B,
                                    L, m, C, G, out, s);
    case 1: return repro::launch<1>(luts, lut_bs, lut_bf16, codes, code_bs, B,
                                    L, m, C, G, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_adc_scan_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
