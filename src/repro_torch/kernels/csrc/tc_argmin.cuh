// Nearest center on the tensor cores (the Lloyd kernel's large-d route):
// for each point of each batch entry, the id of its nearest center and the
// squared distance to it, plus each block's weighted SSE partial.
//
// Replaces the distance pass of repro/kernels/lloyd.py::lloyd_step_pallas
// where d >= 32 and the SIMT route's accumulator would not fit shared
// memory (repro_torch/kernels/tiles.py::lloyd_route).  What bounds it on
// this card: the tensor cores' TF32 rate.  The cross term x.c of every
// (point, center) pair is a (M x d) . (d x K) product per batch entry; at
// the KV-cache refresh (256 lanes x 9216 x 8192, d = 128) that is 2.5e12
// multiply-adds, 74.7 ms on the FP32 CUDA cores, 30 ms on the tensor cores
// in three TF32 passes.
//
// Precision.  TF32 keeps 10 mantissa bits, far too few for the near-ties
// of fp32 distances at d = 128.  Both operands are split v = hi + lo with
// hi = v rounded to TF32 (as cvt.rna.tf32 does, in two integer operations)
// and lo = v - hi (exact), and the product is accumulated as
// lo_x hi_c + hi_x lo_c + hi_x hi_c in fp32: the dropped lo_x lo_c and the
// truncation of lo (the tensor core reads the top 19 bits of an operand)
// are near 2^-21 relative, fp32-class.  Where every lo of a block's points
// is 0 (values exact in TF32, e.g. the refresh's upcast bf16 keys) the
// block leaves out the lo_x pass: its products are exact zeros, so the
// result is the same, a third sooner.
//
// Design.  Grid (ceil(M / 128), B): the blocks of one batch entry are
// consecutive, so the blocks resident at one time share one or two lanes'
// centers in L2.  A block holds its 128 points in shared memory, split once
// into hi and lo planes, with |x|^2 by one fixed-order loop per row.  It
// walks the lane's centers in tiles of 128, each in chunks of 32 dims: the
// threads load a chunk into registers one chunk ahead, split it and store
// hi and lo into one of three buffers (a buffer is rewritten only after a
// barrier that follows both warpgroups' waits for its readers).  Operands
// sit in the K-major layout without swizzle that wgmma reads (8 x 16-byte
// core matrices).  Two warpgroups, one per 64 points, each issue wgmma
// m64n128k8 (asynchronous, both operands from shared memory) per 8 dims
// and pass; a chunk's products run while the next chunk is staged.  After
// a tile each thread folds its 64 accumulators (2 rows x 32 centers) into
// a running (best, best_k) per row: d2 = max(|x|^2 + |c|^2 - 2 x.c, 0),
// |c|^2 from the pre-pass (one code path per row, so identical centers get
// identical values).
//
// Ties.  Each thread visits its columns in increasing center order with a
// strict <, and the merge across the quad's lanes compares (d2, k)
// lexicographically, so the lowest index wins.  Identical centers give
// identical columns (same inputs, same k order).  No float atomics: a
// repeated launch is bit-identical.
#pragma once

#include "distance.cuh"
#include "warp.cuh"

namespace repro {
namespace tc {

constexpr int kRows = 128;    // points per block: two warpgroups of 64
constexpr int kCols = 128;    // centers per tile (the wgmma's N)
constexpr int kChunk = 32;    // dims per staged chunk of centers
constexpr int kBuffers = 3;   // staged chunks: written 3 chunks after read
constexpr int kThreads = 256;

// Dims a block stages per point: d rounded up to whole chunks.
__host__ __device__ constexpr int dims(int d) {
  return (d + kChunk - 1) / kChunk * kChunk;
}

// Shared memory of one block: the points' hi and lo planes, kBuffers
// buffers of the centers' hi and lo chunks (at the end, the rows' results
// and four warp sums), |x|^2 and two tiles of |c|^2.
__host__ __device__ constexpr size_t smem_bytes(int d) {
  return sizeof(float) *
         (2 * static_cast<size_t>(kRows) * dims(d) +
          2 * kBuffers * static_cast<size_t>(kCols) * kChunk + kRows +
          2 * kCols);
}

// Byte offset of (row, col) in a K-major plane of `cols` columns without
// swizzle: 8-row x 16-byte core matrices, adjacent along K at 128 bytes
// (the descriptor's leading offset), along the rows at cols * 32 bytes
// (its stride offset).
__device__ __forceinline__ uint32_t kmajor(int row, int col, int cols) {
  return (row >> 3) * (cols * 32) + (col >> 2) * 128 + (row & 7) * 16 +
         (col & 3) * 4;
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets, no swizzle.
__device__ __forceinline__ uint64_t descriptor(uint32_t saddr, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cvt.rna.tf32.f32 in two integer operations: the mantissa rounded to 10
// bits, ties away from zero (the conversion instruction issues at a
// fraction of the integer rate).
__device__ __forceinline__ float to_tf32(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
}

// d (+)= A (64 x 8, K-major in shared memory) . B (8 x 128, K-major in
// shared memory), both TF32; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses to d across a wgmma's issue or
// its wait.
__device__ __forceinline__ void fence_operand(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory writes by this thread become visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// (d2, k) lexicographically below (best, best_k)
__device__ __forceinline__ bool better(float d2, int k, float best,
                                       int best_k) {
  return d2 < best || (d2 == best && k < best_k);
}

// |c|^2 of every center, one warp per row (lane l takes coordinates l,
// l + 32, ..., then a butterfly of fixed shape), and a copy of the centers
// as f32 rows of dims(d) floats, zero past d, which the argmin reads.
__global__ void centers_kernel(const void* __restrict__ c, int64_t c_bs,
                               int c_bf16, int B, int K, int d,
                               float* __restrict__ c2,
                               float* __restrict__ cpad) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<int64_t>(B) * K) return;  // warp-uniform
  const int64_t b = row / K, k = row % K;
  const int64_t src = b * c_bs + k * d;
  const int D = dims(d);
  float s = 0.f;
  for (int j = lane; j < D; j += 32) {
    const float v = j < d ? load_f32(c, src + j, c_bf16) : 0.f;
    s = fmaf(v, v, s);
    cpad[row * D + j] = v;
  }
  s = warp_sum(s);
  if (lane == 0) c2[row] = s;
}

// Block (i, b): points [128 i, 128 i + 128) of lane b against all K
// centers, read from centers_kernel's copy (B, K, dims(d)).  Without
// part_sse (the assignment kernel's call) w is not read and no SSE
// partial is written.
__global__ void __launch_bounds__(kThreads, 1)
argmin_kernel(const void* __restrict__ x, int64_t x_bs, int x_bf16,
              const void* __restrict__ w, int64_t w_bs, int w_bf16,
              const float* __restrict__ c, const float* __restrict__ c2,
              int M, int K, int d, int32_t* __restrict__ idx,
              float* __restrict__ dist, float* __restrict__ part_sse) {
  extern __shared__ float4 smem4[];
  const int D = dims(d);
  float* xhi = reinterpret_cast<float*>(smem4);
  float* xlo = xhi + kRows * D;
  float* cbuf = xlo + kRows * D;  // [kBuffers][hi, lo][kCols x kChunk]
  float* x2s = cbuf + 2 * kBuffers * kCols * kChunk;
  float* c2s = x2s + kRows;                 // [2 tiles][kCols]
  float* mb = cbuf;  // after the last products: the rows' results
  int* mk = reinterpret_cast<int*>(mb + kRows);
  float* wsse = reinterpret_cast<float*>(mk + kRows);

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wg = warp >> 2;                 // warpgroup: points 64 wg ..
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kRows;
  const int rows = min(kRows, M - m0);

  const int n_chunks = D / kChunk;
  const int n_tiles = (K + kCols - 1) / kCols;
  const int total = n_tiles * n_chunks;
  const float* cb = c + static_cast<int64_t>(b) * K * D;

  // this thread's share of a chunk, 4 pieces of 4 dims: piece i is row
  // 8 (warp + 8 (i & 1)) + (lane & 7), dims 4 ((lane >> 3) + 4 (i >> 1)).
  // A warp's load reads 64 contiguous bytes of each of 8 rows; a quarter
  // warp's store fills one 128-byte column of core matrices.
  float4 pre[4];
  auto piece_row = [&](int i) {
    return 8 * (warp + 8 * (i & 1)) + (lane & 7);
  };
  auto piece_col = [&](int i) { return 4 * ((lane >> 3) + 4 * (i >> 1)); };
  auto fetch = [&](int it) {
    const int tile = it / n_chunks, chunk = it - tile * n_chunks;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = tile * kCols + piece_row(i);
      const int col = chunk * kChunk + piece_col(i);
      pre[i] = n < K ? __ldg(reinterpret_cast<const float4*>(
                           cb + static_cast<int64_t>(n) * D + col))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto stage = [&](int it) {
    float* hi = cbuf + (it % kBuffers) * 2 * kCols * kChunk;
    float* lo = hi + kCols * kChunk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t o = kmajor(piece_row(i), piece_col(i), kChunk) / 4;
      const float4 v = pre[i];
      const float4 h = make_float4(to_tf32(v.x), to_tf32(v.y), to_tf32(v.z),
                                   to_tf32(v.w));
      *reinterpret_cast<float4*>(hi + o) = h;
      *reinterpret_cast<float4*>(lo + o) =
          make_float4(v.x - h.x, v.y - h.y, v.z - h.z, v.w - h.w);
    }
  };
  fetch(0);

  // the block's points, zero-padded, split; whether any has a nonzero lo
  const int64_t xb =
      static_cast<int64_t>(b) * x_bs + static_cast<int64_t>(m0) * d;
  bool any_lo = false;
  for (int i = t; i < kRows * D; i += kThreads) {
    const int r = i / D, j = i - r * D;
    const float v =
        (r < rows && j < d)
            ? load_f32(x, xb + static_cast<int64_t>(r) * d + j, x_bf16)
            : 0.f;
    const float h = to_tf32(v);
    const uint32_t o = kmajor(r, j, D) / 4;
    xhi[o] = h;
    xlo[o] = v - h;
    any_lo |= v != h;
  }
  const bool lo_pass = __syncthreads_or(any_lo);
  if (t < kRows) {  // |x|^2: one fixed-order loop per row (v = hi + lo)
    float s = 0.f;
    for (int j = 0; j < d; ++j) {
      const uint32_t o = kmajor(t, j, D) / 4;
      const float v = xhi[o] + xlo[o];
      s = fmaf(v, v, s);
    }
    x2s[t] = s;
  }

  const uint32_t a_hi = smem_addr(xhi) + wg * 64 / 8 * (D * 32);
  const uint32_t a_lo = smem_addr(xlo) + wg * 64 / 8 * (D * 32);
  const uint32_t b0 = smem_addr(cbuf);

  // rows 64 wg + 16 (warp & 3) + g + 8 h, h = 0, 1
  float best[2] = {INFINITY, INFINITY};
  int best_k[2] = {0, 0};
  float acc[64];

  // fold a finished tile: columns in increasing center order, strict <
  auto fold = [&](int tile) {
    const float* c2t = c2s + (tile & 1) * kCols;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x2 = x2s[64 * wg + 16 * (warp & 3) + g + 8 * h];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * q + e;
          const float d2 =
              fmaxf(x2 + c2t[col] - 2.f * acc[4 * j + 2 * h + e], 0.f);
          if (d2 < best[h]) {
            best[h] = d2;
            best_k[h] = tile * kCols + col;
          }
        }
    }
  };
  // |c|^2 of this thread's column of a tile (t < kCols), a tile ahead
  auto c2_of = [&](int tile) {
    const int n = tile * kCols + t;
    return t < kCols && n < K ? c2[static_cast<int64_t>(b) * K + n]
                              : INFINITY;
  };
  float c2_next = c2_of(0);

  // chunk it: stage it, make the stores visible to wgmma, then load chunk
  // it + 1 (after the proxy fence, which would otherwise wait for those
  // loads: they stay in flight across the barrier and the products);
  // after a tile's last chunk, wait for the products and fold
  for (int it = 0; it < total; ++it) {
    const int tile = it / n_chunks, chunk = it - tile * n_chunks;
    stage(it);  // buffer it % 3: its last readers, both warpgroups'
                // products of chunk it - 3, were waited for before the
                // previous iteration's barrier
    if (chunk == 0 && t < kCols) c2s[(tile & 1) * kCols + t] = c2_next;
    fence_async_smem();
    if (it + 1 < total) fetch(it + 1);
    if (chunk == 0 && tile + 1 < n_tiles) c2_next = c2_of(tile + 1);
    __syncthreads();

    const uint32_t bh = b0 + (it % kBuffers) * 2 * kCols * kChunk * 4;
    const uint32_t bl = bh + kCols * kChunk * 4;
    const uint32_t ka = chunk * kChunk / 8 * 256;  // 2 core matrices per 8
    fence_operand(acc);
    wgmma_fence();
    if (lo_pass) {
#pragma unroll
      for (int ks = 0; ks < kChunk / 8; ++ks) {
        const uint64_t dah = descriptor(a_hi + ka + ks * 256, D * 32);
        const uint64_t dbh = descriptor(bh + ks * 256, kChunk * 32);
        wgmma_128(acc, descriptor(a_lo + ka + ks * 256, D * 32), dbh,
                  chunk > 0 || ks > 0);
        wgmma_128(acc, dah, descriptor(bl + ks * 256, kChunk * 32), 1);
        wgmma_128(acc, dah, dbh, 1);
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kChunk / 8; ++ks) {
        const uint64_t dah = descriptor(a_hi + ka + ks * 256, D * 32);
        wgmma_128(acc, dah, descriptor(bl + ks * 256, kChunk * 32),
                  chunk > 0 || ks > 0);
        wgmma_128(acc, dah, descriptor(bh + ks * 256, kChunk * 32), 1);
      }
    }
    wgmma_commit();
    if (chunk == n_chunks - 1) {
      wgmma_wait<0>();
      fence_operand(acc);
      fold(tile);
    } else {
      wgmma_wait<1>();
      fence_operand(acc);
    }
  }

  __syncthreads();  // every warpgroup's products are done: cbuf is free

  // merge the quad's lanes (lexicographic), then the block's outputs and
  // weighted SSE in a fixed order
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[h], off);
      const int ok = __shfl_xor_sync(0xffffffffu, best_k[h], off);
      if (better(ob, ok, best[h], best_k[h])) {
        best[h] = ob;
        best_k[h] = ok;
      }
    }
  if (q == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 64 * wg + 16 * (warp & 3) + g + 8 * h;
      mb[row] = best[h];
      mk[row] = best_k[h];
    }
  __syncthreads();
  if (t < rows) {
    const int64_t o = static_cast<int64_t>(b) * M + m0 + t;
    idx[o] = mk[t];
    dist[o] = mb[t];
  }
  if (part_sse == nullptr) return;  // the assignment alone (no weights)
  if (t < kRows) {
    float v = 0.f;
    if (t < rows) {
      const float wv =
          load_f32(w, static_cast<int64_t>(b) * w_bs + m0 + t, w_bf16);
      v = wv != 0.f ? wv * mb[t] : 0.f;
    }
    v = warp_sum(v);
    if (lane == 0) wsse[warp] = v;
  }
  __syncthreads();
  if (t == 0)
    part_sse[static_cast<int64_t>(b) * gridDim.x + blockIdx.x] =
        ((wsse[0] + wsse[1]) + wsse[2]) + wsse[3];
}

}  // namespace tc
}  // namespace repro
