// Nearest center on the tensor cores (the Lloyd kernel's large-d route):
// for each point of each batch entry, the id of its nearest center and the
// squared distance to it, plus each block's weighted SSE partial.
//
// Replaces the distance pass of repro/kernels/lloyd.py::lloyd_step_pallas
// where d >= 32 and the SIMT route's accumulator would not fit shared
// memory or its scan would read the point from device memory (d > 128)
// (repro_torch/kernels/tiles.py::lloyd_route).  What bounds it on
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
// Design.  A pre-pass (split_kernel) writes both operands' TF32 hi and lo
// planes to device memory, chunk by chunk of 32 dims in the K-major layout
// without swizzle that wgmma reads (8 x 16-byte core matrices), with the
// rows' squared norms and whether a tile of points has a nonzero lo.  The
// argmin (argmin_kernel) is then the ordinary GEMM main loop with K-dim =
// d.  Grid (ceil(M / 128), B): the blocks of one batch entry are
// consecutive, so the blocks resident at one time share one or two lanes'
// points and centers in L2.  A block takes 128 points and walks the lane's
// centers in tiles of 128, each in chunks of 32 dims: one producer warp
// copies a chunk's four planes (the points' lo only where a point of the
// block has one) into one of three stages with bulk asynchronous copies,
// completing on the stage's mbarrier, and two warpgroups, one per 64
// points, each issue wgmma m64n128k8 (asynchronous, both operands from
// shared memory) per 8 dims and pass, then release the stage on another
// mbarrier once their products of it are done.  The 64 x 128 accumulator
// tile of each warpgroup stays in registers across all of a center tile's
// chunks.  The shared memory (199,248 bytes) does not grow with d; each
// tile reads the block's points again, from L2.  After a tile each thread
// folds its 64 accumulators (2 rows x 32 centers) into a running (best,
// best_k) per row: d2 = max(|x|^2 + |c|^2 - 2 x.c, 0), the norms from the
// pre-pass (one code path per row, so identical centers get identical
// values).
//
// Ties.  Each thread visits its columns in increasing center order with a
// strict <, and the merge across the quad's lanes compares (d2, k)
// lexicographically, so the lowest index wins.  Identical centers give
// identical columns (same inputs, same k order).  No float atomics: a
// repeated launch is bit-identical.
#pragma once

#include <type_traits>

#include "distance.cuh"
#include "warp.cuh"

namespace repro {
namespace tc {

constexpr int kRows = 128;    // points per block: two warpgroups of 64
constexpr int kCols = 128;    // centers per tile (the wgmma's N)
constexpr int kChunk = 32;    // dims per staged chunk
constexpr int kPlane = kCols * kChunk;  // floats in a chunk's hi or lo plane
constexpr int kStages = 3;    // chunks in flight
constexpr int kThreads = 256;  // the two warpgroups
constexpr int kBlockThreads = kThreads + 32;  // and the producer warp

// Dims a block stages per point: d rounded up to whole chunks.
__host__ __device__ constexpr int dims(int d) {
  return (d + kChunk - 1) / kChunk * kChunk;
}

// A stage: the centers' hi and lo planes of a chunk, the points' hi and
// lo planes, then |c|^2 of the tile (copied with its last chunk).
constexpr size_t kStageBytes = sizeof(float) * (4 * kPlane + kCols);

// Shared memory of a block: kStages stages, their full and empty
// mbarriers, the rows' results and eight warp sums.
constexpr size_t kSmem = kStages * kStageBytes + 2 * kStages * 8 +
                         sizeof(float) * (2 * kRows + 8);

__host__ __device__ constexpr int64_t n_tiles(int rows) {
  return (rows + kRows - 1) / kRows;
}

// Floats of the workspace a launch takes (tiles.tc_work_floats), x_lanes
// 1 where the lanes share one point set (x_bs = 0), else B: the centers'
// planes (B, ceil(K / 128), dims(d) / 32, 2, kPlane), the points' (x_lanes,
// ceil(M / 128), ...), |c|^2 and |x|^2 in whole tiles, and each point
// tile's lo flag.
__host__ __device__ constexpr int64_t work_floats(int B, int M, int K, int d,
                                                  int x_lanes) {
  return (B * n_tiles(K) + x_lanes * n_tiles(M)) * kRows *
             (2 * dims(d) + 1) +
         x_lanes * n_tiles(M);
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

// The two warpgroups' barrier (the producer warp has left by then).
__device__ __forceinline__ void sync_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
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

// (d2, k) lexicographically below (best, best_k)
__device__ __forceinline__ bool better(float d2, int k, float best,
                                       int best_k) {
  return d2 < best || (d2 == best && k < best_k);
}

// This thread's share of a chunk of 128 rows x 32 dims, 4 pieces of 4
// dims: piece i is row 8 (warp + 8 (i & 1)) + (lane & 7), dims 4 ((lane >>
// 3) + 4 (i >> 1)).  A warp's load reads 64 contiguous bytes of each of 8
// rows; a quarter warp's store fills one 128-byte column of core matrices.
__device__ __forceinline__ int piece_row(int i, int warp, int lane) {
  return 8 * (warp + 8 * (i & 1)) + (lane & 7);
}
__device__ __forceinline__ int piece_col(int i, int lane) {
  return 4 * ((lane >> 3) + 4 * (i >> 1));
}

// Four consecutive coordinates of a row from element offset o, the first
// n of them in the row (zero past them; n <= 0: all zero): one 16-byte
// (f32) or 8-byte (bf16) load where vec holds and all four are in the row.
__device__ __forceinline__ float4 load4(const void* x, int64_t o, int n,
                                        int bf16, bool vec) {
  if (vec && n >= 4) {
    if (bf16) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(
          static_cast<const __nv_bfloat16*>(x) + o));
      return make_float4(__uint_as_float(u.x << 16),
                         __uint_as_float(u.x & 0xffff0000u),
                         __uint_as_float(u.y << 16),
                         __uint_as_float(u.y & 0xffff0000u));
    }
    return __ldg(reinterpret_cast<const float4*>(
        static_cast<const float*>(x) + o));
  }
  float v[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) v[r] = r < n ? load_f32(x, o + r, bf16) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// One operand of the pre-pass: T tiles of 128 rows in each lane of a (.,
// R, d) source with lane stride bs; its planes (planes + ((b T + t)
// dims(d) / 32 + chunk) 2 kPlane: hi, then lo), its rows' squared norms
// (norms + (b T + t) 128, `pad` past R) and, where any_lo is not null, each
// tile's lo flag.
struct Split {
  const void* src;
  int64_t bs;
  int bf16, R, T;
  float pad;
  float* planes;
  float* norms;
  int* any_lo;
};

// Block i of the pre-pass: tile i of operand a (i < n_a), else tile i - n_a
// of operand b (one launch for the centers and the points).  Its rows are
// split into TF32 hi and lo planes chunk by chunk, zero past d and R; the
// norms are one fixed-order sum a row, and the lo flag says whether a lo
// of the tile is nonzero.
__global__ void __launch_bounds__(kThreads)
split_kernel(Split a, Split b, int n_a, int d) {
  const bool in_a = static_cast<int>(blockIdx.x) < n_a;
  const Split op = in_a ? a : b;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t tile = in_a ? blockIdx.x : blockIdx.x - n_a;  // b T + t
  const int r0 = static_cast<int>(tile % op.T) * kRows;
  const void* src = op.src;
  const int bf16 = op.bf16, R = op.R;
  const int64_t bs = op.bs;
  const int n_chunks = dims(d) / kChunk;
  const int64_t base = tile / op.T * bs + static_cast<int64_t>(r0) * d;
  const bool vec = d % 4 == 0 && bs % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & (bf16 ? 7 : 15)) == 0;
  float* out = op.planes + tile * n_chunks * 2 * kPlane;
  float s[2] = {0.f, 0.f};  // rows piece_row(0) and piece_row(1)
  bool lo = false;
  for (int ch = 0; ch < n_chunks; ++ch) {
    float4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = piece_row(i, warp, lane);
      const int col = ch * kChunk + piece_col(i, lane);
      v[i] = load4(src, base + static_cast<int64_t>(r) * d + col,
                   r0 + r < R ? d - col : 0, bf16, vec);
      s[i & 1] = fmaf(v[i].x, v[i].x, s[i & 1]);
      s[i & 1] = fmaf(v[i].y, v[i].y, s[i & 1]);
      s[i & 1] = fmaf(v[i].z, v[i].z, s[i & 1]);
      s[i & 1] = fmaf(v[i].w, v[i].w, s[i & 1]);
      lo |= v[i].x != to_tf32(v[i].x) || v[i].y != to_tf32(v[i].y) ||
            v[i].z != to_tf32(v[i].z) || v[i].w != to_tf32(v[i].w);
    }
    float* hi = out + ch * 2 * kPlane;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t o =
          kmajor(piece_row(i, warp, lane), piece_col(i, lane), kChunk) / 4;
      const float4 h = make_float4(to_tf32(v[i].x), to_tf32(v[i].y),
                                   to_tf32(v[i].z), to_tf32(v[i].w));
      *reinterpret_cast<float4*>(hi + o) = h;
      *reinterpret_cast<float4*>(hi + kPlane + o) = make_float4(
          v[i].x - h.x, v[i].y - h.y, v[i].z - h.z, v[i].w - h.w);
    }
  }
  // a row's partials sit in lanes lane & 7 + 8 j, j = 0 .. 3
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 8);
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 16);
    const int r = piece_row(h, warp, lane);
    if (lane < 8) op.norms[tile * kRows + r] = r0 + r < R ? s[h] : op.pad;
  }
  if (op.any_lo != nullptr) {  // uniform in the block
    lo = __syncthreads_or(lo);
    if (t == 0) op.any_lo[tile] = lo;
  }
}

// Folds a finished tile into the running (best, best_k) of this thread's
// rows: columns in increasing center order, strict <.  x2: |x|^2 of the
// rows; c2t: |c|^2 of the tile's columns (INFINITY past K).
__device__ __forceinline__ void fold(const float (&acc)[64],
                                     const float (&x2)[2],
                                     const float* c2t, int tile, int q,
                                     float (&best)[2], int (&best_k)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * q + e;
        const float d2 =
            fmaxf(x2[h] + c2t[col] - 2.f * acc[4 * j + 2 * h + e], 0.f);
        if (d2 < best[h]) {
          best[h] = d2;
          best_k[h] = tile * kCols + col;
        }
      }
}

// The block's end, on the two warpgroups' threads: merge the quad's lanes
// (lexicographic), then the rows' outputs and the weighted SSE in a fixed
// order.  mb, mk: kRows floats and ints; wsse: a float a warp.
__device__ __forceinline__ void finish(
    float (&best)[2], int (&best_k)[2], float* mb, int* mk, float* wsse,
    const void* __restrict__ w, int64_t w_bs, int w_bf16, int M,
    int32_t* __restrict__ idx, float* __restrict__ dist,
    float* __restrict__ part_sse) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3, wg = warp >> 2;
  const int b = blockIdx.y, m0 = blockIdx.x * kRows;
  const int rows = min(kRows, M - m0);
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
  sync_consumers();
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
  sync_consumers();
  if (t == 0)
    part_sse[static_cast<int64_t>(b) * gridDim.x + blockIdx.x] =
        ((wsse[0] + wsse[1]) + wsse[2]) + wsse[3];
}

// Block (i, b): points [128 i, 128 i + 128) of lane b against all K
// centers, from split_kernel's planes: the centers' (cp, B lanes) and the
// points' (xp, lane b x_lane), |c|^2 (c2) and |x|^2 (x2) in whole tiles,
// the point tiles' lo flags (xlo).  Warps 0-7 are the two warpgroups; warp
// 8 issues the copies.  Without part_sse (the assignment kernel's call) w
// is not read and no SSE partial is written.
__global__ void __launch_bounds__(kBlockThreads, 1)
argmin_kernel(const float* __restrict__ cp, const float* __restrict__ c2,
              const float* __restrict__ xp, const float* __restrict__ x2,
              const int* __restrict__ xlo, int x_lane,
              const void* __restrict__ w, int64_t w_bs, int w_bf16, int M,
              int K, int d, int32_t* __restrict__ idx,
              float* __restrict__ dist, float* __restrict__ part_sse) {
  extern __shared__ float4 smem4[];
  constexpr int kStageFloats = static_cast<int>(kStageBytes / 4);
  float* stages = reinterpret_cast<float*>(smem4);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(stages + kStages * kStageFloats);
  uint64_t* empty = full + kStages;
  float* mb = reinterpret_cast<float*>(empty + kStages);
  int* mk = reinterpret_cast<int*>(mb + kRows);
  float* wsse = reinterpret_cast<float*>(mk + kRows);

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int b = blockIdx.y;
  const int n_chunks = dims(d) / kChunk;
  const int n_ct = (K + kCols - 1) / kCols;
  const int total = n_ct * n_chunks;
  const int64_t xt = static_cast<int64_t>(b) * x_lane * gridDim.x +
                     blockIdx.x;            // the block's point tile
  const bool lo_pass = xlo[xt] != 0;

  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);       // the producer's expect_tx
      mbar_init(&empty[s], 8);      // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kThreads / 32) {  // the producer
    if (lane == 0) {
      const float* cb = cp + static_cast<int64_t>(b) * n_ct * n_chunks * 2 *
                                 kPlane;
      const float* xb = xp + xt * n_chunks * 2 * kPlane;
      const uint32_t x_bytes = (lo_pass ? 2 : 1) * kPlane * 4;
      for (int it = 0; it < total; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
        const int tile = it / n_chunks, chunk = it - tile * n_chunks;
        const bool last = chunk == n_chunks - 1;
        float* st = stages + s * kStageFloats;
        mbar_expect_tx(&full[s], 2 * kPlane * 4 + x_bytes +
                                     (last ? kCols * 4 : 0));
        bulk_copy(st, cb + static_cast<int64_t>(it) * 2 * kPlane,
                  2 * kPlane * 4, &full[s]);
        bulk_copy(st + 2 * kPlane, xb + static_cast<int64_t>(chunk) * 2 *
                                            kPlane, x_bytes, &full[s]);
        if (last)
          bulk_copy(st + 4 * kPlane,
                    c2 + (static_cast<int64_t>(b) * n_ct + tile) * kCols,
                    kCols * 4, &full[s]);
      }
    }
    return;
  }

  const int g = lane >> 2, q = lane & 3;
  const int wg = warp >> 2;                 // warpgroup: points 64 wg ..
  // rows 64 wg + 16 (warp & 3) + g + 8 h, h = 0, 1
  const int r = 64 * wg + 16 * (warp & 3) + g;
  const float xr2[2] = {x2[xt * kRows + r], x2[xt * kRows + r + 8]};
  float best[2] = {INFINITY, INFINITY};
  int best_k[2] = {0, 0};
  float acc[64];
  const uint32_t s0 = smem_addr(stages);

  // chunk it: wait for its stage, issue its products, wait for the
  // previous chunk's and release that chunk's stage; after a tile's last
  // chunk, wait for its products and fold (|c|^2 from the last stage,
  // released only after the fold)
  auto main_loop = [&](auto lo_tag) {
    constexpr bool kLo = decltype(lo_tag)::value;
    int it = 0;
    for (int tile = 0; tile < n_ct; ++tile) {
      for (int chunk = 0; chunk < n_chunks; ++chunk, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        const uint32_t bh = s0 + s * static_cast<uint32_t>(kStageBytes);
        const uint32_t bl = bh + kPlane * 4;
        const uint32_t ah = bh + 2 * kPlane * 4 + wg * 64 / 8 * kChunk * 32;
        const uint32_t al = ah + kPlane * 4;
        fence_operand(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kChunk / 8; ++ks) {
          const uint64_t dah = descriptor(ah + ks * 256, kChunk * 32);
          const uint64_t dbh = descriptor(bh + ks * 256, kChunk * 32);
          const int keep = chunk > 0 || ks > 0;
          if constexpr (kLo)
            wgmma_128(acc, descriptor(al + ks * 256, kChunk * 32), dbh,
                      keep);
          wgmma_128(acc, dah, descriptor(bl + ks * 256, kChunk * 32),
                    kLo ? 1 : keep);
          wgmma_128(acc, dah, dbh, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_operand(acc);
        if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
      wgmma_wait<0>();
      fence_operand(acc);
      fold(acc, xr2,
           stages + ((it - 1) % kStages) * kStageFloats + 4 * kPlane, tile,
           q, best, best_k);
    }
  };
  if (lo_pass)
    main_loop(std::true_type{});
  else
    main_loop(std::false_type{});

  finish(best, best_k, mb, mk, wsse, w, w_bs, w_bf16, M, idx, dist,
         part_sse);
}

// The argmin of B lanes of M points against (B, K, d) centers c: the
// pre-pass, then argmin_kernel.  work: work_floats(B, M, K, d, x_bs == 0 ?
// 1 : B) floats (n_work, checked).  part_sse (B, ceil(M / kRows)) or
// nullptr.  Returns the first error.
inline cudaError_t launch_argmin(const void* x, int64_t x_bs, int x_bf16,
                                 const void* w, int64_t w_bs, int w_bf16,
                                 const void* c, int64_t c_bs, int c_bf16,
                                 int B, int M, int K, int d, float* work,
                                 int64_t n_work, int32_t* idx, float* dist,
                                 float* part_sse, cudaStream_t s) {
  const int x_lanes = x_bs == 0 ? 1 : B;
  if (n_work < work_floats(B, M, K, d, x_lanes)) return cudaErrorInvalidValue;
  const int mt = static_cast<int>(n_tiles(M));
  const int kt = static_cast<int>(n_tiles(K));
  // planes first (whole tiles of 16 KB a plane, so every copy's source is
  // aligned)
  const int64_t tile_floats = static_cast<int64_t>(kRows) * 2 * dims(d);
  float* cp = work;
  float* xp = cp + B * kt * tile_floats;
  float* c2 = xp + static_cast<int64_t>(x_lanes) * mt * tile_floats;
  float* x2 = c2 + static_cast<int64_t>(B) * kt * kRows;
  int* xlo = reinterpret_cast<int*>(x2 + static_cast<int64_t>(x_lanes) * mt *
                                             kRows);
  const Split centers{c, c_bs, c_bf16, K, kt, INFINITY, cp, c2, nullptr};
  const Split points{x, x_bs, x_bf16, M, mt, 0.f, xp, x2, xlo};
  split_kernel<<<static_cast<unsigned>(B * kt + x_lanes * mt), kThreads, 0,
                 s>>>(centers, points, B * kt, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = allow_smem(argmin_kernel, kSmem);
  if (e != cudaSuccess) return e;
  argmin_kernel<<<dim3(mt, B), kBlockThreads, kSmem, s>>>(
      cp, c2, xp, x2, xlo, x_lanes == 1 ? 0 : 1, w, w_bs, w_bf16, M, K, d,
      idx, dist, part_sse);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace repro
