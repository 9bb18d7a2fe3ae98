// Warp-level helpers shared by the Lloyd kernel's accumulation
// (accumulate.cuh) and the centroid update (centroid.cu).
#pragma once

namespace repro {

// The lanes of this warp whose key equals this lane's, for keys below
// 2^nbits (nbits warp-uniform): one ballot per bit.  __match_any_sync gives
// the same mask but measured slower on the H100; unrolling the loop was
// slower still.
__device__ __forceinline__ unsigned equal_lanes(unsigned key, int nbits) {
  unsigned eq = 0xffffffffu;
  for (int i = 0; i < nbits; ++i) {
    const bool bit = (key >> i) & 1u;
    const unsigned set = __ballot_sync(0xffffffffu, bit);
    eq &= bit ? set : ~set;
  }
  return eq;
}

// The sum of v over the warp, valid in lane 0: a butterfly of fixed shape,
// so a repeated call adds in the same order.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace repro
