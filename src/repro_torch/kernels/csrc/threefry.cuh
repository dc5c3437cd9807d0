// The threefry2x32 hash of jax.random (non-partitionable), shared by the
// keyed quantizer (K5, wire_pack.cu) and the normal kernel
// (threefry_normal.cu).
//
// A size-n draw from key words (k0, k1) is the 32-bit words of blocks
// over the counters iota(n) split in halves: with half = (n + 1) / 2,
// block `pair` < half hashes the counters (pair, pair + half) and gives
// position pair its first word and position pair + half its second. For
// an odd n the last block's second counter is 0 and its second word is
// dropped (position n does not exist). threefry_pair hashes one block
// once and returns both of its words, so a thread that owns a block
// writes both positions it serves. The plain version is
// src/repro_torch/kernels/ref.py:threefry_bits_ref.

#pragma once

#include <stdint.h>

namespace threefry {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// one threefry2x32 block (jax's 20-round schedule, ref.py:threefry2x32_pair)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0,
                                             uint32_t c1, uint32_t& o0, uint32_t& o1) {
  const uint32_t ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const uint32_t inj[5][2] = {{k1, ks2}, {ks2, k0}, {k0, k1}, {k1, ks2}, {ks2, k0}};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += inj[i][0];
    x1 += inj[i][1] + static_cast<uint32_t>(i + 1);
  }
  o0 = x0;
  o1 = x1;
}

// block `pair` (< half) of a size-n draw, hashed once: o0 is the word of
// position pair, o1 that of position pair + half (unused when it is n)
__device__ __forceinline__ void threefry_pair(uint32_t k0, uint32_t k1, uint32_t pair,
                                              uint32_t n, uint32_t& o0, uint32_t& o1) {
  const uint32_t half = (n + 1u) / 2u;
  const uint32_t c1 = pair + half < n ? pair + half : 0u;
  threefry2x32(k0, k1, pair, c1, o0, o1);
}

// the word at position p of a size-n draw, its block hashed for it alone
__device__ __forceinline__ uint32_t threefry_word(uint32_t k0, uint32_t k1, uint32_t p,
                                                  uint32_t n) {
  const uint32_t half = (n + 1u) / 2u;
  const bool lo = p < half;
  uint32_t o0, o1;
  threefry_pair(k0, k1, lo ? p : p - half, n, o0, o1);
  return lo ? o0 : o1;
}

// jax.random.uniform's mantissa fill: the top 23 bits under the exponent
// of 1.0, minus 1 -> [0, 1)
__device__ __forceinline__ float bits_to_unit(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

}  // namespace threefry
