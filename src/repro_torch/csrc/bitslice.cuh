// Bit-sliced (vertical) vote counters, shared by the vote kernels.
//
// A count of up to 2^P - 1 for each of the 32 bit positions of a word is
// held as P 32-bit count planes: bit k of plane p is bit p of position
// k's count.  Adding a word of votes is a ripple of P half adders (2 P
// integer operations for all 32 positions at once), and comparing every
// count with one constant is an MSB-first walk over the planes, where a
// per-position counter would spend ~3 operations a position on each.
#pragma once

#include <stdint.h>

template <int P>
struct BitCounter {
  uint32_t plane[P];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int p = 0; p < P; ++p) plane[p] = 0u;
  }

  // count[k] += bit k of word, for k = 0..31
  __device__ __forceinline__ void add(uint32_t word) {
    uint32_t carry = word;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      uint32_t t = plane[p] & carry;
      plane[p] ^= carry;
      carry = t;
    }
  }

  // Positions whose count is greater than k (gt) and equal to k (eq);
  // k < 2^P.  k is the same for every thread, so the branch is uniform.
  __device__ __forceinline__ void compare(uint32_t k, uint32_t& gt,
                                          uint32_t& eq) const {
    gt = 0u;
    eq = 0xFFFFFFFFu;
#pragma unroll
    for (int p = P - 1; p >= 0; --p) {
      if ((k >> p) & 1u) {
        eq &= plane[p];
      } else {
        gt |= eq & plane[p];
        eq &= ~plane[p];
      }
    }
  }
};
