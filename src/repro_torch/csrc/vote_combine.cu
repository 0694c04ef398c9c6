// vote_combine: routed sign words (B, W, R, 128) + gate (B, R, 128)
//   -> sign words and mask words, each (B, R, 128).
//
// Replaces the TPU kernel repro/kernels/fused.py::_vote_combine_kernel
// (pallas_call at fused.py:238): PopCount c over the W workers per bit,
// vote margin a = 2c - W, sign bit = a > 0, mask bit = (a != 0) & gate.
// B is the number of owner shards handled in one launch (all W owners of
// a virtual group, or the one shard this rank owns).
//
// Bound on an H100: memory.  It reads W + 1 words and writes 2 words per
// 32 elements; the counts never leave registers.  A counter per bit
// position costs ~450 integer instructions a word at W = 4, which made
// the first version bound by its integer instruction rate.  Design:
//   - bit-sliced counters (bitslice.cuh): P = bit_length(W) count planes,
//     a ripple of half adders per worker word, then one MSB-first compare
//     of every count with K = W / 2: sign = c > K; for even W the tie
//     c == K clears the mask, for odd W there is no tie.  The kernel is
//     a template on P, so counts of any W below 2^32 cannot wrap;
//   - one thread per 4 neighbouring lanes, 16-byte loads and stores (the
//     wrapper checks the alignment of pointers and strides);
//   - a 2-D grid, y over owners and x over an owner's words: no division.
//
// The owner and worker axes take any stride (in words, a multiple of 4)
// while rows and lanes are contiguous, so a virtual group's all_to_all,
// which is a transposed view of the packed words, needs no copy.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitslice.cuh"

namespace {

constexpr int kLane = 128;
constexpr int kThreads = 256;

template <int P>
__device__ __forceinline__ void decide(const BitCounter<P>& c, uint32_t k,
                                       bool even, uint32_t gate,
                                       uint32_t& sign, uint32_t& mask) {
  uint32_t eq;
  c.compare(k, sign, eq);
  mask = even ? (gate & ~eq) : gate;
}

template <int P>
__global__ void __launch_bounds__(kThreads) vote_combine_kernel(
    const uint4* __restrict__ routed, const uint4* __restrict__ gate,
    uint4* __restrict__ sign_out, uint4* __restrict__ mask_out,
    long long workers, long long quads,
    long long owner_stride, long long worker_stride, uint32_t k,
    bool even) {
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= quads) return;
  long long b = blockIdx.y;
  const uint4* src = routed + b * owner_stride + i;
  BitCounter<P> c0, c1, c2, c3;
  c0.clear(); c1.clear(); c2.clear(); c3.clear();
#pragma unroll 4
  for (long long w = 0; w < workers; ++w) {
    uint4 v = __ldg(src);
    src += worker_stride;
    c0.add(v.x); c1.add(v.y); c2.add(v.z); c3.add(v.w);
  }
  long long o = b * quads + i;
  uint4 g = __ldg(gate + o), s, m;
  decide(c0, k, even, g.x, s.x, m.x);
  decide(c1, k, even, g.y, s.y, m.y);
  decide(c2, k, even, g.z, s.z, m.z);
  decide(c3, k, even, g.w, s.w, m.w);
  sign_out[o] = s;
  mask_out[o] = m;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

#define VOTE_COMBINE_CASE(P)                                              \
  case P:                                                                 \
    vote_combine_kernel<P><<<grid, kThreads, 0, (cudaStream_t)stream>>>(  \
        (const uint4*)routed, (const uint4*)gate, (uint4*)sign_out,       \
        (uint4*)mask_out, workers, quads, owner_stride / 4,               \
        worker_stride / 4, k, even);                                      \
    break;

extern "C" int vote_combine_u32(const void* routed, const void* gate,
                                void* sign_out, void* mask_out,
                                long long owners, long long workers,
                                long long rows, long long owner_stride,
                                long long worker_stride, void* stream) {
  long long quads = rows * (kLane / 4);     // 16-byte groups per owner
  if (owners <= 0 || quads <= 0) return (int)cudaSuccess;
  if (workers < 1 || workers > 0xFFFFFFFFLL || owner_stride % 4 ||
      worker_stride % 4 || !aligned16(routed) || !aligned16(gate) ||
      !aligned16(sign_out) || !aligned16(mask_out))
    return (int)cudaErrorInvalidValue;
  int p = 64 - __builtin_clzll((unsigned long long)workers);
  uint32_t k = (uint32_t)(workers >> 1);
  bool even = (workers & 1) == 0;
  // more than 65,535 owners is refused by the launch (and reported)
  dim3 grid((unsigned)((quads + kThreads - 1) / kThreads), (unsigned)owners);
  switch (p) {
    VOTE_COMBINE_CASE(1) VOTE_COMBINE_CASE(2) VOTE_COMBINE_CASE(3)
    VOTE_COMBINE_CASE(4) VOTE_COMBINE_CASE(5) VOTE_COMBINE_CASE(6)
    VOTE_COMBINE_CASE(7) VOTE_COMBINE_CASE(8) VOTE_COMBINE_CASE(9)
    VOTE_COMBINE_CASE(10) VOTE_COMBINE_CASE(11) VOTE_COMBINE_CASE(12)
    VOTE_COMBINE_CASE(13) VOTE_COMBINE_CASE(14) VOTE_COMBINE_CASE(15)
    VOTE_COMBINE_CASE(16) VOTE_COMBINE_CASE(17) VOTE_COMBINE_CASE(18)
    VOTE_COMBINE_CASE(19) VOTE_COMBINE_CASE(20) VOTE_COMBINE_CASE(21)
    VOTE_COMBINE_CASE(22) VOTE_COMBINE_CASE(23) VOTE_COMBINE_CASE(24)
    VOTE_COMBINE_CASE(25) VOTE_COMBINE_CASE(26) VOTE_COMBINE_CASE(27)
    VOTE_COMBINE_CASE(28) VOTE_COMBINE_CASE(29) VOTE_COMBINE_CASE(30)
    VOTE_COMBINE_CASE(31) VOTE_COMBINE_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
