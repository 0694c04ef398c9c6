// majority_decode: vote counts (B, 32 R, 128) int32 + gate words
//   (B, R, 128) -> sign words and mask words, each (B, R, 128).
//
// Replaces the TPU kernel repro/kernels/popcount_majority.py::
// _majority_decode_kernel (pallas_call at popcount_majority.py:106): vote
// margin a = 2c - W in int32, sign bit = a > 0, mask bit = (a != 0) &
// gate.  This is the staged chain's second stage, after popcount_stack.
//
// Bound on an H100: memory.  It reads 4 bytes of count and 1/32 of a gate
// word per element and writes 2/32 of a word, so the count read sets its
// least time.  Design: one thread per output word (b, r, l) reads its 32
// counts [b, 32 r + k, l], strided by 128, so each of a warp's 32 loads
// covers 32 neighbouring lanes of one count row (one coalesced segment),
// and assembles both words in registers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kPack = 32;

__global__ void majority_decode_kernel(const int32_t* __restrict__ counts,
                                       const uint32_t* __restrict__ gate,
                                       uint32_t* __restrict__ sign_out,
                                       uint32_t* __restrict__ mask_out,
                                       long long num_words, int workers) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= num_words) return;
  long long r = idx / kLane;               // word row over all owners
  int l = (int)(idx % kLane);
  const int32_t* src = counts + r * kPack * kLane + l;
  uint32_t sign = 0, mask = 0;
#pragma unroll
  for (int k = 0; k < kPack; ++k) {
    int a = 2 * src[k * kLane] - workers;
    sign |= (uint32_t)(a > 0) << k;
    mask |= (uint32_t)(a != 0) << k;
  }
  sign_out[idx] = sign;
  mask_out[idx] = mask & gate[idx];
}

}  // namespace

extern "C" int majority_decode_u32(const void* counts, const void* gate,
                                   void* sign_out, void* mask_out,
                                   long long num_words, long long workers,
                                   void* stream) {
  if (num_words <= 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (num_words + threads - 1) / threads;
  majority_decode_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)counts, (const uint32_t*)gate, (uint32_t*)sign_out,
      (uint32_t*)mask_out, num_words, (int)workers);
  return (int)cudaGetLastError();
}
