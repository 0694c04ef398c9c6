// sign_pack: value plane (M, 128) of float or bf16 -> sign words (M/32, 128).
//
// Replaces the TPU kernel repro/kernels/sign_pack.py::_sign_pack_kernel
// (pallas_call at sign_pack.py:52).  Bit b of word [r, l] is 1 iff
// value [32 r + b, l] > 0; -0.0 and NaN give 0, as in the reference.
//
// Bound on an H100: memory.  The kernel reads each value once and writes
// one bit per value, so it moves n * (sizeof(T) + 1/8) bytes; at the
// card's 3.35 TB/s that is its least time.  Design: one thread per output
// word.  A warp covers 32 neighbouring lanes of one word row, so each of
// its 32 row loads is one coalesced segment, and the word is assembled in
// a register and written once.  Several planes stacked one after another
// (the W workers of a bucket) are one plane of W*M rows, packed in one
// launch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kPack = 32;

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void sign_pack_kernel(const T* __restrict__ plane,
                                 uint32_t* __restrict__ words,
                                 long long num_words) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= num_words) return;
  long long r = idx / kLane;
  int l = (int)(idx % kLane);
  const T* src = plane + r * kPack * kLane + l;
  uint32_t word = 0;
#pragma unroll
  for (int b = 0; b < kPack; ++b) {
    word |= (uint32_t)(as_float(src[b * kLane]) > 0.0f) << b;
  }
  words[idx] = word;
}

template <typename T>
int launch(const void* plane, void* words, long long num_words,
           void* stream) {
  if (num_words <= 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (num_words + threads - 1) / threads;
  sign_pack_kernel<T><<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
      (const T*)plane, (uint32_t*)words, num_words);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sign_pack_f32(const void* plane, void* words,
                             long long num_words, void* stream) {
  return launch<float>(plane, words, num_words, stream);
}

extern "C" int sign_pack_bf16(const void* plane, void* words,
                              long long num_words, void* stream) {
  return launch<__nv_bfloat16>(plane, words, num_words, stream);
}
