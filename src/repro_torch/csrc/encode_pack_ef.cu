// encode_pack_ef: value planes g (M, 128) and error-feedback residuals e
// (M, 128) -> sign words (M/32, 128) and the g_eff = g + e plane (M, 128).
//
// Replaces the TPU kernel repro/kernels/fused.py::_encode_pack_ef_kernel
// (pallas_call at fused.py:210).  g_eff is formed in g's dtype with the
// residual rounded to that dtype first (the reference adds
// ef.astype(g.dtype)); in bfloat16 the sum is a float add rounded once to
// bfloat16 (__float2bfloat16_rn), which is what PyTorch does for
// `g + e.to(g.dtype)`.  A native bfloat16 add is not used: its rounding
// need not be the same where the two exponents are far apart.  Bit b of
// word [r, l] is 1 iff the *rounded* g_eff [32 r + b, l] > 0, so -0.0 and
// NaN give 0.
//
// Bound on an H100: memory.  Per element it reads g and e and writes
// g_eff and one bit: with bf16 g and f32 e, 2 + 4 + 2 + 1/8 bytes.
// Design: one thread per output word.  A warp covers 32 neighbouring
// lanes of one word row, so each of its 32 row loads and stores is one
// coalesced segment; the residual is read in its own dtype and rounded in
// registers, which saves a separate cast pass over e.  The W planes of a
// bucket, stacked one after another, are one plane of W*M rows and go in
// one launch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kPack = 32;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// float -> T, rounded to nearest even
template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename TG, typename TE>
__global__ void encode_pack_ef_kernel(const TG* __restrict__ g,
                                      const TE* __restrict__ e,
                                      uint32_t* __restrict__ words,
                                      TG* __restrict__ g_eff,
                                      long long num_words) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= num_words) return;
  long long r = idx / kLane;
  int l = (int)(idx % kLane);
  long long base = r * kPack * kLane + l;
  uint32_t word = 0;
#pragma unroll
  for (int b = 0; b < kPack; ++b) {
    long long i = base + (long long)b * kLane;
    // e rounded to g's dtype, then one float add rounded to g's dtype
    float ev = widen(narrow<TG>(widen(e[i])));
    TG x = narrow<TG>(__fadd_rn(widen(g[i]), ev));
    g_eff[i] = x;
    word |= (uint32_t)(widen(x) > 0.0f) << b;
  }
  words[idx] = word;
}

template <typename TG, typename TE>
int launch(const void* g, const void* e, void* words, void* g_eff,
           long long num_words, void* stream) {
  if (num_words <= 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (num_words + threads - 1) / threads;
  encode_pack_ef_kernel<TG, TE><<<(unsigned)blocks, threads, 0,
                                  (cudaStream_t)stream>>>(
      (const TG*)g, (const TE*)e, (uint32_t*)words, (TG*)g_eff, num_words);
  return (int)cudaGetLastError();
}

}  // namespace

// one entry point per (g dtype, e dtype)
#define ENCODE_PACK_EF(NAME, TG, TE)                                       \
  extern "C" int NAME(const void* g, const void* e, void* words,           \
                      void* g_eff, long long num_words, void* stream) {    \
    return launch<TG, TE>(g, e, words, g_eff, num_words, stream);          \
  }

ENCODE_PACK_EF(encode_pack_ef_f32_f32, float, float)
ENCODE_PACK_EF(encode_pack_ef_f32_bf16, float, __nv_bfloat16)
ENCODE_PACK_EF(encode_pack_ef_bf16_f32, __nv_bfloat16, float)
ENCODE_PACK_EF(encode_pack_ef_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
