// apply_sign_update: parameter plane (M, 128) of float or bf16, the
//   ternary packed pair (M/32, 128) of sign and mask words, and a float32
//   scale -> param - scale * u, (M, 128) in the parameter's dtype.
//
// Replaces the TPU kernel repro/kernels/apply_update.py::
// _apply_sign_update_kernel (pallas_call at apply_update.py:87).  u is
// +1 / -1 by the sign bit where the mask bit is set and +0.0 elsewhere,
// as unpack_ternary decodes it; the update is computed in float32 (the
// product scale * u, then the difference, each IEEE-rounded) and rounded
// once to the parameter's dtype (__float2bfloat16_rn for bf16).
//
// Bound on an H100: memory.  It reads the parameter once, two bits per
// element of words, and writes the parameter once: 2 * sizeof(T) + 1/4
// bytes an element.  Design: one thread per element; a warp covers 32
// neighbouring lanes of one row, so the parameter loads and stores
// coalesce and the 32 rows that share a word pair find it in L1.  The
// scale is read from the card, so the caller never syncs for it.
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

template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void apply_sign_update_kernel(const T* __restrict__ param,
                                         const uint32_t* __restrict__ sign,
                                         const uint32_t* __restrict__ mask,
                                         const float* __restrict__ scale,
                                         T* __restrict__ out,
                                         long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long row = i / kLane;
  long long w = (row / kPack) * kLane + i % kLane;
  int bit = (int)(row % kPack);
  float u = ((mask[w] >> bit) & 1u) ? (((sign[w] >> bit) & 1u) ? 1.0f : -1.0f)
                                    : 0.0f;
  out[i] = narrow<T>(__fsub_rn(widen(param[i]), __fmul_rn(scale[0], u)));
}

template <typename T>
int launch(const void* param, const void* sign, const void* mask,
           const void* scale, void* out, long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  apply_sign_update_kernel<T><<<(unsigned)blocks, threads, 0,
                                (cudaStream_t)stream>>>(
      (const T*)param, (const uint32_t*)sign, (const uint32_t*)mask,
      (const float*)scale, (T*)out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int apply_sign_update_f32(const void* param, const void* sign,
                                     const void* mask, const void* scale,
                                     void* out, long long n, void* stream) {
  return launch<float>(param, sign, mask, scale, out, n, stream);
}

extern "C" int apply_sign_update_bf16(const void* param, const void* sign,
                                      const void* mask, const void* scale,
                                      void* out, long long n, void* stream) {
  return launch<__nv_bfloat16>(param, sign, mask, scale, out, n, stream);
}
