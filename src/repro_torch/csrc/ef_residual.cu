// ef_residual: value planes x (L, M, 128) and one beta per plane (L,)
//   -> error-feedback residuals x - beta * sgn(x), (L, M, 128), written
//   in the residuals' dtype.
//
// Replaces the TPU kernel repro/kernels/fused.py::_ef_residual_kernel
// (pallas_call at fused.py:305).  beta = mean|g_eff| over the leaf's own
// elements is computed outside, as the reference does (fused.py:387): the
// zero padding of the plane would lower it.  The arithmetic is PyTorch's
// on tensors of x's dtype: sgn(x) = (0 < x) - (x < 0), so NaN and -0.0
// give +0; the product beta * sgn(x) and the difference are each rounded
// to x's dtype (__float2bfloat16_rn for bfloat16); the result is then
// widened (or narrowed) to the residuals' dtype in the same store.
//
// Bound on an H100: memory.  It reads x once and writes the residual
// once: with bf16 x and f32 residuals, 2 + 4 bytes an element.  Design:
// one thread per element, blockIdx.y the plane (its beta), so a warp's
// loads and stores are coalesced and no thread divides by the plane size.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

// x - beta * sgn(x) in T's arithmetic: each operation rounded to T
template <typename T>
__device__ __forceinline__ T residual(T x, T beta) {
  float xf = widen(x);
  float s = (float)((0.0f < xf) - (xf < 0.0f));
  T p = narrow<T>(__fmul_rn(widen(beta), s));
  return narrow<T>(__fsub_rn(xf, widen(p)));
}

template <typename TX, typename TO>
__global__ void ef_residual_kernel(const TX* __restrict__ x,
                                   const float* __restrict__ beta,
                                   TO* __restrict__ out,
                                   long long per_plane) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_plane) return;
  long long off = (long long)blockIdx.y * per_plane + i;
  TX b = narrow<TX>(beta[blockIdx.y]);
  out[off] = narrow<TO>(widen(residual<TX>(x[off], b)));
}

template <typename TX, typename TO>
int launch(const void* x, const void* beta, void* out, long long planes,
           long long per_plane, void* stream) {
  if (planes <= 0 || per_plane <= 0) return (int)cudaSuccess;
  if (planes > 65535) return (int)cudaErrorInvalidConfiguration;
  const int threads = 256;
  dim3 grid((unsigned)((per_plane + threads - 1) / threads),
            (unsigned)planes);
  ef_residual_kernel<TX, TO><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const TX*)x, (const float*)beta, (TO*)out, per_plane);
  return (int)cudaGetLastError();
}

}  // namespace

// one entry point per (x dtype, residual dtype); beta is float32
#define EF_RESIDUAL(NAME, TX, TO)                                          \
  extern "C" int NAME(const void* x, const void* beta, void* out,          \
                      long long planes, long long per_plane,               \
                      void* stream) {                                      \
    return launch<TX, TO>(x, beta, out, planes, per_plane, stream);        \
  }

EF_RESIDUAL(ef_residual_f32_f32, float, float)
EF_RESIDUAL(ef_residual_f32_bf16, float, __nv_bfloat16)
EF_RESIDUAL(ef_residual_bf16_f32, __nv_bfloat16, float)
EF_RESIDUAL(ef_residual_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
