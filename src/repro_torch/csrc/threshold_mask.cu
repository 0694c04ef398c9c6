// threshold_mask: value planes (L, M, 128) of float or bf16 and one
//   threshold per plane (L,) -> (L, M, 128): x where |x| >= t, else +0.
//
// Replaces the TPU kernel repro/kernels/fused.py::_threshold_mask_kernel
// (pallas_call at fused.py:359), the top-k codec's sparsify pass.  t is
// the k-th largest |x| of the plane, chosen outside (torch.topk, as the
// reference takes it from lax.top_k) and rounded to the planes' dtype
// there; the wrapper hands it widened to float32, which is exact, and the
// compare runs in float32 on the widened |x|, so it equals the compare in
// the planes' dtype.  A NaN never passes (every compare with NaN is
// false); a kept -0.0 stays -0.0.
//
// Bound on an H100: memory.  It reads each value once and writes it once:
// 2 * sizeof(T) bytes an element.  Design: one thread per element,
// blockIdx.y the plane (its threshold), so loads and stores coalesce.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

template <typename T>
__global__ void threshold_mask_kernel(const T* __restrict__ x,
                                      const float* __restrict__ thresh,
                                      T* __restrict__ out,
                                      long long per_plane) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_plane) return;
  long long off = (long long)blockIdx.y * per_plane + i;
  T v = x[off];
  out[off] = fabsf(widen(v)) >= thresh[blockIdx.y] ? v : zero<T>();
}

template <typename T>
int launch(const void* x, const void* thresh, void* out, long long planes,
           long long per_plane, void* stream) {
  if (planes <= 0 || per_plane <= 0) return (int)cudaSuccess;
  if (planes > 65535) return (int)cudaErrorInvalidConfiguration;
  const int threads = 256;
  dim3 grid((unsigned)((per_plane + threads - 1) / threads),
            (unsigned)planes);
  threshold_mask_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)thresh, (T*)out, per_plane);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int threshold_mask_f32(const void* x, const void* thresh,
                                  void* out, long long planes,
                                  long long per_plane, void* stream) {
  return launch<float>(x, thresh, out, planes, per_plane, stream);
}

extern "C" int threshold_mask_bf16(const void* x, const void* thresh,
                                   void* out, long long planes,
                                   long long per_plane, void* stream) {
  return launch<__nv_bfloat16>(x, thresh, out, planes, per_plane, stream);
}
