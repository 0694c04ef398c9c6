// threshold_mask: value planes (L, M, 128) of float or bf16 and one
//   threshold per plane (L,) -> (L, M, 128): x where |x| >= t, else +0.
//
// Replaces the TPU kernel repro/kernels/fused.py::_threshold_mask_kernel
// (pallas_call at fused.py:359), the top-k codec's sparsify pass.  t is
// the k-th largest |x| of the plane, chosen outside (torch.topk, as the
// reference takes it from lax.top_k) and rounded to the planes' dtype
// there, which is the dtype the kernel reads it in (so the wrapper
// launches nothing but the kernel on the main path); the compare runs in
// float32 on the widened |x| and t, which equals the compare in the
// planes' dtype.  A NaN never passes (every compare with NaN is
// false), a tie at t passes, a kept -0.0 stays -0.0, and a negative t
// keeps every value that is not NaN.
//
// Bound on an H100: memory.  It reads each value once and writes it once:
// 2 * sizeof(T) bytes an element.  Design:
//   - 16-byte vectors (4 floats or 8 bf16) over one flat index across all
//     planes: a plane's length is a multiple of 128 values, so no vector
//     straddles two planes, and the plane count is not limited;
//   - one vector a thread, 512 threads a block: the vector index is a
//     shift of the block number plus the thread number.  A thread that
//     took 2, 4 or 8 vectors a block's width apart (all loads before the
//     stores, t kept in a register across them) measured 0.4-0.7% slower
//     on the H100 in both dtypes, and slower than hardshrink in bf16;
//   - the thread finds its vector's plane (one division, issued after
//     the load, so it hides under it) and loads that plane's t once;
//   - the test runs on the bits: |x| is the value with its sign bit
//     cleared, and a bf16 value widens to float by a 16-bit shift.
// The wrapper raises on a base pointer that is not 16-byte aligned.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

// A float, or a bf16 value widened to float by a 16-bit shift (exact).
__device__ __forceinline__ float widen(float t) { return t; }
__device__ __forceinline__ float widen(uint16_t t) {
  return __uint_as_float((uint32_t)t << 16);
}

// One 32-bit word of the plane, masked: a float, or two bf16 values.
template <bool kBf16>
__device__ __forceinline__ uint32_t mask_word(uint32_t w, float t) {
  if constexpr (kBf16) {
    uint32_t lo = __uint_as_float((w & 0x7FFFu) << 16) >= t ? w & 0xFFFFu
                                                           : 0u;
    uint32_t hi = __uint_as_float(w & 0x7FFF0000u) >= t ? w & 0xFFFF0000u
                                                        : 0u;
    return lo | hi;
  } else {
    return __uint_as_float(w & 0x7FFFFFFFu) >= t ? w : 0u;
  }
}

// T: the planes' storage type, float or uint16_t (bf16 bits)
template <typename T>
__global__ void __launch_bounds__(kThreads) threshold_mask_kernel(
    const uint4* __restrict__ x, const T* __restrict__ thresh,
    uint4* __restrict__ out, long long vecs, long long vecs_per_plane) {
  constexpr bool kBf16 = sizeof(T) == 2;
  long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (v >= vecs) return;
  uint4 r = __ldg(x + v);
  float t = widen(__ldg(thresh + v / vecs_per_plane));
  out[v] = make_uint4(mask_word<kBf16>(r.x, t), mask_word<kBf16>(r.y, t),
                      mask_word<kBf16>(r.z, t), mask_word<kBf16>(r.w, t));
}

template <typename T>
int launch(const void* x, const void* thresh, void* out, long long planes,
           long long per_plane, void* stream) {
  if (planes <= 0 || per_plane <= 0) return (int)cudaSuccess;
  const long long per_vec = 16 / sizeof(T);
  if (per_plane % 128 || ((uintptr_t)x | (uintptr_t)out) & 15u)
    return (int)cudaErrorInvalidValue;
  long long vecs_per_plane = per_plane / per_vec;
  long long vecs = planes * vecs_per_plane;
  long long blocks = (vecs + kThreads - 1) / kThreads;
  threshold_mask_kernel<T><<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const uint4*)x, (const T*)thresh, (uint4*)out, vecs, vecs_per_plane);
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
  return launch<uint16_t>(x, thresh, out, planes, per_plane, stream);
}
