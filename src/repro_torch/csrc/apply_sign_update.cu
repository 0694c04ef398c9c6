// apply_sign_update: parameter plane (M, 128) of float or bf16, the
//   ternary packed pair (M/32, 128) of sign and mask words, and a float32
//   scale -> param - scale * u, (M, 128) in the parameter's dtype.
//
// Replaces the TPU kernel repro/kernels/apply_update.py::
// _apply_sign_update_kernel (pallas_call at apply_update.py:87).  u is
// +1 / -1 by the sign bit where the mask bit is set and +0.0 elsewhere,
// as unpack_ternary decodes it; the update is computed in float32 (the
// product scale * u, then the difference, each IEEE-rounded) and rounded
// once to the parameter's dtype.  The thread forms the three products
// scale * +1, scale * -1 and scale * +0 once and picks one an element by
// two bit tests, so a scale of +-0, +-inf or NaN and a parameter of +-0,
// +-inf, NaN or a subnormal give the bits of the plain twin's
// ``param.float() - scale * u`` rounded to the dtype.
//
// Bound on an H100: memory.  It reads the parameter once, two bits per
// element of words, and writes the parameter once: 2 * sizeof(T) + 1/4
// bytes an element.  The first version spent a thread, a 64-bit division
// and two word loads on each element (64 bytes a warp instruction in
// bf16).  Design: one thread per 8 neighbouring lanes of one row, i.e. per
// 16-byte vector of the parameter in bf16 (two in float): the vector's
// index is the thread's number, and its word row (row / 32), lanes and
// bit (row % 32) are shifts of it.  The thread makes one 16-byte load of
// parameters (two in float), two of sign words and two of mask words
// (the 32 rows of a word row share them, so all but the first hit in
// cache), 8 updates, and as many 16-byte stores, which a warp makes over
// two whole rows.  A sweep on the H100 found this fastest in both dtypes:
// a thread that walked 2 to 32 rows of its word row, loading the words
// once, was slower (the full walk most of all, in float, where its long
// threads left the last wave's blocks running alone), and streaming
// stores were no faster than plain ones.
//
// The scale comes by value, or through a pointer to one float32 on the
// card (a one-element tensor), which the kernel reads itself: neither
// way makes the caller wait for the card.  The wrapper raises on
// operands that are not 16-byte aligned.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kPack = 32;
constexpr int kLaneGroups = 16;           // 128 lanes in groups of 8
constexpr int kThreads = 256;

// scale * u for the three values of u, each rounded as the twin rounds it
struct Steps {
  float plus, minus, zero;
};

// x - scale * u for bit b of the element's sign and mask words.
__device__ __forceinline__ float update(float x, uint32_t s, uint32_t m,
                                        int b, const Steps& st) {
  const float d = ((m >> b) & 1u) ? (((s >> b) & 1u) ? st.plus : st.minus)
                                  : st.zero;
  return __fsub_rn(x, d);
}

// Two bf16 parameters in one 32-bit word (low half first), updated.
__device__ __forceinline__ uint32_t update_bf16x2(
    uint32_t x, const uint32_t* s, const uint32_t* m, int b,
    const Steps& st) {
  const float lo = update(__uint_as_float(x << 16), s[0], m[0], b, st);
  const float hi = update(__uint_as_float(x & 0xFFFF0000u), s[1], m[1], b,
                          st);
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t update_f32(uint32_t x, uint32_t s,
                                               uint32_t m, int b,
                                               const Steps& st) {
  return __float_as_uint(update(__uint_as_float(x), s, m, b, st));
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads) apply_sign_update_kernel(
    const uint4* __restrict__ param, const uint4* __restrict__ sign,
    const uint4* __restrict__ mask, const float* __restrict__ scale_ptr,
    float scale, uint4* __restrict__ out, long long threads) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= threads) return;
  if (scale_ptr != nullptr) scale = __ldg(scale_ptr);
  const Steps st = {__fmul_rn(scale, 1.0f), __fmul_rn(scale, -1.0f),
                    __fmul_rn(scale, 0.0f)};
  // thread t: lanes 8 (t % 16) .. + 7 of row t / 16 = 32 r + b; its
  // words are 16-byte vectors 32 r + 2 (t % 16) and the next
  const int b = (int)(t >> 4) & (kPack - 1);
  const long long w = (t >> 9) * 32 + 2 * (t & (kLaneGroups - 1));
  const uint4 sa = __ldg(sign + w), sb = __ldg(sign + w + 1);
  const uint4 ma = __ldg(mask + w), mb = __ldg(mask + w + 1);
  const uint32_t s[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
  const uint32_t m[8] = {ma.x, ma.y, ma.z, ma.w, mb.x, mb.y, mb.z, mb.w};
  if constexpr (kBf16) {
    const uint4 x = __ldg(param + t);
    out[t] = make_uint4(update_bf16x2(x.x, s, m, b, st),
                        update_bf16x2(x.y, s + 2, m + 2, b, st),
                        update_bf16x2(x.z, s + 4, m + 4, b, st),
                        update_bf16x2(x.w, s + 6, m + 6, b, st));
  } else {
    const uint4 x0 = __ldg(param + 2 * t), x1 = __ldg(param + 2 * t + 1);
    out[2 * t] = make_uint4(update_f32(x0.x, s[0], m[0], b, st),
                            update_f32(x0.y, s[1], m[1], b, st),
                            update_f32(x0.z, s[2], m[2], b, st),
                            update_f32(x0.w, s[3], m[3], b, st));
    out[2 * t + 1] = make_uint4(update_f32(x1.x, s[4], m[4], b, st),
                                update_f32(x1.y, s[5], m[5], b, st),
                                update_f32(x1.z, s[6], m[6], b, st),
                                update_f32(x1.w, s[7], m[7], b, st));
  }
}

template <bool kBf16>
int launch(const void* param, const void* sign, const void* mask,
           const void* scale_ptr, void* out, long long n, float scale,
           void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n % (kPack * 128) || ((uintptr_t)param | (uintptr_t)sign |
                            (uintptr_t)mask | (uintptr_t)out) & 15u)
    return (int)cudaErrorInvalidValue;
  const long long threads = n / 8;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  apply_sign_update_kernel<kBf16><<<(unsigned)blocks, kThreads, 0,
                                    (cudaStream_t)stream>>>(
      (const uint4*)param, (const uint4*)sign, (const uint4*)mask,
      (const float*)scale_ptr, scale, (uint4*)out, threads);
  return (int)cudaGetLastError();
}

}  // namespace

// scale_ptr: one float32 on the card, or null to take ``scale``.
extern "C" int apply_sign_update_f32(const void* param, const void* sign,
                                     const void* mask, const void* scale_ptr,
                                     void* out, long long n, float scale,
                                     void* stream) {
  return launch<false>(param, sign, mask, scale_ptr, out, n, scale, stream);
}

extern "C" int apply_sign_update_bf16(const void* param, const void* sign,
                                      const void* mask,
                                      const void* scale_ptr, void* out,
                                      long long n, float scale,
                                      void* stream) {
  return launch<true>(param, sign, mask, scale_ptr, out, n, scale, stream);
}
