// unpack_ternary: sign words and mask words (R, 128) -> plane (32 R, 128)
// of {-1, 0, +1} in float32 or bfloat16.
//
// Replaces the TPU kernel repro/kernels/apply_update.py::
// _unpack_ternary_kernel (pallas_call at apply_update.py:47):
// value [32 r + b, l] = (2 s - 1) * m with s, m bit b of the two words,
// cast to the output dtype (the reference's ``dtype`` argument).  A masked
// element is +0.0, as the reference's integer product gives; -1, 0 and +1
// are exact in both dtypes.
//
// Bound on an H100: memory.  It reads 2 bits and writes 4 (f32) or 2
// (bf16) bytes per element, so the write stream sets its least time.  The
// first version spent a thread, a 64-bit division and two word loads on
// each element.  Design: one thread per (word row r, 4 neighbouring
// lanes).  It loads the two 16-byte groups of words once and writes the
// 32 rows 32 r + b, each with one vector store (16 bytes in f32, 8 in
// bf16), so a warp writes whole rows; the indices are shifts of the
// thread's number.  The stores stream past the cache (st.global.cs): the
// plane of the main path's largest leaf is larger than L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPack = 32;
constexpr int kQuadsPerRow = 32;          // 128 lanes in groups of 4
constexpr int kThreads = 256;

// Bits of (2 s - 1) * m for bit b: +1, -1 or +0 in the output format.
template <bool kBf16>
__device__ __forceinline__ uint32_t ternary_bits(uint32_t s, uint32_t m,
                                                 int b) {
  constexpr uint32_t kOne = kBf16 ? 0x3F80u : 0x3F800000u;
  constexpr int kSignBit = kBf16 ? 15 : 31;
  uint32_t neg = (~s >> b) & 1u;
  return ((m >> b) & 1u) ? (kOne | (neg << kSignBit)) : 0u;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads) unpack_ternary_kernel(
    const uint4* __restrict__ sign, const uint4* __restrict__ mask,
    void* __restrict__ out, long long quads) {
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= quads) return;
  uint4 s = __ldg(sign + i), m = __ldg(mask + i);
  // word row r = i / 32, lane group q = i % 32: output row 32 r + b holds
  // this thread's 4 values at vector index (32 r + b) * 32 + q
  long long base = (i >> 5) * (kPack * kQuadsPerRow) + (i & 31);
#pragma unroll
  for (int b = 0; b < kPack; ++b) {
    uint32_t e0 = ternary_bits<kBf16>(s.x, m.x, b);
    uint32_t e1 = ternary_bits<kBf16>(s.y, m.y, b);
    uint32_t e2 = ternary_bits<kBf16>(s.z, m.z, b);
    uint32_t e3 = ternary_bits<kBf16>(s.w, m.w, b);
    long long v = base + (long long)b * kQuadsPerRow;
    if constexpr (kBf16) {
      __stcs((uint2*)out + v, make_uint2(e0 | (e1 << 16), e2 | (e3 << 16)));
    } else {
      __stcs((uint4*)out + v, make_uint4(e0, e1, e2, e3));
    }
  }
}

template <bool kBf16>
int launch(const void* sign, const void* mask, void* out,
           long long num_words, void* stream) {
  if (num_words <= 0) return (int)cudaSuccess;
  if (num_words % 128 || ((uintptr_t)sign | (uintptr_t)mask |
                          (uintptr_t)out) & 15u)
    return (int)cudaErrorInvalidValue;
  long long quads = num_words / 4;
  long long blocks = (quads + kThreads - 1) / kThreads;
  unpack_ternary_kernel<kBf16><<<(unsigned)blocks, kThreads, 0,
                                 (cudaStream_t)stream>>>(
      (const uint4*)sign, (const uint4*)mask, out, quads);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int unpack_ternary_f32(const void* sign, const void* mask,
                                  void* out, long long num_words,
                                  void* stream) {
  return launch<false>(sign, mask, out, num_words, stream);
}

extern "C" int unpack_ternary_bf16(const void* sign, const void* mask,
                                   void* out, long long num_words,
                                   void* stream) {
  return launch<true>(sign, mask, out, num_words, stream);
}
