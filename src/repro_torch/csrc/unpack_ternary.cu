// unpack_ternary: sign words and mask words (R, 128) -> float32 plane
// (32 R, 128) of {-1, 0, +1}.
//
// Replaces the TPU kernel repro/kernels/apply_update.py::
// _unpack_ternary_kernel (pallas_call at apply_update.py:47):
// value [32 r + b, l] = (2 s - 1) * m with s, m bit b of the two words.
// A masked element is +0.0, as the reference's integer product gives.
//
// Bound on an H100: memory.  It reads 2 bits and writes 4 bytes per
// element, so the write stream sets its least time.  Design: one thread
// per output element; a warp writes 32 neighbouring lanes of one row
// (one coalesced 128-byte store) and the 32 rows of a word row read the
// same two words, which stay in L1.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kPack = 32;

__global__ void unpack_ternary_kernel(const uint32_t* __restrict__ sign,
                                      const uint32_t* __restrict__ mask,
                                      float* __restrict__ out,
                                      long long num_values) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= num_values) return;
  long long row = idx / kLane;
  int l = (int)(idx % kLane);
  long long w = (row / kPack) * kLane + l;
  int b = (int)(row % kPack);
  uint32_t s = (sign[w] >> b) & 1u;
  uint32_t m = (mask[w] >> b) & 1u;
  out[idx] = m ? (s ? 1.0f : -1.0f) : 0.0f;
}

}  // namespace

extern "C" int unpack_ternary_f32(const void* sign, const void* mask,
                                  void* out, long long num_values,
                                  void* stream) {
  if (num_values <= 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (num_values + threads - 1) / threads;
  unpack_ternary_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)sign, (const uint32_t*)mask, (float*)out,
      num_values);
  return (int)cudaGetLastError();
}
