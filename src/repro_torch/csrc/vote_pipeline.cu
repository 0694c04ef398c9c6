// vote_pipeline: stacked value planes (W, M, 128) of float or bf16 + gate
//   words (M/32, 128) -> the decoded float32 plane (M, 128) of {-1, 0, +1}.
//
// Replaces the TPU kernel repro/kernels/fused.py::_vote_pipeline_kernel
// (pallas_call at fused.py:272): the whole local vote datapath, encode ->
// PopCount -> majority -> gate -> decode, in one pass.  Per element: c =
// number of workers whose value is > 0 (so -0.0 and NaN count as 0, as in
// sign_pack), a = 2c - W, keep = the element's gate bit; the output is
// +1 where a > 0, -1 where a < 0, and +0.0 where a == 0 or the gate drops
// it.  The count is an int32 at any W (the reference twice wrapped int8
// counts at W >= 128).
//
// Bound on an H100: memory.  It reads each of the W values once, the gate
// bit once and writes one float: n * (W * sizeof(T) + 1/8 + 4) bytes.
// Design: one thread per element; a warp covers 32 neighbouring lanes of
// one row, so each worker's load and the store are coalesced, and the 32
// rows that share a gate word find it in L1.  No packed words, counts or
// ternary pair reach device memory.
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
__global__ void vote_pipeline_kernel(const T* __restrict__ stack,
                                     const uint32_t* __restrict__ gate,
                                     float* __restrict__ out,
                                     long long per_plane, int workers) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_plane) return;
  int count = 0;
  for (int w = 0; w < workers; ++w) {
    count += as_float(stack[(long long)w * per_plane + i]) > 0.0f;
  }
  long long row = i / kLane;
  int l = (int)(i % kLane);
  uint32_t word = gate[(row / kPack) * kLane + l];
  int keep = (int)((word >> (row % kPack)) & 1u);
  int a = 2 * count - workers;
  out[i] = (a != 0 && keep) ? (a > 0 ? 1.0f : -1.0f) : 0.0f;
}

template <typename T>
int launch(const void* stack, const void* gate, void* out,
           long long per_plane, long long workers, void* stream) {
  if (per_plane <= 0) return (int)cudaSuccess;
  if (workers < 1 || workers > (1LL << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = 256;
  long long blocks = (per_plane + threads - 1) / threads;
  vote_pipeline_kernel<T><<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      (const T*)stack, (const uint32_t*)gate, (float*)out, per_plane,
      (int)workers);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vote_pipeline_f32(const void* stack, const void* gate,
                                 void* out, long long per_plane,
                                 long long workers, void* stream) {
  return launch<float>(stack, gate, out, per_plane, workers, stream);
}

extern "C" int vote_pipeline_bf16(const void* stack, const void* gate,
                                  void* out, long long per_plane,
                                  long long workers, void* stream) {
  return launch<__nv_bfloat16>(stack, gate, out, per_plane, workers, stream);
}
