// vote_combine: routed sign words (B, W, R, 128) + gate (B, R, 128)
//   -> sign words and mask words, each (B, R, 128).
//
// Replaces the TPU kernel repro/kernels/fused.py::_vote_combine_kernel
// (pallas_call at fused.py:238): PopCount over the W workers per bit, vote
// margin a = 2c - W, sign bit = a > 0, mask bit = (a != 0) & gate.  B is
// the number of owner shards handled in one launch (all W owners of a
// virtual group, or the one shard this rank owns).
//
// Bound on an H100: memory.  It reads W + 1 words and writes 2 words per
// 32 elements; the counts never leave registers.  Design: one thread per
// output word (b, r, l) keeps 32 int32 counters in registers and loops
// over W, so a warp's load of worker w is one coalesced 128-byte segment.
// The counters are int32: W up to 2^30 cannot wrap them (the reference
// twice wrapped int8 counts at W >= 128).
//
// The owner and worker axes take any stride (in words) while rows and
// lanes are contiguous, so a virtual group's all_to_all, which is a
// transposed view of the packed words, needs no copy.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kPack = 32;

__global__ void vote_combine_kernel(const uint32_t* __restrict__ routed,
                                    const uint32_t* __restrict__ gate,
                                    uint32_t* __restrict__ sign_out,
                                    uint32_t* __restrict__ mask_out,
                                    long long owners, long long workers,
                                    long long rows, long long owner_stride,
                                    long long worker_stride) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long per_owner = rows * kLane;
  if (idx >= owners * per_owner) return;
  long long b = idx / per_owner;
  long long rl = idx % per_owner;          // r * 128 + l
  const uint32_t* src = routed + b * owner_stride + rl;
  int count[kPack];
#pragma unroll
  for (int k = 0; k < kPack; ++k) count[k] = 0;
  for (long long w = 0; w < workers; ++w) {
    uint32_t word = src[w * worker_stride];
#pragma unroll
    for (int k = 0; k < kPack; ++k) count[k] += (word >> k) & 1u;
  }
  uint32_t sign = 0, mask = 0;
  int wk = (int)workers;
#pragma unroll
  for (int k = 0; k < kPack; ++k) {
    int a = 2 * count[k] - wk;
    sign |= (uint32_t)(a > 0) << k;
    mask |= (uint32_t)(a != 0) << k;
  }
  sign_out[idx] = sign;
  mask_out[idx] = mask & gate[idx];
}

}  // namespace

extern "C" int vote_combine_u32(const void* routed, const void* gate,
                                void* sign_out, void* mask_out,
                                long long owners, long long workers,
                                long long rows, long long owner_stride,
                                long long worker_stride, void* stream) {
  long long total = owners * rows * kLane;
  if (total <= 0) return (int)cudaSuccess;
  const int threads = 128;
  long long blocks = (total + threads - 1) / threads;
  vote_combine_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)routed, (const uint32_t*)gate, (uint32_t*)sign_out,
      (uint32_t*)mask_out, owners, workers, rows, owner_stride,
      worker_stride);
  return (int)cudaGetLastError();
}
