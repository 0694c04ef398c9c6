// popcount_stack: routed sign words (B, W, R, 128) -> per-element vote
// counts (B, 32 R, 128) int32.
//
// Replaces the TPU kernel repro/kernels/popcount_majority.py::
// _popcount_stack_kernel (pallas_call at popcount_majority.py:58): count
// [b, 32 r + k, l] = number of workers w whose word [b, w, r, l] has bit k
// set.  B is the number of owner shards handled in one launch (all W
// owners of a virtual group).  This is the staged chain's first stage;
// the fused vote_combine never writes these counts.
//
// Bound on an H100: memory.  It reads W bits and writes 4 bytes per
// element of an owner shard, so the count store sets its least time.
// Design: one thread per input word position (b, r, l) keeps 32 int32
// counters in registers and loops over W, so a warp's load of worker w is
// one coalesced 128-byte segment, then stores its 32 counts: each of the
// 32 stores of a warp covers 32 neighbouring lanes of one count row.
// The counters are int32: no W this repository runs can wrap them (the
// reference twice wrapped int8 counts at W >= 128).
//
// The owner and worker axes take any stride (in words) while rows and
// lanes are contiguous, so a virtual group's all_to_all, which is a
// transposed view of the packed words, needs no copy.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kPack = 32;

__global__ void popcount_stack_kernel(const uint32_t* __restrict__ packed,
                                      int32_t* __restrict__ counts,
                                      long long owners, long long workers,
                                      long long rows, long long owner_stride,
                                      long long worker_stride) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long per_owner = rows * kLane;
  if (idx >= owners * per_owner) return;
  long long b = idx / per_owner;
  long long rl = idx % per_owner;          // r * 128 + l
  long long r = rl / kLane;
  int l = (int)(rl % kLane);
  const uint32_t* src = packed + b * owner_stride + rl;
  int count[kPack];
#pragma unroll
  for (int k = 0; k < kPack; ++k) count[k] = 0;
  for (long long w = 0; w < workers; ++w) {
    uint32_t word = src[w * worker_stride];
#pragma unroll
    for (int k = 0; k < kPack; ++k) count[k] += (word >> k) & 1u;
  }
  int32_t* dst = counts + b * per_owner * kPack + r * kPack * kLane + l;
#pragma unroll
  for (int k = 0; k < kPack; ++k) dst[k * kLane] = count[k];
}

}  // namespace

extern "C" int popcount_stack_u32(const void* packed, void* counts,
                                  long long owners, long long workers,
                                  long long rows, long long owner_stride,
                                  long long worker_stride, void* stream) {
  long long total = owners * rows * kLane;
  if (total <= 0) return (int)cudaSuccess;
  const int threads = 128;
  long long blocks = (total + threads - 1) / threads;
  popcount_stack_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)packed, (int32_t*)counts, owners, workers, rows,
      owner_stride, worker_stride);
  return (int)cudaGetLastError();
}
