// vote_pipeline: stacked value planes (W, M, 128) of float or bf16 + gate
//   words (M/32, 128) -> the decoded plane (M, 128) of {-1, 0, +1} in
//   float or bf16.
//
// Replaces the TPU kernel repro/kernels/fused.py::_vote_pipeline_kernel
// (pallas_call at fused.py:272): the whole local vote datapath, encode ->
// PopCount -> majority -> gate -> decode, in one pass, written in the
// reference's output ``dtype``.  Per element: c = number of workers whose
// value is > 0 (so -0.0 and NaN count as 0, as in sign_pack); the output
// is +1 where 2c > W, -1 where 2c < W, and +0.0 where 2c == W or the
// element's gate bit (bit b of gate[r, l] for row 32 r + b) is clear.  c
// is a 32-bit counter and 2c is compared with W unsigned, so no W the
// wrapper takes (1 to 2^30) can wrap (the reference twice wrapped int8
// counts at W >= 128).  -1, 0 and +1 are exact in both output types, so
// the bits equal a float decode cast to bf16.
//
// Bound on an H100: memory.  It reads each of the W values once, the gate
// bit once and writes one value: n * (W * sizeof(Tin) + 1/8 +
// sizeof(Tout)) bytes.  Design:
//   - one block per word row (32 rows x 128 lanes); a thread takes 8
//     neighbouring lanes of as many rows as make 32 bytes of output (2
//     rows, 16 apart, in bf16; 1 in float), so a warp reads and
//     writes whole rows, and the indices are shifts of the block and
//     thread numbers.  On the H100, 2 rows a thread took 5% longer than
//     1 into float, and 1 row 6% longer than 2 into bf16;
//   - the thread loads its 8 gate words once, as two 16-byte loads;
//   - each worker's rows are read with 16-byte loads (one a row in bf16,
//     two in float);
//   - x > 0 is a test on the bits, bits - 1 < 0x7F800000 (positive, not
//     +0, not NaN; +inf counts), on a bf16 value after a 16-bit shift;
//   - 16-byte stores in the output type (streaming stores measured up
//     to 1.1% slower on the H100).
// No packed words, counts or ternary pair reach device memory.  The
// wrapper raises on operands that are not 16-byte aligned.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kPack = 32;
constexpr int kLanesPerThread = 8;
constexpr int kLaneGroups = kLane / kLanesPerThread;      // 16

// rows a thread: 32 bytes of output (8 lanes of 2 or 4 bytes a row)
__host__ __device__ constexpr int rows_per_thread(bool out_bf16) {
  return out_bf16 ? 2 : 1;
}
__host__ __device__ constexpr int threads_per_block(bool out_bf16) {
  return kLaneGroups * kPack / rows_per_thread(out_bf16);
}

__device__ __forceinline__ uint32_t positive(uint32_t float_bits) {
  return (float_bits - 1u) < 0x7F800000u;
}

// Adds the votes of 8 neighbouring lanes of one row to c.
template <bool kInBf16>
__device__ __forceinline__ void count_row(const uint4* src, uint32_t* c) {
  if constexpr (kInBf16) {
    uint4 v = __ldg(src);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c[2 * i] += positive(w[i] << 16);
      c[2 * i + 1] += positive(w[i] & 0xFFFF0000u);
    }
  } else {
    uint4 a = __ldg(src), b = __ldg(src + 1);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) c[i] += positive(w[i]);
  }
}

// Bits of +1, -1 or +0 in the output format.
template <bool kOutBf16>
__device__ __forceinline__ uint32_t decide(uint32_t count, uint32_t workers,
                                           uint32_t keep) {
  constexpr uint32_t kOne = kOutBf16 ? 0x3F80u : 0x3F800000u;
  constexpr uint32_t kSign = kOutBf16 ? 0x8000u : 0x80000000u;
  uint32_t twice = 2u * count;
  if (!keep || twice == workers) return 0u;
  return twice > workers ? kOne : (kOne | kSign);
}

template <bool kInBf16, bool kOutBf16>
__global__ void __launch_bounds__(threads_per_block(kOutBf16))
vote_pipeline_kernel(const void* __restrict__ stack,
                     const uint4* __restrict__ gate, void* __restrict__ out,
                     long long per_plane, long long workers) {
  constexpr int kInBytes = kInBf16 ? 2 : 4;
  constexpr int kOutBytes = kOutBf16 ? 2 : 4;
  constexpr int kRows = rows_per_thread(kOutBf16);
  constexpr int kRowGroups = kPack / kRows;
  const int q = threadIdx.x % kLaneGroups;        // lanes 8 q .. 8 q + 7
  const int g = threadIdx.x / kLaneGroups;        // rows g + kRowGroups j
  // element (row, 8 q) of this block's word row
  const long long first = ((long long)blockIdx.x << 12) + 8 * q;
  const uint4* gp = gate + (((long long)blockIdx.x * kLane + 8 * q) >> 2);
  const uint4 ga = __ldg(gp), gb = __ldg(gp + 1);
  const uint32_t gw[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};

  uint32_t c[kRows][kLanesPerThread] = {};
  const char* src = (const char*)stack + first * kInBytes;
  const long long plane_bytes = per_plane * kInBytes;
#pragma unroll 2
  for (long long w = 0; w < workers; ++w) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int row = g + kRowGroups * j;
      count_row<kInBf16>(
          (const uint4*)(src + (long long)row * kLane * kInBytes), c[j]);
    }
    src += plane_bytes;
  }

  const uint32_t wu = (uint32_t)workers;
  char* dst = (char*)out + first * kOutBytes;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int row = g + kRowGroups * j;
    uint32_t e[kLanesPerThread];
#pragma unroll
    for (int i = 0; i < kLanesPerThread; ++i)
      e[i] = decide<kOutBf16>(c[j][i], wu, (gw[i] >> row) & 1u);
    uint4* o = (uint4*)(dst + (long long)row * kLane * kOutBytes);
    if constexpr (kOutBf16) {
      o[0] = make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16),
                        e[4] | (e[5] << 16), e[6] | (e[7] << 16));
    } else {
      o[0] = make_uint4(e[0], e[1], e[2], e[3]);
      o[1] = make_uint4(e[4], e[5], e[6], e[7]);
    }
  }
}

template <bool kInBf16, bool kOutBf16>
int launch(const void* stack, const void* gate, void* out,
           long long per_plane, long long workers, void* stream) {
  if (per_plane <= 0) return (int)cudaSuccess;
  if (workers < 1 || workers > (1LL << 30) || per_plane % (kPack * kLane) ||
      ((uintptr_t)stack | (uintptr_t)gate | (uintptr_t)out) & 15u)
    return (int)cudaErrorInvalidValue;
  long long blocks = per_plane / (kPack * kLane);
  vote_pipeline_kernel<kInBf16, kOutBf16>
      <<<(unsigned)blocks, threads_per_block(kOutBf16), 0,
         (cudaStream_t)stream>>>(stack, (const uint4*)gate, out, per_plane,
                                 workers);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vote_pipeline_f32_f32(const void* stack, const void* gate,
                                     void* out, long long per_plane,
                                     long long workers, void* stream) {
  return launch<false, false>(stack, gate, out, per_plane, workers, stream);
}

extern "C" int vote_pipeline_f32_bf16(const void* stack, const void* gate,
                                      void* out, long long per_plane,
                                      long long workers, void* stream) {
  return launch<false, true>(stack, gate, out, per_plane, workers, stream);
}

extern "C" int vote_pipeline_bf16_f32(const void* stack, const void* gate,
                                      void* out, long long per_plane,
                                      long long workers, void* stream) {
  return launch<true, false>(stack, gate, out, per_plane, workers, stream);
}

extern "C" int vote_pipeline_bf16_bf16(const void* stack, const void* gate,
                                       void* out, long long per_plane,
                                       long long workers, void* stream) {
  return launch<true, true>(stack, gate, out, per_plane, workers, stream);
}
