// int4_quant: float32 value planes (L, M, 128) -> absmax int4 fake-quant
//   (L, M, 128), one scale per plane, in two launches.
//
// Replaces the TPU kernel repro/kernels/fused.py::_int4_quant_kernel
// (fused.py:158, pallas_call at fused.py:330).  The TPU runs one launch
// on grid (2, nblocks): phase 0 walks the plane in order keeping the
// absmax in SMEM, phase 1 quantizes with it.  Blocks of a Hopper grid run
// in no order, so the max across blocks is taken in a first launch
// instead: |x| is a non-negative float, whose bit pattern orders as an
// unsigned int, so each block reduces its share in registers and shared
// memory and does one atomicMax on the plane's 32-bit slot (zeroed by
// the caller).  A NaN (sign cleared) orders above +inf, so it wins, as it
// does in jnp.max.  The second launch, per element:
//   s    = absmax * (1 / levels)    (the reciprocal rounded to float32,
//                                    then one rounded product: the
//                                    reference's arithmetic, since XLA
//                                    folds its division by the constant
//                                    levels into this product)
//   safe = s > 0 ? s : 1            (a zero or NaN scale becomes 1)
//   q    = rint(x / safe)           (IEEE division, half to even; -0 kept)
//   q    = clip(q, -levels, levels) by comparisons, so NaN stays NaN
//   out  = q * safe
// Built without --use_fast_math: every division and rounding is IEEE
// and subnormals are kept.
//
// Bound on an H100: memory.  The row reads the plane twice (absmax,
// quantize) and writes it once: 12 bytes an element, the reference's own
// accounting (Int4KernelSet.hbm_bytes); the quantize launch alone reads
// 4 bytes and writes 4.  Design:
//   - the absmax launch runs a bounded grid of blocks per plane with a
//     grid-stride loop (few atomics per plane), blockIdx.y the plane;
//   - the quantize launch moves one 16-byte vector (4 floats) a thread
//     over one flat index across all planes, 512 threads a block, as
//     threshold_mask.cu does: a plane's length is a multiple of 128
//     values, so no vector straddles two planes, and the plane count is
//     not limited.  The thread finds its vector's plane (one division,
//     issued after the load, so it hides under it), loads that plane's
//     absmax bits once and derives safe once for its four values;
//   - timed on the H100 at four planes of 88,080,384 values (PERF.md
//     §6): this form 0.9245 ms against a 0.8414 ms bound, where one
//     thread an element with 4-byte accesses and the plane in
//     blockIdx.y took 1.2857 (and torch.fake_quantize_per_tensor_affine
//     1.0649); 2, 4 and 8 vectors a thread, a block's width apart
//     with all loads before the stores, 0.3%, 2.1% and 2.4% slower; 256
//     and 1024 threads a block 0.2% and 0.4% slower; a multiply by the
//     reciprocal of safe in place of the IEEE division no faster, and
//     not the function (it moves values off their .5 ties), so at
//     16-byte accesses the division does not bind.  All were dropped.
// The scales stay on the card: nothing is read back.  The wrapper raises
// on a base pointer that is not 16-byte aligned.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxAbsmaxBlocks = 1024;   // per plane
constexpr int kQuantThreads = 512;

__global__ void absmax_bits_kernel(const float* __restrict__ x,
                                   unsigned int* __restrict__ amax_bits,
                                   long long per_plane) {
  __shared__ unsigned int warp_max[kThreads / 32];
  const float* p = x + (long long)blockIdx.y * per_plane;
  unsigned int m = 0u;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < per_plane; i += stride) {
    m = max(m, __float_as_uint(p[i]) & 0x7fffffffu);
  }
  m = __reduce_max_sync(0xffffffffu, m);
  int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) atomicMax(amax_bits + blockIdx.y, m);
  }
}

__device__ __forceinline__ float quantize(float x, float safe,
                                          float levels) {
  float q = rintf(__fdiv_rn(x, safe));
  q = q < -levels ? -levels : (q > levels ? levels : q);
  return __fmul_rn(q, safe);
}

__global__ void __launch_bounds__(kQuantThreads) quantize_kernel(
    const float4* __restrict__ x, const unsigned int* __restrict__ amax_bits,
    float4* __restrict__ out, long long vecs, long long vecs_per_plane,
    float levels) {
  long long v = (long long)blockIdx.x * kQuantThreads + threadIdx.x;
  if (v >= vecs) return;
  float4 r = __ldg(x + v);
  float scale = __fmul_rn(__uint_as_float(__ldg(amax_bits +
                                                v / vecs_per_plane)),
                          __fdiv_rn(1.0f, levels));
  float safe = scale > 0.0f ? scale : 1.0f;
  out[v] = make_float4(quantize(r.x, safe, levels),
                       quantize(r.y, safe, levels),
                       quantize(r.z, safe, levels),
                       quantize(r.w, safe, levels));
}

}  // namespace

// The two launches are two entry points, so that a caller may reduce the
// absmax bits over a group of ranks between them (a tensor-parallel
// leaf: each rank holds a block, and the scale is the whole leaf's, the
// max of the blocks' bits over the model group).
//
// Phase 1.  amax_bits: one zeroed uint32 per plane; it holds the planes'
// absmax bit patterns after the call.
extern "C" int int4_absmax_f32(const void* x, void* amax_bits,
                               long long planes, long long per_plane,
                               void* stream) {
  if (planes <= 0 || per_plane <= 0) return (int)cudaSuccess;
  if (planes > 65535) return (int)cudaErrorInvalidConfiguration;
  long long blocks = (per_plane + kThreads - 1) / kThreads;
  long long scan = blocks < kMaxAbsmaxBlocks ? blocks : kMaxAbsmaxBlocks;
  absmax_bits_kernel<<<dim3((unsigned)scan, (unsigned)planes), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)x, (unsigned int*)amax_bits, per_plane);
  return (int)cudaGetLastError();
}

// Phase 2: quantize every plane with the absmax whose bits amax_bits
// holds (phase 1's, or a group's max of them).  x and out start on a
// 16-byte boundary and a plane holds a multiple of 128 values.
extern "C" int int4_quantize_f32(const void* x, const void* amax_bits,
                                 void* out, long long planes,
                                 long long per_plane, float levels,
                                 void* stream) {
  if (planes <= 0 || per_plane <= 0) return (int)cudaSuccess;
  if (per_plane % 128 || ((uintptr_t)x | (uintptr_t)out) & 15u)
    return (int)cudaErrorInvalidValue;
  long long vecs_per_plane = per_plane / 4;
  long long vecs = planes * vecs_per_plane;
  long long blocks = (vecs + kQuantThreads - 1) / kQuantThreads;
  quantize_kernel<<<(unsigned)blocks, kQuantThreads, 0,
                    (cudaStream_t)stream>>>(
      (const float4*)x, (const unsigned int*)amax_bits, (float4*)out, vecs,
      vecs_per_plane, levels);
  return (int)cudaGetLastError();
}
