// Shared helpers of the port's kernels: dtype conversion, the int8 code
// rounding, warp reductions, and the flash one-pass backward's ordered dq
// turns and finishing pass.  Kernels take float32 (dtype code 0) or
// bfloat16 (code 1); the paged-attention pools may also hold int8 codes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

// The width the paged-attention kernels are built at for a head dim dr (a
// multiple of 8 up to 128): the least of 32, 64, 96 and 128 that is at
// least dr and of which dr is a whole number of 32nds, so that a lane's
// D / 32 columns lie all below dr or all past it.  0 for other dr.
__host__ __device__ constexpr int paged_width(int dr) {
  return dr < 8 || dr > 128 || dr % 8 ? 0
         : dr <= 32                   ? 32
         : dr <= 64                   ? 64
         : dr <= 96 && dr % 3 == 0    ? 96
                                      : 128;
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);

template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return (float)x;
}

// round to nearest even, as torch's float -> bfloat16 cast
template <typename T>
__device__ __forceinline__ T from_f32(float x);

template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the symmetric int8 code of x under absmax s: round(x / s * 127) clipped
// to [-127, 127], an IEEE division and round-half-even, in the order of
// the reference's quantize_rows_symmetric
__device__ __forceinline__ float quant_code(float x, float s) {
  return fminf(fmaxf(rintf(__fmul_rn(__fdiv_rn(x, s), 127.f)), -127.f),
               127.f);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The one-pass flash backward's ordered dq accumulation (both flash
// sources).  A counter per (b*h, q-row block), zeroed by the caller, holds
// the rank of the k tile whose share is added next: the block of rank r
// waits until the counter reads r, adds its share with plain loads and
// stores through L2 (ld/st.global.cg: no stale L1 line), and passes the
// turn to r + 1.  The shares are summed in k-tile order on every run, so
// dq is bitwise deterministic without atomics.
//
// take_ticket: a block's place in the order blocks start (one atomic on a
// zeroed counter).  A block that waits on lower tickets only waits on
// blocks that have started, so are resident or done, whatever order the
// card dispatches blocks in: the lowest unfinished ticket waits on no
// one and makes progress.
__device__ __forceinline__ int take_ticket(int* ticket) {
  __shared__ int t;
  if (threadIdx.x == 0) t = atomicAdd(ticket, 1);
  __syncthreads();
  return t;
}

__device__ __forceinline__ void wait_turn(const int* turn, int rank) {
  if (threadIdx.x == 0) {
    int v;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(turn)
                   : "memory");
      if (v == rank) break;
      __nanosleep(32);
    }
  }
  __syncthreads();
}

// The barrier orders every thread's adds before thread 0's release store,
// and a gpu-scope release is cumulative over what the barrier ordered
// before it (the pattern of CUTLASS's split-K semaphore): no separate fence.
__device__ __forceinline__ void pass_turn(int* turn, int next) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(turn),
                 "r"(next)
                 : "memory");
}

// The one-pass flash backward's finishing pass (both flash sources): dq =
// inverse-rope(dq_acc) cast to T, one thread per element; the rope
// expressions use __fmul_rn/__fsub_rn (no FMA contraction), as the plain
// version rounds.
template <typename T, int D, bool ROPE>
__global__ void dq_finalize_kernel(const float* __restrict__ acc,
                                   const float* __restrict__ cos,
                                   const float* __restrict__ sin,
                                   T* __restrict__ dq, int H, int Sq,
                                   size_t n) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float x = acc[e];
  if (ROPE) {
    const int d = (int)(e % D);
    const size_t pos = (e / ((size_t)D * H)) % Sq;
    const float rot = d < D / 2 ? -acc[e + D / 2] : acc[e - D / 2];
    x = __fsub_rn(__fmul_rn(x, cos[pos * D + d]),
                  __fmul_rn(rot, sin[pos * D + d]));
  }
  dq[e] = from_f32<T>(x);
}

}  // namespace ptt
