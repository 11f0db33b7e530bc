// Shared helpers of the port's kernels: dtype conversion, the int8 code
// rounding and warp reductions.  Kernels take float32 (dtype code 0) or
// bfloat16 (code 1); the paged-attention pools may also hold int8 codes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

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

}  // namespace ptt
