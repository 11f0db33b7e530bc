// Row-wise RMSNorm for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py _rms_kernel (launched by
// rms_norm_tpu).  x [rows, d] (fp32 or bf16), w [d] of the same dtype:
//   out = (x * rsqrt(mean(x^2) + eps) * w) in fp32, cast once to x's dtype.
// The ROUND_FIRST variant computes what the reference's layerwise step
// normalises with (paddle_tpu/jit/layerwise.py _rms_norm, which has no
// kernel): round(x * rsqrt(mean(x^2) + eps)) * w, rounded again to x's
// dtype.  A product of two bf16 values is exact in fp32, so its one
// rounding is the bf16 multiply's.  In fp32 the two variants are equal.
//
// Bound on the card: bytes.  Each element is read once and written once
// with a handful of fp32 operations, far below the ~295 operations per
// byte where the card turns compute bound.  So the design is the plainest
// coalesced pass: one block per row, 16-byte vector loads and stores
// (8 bf16 or 4 fp32 values a thread) where d and the pointers allow and
// scalar ones otherwise, the sum of squares in fp32 reduced by warp
// shuffles and then across warps through shared memory.  The second pass
// reads the row again; at d <= 8192 it is at most 32 KB and comes from
// L1/L2, not device memory.
//
// Rounding: the summation order differs from XLA's and rsqrtf is within
// 2 ulp, so the result is within a few fp32 ulps of the plain PyTorch
// version, and within one bf16 ulp after the cast.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float block_sum(float x, float* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  x = ptt::warp_sum(x);
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float v = lane < n_warps ? smem[lane] : 0.f;
    v = ptt::warp_sum(v);
    if (lane == 0) smem[0] = v;
  }
  __syncthreads();
  return smem[0];
}

// VEC: the row is read and written as 16-byte vectors of 16/sizeof(T).
// ROUND_FIRST: round to T before the weight multiply (the layerwise norm).
template <typename T, bool VEC, bool ROUND_FIRST>
__global__ void rms_norm_kernel(const T* __restrict__ x,
                                const T* __restrict__ w, T* __restrict__ out,
                                int d, float eps) {
  __shared__ float smem[32];
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  using Vec = typename std::conditional<VEC, uint4, T>::type;
  const size_t row = blockIdx.x;
  const Vec* xr = reinterpret_cast<const Vec*>(x + row * d);
  const Vec* wv = reinterpret_cast<const Vec*>(w);
  Vec* orow = reinterpret_cast<Vec*>(out + row * d);
  const int n = d / V;

  float ss = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const Vec raw = xr[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = ptt::to_f32(e[j]);
      ss += f * f;
    }
  }
  const float total = block_sum(ss, smem);
  const float r = rsqrtf(__fdiv_rn(total, (float)d) + eps);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const Vec raw = xr[i];
    const Vec wraw = wv[i];
    const T* e = reinterpret_cast<const T*>(&raw);
    const T* we = reinterpret_cast<const T*>(&wraw);
    Vec res;
    T* o = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float n = __fmul_rn(ptt::to_f32(e[j]), r);
      if (ROUND_FIRST) n = ptt::to_f32(ptt::from_f32<T>(n));
      o[j] = ptt::from_f32<T>(__fmul_rn(n, ptt::to_f32(we[j])));
    }
    orow[i] = res;
  }
}

template <typename T, bool ROUND_FIRST>
void launch_variant(const void* x, const void* w, void* out, int rows,
                    int d, float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && ((uintptr_t)x % 16) == 0 &&
                   ((uintptr_t)w % 16) == 0 && ((uintptr_t)out % 16) == 0;
  const int units = vec ? d / V : d;
  // about four units a thread, whole warps, at most kMaxThreads
  int threads = ((units + 3) / 4 + 31) / 32 * 32;
  if (threads < 32) threads = 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (vec)
    rms_norm_kernel<T, true, ROUND_FIRST><<<rows, threads, 0, stream>>>(
        (const T*)x, (const T*)w, (T*)out, d, eps);
  else
    rms_norm_kernel<T, false, ROUND_FIRST><<<rows, threads, 0, stream>>>(
        (const T*)x, (const T*)w, (T*)out, d, eps);
}

template <typename T>
void launch(const void* x, const void* w, void* out, int rows, int d,
            float eps, int round_first, cudaStream_t stream) {
  if (round_first)
    launch_variant<T, true>(x, w, out, rows, d, eps, stream);
  else
    launch_variant<T, false>(x, w, out, rows, d, eps, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; round_first: the layerwise variant.
// Returns cudaGetLastError().
extern "C" int ptt_rms_norm(const void* x, const void* w, void* out, int rows,
                            int d, float eps, int dtype, int round_first,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    launch<float>(x, w, out, rows, d, eps, round_first, st);
  else if (dtype == 1)
    launch<__nv_bfloat16>(x, w, out, rows, d, eps, round_first, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
