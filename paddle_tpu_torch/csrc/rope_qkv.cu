// Fused RoPE + QKV epilogue for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py _rope_qkv_kernel (launched by
// rope_qkv_epilogue).  Neox rotation of q [N, H, D] and k [N, Hkv, D] at
// each token's position, given cos/sin [N, D] fp32 tables; with
// with_amax, also the per-token, per-head absmax of the STORED (post-cast)
// k rows and of the v rows [N, Hkv] fp32, in the same pass.
//
// Bound on the card: bytes.  Each element is read once, written once, with
// four fp32 operations; nothing is reused, so the design is the plainest
// coalesced pass: one block per token row, one warp per head row,
// neighbouring lanes on neighbouring elements, no shared memory.
//
// Bit identity with the plain PyTorch version (and the reference's XLA
// version): the rotation is written with __fmul_rn / __fadd_rn so nvcc
// cannot contract x*cos + rot*sin into an FMA, and the cast rounds to
// nearest even like torch's.
#include "common.cuh"

namespace {

template <typename T>
__global__ void rope_qkv_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const float* __restrict__ cos_t,
                                const float* __restrict__ sin_t,
                                T* __restrict__ q_out, T* __restrict__ k_out,
                                float* __restrict__ k_amax,
                                float* __restrict__ v_amax, int H, int Hkv,
                                int D, int with_amax) {
  const int n = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int half = D >> 1;
  const float* c = cos_t + (size_t)n * D;
  const float* s = sin_t + (size_t)n * D;
  const int rows = H + Hkv + (with_amax ? Hkv : 0);
  for (int r = warp; r < rows; r += n_warps) {
    if (r < H + Hkv) {
      const bool is_q = r < H;
      const size_t row = is_q ? (size_t)n * H + r : (size_t)n * Hkv + (r - H);
      const T* src = (is_q ? q : k) + row * D;
      T* dst = (is_q ? q_out : k_out) + row * D;
      float amax = 0.f;
      for (int i = lane; i < half; i += 32) {
        const float x1 = ptt::to_f32(src[i]);
        const float x2 = ptt::to_f32(src[i + half]);
        // rot = cat(-x[half:], x[:half]); out = x*cos + rot*sin
        const float o1 = __fadd_rn(__fmul_rn(x1, c[i]), __fmul_rn(-x2, s[i]));
        const float o2 =
            __fadd_rn(__fmul_rn(x2, c[i + half]), __fmul_rn(x1, s[i + half]));
        const T t1 = ptt::from_f32<T>(o1);
        const T t2 = ptt::from_f32<T>(o2);
        dst[i] = t1;
        dst[i + half] = t2;
        amax = fmaxf(amax, fmaxf(fabsf(ptt::to_f32(t1)),
                                 fabsf(ptt::to_f32(t2))));
      }
      if (with_amax && !is_q) {
        amax = ptt::warp_max(amax);
        if (lane == 0) k_amax[row] = amax;
      }
    } else {
      const size_t row = (size_t)n * Hkv + (r - H - Hkv);
      const T* src = v + row * D;
      float amax = 0.f;
      for (int i = lane; i < D; i += 32)
        amax = fmaxf(amax, fabsf(ptt::to_f32(src[i])));
      amax = ptt::warp_max(amax);
      if (lane == 0) v_amax[row] = amax;
    }
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const void* cos_t,
            const void* sin_t, void* q_out, void* k_out, void* k_amax,
            void* v_amax, int N, int H, int Hkv, int D, int with_amax,
            cudaStream_t stream) {
  const int rows = H + Hkv + (with_amax ? Hkv : 0);
  int threads = 32 * rows;
  if (threads > 256) threads = 256;
  rope_qkv_kernel<T><<<N, threads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)cos_t,
      (const float*)sin_t, (T*)q_out, (T*)k_out, (float*)k_amax,
      (float*)v_amax, H, Hkv, D, with_amax);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int ptt_rope_qkv(const void* q, const void* k, const void* v,
                            const void* cos_t, const void* sin_t, void* q_out,
                            void* k_out, void* k_amax, void* v_amax, int N,
                            int H, int Hkv, int D, int dtype, int with_amax,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    launch<float>(q, k, v, cos_t, sin_t, q_out, k_out, k_amax, v_amax, N, H,
                  Hkv, D, with_amax, st);
  else if (dtype == 1)
    launch<__nv_bfloat16>(q, k, v, cos_t, sin_t, q_out, k_out, k_amax,
                          v_amax, N, H, Hkv, D, with_amax, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
