// Paged decode attention for Hopper (sm_90a): the attention of the split
// engine's decode step, one query token per slot.
//
// Replaces: paddle_tpu/ops/paged_attention.py _paged_decode_kernel
// (launched by _paged_attention_pallas), both variants: fp32/bf16 pools
// and int8 pools with per-page, per-head fp32 scales.
//
// What it computes.  Slot b's query q[b] (H heads, grouped over Hkv kv
// heads as [Hkv, groups], query head h*groups + j <-> kv head h) attends
// the keys at positions c < seq_lens[b] of its pages bt[b, 0 :
// ceil(seq_len / bs)] in the pools [phys, bs, Hkv, D]; fp32 online
// softmax, output in q's dtype.
//
// int8 pools compute what the pipelined Pallas int8 path computes: each
// q row (one query head, over D) is quantized per row to codes and an
// absmax scale; q.K^T runs on the codes with an exact integer sum, then
// folds as acc * (q_scale * (k_scale[page, h] * float32(scale / 127^2)));
// the probabilities of a page are quantized per row (their max is the
// scale) and p.V runs on the codes too, folded as acc * (p_scale *
// (v_scale[page, h] * float32(1 / 127^2))).  Only int8 codes and the fp32
// scale rows are read from device memory.  Code products summed over
// D <= 128 (or over a page of <= 32 keys) stay below 2^24, so the kernel
// sums them in fp32 registers exactly.  Rounding is rintf (half to even)
// after an IEEE division, as the reference's round(x / s * 127).
//
// Design (simple and right first; wgmma/TMA and split-K over pages
// later).  One block per (slot, kv head), 8 warps.  A warp owns pages
// p = warp, warp + 8, ... of the slot and keeps fp32 online-softmax state
// for the kv head's `groups` query heads (a template parameter: 1, 2, 4
// or 8); lane l holds columns l*D/32 .. l*D/32 + D/32 - 1 of q, of each
// key row it reads and of the output, so each key row is one coalesced
// vector load per lane.  Per page the warp scores every key (a warp sum
// per key and head; lane `key` keeps key's score), updates the running
// max once per page, forms p, and accumulates p.V reading each value row
// once.  At the end the 8 warps' (m, l, acc) merge through shared memory.
// The int8 probability codes depend only on exp(s - page max), so this
// split over warps computes the same function as the Pallas kernel's
// sequential page loop, up to fp32 rounding (and, rarely, a probability
// code that rounds the other way at a .5 boundary).
//
// Bound on the card: bytes.  Decode reads seq_len x D x 2 values per kv
// head (int8: 1 byte each) and does 4 operations per value read, far
// below the ~295 operations per byte at which the H100 turns compute
// bound.
//
// Traps of the reference's wrapper that this kernel avoids:
// - jnp.moveaxis(key_cache, 2, 0) transposes the whole pool on every
//   call, and kp.astype(float32) copies it to fp32: here the pool is read
//   in place, [phys, bs, Hkv, D], in its own dtype, with its strides.
// - Poison pages.  A warp reads block-table entries p < min(ceil(seq_len
//   / bs), W) only, and keys below seq_len only: table entries and page
//   slots past them may hold anything (NaN included).  A slot with
//   seq_len 0 reads nothing and writes 0; a masked slot of the engine
//   (seq_len 1 over an all-sink row) reads sink row 0 only.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;

template <typename P, int N>
struct alignas(sizeof(P) * N) Vec {
  P v[N];
};

template <typename T, typename P, int D, int G, bool Q8>
__global__ void __launch_bounds__(kWarps * 32) paged_decode_kernel(
    const T* __restrict__ q, const P* __restrict__ k_pool,
    const P* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens, T* __restrict__ out, int W, int H,
    int Hkv, int bs, int page_stride, int slot_stride, float scale,
    float c_qk, float c_pv) {
  constexpr int DPL = D / 32;  // columns per lane
  __shared__ float m_s[kWarps][G];
  __shared__ float l_s[kWarps][G];
  __shared__ float acc_s[kWarps][G][D];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seq_len = seq_lens[b];
  const int n_pages = seq_len > 0 ? min((seq_len + bs - 1) / bs, W) : 0;
  const int* bt = block_tables + (size_t)b * W;

  // this kv head's query heads: scaled (fp) or quantized per row (int8)
  float qv[G][DPL], qs[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const Vec<T, DPL> raw = *reinterpret_cast<const Vec<T, DPL>*>(
        q + ((size_t)b * H + h * G + j) * D + lane * DPL);
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      qv[j][i] = ptt::to_f32(raw.v[i]);
      amax = fmaxf(amax, fabsf(qv[j][i]));
    }
    qs[j] = 1.f;
    if constexpr (Q8) {
      qs[j] = fmaxf(ptt::warp_max(amax), 1e-30f);
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        qv[j][i] = ptt::quant_code(qv[j][i], qs[j]);
    } else {
#pragma unroll
      for (int i = 0; i < DPL; ++i) qv[j][i] = __fmul_rn(qv[j][i], scale);
    }
  }

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[j][i] = 0.f;
  }

  for (int p = warp; p < n_pages; p += kWarps) {
    const int page = bt[p];
    const int nk = min(bs, seq_len - p * bs);  // >= 1 keys of this page
    const size_t row0 =
        (size_t)page * page_stride + (size_t)h * D + lane * DPL;
    float sk = 1.f, sv = 1.f;
    if constexpr (Q8) {
      sk = k_scale[(size_t)page * Hkv + h];
      sv = v_scale[(size_t)page * Hkv + h];
    }

    // scores: lane `key` keeps key's score for every head of the group
    float my_s[G];
#pragma unroll
    for (int j = 0; j < G; ++j) my_s[j] = -INFINITY;
#pragma unroll 4
    for (int key = 0; key < nk; ++key) {
      const Vec<P, DPL> kr = *reinterpret_cast<const Vec<P, DPL>*>(
          k_pool + row0 + (size_t)key * slot_stride);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          d += qv[j][i] * ptt::to_f32(kr.v[i]);
        d = ptt::warp_sum(d);
        if (Q8) d = d * (qs[j] * (sk * c_qk));
        if (lane == key) my_s[j] = d;
      }
    }

    // one online-softmax update per page
    const bool ok = lane < nk;
    float pj[G], fold[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float m_new = fmaxf(m[j], ptt::warp_max(my_s[j]));
      const float p_ = ok ? expf(my_s[j] - m_new) : 0.f;
      const float alpha = expf(m[j] - m_new);
      l[j] = l[j] * alpha + ptt::warp_sum(p_);
      m[j] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[j][i] *= alpha;
      pj[j] = p_;
      fold[j] = 1.f;
      if constexpr (Q8) {
        const float ps = fmaxf(ptt::warp_max(p_), 1e-30f);
        pj[j] = ptt::quant_code(p_, ps);
        fold[j] = ps * (sv * c_pv);
      }
    }

    float pv[G][DPL];
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int i = 0; i < DPL; ++i) pv[j][i] = 0.f;
#pragma unroll 4
    for (int key = 0; key < nk; ++key) {
      const Vec<P, DPL> vr = *reinterpret_cast<const Vec<P, DPL>*>(
          v_pool + row0 + (size_t)key * slot_stride);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float pk = __shfl_sync(0xffffffffu, pj[j], key);
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          pv[j][i] += pk * ptt::to_f32(vr.v[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[j][i] += pv[j][i] * fold[j];
  }

  // merge the warps' partial states
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (lane == 0) {
      m_s[warp][j] = m[j];
      l_s[warp][j] = l[j];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc_s[warp][j][lane * DPL + i] = acc[j][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int j = idx / D, d = idx % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_s[w][j]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float e = expf(m_s[w][j] - M);  // 0 for a warp with no page
        L += l_s[w][j] * e;
        A += acc_s[w][j][d] * e;
      }
    }
    out[((size_t)b * H + h * G + j) * D + d] =
        ptt::from_f32<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T, typename P, int D, int G, bool Q8>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* bt,
           const void* seq_lens, void* out, int B, int W, int H, int Hkv,
           int bs, int page_stride, int slot_stride, float scale, float c_qk,
           float c_pv, cudaStream_t stream) {
  dim3 grid(B, Hkv);
  paged_decode_kernel<T, P, D, G, Q8><<<grid, kWarps * 32, 0, stream>>>(
      (const T*)q, (const P*)k_pool, (const P*)v_pool, (const float*)k_scale,
      (const float*)v_scale, (const int*)bt, (const int*)seq_lens, (T*)out, W,
      H, Hkv, bs, page_stride, slot_stride, scale, c_qk, c_pv);
  return (int)cudaGetLastError();
}

#define PTT_DECODE_ARGS                                                     \
  q, k_pool, v_pool, k_scale, v_scale, bt, seq_lens, out, B, W, H, Hkv, bs, \
      page_stride, slot_stride, scale, c_qk, c_pv, st

template <typename T, typename P, bool Q8, int D>
int dispatch_g(int G, const void* q, const void* k_pool, const void* v_pool,
               const void* k_scale, const void* v_scale, const void* bt,
               const void* seq_lens, void* out, int B, int W, int H, int Hkv,
               int bs, int page_stride, int slot_stride, float scale,
               float c_qk, float c_pv, cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, P, D, 1, Q8>(PTT_DECODE_ARGS);
    case 2: return launch<T, P, D, 2, Q8>(PTT_DECODE_ARGS);
    case 4: return launch<T, P, D, 4, Q8>(PTT_DECODE_ARGS);
    case 8: return launch<T, P, D, 8, Q8>(PTT_DECODE_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename P, bool Q8>
int dispatch_d(int D, int G, const void* q, const void* k_pool,
               const void* v_pool, const void* k_scale, const void* v_scale,
               const void* bt, const void* seq_lens, void* out, int B, int W,
               int H, int Hkv, int bs, int page_stride, int slot_stride,
               float scale, float c_qk, float c_pv, cudaStream_t st) {
  switch (D) {
    case 32: return dispatch_g<T, P, Q8, 32>(G, PTT_DECODE_ARGS);
    case 64: return dispatch_g<T, P, Q8, 64>(G, PTT_DECODE_ARGS);
    case 128: return dispatch_g<T, P, Q8, 128>(G, PTT_DECODE_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and out share it; the pools too
// unless quantized, when they are int8 with float32 scales [phys, Hkv]).
// Strides are in elements.  Needs bs <= 32 and groups H / Hkv in
// {1, 2, 4, 8}.  Returns the launch's cudaGetLastError().
extern "C" int ptt_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* bt,
    const void* seq_lens, void* out, int B, int W, int H, int Hkv, int D,
    int bs, int page_stride, int slot_stride, float scale, float c_qk,
    float c_pv, int dtype, int quantized, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bs < 1 || bs > 32 || Hkv < 1 || H % Hkv)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  if (dtype == 0 && !quantized)
    return dispatch_d<float, float, false>(D, G, PTT_DECODE_ARGS);
  if (dtype == 1 && !quantized)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16, false>(D, G,
                                                           PTT_DECODE_ARGS);
  if (dtype == 0 && quantized)
    return dispatch_d<float, int8_t, true>(D, G, PTT_DECODE_ARGS);
  if (dtype == 1 && quantized)
    return dispatch_d<__nv_bfloat16, int8_t, true>(D, G, PTT_DECODE_ARGS);
  return (int)cudaErrorInvalidValue;
}
