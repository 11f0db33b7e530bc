// The generic paged-attention kernel body, shared by the ragged (#5) and
// the decode (#7) sources: the shapes their fast kernels do not take.
//
// Replaces, for those shapes: paddle_tpu/ops/pallas_kernels.py
// _ragged_paged_kernel and paddle_tpu/ops/paged_attention.py
// _paged_decode_kernel, which take any head dim, block size and group
// count.  The fast kernels are built at head dims of 32 to 128
// (ptt::paged_width) and at bounded block sizes and group counts; the
// wrappers (ops/paged_attention.py) route every other shape here: a head
// dim that is not a multiple of 8 or is over 128, #5 with more than 32
// query heads a kv head or int8 pools of block size over 64, #7 with
// block sizes over 128.  The routing is by shape only; a failed launch
// raises like any other.
//
// What it computes: what the fast kernels compute, query vector by query
// vector.  A query vector (token t, query head hq; kv head hq / groups)
// at global position qpos attends the keys at columns 0 .. qpos of its
// span's pages, with an fp32 softmax; fp32, bf16 and int8 pools.  int8
// pools keep the reference's int8 math (the Pallas int8 path): the q
// vector quantized over D to codes and an absmax scale, q.K^T on the
// codes with an exact int32 sum folded as acc * (q_scale * (k_scale[page,
// h] * float32(scale / 127^2))), and page by page the probabilities
// quantized against their page's largest (the online softmax's running
// max updated once a page, as the plain version does), p.V on the codes
// with an exact int32 sum folded as acc * (p_scale * (v_scale[page, h] *
// float32(1 / 127^2))).
//
// Design: simple and right first.  One warp per query vector, four warps
// a block, no barrier across warps.  The warp keeps its q vector (scaled
// fp32, or int8 codes), its fp32 accumulator and one page's scores in
// shared memory ((2 D + bs) floats a warp), so any head dim and block size
// fit until shared memory runs out (D 256 at block size 256: 12 KB a
// block).  Lane l owns the columns l, l + 32, ... below D: every load is
// one element wide, so a row of any width and alignment (D 100 in bf16 is
// 200 bytes, 8-byte aligned) is read as it lies, neighbouring lanes on
// neighbouring addresses.  A key's score is the warp's sum over its
// columns; the page's keys are scored one after another, then its
// probabilities formed and p.V added column by column.  Keys past the
// last one a query can see are never read, nor pages past it.
//
// Bound on the card: bytes, as for the fast kernels; this kernel reads
// each key once per query vector of its group (not once per kv head) and
// reduces over the warp once per key, so it sits far from that bound.
// It serves shapes no model of the repository uses; making it fast is
// later work.
#pragma once

#include <math.h>

#include "common.cuh"

namespace ptt {

struct GenericArgs {
  const void* q;            // [T, H, D] (decode: [B, H, D])
  const void* k_pool;       // [phys, bs, Hkv, D]
  const void* v_pool;
  const float* k_scale;     // [phys, Hkv] (int8 pools)
  const float* v_scale;
  const int* bt;            // [S, W]
  const int* q_off;         // [S] (null: decode, span b = token b)
  const int* q_len;         // [S] (null: decode, q_len 1)
  const int* kv_len;        // [S] (decode: seq_lens)
  void* out;                // [T, H, D]
  int T, S, W, H, Hkv, D, bs;  // T: tokens (decode: slots)
  long long page_stride, slot_stride;  // pool strides, in elements
  float scale, c_qk, c_pv;
};

constexpr int kGenWarps = 4;

// dynamic shared memory of a block: each warp's q vector, accumulator and
// page of scores
inline size_t generic_smem(int D, int bs) {
  return (size_t)kGenWarps * (2 * (size_t)D + (size_t)bs) * sizeof(float);
}

__device__ __forceinline__ int warp_sum_int(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One query vector, by the calling warp: token t, query head hq, of span s
// (rows q_off .. q_off + q_len - 1, kv_len keys).  ws: the warp's shared
// memory, (2 D + bs) floats.
template <typename T, typename P, bool Q8>
__device__ void generic_attend(const GenericArgs& a, float* ws, int t,
                               int hq, int s, int q_off, int q_len,
                               int kv_len) {
  const int lane = threadIdx.x & 31;
  const int D = a.D, bs = a.bs;
  const int h = hq / (a.H / a.Hkv);
  float* qs = ws;          // [D] q (scaled fp32, or int8 codes)
  float* acc = ws + D;     // [D] the output accumulator
  float* sc = ws + 2 * D;  // [bs] one page's scores, then probabilities

  const T* qrow = (const T*)a.q + ((size_t)t * a.H + hq) * D;
  float amax = 0.f;
  for (int d = lane; d < D; d += 32) {
    float x = to_f32(qrow[d]);
    if (!Q8) x *= a.scale;
    qs[d] = x;
    acc[d] = 0.f;
    amax = fmaxf(amax, fabsf(x));
  }
  float q_s = 1.f;
  if constexpr (Q8) {
    q_s = fmaxf(warp_max(amax), 1e-30f);
    for (int d = lane; d < D; d += 32) qs[d] = quant_code(qs[d], q_s);
  }
  __syncwarp();

  // keys at columns <= qpos (all below kv_len), in whole pages of the table
  const int qpos = kv_len - q_len + (t - q_off);
  const int n_keys = qpos + 1;
  const int n_pages = min((n_keys + bs - 1) / bs, a.W);
  const int key_end = min(n_keys, n_pages * bs);
  const int* bt = a.bt + (size_t)s * a.W;
  float m = -INFINITY, l = 0.f;
  for (int pg = 0; pg < n_pages; ++pg) {
    const int page = bt[pg];
    const int nk = min(bs, key_end - pg * bs);
    const size_t base = (size_t)page * a.page_stride + (size_t)h * D;
    const P* kp = (const P*)a.k_pool + base;
    const P* vp = (const P*)a.v_pool + base;
    float fold_k = 1.f, sv = 0.f;
    if constexpr (Q8) {
      fold_k = q_s * (a.k_scale[(size_t)page * a.Hkv + h] * a.c_qk);
      sv = a.v_scale[(size_t)page * a.Hkv + h];
    }
    // the page's scores, a key at a time: lanes split its columns
    float pmax = -INFINITY;
    for (int j = 0; j < nk; ++j) {
      const P* krow = kp + (size_t)j * a.slot_stride;
      float sj;
      if constexpr (Q8) {
        int part = 0;
        for (int d = lane; d < D; d += 32)
          part += (int)qs[d] * (int)krow[d];
        sj = (float)warp_sum_int(part) * fold_k;
      } else {
        float part = 0.f;
        for (int d = lane; d < D; d += 32) part += qs[d] * to_f32(krow[d]);
        sj = warp_sum(part);
      }
      if (lane == 0) sc[j] = sj;
      pmax = fmaxf(pmax, sj);
    }
    __syncwarp();
    // the running max moves once a page; p = exp(s - m) of the page
    const float m_new = fmaxf(m, pmax);
    const float corr = expf(m - m_new);
    float psum = 0.f, pm = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float p = expf(sc[j] - m_new);
      sc[j] = p;
      psum += p;
      pm = fmaxf(pm, p);
    }
    psum = warp_sum(psum);
    if constexpr (Q8) {
      // the page's probability codes against their largest (each lane
      // rewrites the keys it wrote), then p.V on the codes, exact in int32
      const float p_s = fmaxf(warp_max(pm), 1e-30f);
      for (int j = lane; j < nk; j += 32) sc[j] = quant_code(sc[j], p_s);
      __syncwarp();
      const float fold_v = p_s * (sv * a.c_pv);
      for (int d = lane; d < D; d += 32) {
        int iacc = 0;
        for (int j = 0; j < nk; ++j)
          iacc += (int)sc[j] * (int)vp[(size_t)j * a.slot_stride + d];
        acc[d] = acc[d] * corr + (float)iacc * fold_v;
      }
    } else {
      __syncwarp();
      for (int d = lane; d < D; d += 32) {
        float o = acc[d] * corr;
        for (int j = 0; j < nk; ++j)
          o += sc[j] * to_f32(vp[(size_t)j * a.slot_stride + d]);
        acc[d] = o;
      }
    }
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // the page's probabilities are consumed
  }

  // a query that sees no key (a decode slot of seq_len 0) gives 0
  T* o = (T*)a.out + ((size_t)t * a.H + hq) * D;
  const float lc = fmaxf(l, 1e-30f);
  for (int d = lane; d < D; d += 32) o[d] = from_f32<T>(acc[d] / lc);
}

// The host side of both entries: set the shared-memory limit, launch
// `kern` over n_vectors query vectors (kGenWarps a block), and return
// cudaGetLastError().
template <typename Kern>
int launch_generic(Kern kern, const GenericArgs& a, long long n_vectors,
                   cudaStream_t st) {
  const size_t smem = generic_smem(a.D, a.bs);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_vectors + kGenWarps - 1) / kGenWarps;
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kGenWarps * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace ptt
