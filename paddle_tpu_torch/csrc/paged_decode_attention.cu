// Paged decode attention for Hopper (sm_90a): the attention of the split
// engine's decode step, one query token per slot.
//
// Replaces: paddle_tpu/ops/paged_attention.py _paged_decode_kernel
// (launched by _paged_attention_pallas), both variants: fp32/bf16 pools
// and int8 pools with per-page, per-head fp32 scales.  Any head dim
// D <= 128 that is a multiple of 8 (the kernel is built at a width of 32,
// 64, 96 or 128, ptt::paged_width, and reads the pools' rows at their
// real width, zero-filling the columns past it), any number of query
// heads per kv head, block sizes 1 to 128.  Every other shape (a head
// dim not a multiple of 8 or over 128, a block size over 128) runs
// paged_decode_kernel_generic, the generic kernel of paged_generic.cuh,
// through its own entry.
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
// scale rows are read from device memory.  Both products are __dp4a
// sums of code products: exact in int32.  Rounding is rintf (half to
// even) after an IEEE division, as the reference's round(x / s * 127).
//
// Bound on the card: bytes.  Decode reads seq_len x D x 2 values per kv
// head (int8: 1 byte each) and does 4 operations per value read and
// query head of the group, far below the ~295 operations per byte at
// which the H100 turns compute bound.  Reading at the memory rate takes
// ~18 KB in flight on each SM (3.35 TB/s x ~0.7 us / 132 SMs).
//
// Design.  One block per (slot, kv head, tile of up to 8 of its query
// heads, split), of 4 or 8 warps (see warps()).  The slot's block-table
// width W is cut into n_split runs of `run` pages (the wrapper picks
// n_split from B x Hkv and W alone, so the host never reads seq_lens: it
// splits only when the slots' blocks would leave SMs idle, and keeps the
// blocks within one wave); a split whose run starts past the slot's
// pages returns at once.  In a block of W warps, warp w takes the run's
// pages w, w + W, ... and streams them through its own ring of shared-
// memory stages of 16 keys x D (3, or 6 at D <= 64), filled by 16-byte
// cp.async (8-byte for int8 rows whose width is not a multiple of 16),
// all but one in flight while one is used: the K stages of a page, then
// its V stages.  An int8 page's scale rides in its stage, and a page's
// table entry is read a page ahead.  Columns past D enter as zeros; keys
// past seq_len are never read.  Scores: lane l scores key l % 16 of the
// stage over half the columns (l / 16) for every query head of the tile
// (q in shared memory, fp32 scaled, or int8 codes with __dp4a), one
// shuffle joins the halves: no reduction over the warp per key.  Per
// page the warp updates its running max once for all the tile's heads
// (their reductions interleaved) and forms p (int8: the page's codes
// against its max); p.V gives each lane 4 output columns (int8: four
// keys' V codes of a column byte-transposed into one word for __dp4a).
// The warps' (m, l, acc) merge in warp order through shared memory; a
// split writes its merged state to the per-stream scratch and the last
// split of the slot to arrive (an atomic count per (slot, kv head,
// tile)) merges the splits' states in split order and resets the count,
// so two calls give the same bits.  The int8 probability codes depend
// only on exp(s - page max), so this split over warps and blocks
// computes the same function as the Pallas kernel's sequential page
// loop, up to fp32 rounding (and, rarely, a probability code that
// rounds the other way at a .5 boundary).
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
#include "mma.cuh"
#include "paged_generic.cuh"

namespace {

constexpr int kChunk = 16;      // keys a stage (a page, or 16 keys of one)
constexpr int kHeadTile = 8;    // query heads a block
constexpr int kCols = 4;        // output columns a lane (lanes < D / 4)
// float32(1 / 127^2), the p.V fold of the plain int8 version
constexpr float kCpv = 1.f / (127.f * 127.f);

struct DecodeArgs {
  const void* q;
  const void *k_pool, *v_pool;
  const float *k_scale, *v_scale;
  const int *bt, *seq_lens;
  void* out;
  float* partials;  // splits' states [slot, kv head, tile][split][8][D + 2]
  int* counters;    // their arrivals [slot, kv head, tile], zero between calls
  int W, H, Hkv, bs, dr, n_split, run;
  float scale;      // softmax scale; int8 pools: float32(scale / 127^2)
  int q_bf16;       // q and out are bfloat16 (else float32)
};

// q's and the output's elements: fp pools share their type; int8 pools
// take float32 or bfloat16 q (one kernel for both: the type is read once)
template <typename P>
__device__ __forceinline__ bool q_bf16(const DecodeArgs& a) {
  if constexpr (sizeof(P) == 1)
    return a.q_bf16;
  else
    return sizeof(P) == 2;
}
__device__ __forceinline__ float load_q(const DecodeArgs& a, bool bf16,
                                        size_t i) {
  return bf16 ? __bfloat162float(((const __nv_bfloat16*)a.q)[i])
              : ((const float*)a.q)[i];
}
__device__ __forceinline__ void store_out(const DecodeArgs& a, bool bf16,
                                          size_t i, float v) {
  if (bf16)
    ((__nv_bfloat16*)a.out)[i] = __float2bfloat16_rn(v);
  else
    ((float*)a.out)[i] = v;
}

// bytes of a staged row: D values and 16 bytes against bank conflicts
// (row 0's spare bytes carry the stage's page scale, int8)
template <typename P, int D>
__host__ __device__ constexpr int row_bytes() {
  return D * (int)sizeof(P) + 16;
}

// Warps a block and ring stages a warp.  The 7B decode shape (one query
// head a kv head, D 128) is bound by bytes: bf16 blocks take 4 warps and
// int8 blocks 8 (an int8 page carries half the bytes for the same work
// per key), each warp three stages of 16 keys, two in flight (at D 128 a
// stage is 4.3 KB in bf16, 2.3 KB in int8), so an SM holds two blocks, 8
// bf16 or 16 int8 warps, with 70 or 74 KB in flight.  A query-head group
// multiplies the work per byte, so GQA blocks take 8 warps too; at D 64
// and below the stages are small and a warp's few pages wait on the
// memory's latency, so a warp takes six.  fp32 pools (no main path) keep
// 4 warps, within the shared memory.  (On the card deeper rings at D 128
// measured no faster: fewer blocks then fit an SM.)
template <typename P, int GMAX>
__host__ __device__ constexpr int warps() {
  return sizeof(P) == 4 ? 4 : (sizeof(P) == 1 || GMAX > 1) ? 8 : 4;
}
template <int D>
__host__ __device__ constexpr int stages() {
  return D <= 64 ? 6 : 3;
}


// One stage: rows [0, kc) of a page's 16-key chunk (src: its first key at
// this kv head), columns [0, dr) and zeros past them, in PB-byte pieces.
// Rows past kc are not written: no score of theirs is kept, p.V reads
// them only as int8 codes times a zero probability code.
template <typename P, int D, int PB>
__device__ __forceinline__ void copy_chunk(unsigned char* dst, const P* src,
                                           const void* any, int kc, int dr,
                                           int slot_stride, int lane) {
  constexpr int RB = D * (int)sizeof(P) / PB;  // pieces a row (even)
  constexpr int EP = PB / (int)sizeof(P);      // elements a piece
  constexpr int RS = row_bytes<P, D>();
#pragma unroll
  for (int it = 0; it < kChunk * RB / 32; ++it) {
    const int idx = lane + 32 * it, row = idx / RB, pc = idx % RB;
    if (row >= kc) continue;
    const bool ok = pc * EP < dr;
    const void* s =
        ok ? (const void*)(src + (size_t)row * slot_stride + pc * EP) : any;
    unsigned char* d = dst + row * RS + pc * PB;
    if constexpr (PB == 16)
      cp_async16(d, s, ok);
    else
      cp_async8(d, s, ok);
  }
}

// 16 staged bytes as fp32 values (8 bf16 or 4 fp32)
template <typename P>
__device__ __forceinline__ void piece_f32(const uint4 w, float* x) {
  if constexpr (sizeof(P) == 2) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = bf16_lo(u[i]);
      x[2 * i + 1] = bf16_hi(u[i]);
    }
  } else {
    x[0] = __uint_as_float(w.x);
    x[1] = __uint_as_float(w.y);
    x[2] = __uint_as_float(w.z);
    x[3] = __uint_as_float(w.w);
  }
}

// at least two blocks an SM: an 8-warp block gets at most 128 registers
// a thread (GQA's int8 kernels take more unbounded, one block an SM, and
// their 256 blocks then ran in two waves on the card)
template <typename P, int D, int GMAX, bool Q8>
__global__ void __launch_bounds__(warps<P, GMAX>() * 32, 2)
    paged_decode_kernel(const DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kWarps = warps<P, GMAX>(), kThreads = kWarps * 32;
  constexpr int NS = stages<D>();
  constexpr int RS = row_bytes<P, D>();
  constexpr int STAGE = kChunk * RS;
  constexpr int SCALE_AT = D * (int)sizeof(P);  // row 0's spare bytes
  constexpr int HALF = D * (int)sizeof(P) / 2;  // bytes of half a row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = a.H / a.Hkv, n_ht = (G + kHeadTile - 1) / kHeadTile;
  const int bh = blockIdx.x, split = blockIdx.y;
  const int ht = bh % n_ht, h = (bh / n_ht) % a.Hkv,
            b = bh / (n_ht * a.Hkv);
  const int j0 = ht * kHeadTile, GT = min(kHeadTile, G - j0);
  const int dr = a.dr, bs = a.bs;
  const bool bf16 = q_bf16<P>(a);
  const size_t o0 = ((size_t)b * a.H + h * G + j0) * dr;  // q's and out's
  // this warp's query rows (heads warp, warp + kWarps, ...), loaded while
  // the slot's length is in flight
  constexpr int QR = (GMAX + kWarps - 1) / kWarps;
  float qx[QR][D / 32];
#pragma unroll
  for (int r = 0; r < QR; ++r)
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const int j = warp + kWarps * r, col = lane + 32 * i;
      qx[r][i] = j < GT && col < dr ? load_q(a, bf16, o0 + j * dr + col)
                                    : 0.f;
    }
  const int seq_len = a.seq_lens[b];
  const int n_pages = seq_len > 0 ? min((seq_len + bs - 1) / bs, a.W) : 0;
  const int n_live = (n_pages + a.run - 1) / a.run;  // splits with pages
  if (n_live == 0) {  // seq_len 0: nothing to attend, the output is 0
    if (split == 0)
      for (int i = threadIdx.x; i < GT * dr; i += kThreads)
        store_out(a, bf16, o0 + i, 0.f);
    return;
  }
  if (split >= n_live) return;  // a run past the slot's pages

  // shared memory: q [GMAX][D] (fp32 scaled, or int8 codes) and its
  // scales, then per warp its ring, its scores / p [GMAX][bsp] (fp32) and,
  // int8, its p codes [GMAX][bsp]; the warps' states alias the rings at
  // the end
  const int bsp = (bs + kChunk - 1) / kChunk * kChunk;
  const int cpp = bsp / kChunk;  // stages a page's K (and its V) take
  float* Qf = reinterpret_cast<float*>(smem);
  const int8_t* Qc = reinterpret_cast<const int8_t*>(smem);
  float* qsc = Qf + GMAX * D;
  unsigned char* wbase = smem + (GMAX * D + ((GMAX + 3) & ~3)) * 4;
  const size_t wbytes =
      (size_t)NS * STAGE + (size_t)GMAX * bsp * (Q8 ? 5 : 4);
  unsigned char* ring = wbase + warp * wbytes;
  float* Sw = reinterpret_cast<float*>(ring + NS * STAGE);
  int8_t* Pc = reinterpret_cast<int8_t*>(Sw + GMAX * bsp);

  // this warp's pages of the split's run, as a sequence of stage loads:
  // page i's K chunks, then its V chunks
  const int p_begin = split * a.run + warp;
  const int p_end = min(n_pages, split * a.run + a.run);
  const int n_my = p_end > p_begin ? (p_end - p_begin + kWarps - 1) / kWarps
                                   : 0;
  const int n_loads = n_my * 2 * cpp;
  const int slot_stride = a.Hkv * dr;
  const size_t page_stride = (size_t)bs * slot_stride;
  const int* bt = a.bt + (size_t)b * a.W;
  const bool narrow = Q8 && (dr & 15);  // int8 rows not 16-byte aligned

  // loads are issued in order, load i = page i / (2 cpp), stage i % (2
  // cpp) of it (its K chunks, then its V chunks), counted without
  // divisions; the table entry of the page after the one being issued is
  // read a page early, so no copy waits on it
  int n_issued = 0, i_pi = 0, i_r = 0, page = 0;
  int next_page = n_my > 0 ? bt[p_begin] : 0;
  auto issue = [&]() {
    const bool is_v = i_r >= cpp;
    const int c = is_v ? i_r - cpp : i_r;
    const int p = p_begin + kWarps * i_pi;
    if (i_r == 0) {
      page = next_page;
      if (i_pi + 1 < n_my) next_page = bt[p + kWarps];
    }
    const int kc = min(kChunk, min(bs, seq_len - p * bs) - c * kChunk);
    const P* pool = (const P*)(is_v ? a.v_pool : a.k_pool);
    const P* src = pool + (size_t)page * page_stride +
                   (size_t)c * kChunk * slot_stride + (size_t)h * dr;
    unsigned char* dst = ring + (n_issued % NS) * STAGE;
    if (narrow)
      copy_chunk<P, D, 8>(dst, src, pool, kc, dr, slot_stride, lane);
    else
      copy_chunk<P, D, 16>(dst, src, pool, kc, dr, slot_stride, lane);
    if (Q8 && lane == 0)  // the page's scale rides with the stage
      cp_async4(dst + SCALE_AT,
                (is_v ? a.v_scale : a.k_scale) + (size_t)page * a.Hkv + h,
                true);
    ++n_issued;
    if (++i_r == 2 * cpp) i_r = 0, ++i_pi;
  };

  float m[GMAX], l[GMAX], acc[GMAX][kCols], psc[GMAX];
  int pvi[GMAX][kCols];  // int8: the page's exact p.V code sums
#pragma unroll
  for (int j = 0; j < GMAX; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
    psc[j] = 1.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[j][e] = 0.f, pvi[j][e] = 0;
  }
  const int key = lane & 15, half = lane >> 4;

#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_loads) issue();
    cp_async_commit();
  }

  // the tile's query rows, stored while the first stages are in flight:
  // scaled (fp) or quantized per row (int8), columns past dr and heads
  // past GT zero
#pragma unroll
  for (int r = 0; r < QR; ++r) {
    const int j = warp + kWarps * r;
    if (j < GMAX) {
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) amax = fmaxf(amax, fabsf(qx[r][i]));
      if constexpr (Q8) {
        const float qs = fmaxf(ptt::warp_max(amax), 1e-30f);
        int8_t* row = reinterpret_cast<int8_t*>(smem) + j * D;
#pragma unroll
        for (int i = 0; i < D / 32; ++i)
          row[lane + 32 * i] = (int8_t)ptt::quant_code(qx[r][i], qs);
        if (lane == 0) qsc[j] = qs;
      } else {
#pragma unroll
        for (int i = 0; i < D / 32; ++i)
          Qf[j * D + lane + 32 * i] = __fmul_rn(qx[r][i], a.scale);
      }
    }
  }
  __syncthreads();

  // load i is stage r of the warp's page pi, which holds nk >= 1 keys
  for (int i = 0, pi = 0, r = 0, nk = min(bs, seq_len - p_begin * bs);
       i < n_loads; ++i) {
    if (i + NS - 1 < n_loads) issue();
    cp_async_commit();
    cp_async_wait<NS - 1>();  // load i has landed (this lane's part)
    __syncwarp();             // ... and every lane's
    const unsigned char* st = ring + (i % NS) * STAGE;
    if (r < cpp) {
      // scores of the chunk's keys: lane = (key, half of the columns)
      const int c = r, kc = min(kChunk, nk - c * kChunk);
      if (kc > 0) {
        const unsigned char* row = st + key * RS + half * HALF;
        if constexpr (Q8) {
          int dot[GMAX];
#pragma unroll
          for (int j = 0; j < GMAX; ++j) dot[j] = 0;
#pragma unroll
          for (int pc = 0; pc < HALF / 16; ++pc) {
            const uint4 kw = *reinterpret_cast<const uint4*>(row + pc * 16);
            const int col0 = half * (D / 2) + pc * 16;
#pragma unroll
            for (int j = 0; j < GMAX; ++j) {
              if (j >= GT) continue;
              const uint4 qw =
                  *reinterpret_cast<const uint4*>(Qc + j * D + col0);
              dot[j] = __dp4a((int)kw.x, (int)qw.x, dot[j]);
              dot[j] = __dp4a((int)kw.y, (int)qw.y, dot[j]);
              dot[j] = __dp4a((int)kw.z, (int)qw.z, dot[j]);
              dot[j] = __dp4a((int)kw.w, (int)qw.w, dot[j]);
            }
          }
          const float sk = *reinterpret_cast<const float*>(st + SCALE_AT);
#pragma unroll
          for (int j = 0; j < GMAX; ++j) {
            dot[j] += __shfl_xor_sync(0xffffffffu, dot[j], 16);
            if (j < GT && half == 0 && key < kc)  // fold the exact score
              Sw[j * bsp + c * kChunk + key] =
                  (float)dot[j] * (qsc[j] * (sk * a.scale));
          }
        } else {
          constexpr int EP = 16 / (int)sizeof(P);
          float dot[GMAX];
#pragma unroll
          for (int j = 0; j < GMAX; ++j) dot[j] = 0.f;
#pragma unroll
          for (int pc = 0; pc < HALF / 16; ++pc) {
            float kf[EP];
            piece_f32<P>(*reinterpret_cast<const uint4*>(row + pc * 16), kf);
            const int col0 = half * (D / 2) + pc * EP;
#pragma unroll
            for (int j = 0; j < GMAX; ++j) {
              if (j >= GT) continue;
#pragma unroll
              for (int e = 0; e < EP; e += 4) {
                const float4 qv =
                    *reinterpret_cast<const float4*>(Qf + j * D + col0 + e);
                dot[j] = fmaf(qv.x, kf[e], dot[j]);
                dot[j] = fmaf(qv.y, kf[e + 1], dot[j]);
                dot[j] = fmaf(qv.z, kf[e + 2], dot[j]);
                dot[j] = fmaf(qv.w, kf[e + 3], dot[j]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < GMAX; ++j) {
            dot[j] += __shfl_xor_sync(0xffffffffu, dot[j], 16);
            if (j < GT && half == 0 && key < kc)
              Sw[j * bsp + c * kChunk + key] = dot[j];
          }
        }
      }
      if (c == cpp - 1) {
        // the page's online-softmax update for every query head, the
        // heads' warp reductions interleaved
        __syncwarp();
        float mx[GMAX], ps[GMAX], pm[GMAX];
#pragma unroll
        for (int j = 0; j < GMAX; ++j) {
          mx[j] = -INFINITY, ps[j] = 0.f, pm[j] = 0.f;
          if (j < GT)
            for (int k = lane; k < nk; k += 32)
              mx[j] = fmaxf(mx[j], Sw[j * bsp + k]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int j = 0; j < GMAX; ++j)
            mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
#pragma unroll
        for (int j = 0; j < GMAX; ++j) {
          if (j >= GT) continue;
          mx[j] = fmaxf(m[j], mx[j]);  // the new running max
          for (int k = lane; k < nk; k += 32) {
            const float e = expf(Sw[j * bsp + k] - mx[j]);
            Sw[j * bsp + k] = e;
            ps[j] += e;
            pm[j] = fmaxf(pm[j], e);
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int j = 0; j < GMAX; ++j) {
            ps[j] += __shfl_xor_sync(0xffffffffu, ps[j], o);
            pm[j] = fmaxf(pm[j], __shfl_xor_sync(0xffffffffu, pm[j], o));
          }
#pragma unroll
        for (int j = 0; j < GMAX; ++j) {
          if (j >= GT) continue;
          const float alpha = expf(m[j] - mx[j]);
          l[j] = l[j] * alpha + ps[j];
          m[j] = mx[j];
#pragma unroll
          for (int e = 0; e < kCols; ++e) acc[j][e] *= alpha;
          if constexpr (Q8) {
            // the page's probability codes against their max (0 past nk)
            psc[j] = fmaxf(pm[j], 1e-30f);
            for (int k = lane; k < bsp; k += 32)
              Pc[j * bsp + k] =
                  k < nk ? (int8_t)ptt::quant_code(Sw[j * bsp + k], psc[j])
                         : 0;
          }
        }
      }
    } else {
      // p.V over the chunk's keys: lane owns columns 4 lane .. 4 lane + 3
      const int c = r - cpp, kc = min(kChunk, nk - c * kChunk);
      if (kc > 0 && lane * kCols < D) {
        if constexpr (Q8) {
          const unsigned char* col = st + lane * kCols;
#pragma unroll 4
          for (int k4 = 0; k4 < kc; k4 += 4) {
            const uint32_t r0 = *reinterpret_cast<const uint32_t*>(
                               col + k4 * RS),
                           r1 = *reinterpret_cast<const uint32_t*>(
                               col + (k4 + 1) * RS),
                           r2 = *reinterpret_cast<const uint32_t*>(
                               col + (k4 + 2) * RS),
                           r3 = *reinterpret_cast<const uint32_t*>(
                               col + (k4 + 3) * RS);
            // 4 keys x 4 columns -> per column the 4 keys' codes
            const uint32_t t0 = __byte_perm(r0, r1, 0x5140),
                           t1 = __byte_perm(r2, r3, 0x5140),
                           t2 = __byte_perm(r0, r1, 0x7362),
                           t3 = __byte_perm(r2, r3, 0x7362);
            const int cv[4] = {(int)__byte_perm(t0, t1, 0x5410),
                               (int)__byte_perm(t0, t1, 0x7632),
                               (int)__byte_perm(t2, t3, 0x5410),
                               (int)__byte_perm(t2, t3, 0x7632)};
#pragma unroll
            for (int j = 0; j < GMAX; ++j) {
              if (j >= GT) continue;
              const int pw = *reinterpret_cast<const int*>(
                  Pc + j * bsp + c * kChunk + k4);
#pragma unroll
              for (int e = 0; e < kCols; ++e)
                pvi[j][e] = __dp4a(cv[e], pw, pvi[j][e]);
            }
          }
        } else {
#pragma unroll 4
          for (int k = 0; k < kc; ++k) {
            const unsigned char* vr = st + k * RS + lane * kCols * sizeof(P);
            float v[kCols];
            if constexpr (sizeof(P) == 2) {
              const uint2 w = *reinterpret_cast<const uint2*>(vr);
              v[0] = bf16_lo(w.x), v[1] = bf16_hi(w.x);
              v[2] = bf16_lo(w.y), v[3] = bf16_hi(w.y);
            } else {
              const float4 w = *reinterpret_cast<const float4*>(vr);
              v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
            }
#pragma unroll
            for (int j = 0; j < GMAX; ++j) {
              if (j >= GT) continue;
              const float pk = Sw[j * bsp + c * kChunk + k];
#pragma unroll
              for (int e = 0; e < kCols; ++e)
                acc[j][e] = fmaf(pk, v[e], acc[j][e]);
            }
          }
        }
      }
      if (Q8 && c == cpp - 1) {  // fold the page's exact code sums
        const float sv = *reinterpret_cast<const float*>(st + SCALE_AT);
#pragma unroll
        for (int j = 0; j < GMAX; ++j) {
          const float fold = psc[j] * (sv * kCpv);
#pragma unroll
          for (int e = 0; e < kCols; ++e) {
            acc[j][e] += __fmul_rn((float)pvi[j][e], fold);
            pvi[j][e] = 0;
          }
        }
      }
    }
    __syncwarp();  // stage i consumed before a later load overwrites it
    if (++r == 2 * cpp) {
      r = 0, ++pi;
      nk = min(bs, seq_len - (p_begin + kWarps * pi) * bs);
    }
  }
  cp_async_wait<0>();

  // merge the warps' states in warp order
  __syncthreads();
  float* m_s = reinterpret_cast<float*>(wbase);  // [kWarps][GMAX]
  float* l_s = m_s + kWarps * GMAX;             // [kWarps][GMAX]
  float* acc_s = l_s + kWarps * GMAX;           // [kWarps][GMAX][D]
#pragma unroll
  for (int j = 0; j < GMAX; ++j) {
    if (lane == 0) {
      m_s[warp * GMAX + j] = m[j];
      l_s[warp * GMAX + j] = l[j];
    }
    if (lane * kCols < D)
#pragma unroll
      for (int e = 0; e < kCols; ++e)
        acc_s[(warp * GMAX + j) * D + lane * kCols + e] = acc[j][e];
  }
  __syncthreads();
  float* part = a.partials +
                ((size_t)bh * a.n_split + split) * kHeadTile * (D + 2);
  for (int idx = threadIdx.x; idx < GT * D; idx += kThreads) {
    const int j = idx / D, d = idx % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_s[w * GMAX + j]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float e = expf(m_s[w * GMAX + j] - M);  // 0: a warp, no page
        L += l_s[w * GMAX + j] * e;
        A += acc_s[(w * GMAX + j) * D + d] * e;
      }
    }
    if (n_live == 1) {
      if (d < dr) store_out(a, bf16, o0 + j * dr + d, A / fmaxf(L, 1e-30f));
    } else {
      float* pj = part + j * (D + 2);
      if (d == 0) pj[0] = M, pj[1] = L;
      pj[2 + d] = A;
    }
  }
  if (n_live == 1) return;
  // the last split to arrive merges the splits' states in split order
  __shared__ int last;
  __threadfence();
  __syncthreads();
  int* count = a.counters + bh;
  if (threadIdx.x == 0) last = atomicAdd(count, 1) == n_live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* part0 =
      a.partials + (size_t)bh * a.n_split * kHeadTile * (D + 2);
  // every split's (M, L) staged in shared memory with one round of loads,
  // as exp(M - max M) and L exp(M - max M) per (split, head)
  float* e_s = reinterpret_cast<float*>(wbase);  // [n_live][GT]
  float* le_s = e_s + n_live * GT;                // [n_live][GT]
  for (int idx = threadIdx.x; idx < n_live * GT; idx += kThreads) {
    const float* pj = part0 + (size_t)idx * (D + 2) +
                      (size_t)(idx / GT) * (kHeadTile - GT) * (D + 2);
    e_s[idx] = __ldcg(pj);
    le_s[idx] = __ldcg(pj + 1);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < GT; j += kThreads) {
    float M = -INFINITY;
    for (int s = 0; s < n_live; ++s) M = fmaxf(M, e_s[s * GT + j]);
    for (int s = 0; s < n_live; ++s) {
      const float e = expf(e_s[s * GT + j] - M);
      e_s[s * GT + j] = e;
      le_s[s * GT + j] *= e;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < GT * dr; idx += kThreads) {
    const int j = idx / dr, d = idx % dr;
    float L = 0.f, A = 0.f;
    // the splits' values in split order, 8 loads in flight at a time
    for (int s0 = 0; s0 < n_live; s0 += 8) {
      float av[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        av[u] = s0 + u < n_live
                    ? __ldcg(part0 + ((size_t)(s0 + u) * kHeadTile + j) *
                                         (D + 2) + 2 + d)
                    : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (s0 + u < n_live) {
          L += le_s[(s0 + u) * GT + j];
          A += av[u] * e_s[(s0 + u) * GT + j];
        }
    }
    store_out(a, bf16, o0 + j * dr + d, A / fmaxf(L, 1e-30f));
  }
  if (threadIdx.x == 0) *count = 0;  // zero for the next call
}

template <typename P, int D, int GMAX, bool Q8>
int launch(const DecodeArgs& a, int n_bh, cudaStream_t st) {
  constexpr int STAGE = kChunk * row_bytes<P, D>();
  const int bsp = (a.bs + kChunk - 1) / kChunk * kChunk;
  const size_t wbytes =
      (size_t)stages<D>() * STAGE + (size_t)GMAX * bsp * (Q8 ? 5 : 4);
  constexpr int kWarps = warps<P, GMAX>();
  const size_t merge = (size_t)kWarps * GMAX * (D + 2) * 4;
  const size_t rings = kWarps * wbytes;
  const size_t smem = (size_t)(GMAX * D + ((GMAX + 3) & ~3)) * 4 +
                      (rings > merge ? rings : merge);
  auto kern = paged_decode_kernel<P, D, GMAX, Q8>;
  // the largest dynamic shared memory allowed so far, per device
  static int allowed[16] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && (dev >= 16 || (int)smem > allowed[dev])) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 16) allowed[dev] = (int)smem;
  }
  kern<<<dim3(n_bh, a.n_split), kWarps * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename P, bool Q8, int D>
int dispatch_g(int gmax, const DecodeArgs& a, int n_bh, cudaStream_t st) {
  switch (gmax) {
    case 1: return launch<P, D, 1, Q8>(a, n_bh, st);
    case 4: return launch<P, D, 4, Q8>(a, n_bh, st);
    case 8: return launch<P, D, 8, Q8>(a, n_bh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename P, bool Q8>
int dispatch_d(int gmax, const DecodeArgs& a, int n_bh, cudaStream_t st) {
  switch (ptt::paged_width(a.dr)) {  // the width the kernel is built at
    case 32: return dispatch_g<P, Q8, 32>(gmax, a, n_bh, st);
    case 64: return dispatch_g<P, Q8, 64>(gmax, a, n_bh, st);
    case 96: return dispatch_g<P, Q8, 96>(gmax, a, n_bh, st);
    default: return dispatch_g<P, Q8, 128>(gmax, a, n_bh, st);
  }
}


// The generic kernel (paged_generic.cuh) over the slots: one warp per
// query vector (slot b, query head), slot b a one-row span of seq_lens[b]
// keys.
template <typename T, typename P, bool Q8>
__global__ void __launch_bounds__(ptt::kGenWarps * 32)
    paged_decode_kernel_generic(const ptt::GenericArgs a) {
  extern __shared__ float gen_smem[];
  const int warp = threadIdx.x >> 5;
  const long long v = (long long)blockIdx.x * ptt::kGenWarps + warp;
  if (v >= (long long)a.T * a.H) return;
  const int b = (int)(v / a.H), hq = (int)(v % a.H);
  ptt::generic_attend<T, P, Q8>(a, gen_smem + warp * (2 * a.D + a.bs), b,
                                hq, b, b, 1, a.kv_len[b]);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and out share it; the pools too
// unless quantized, when they are int8 with float32 scales [phys, Hkv]).
// q [B, H, D], out [B, H, D], contiguous pools [phys, bs, Hkv, D]; D a
// multiple of 8 up to 128, bs 1 to 128, H a multiple of Hkv.  The table's
// width W is cut into n_split runs of `run` pages (n_split * run >= W);
// with n_bh = B * Hkv * ceil(groups / 8) blocks a split (query heads in
// tiles of kHeadTile = 8), partials (n_bh * n_split * 8 * (Dw + 2)
// float32, Dw = ptt::paged_width(D), the width the kernel is built at)
// and counters (n_bh int32, zero; left zero) serve the splits when
// n_split > 1.  `scale` is the softmax scale, or for int8
// pools float32(scale / 127^2).  Returns the launch's cudaGetLastError().
extern "C" int ptt_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* bt,
    const void* seq_lens, void* partials, void* counters, void* out, int B,
    int W, int H, int Hkv, int D, int bs, int n_split, int run, float scale,
    int dtype, int quantized, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bs < 1 || bs > 128 || Hkv < 1 || H % Hkv || ptt::paged_width(D) == 0 ||
      B < 1 || W < 1 || n_split < 1 || run < 1 ||
      (long long)n_split * run < W ||
      (n_split > 1 && (partials == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv, gt = G < kHeadTile ? G : kHeadTile;
  const int gmax = gt == 1 ? 1 : gt <= 4 ? 4 : 8;
  const int n_bh = B * Hkv * ((G + kHeadTile - 1) / kHeadTile);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const DecodeArgs a = {q, k_pool, v_pool, (const float*)k_scale,
                        (const float*)v_scale, (const int*)bt,
                        (const int*)seq_lens, out, (float*)partials,
                        (int*)counters, W, H, Hkv, bs, D, n_split, run,
                        scale, dtype};
  if (quantized) return dispatch_d<int8_t, true>(gmax, a, n_bh, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, false>(gmax, a, n_bh, st);
  return dispatch_d<float, false>(gmax, a, n_bh, st);
}

// The generic kernel (paged_generic.cuh) for the shapes the kernel above
// does not take: any head dim D >= 1, any block size, any group count.
// q and out are [B, H, D] at the pools' own D; the pools contiguous.
// scale is the softmax scale; c_qk and c_pv the int8 folds
// (float32(scale / 127^2), float32(1 / 127^2)).  Returns the launch's
// cudaGetLastError().
extern "C" int ptt_paged_decode_attention_generic(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* bt,
    const void* seq_lens, void* out, int B, int W, int H, int Hkv, int D,
    int bs, float scale, float c_qk, float c_pv, int dtype, int quantized,
    void* stream) {
  if (B < 1 || W < 1 || Hkv < 1 || H % Hkv || D < 1 || bs < 1 ||
      (dtype != 0 && dtype != 1) ||
      (quantized && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const ptt::GenericArgs a = {
      q, k_pool, v_pool, (const float*)k_scale, (const float*)v_scale,
      (const int*)bt, nullptr, nullptr, (const int*)seq_lens, out, B, B, W,
      H, Hkv, D, bs, (long long)bs * Hkv * D, (long long)Hkv * D, scale,
      c_qk, c_pv};
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H;
  if (quantized)
    return dtype == 1
               ? ptt::launch_generic(
                     paged_decode_kernel_generic<__nv_bfloat16, int8_t, true>,
                     a, n, st)
               : ptt::launch_generic(
                     paged_decode_kernel_generic<float, int8_t, true>, a, n,
                     st);
  return dtype == 1
             ? ptt::launch_generic(
                   paged_decode_kernel_generic<__nv_bfloat16, __nv_bfloat16,
                                               false>,
                   a, n, st)
             : ptt::launch_generic(paged_decode_kernel_generic<float, float,
                                                               false>,
                                   a, n, st);
}
