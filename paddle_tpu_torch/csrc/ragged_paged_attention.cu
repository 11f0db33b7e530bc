// Ragged paged attention for Hopper (sm_90a): the attention of the fused
// mixed prefill+decode serving step.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py _ragged_paged_kernel
// (launched by _ragged_paged_attention_pallas), both variants: fp32/bf16
// pools and int8 pools with per-page, per-head fp32 scales.
//
// What it computes.  The packed query batch q [T, H, D] holds S spans:
// span s owns rows q_off[s] .. q_off[s] + q_len[s] - 1.  Row r of span s
// sits at global position kv_len[s] - q_len[s] + r and attends the keys
// at columns c <= that position (so c < kv_len[s]) of the span's pages
// bt[s, 0 : ceil(kv_len/bs)] in the pools [phys, bs, Hkv, D].  Query
// heads group over kv heads as [T, Hkv, groups, D].  Softmax is fp32
// online, the output has q's dtype.
//
// int8 pools compute what the pipelined Pallas int8 path computes
// (pallas_kernels.py:1524-1595): each query vector (one head of one row,
// over D) is quantized per row to codes and an absmax scale; q.K^T runs on
// the codes with an exact integer sum, folded as acc * (q_scale *
// (k_scale[page, h] * float32(scale / 127^2))); each page's probabilities
// are quantized per row (their max over the page is the scale) and p.V
// runs on the codes, folded per page as acc * (p_scale * (v_scale[page,
// h] * float32(1 / 127^2))).  Only int8 codes and the fp32 scale rows are
// read from device memory.  Code products summed over D <= 128 (or over a
// tile of <= 64 keys) stay below 2^24, so fp32 sums of them are exact.
// The int8 tile holds whole pages (floor(64 / bs) of them) and takes its
// running max over the tile rather than page by page: the probability
// codes depend only on exp(s - page max), so the function is the Pallas
// kernel's up to fp32 rounding (and, rarely, a code that rounds the other
// way at a .5 boundary).
//
// Design (simple and right first; wgmma/TMA/warp specialisation later).
// One block per (span, row tile, kv head), 8 warps.  A block owns up to
// 32 query vectors (rows x the kv head's `groups` query heads), 4 per
// warp.  Keys stream through shared memory 64 at a time (each key finds
// its own page, so any block size works), converted to fp32; one lane
// scores two keys against all 4 of its warp's queries, the warp updates
// each query's running max / sum, and the probabilities go through
// shared memory into the P·V accumulation, which keeps D/32 output
// columns per lane in fp32 registers.
//
// Bound on the card: bytes for decode (each span reads kv_len x D x 2
// values per kv head and does 4 operations per value); the long chunk
// spans do ~4 x rows operations per value read and are bounded by the
// fp32 CUDA-core rate in this design (no tensor cores yet).
//
// Where trouble is likely, and what the design does about it:
// - Garbage-row stores race on the GPU.  The Pallas kernel computes and
//   writes back rows r >= q_len inside its fixed span window, relying on
//   the TPU's sequential grid to let the next span overwrite them.  Here
//   blocks run concurrently, so only rows r < q_len are ever stored; the
//   wrapper allocates the output with zeros, so padding rows are 0.
// - No pool copy.  The Pallas wrapper moves the head axis and casts both
//   pools to fp32 on every call (a whole-pool copy per layer per step).
//   This kernel reads [phys, bs, Hkv, D] in place, in its own dtype, with
//   the page and slot strides it is given.
// - Poison-page invariant.  A block reads block-table entries j <
//   min(ceil(n_keys / bs), W) only, where n_keys <= kv_len is the last
//   key its rows can see, and never reads a key at or past n_keys (such
//   slots enter shared memory as zeros).  Spans with q_len == 0 (the
//   engine's padding spans) return before touching anything.
// - GQA.  Each kv-head block owns its `groups` query heads; the row tile
//   shrinks as groups grow so a block holds at most 32 query vectors.
// - Load imbalance.  Decode spans have one row, chunk spans up to
//   span_q rows; rows are tiled (32 / groups rows per block), so a long
//   chunk spreads over many blocks instead of serialising on one.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kQPerWarp = 4;
constexpr int kQPerBlock = kWarps * kQPerWarp;  // 32 query vectors
constexpr int kKeysPerLane = 2;
constexpr int kTileKeys = 32 * kKeysPerLane;  // 64 keys per smem tile

template <int D>
constexpr size_t smem_floats() {
  // K tile (row-padded against bank conflicts) + V tile + Q rows +
  // per-warp probability rows, then (int8) the tile's page scales and
  // per-warp probability scales
  return (size_t)kTileKeys * (D + 1) + (size_t)kTileKeys * D +
         (size_t)kQPerBlock * D + (size_t)kWarps * kQPerWarp * kTileKeys +
         2 * (size_t)kTileKeys + (size_t)kWarps * kTileKeys;
}

// T: q / out type.  P: pool type (T, or int8_t with Q8).
template <typename T, typename P, int D, bool Q8>
__global__ void __launch_bounds__(kWarps * 32)
    ragged_paged_attention_kernel(
        const T* __restrict__ q, const P* __restrict__ k_pool,
        const P* __restrict__ v_pool, const float* __restrict__ k_scale,
        const float* __restrict__ v_scale,
        const int* __restrict__ block_tables,
        const int* __restrict__ q_offsets, const int* __restrict__ q_lens,
        const int* __restrict__ kv_lens, T* __restrict__ out, int W, int H,
        int Hkv, int bs, int page_stride, int slot_stride, int n_tiles,
        int rows_per_tile, int tile_keys, float scale, float c_qk,
        float c_pv) {
  constexpr int DPL = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* Ks = smem;                            // [kTileKeys][D + 1]
  float* Vs = Ks + kTileKeys * (D + 1);        // [kTileKeys][D]
  float* Qs = Vs + kTileKeys * D;              // [kQPerBlock][D]
  float* Ps = Qs + kQPerBlock * D;             // [kWarps][kQPerWarp][keys]
  float* Ksc = Ps + kWarps * kQPerWarp * kTileKeys;  // [pages in tile]
  float* Vsc = Ksc + kTileKeys;                      // [pages in tile]
  float* Psc = Vsc + kTileKeys;                // [kWarps][pages in tile]

  const int s = blockIdx.x / n_tiles;
  const int tile = blockIdx.x % n_tiles;
  const int h = blockIdx.y;
  const int q_len = q_lens[s];
  const int row0 = tile * rows_per_tile;
  if (q_len <= 0 || row0 >= q_len) return;  // whole block: no barrier yet

  const int groups = H / Hkv;
  const int kv_len = kv_lens[s];
  const int q_off = q_offsets[s];
  const int rows = min(rows_per_tile, q_len - row0);
  const int nq = rows * groups;
  // the last key any row of this block may see, and the pages it spans
  const int n_keys = kv_len - q_len + row0 + rows;
  const int n_pages = min((n_keys + bs - 1) / bs, W);
  const int key_end = min(n_keys, n_pages * bs);
  const int* bt = block_tables + (size_t)s * W;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // query rows (scaled for fp pools, raw for int8); unused slots are 0
  for (int i = tid; i < kQPerBlock * D; i += blockDim.x) {
    const int qi = i / D, d = i % D;
    float val = 0.f;
    if (qi < nq) {
      const int row = row0 + qi / groups;
      const int head = h * groups + qi % groups;
      val = ptt::to_f32(q[((size_t)(q_off + row) * H + head) * D + d]);
      if (!Q8) val *= scale;
    }
    Qs[i] = val;
  }

  // int8: each warp quantizes its own query rows in place (codes)
  float qsc[kQPerWarp];
#pragma unroll
  for (int j = 0; j < kQPerWarp; ++j) qsc[j] = 1.f;
  if constexpr (Q8) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kQPerWarp; ++j) {
      float* qrow = Qs + (warp + kWarps * j) * D;
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        amax = fmaxf(amax, fabsf(qrow[lane + 32 * i]));
      qsc[j] = fmaxf(ptt::warp_max(amax), 1e-30f);
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        qrow[lane + 32 * i] = ptt::quant_code(qrow[lane + 32 * i], qsc[j]);
    }
  }

  float m[kQPerWarp], l[kQPerWarp], acc[kQPerWarp][DPL];
  int qpos[kQPerWarp];
#pragma unroll
  for (int j = 0; j < kQPerWarp; ++j) {
    const int qi = warp + kWarps * j;
    m[j] = -INFINITY;
    l[j] = 0.f;
    qpos[j] = qi < nq ? kv_len - q_len + row0 + qi / groups : -1;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[j][i] = 0.f;
  }

  float* psc = Psc + warp * kTileKeys;
  for (int kt0 = 0; kt0 < key_end; kt0 += tile_keys) {
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    for (int i = tid; i < kTileKeys * D; i += blockDim.x) {
      const int key = i / D, d = i % D;
      const int col = kt0 + key;
      float kv = 0.f, vv = 0.f;
      if (key < tile_keys && col < key_end) {
        const int page = bt[col / bs];
        const size_t at = (size_t)page * page_stride +
                          (size_t)(col % bs) * slot_stride + (size_t)h * D + d;
        kv = ptt::to_f32(k_pool[at]);
        vv = ptt::to_f32(v_pool[at]);
      }
      Ks[key * (D + 1) + d] = kv;
      Vs[key * D + d] = vv;
    }
    if constexpr (Q8) {  // the tile's whole pages' scales
      const int pg0 = kt0 / bs;
      for (int i = tid; i < tile_keys / bs; i += blockDim.x) {
        const bool used = pg0 + i < n_pages;
        const size_t at = (size_t)(used ? bt[pg0 + i] : 0) * Hkv + h;
        Ksc[i] = used ? k_scale[at] : 0.f;
        Vsc[i] = used ? v_scale[at] : 0.f;
      }
    }
    __syncthreads();

    // scores: lane owns keys lane and lane + 32 of the tile
    float sc[kQPerWarp][kKeysPerLane];
#pragma unroll
    for (int j = 0; j < kQPerWarp; ++j)
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) sc[j][kk] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kd[kKeysPerLane];
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk)
        kd[kk] = Ks[(lane + 32 * kk) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kQPerWarp; ++j) {
        const float qd = Qs[(warp + kWarps * j) * D + d];
#pragma unroll
        for (int kk = 0; kk < kKeysPerLane; ++kk) sc[j][kk] += qd * kd[kk];
      }
    }

    const int tile_end = min(tile_keys, key_end - kt0);  // keys to use
#pragma unroll
    for (int j = 0; j < kQPerWarp; ++j) {
      if (qpos[j] < 0) continue;  // warp-uniform: inactive query slot
      float tmax = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) {
        const int key = lane + 32 * kk;
        const int col = kt0 + key;
        if (Q8 && key < tile_keys)  // fold the exact integer score
          sc[j][kk] = sc[j][kk] * (qsc[j] * (Ksc[key / bs] * c_qk));
        if (!(key < tile_end && col <= qpos[j])) sc[j][kk] = -INFINITY;
        tmax = fmaxf(tmax, sc[j][kk]);
      }
      tmax = ptt::warp_max(tmax);
      const float m_new = fmaxf(m[j], tmax);
      if (m_new == -INFINITY) continue;  // nothing visible yet
      const float corr = expf(m[j] - m_new);
      float psum = 0.f;
      float* prow = Ps + (warp * kQPerWarp + j) * kTileKeys;
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) {
        const float p =
            sc[j][kk] == -INFINITY ? 0.f : expf(sc[j][kk] - m_new);
        prow[lane + 32 * kk] = p;
        psum += p;
      }
      l[j] = l[j] * corr + ptt::warp_sum(psum);
      m[j] = m_new;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[j][i] *= corr;
      if constexpr (Q8) {
        // per-page probability scales, then the codes, in place
        const int n_pg = (tile_end + bs - 1) / bs;
        for (int pg = lane; pg < n_pg; pg += 32) {
          float pmax = 0.f;
          for (int k = pg * bs; k < min(pg * bs + bs, tile_end); ++k)
            pmax = fmaxf(pmax, prow[k]);
          psc[pg] = fmaxf(pmax, 1e-30f);
        }
        __syncwarp();
#pragma unroll
        for (int kk = 0; kk < kKeysPerLane; ++kk) {
          const int key = lane + 32 * kk;
          if (key < tile_end)
            prow[key] = ptt::quant_code(prow[key], psc[key / bs]);
        }
        __syncwarp();
        for (int pg = 0; pg < n_pg; ++pg) {
          float pv[DPL];
#pragma unroll
          for (int i = 0; i < DPL; ++i) pv[i] = 0.f;
          for (int key = pg * bs; key < min(pg * bs + bs, tile_end); ++key) {
            const float p = prow[key];
#pragma unroll
            for (int i = 0; i < DPL; ++i)
              pv[i] += p * Vs[key * D + lane + 32 * i];
          }
          const float fold = psc[pg] * (Vsc[pg] * c_pv);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[j][i] += pv[i] * fold;
        }
      } else {
        for (int key = 0; key < tile_end; ++key) {
          const float p = prow[key];
#pragma unroll
          for (int i = 0; i < DPL; ++i)
            acc[j][i] += p * Vs[key * D + lane + 32 * i];
        }
      }
      __syncwarp();
    }
  }

  // store only the span's own rows: padding rows stay as allocated (0)
#pragma unroll
  for (int j = 0; j < kQPerWarp; ++j) {
    if (qpos[j] < 0) continue;
    const int qi = warp + kWarps * j;
    const int row = row0 + qi / groups;
    const int head = h * groups + qi % groups;
    const float inv_l = 1.f / fmaxf(l[j], 1e-30f);
    T* o = out + ((size_t)(q_off + row) * H + head) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      o[lane + 32 * i] = ptt::from_f32<T>(acc[j][i] * inv_l);
  }
}

template <typename T, typename P, int D, bool Q8>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale,
           const void* block_tables, const void* q_offsets,
           const void* q_lens, const void* kv_lens, void* out, int S, int W,
           int H, int Hkv, int bs, int page_stride, int slot_stride,
           int span_q, float scale, float c_qk, float c_pv,
           cudaStream_t stream) {
  const int groups = H / Hkv;
  const int rows_per_tile = groups >= kQPerBlock ? 1 : kQPerBlock / groups;
  const int n_tiles = (span_q + rows_per_tile - 1) / rows_per_tile;
  // int8 tiles hold whole pages; fp tiles any 64 keys
  const int tile_keys = Q8 ? (kTileKeys / bs) * bs : kTileKeys;
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_paged_attention_kernel<T, P, D, Q8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S * n_tiles, Hkv);
  ragged_paged_attention_kernel<T, P, D, Q8>
      <<<grid, kWarps * 32, smem, stream>>>(
          (const T*)q, (const P*)k_pool, (const P*)v_pool,
          (const float*)k_scale, (const float*)v_scale,
          (const int*)block_tables, (const int*)q_offsets,
          (const int*)q_lens, (const int*)kv_lens, (T*)out, W, H, Hkv, bs,
          page_stride, slot_stride, n_tiles, rows_per_tile, tile_keys,
          scale, c_qk, c_pv);
  return (int)cudaGetLastError();
}

#define PTT_RAGGED_ARGS                                                     \
  q, k_pool, v_pool, k_scale, v_scale, bt, q_off, q_len, kv_len, out, S, W, \
      H, Hkv, bs, page_stride, slot_stride, span_q, scale, c_qk, c_pv, st

template <typename T, typename P, bool Q8>
int dispatch_d(int D, const void* q, const void* k_pool, const void* v_pool,
               const void* k_scale, const void* v_scale, const void* bt,
               const void* q_off, const void* q_len, const void* kv_len,
               void* out, int S, int W, int H, int Hkv, int bs,
               int page_stride, int slot_stride, int span_q, float scale,
               float c_qk, float c_pv, cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, P, 32, Q8>(PTT_RAGGED_ARGS);
    case 64: return launch<T, P, 64, Q8>(PTT_RAGGED_ARGS);
    case 128: return launch<T, P, 128, Q8>(PTT_RAGGED_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and out share it; the pools too
// unless quantized, when they are int8 with float32 scales [phys, Hkv]
// and bs <= 64).  Strides are in elements.  Returns the launch's
// cudaGetLastError().
extern "C" int ptt_ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* bt,
    const void* q_off, const void* q_len, const void* kv_len, void* out,
    int S, int W, int H, int Hkv, int D, int bs, int page_stride,
    int slot_stride, int span_q, float scale, float c_qk, float c_pv,
    int dtype, int quantized, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bs < 1 || (quantized && bs > kTileKeys))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && !quantized)
    return dispatch_d<float, float, false>(D, PTT_RAGGED_ARGS);
  if (dtype == 1 && !quantized)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16, false>(D,
                                                           PTT_RAGGED_ARGS);
  if (dtype == 0 && quantized)
    return dispatch_d<float, int8_t, true>(D, PTT_RAGGED_ARGS);
  if (dtype == 1 && quantized)
    return dispatch_d<__nv_bfloat16, int8_t, true>(D, PTT_RAGGED_ARGS);
  return (int)cudaErrorInvalidValue;
}
