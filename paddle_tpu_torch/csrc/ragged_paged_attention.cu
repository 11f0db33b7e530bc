// Ragged paged attention for Hopper (sm_90a): the attention of the fused
// mixed prefill+decode serving step.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py _ragged_paged_kernel
// (launched by _ragged_paged_attention_pallas), both variants: fp32/bf16
// pools and int8 pools with per-page, per-head fp32 scales.  Any head
// dim D <= 128 that is a multiple of 8: the kernels are built at 32, 64,
// 96 and 128; at another D the wrapper pads q and the output to the width
// ptt::paged_width gives, and the kernels read the pools' rows at their
// real width dr.  Past dr the chunk tiles take zeros (a cp.async of 0
// bytes), the CUDA-core kernel masks its loads, and a decode item's lane
// reads its row's first columns instead: finite values that meet q's
// zero columns in the scores and land in output columns the wrapper
// drops.  int8 pools on the tensor cores need dr a multiple of 16
// (16-byte rows); the wrapper routes other widths to the CUDA-core
// kernel.  Every other shape (a head dim not a multiple of 8 or over
// 128, more than 32 query heads a kv head, int8 pools of block size over
// 64) runs ragged_paged_attention_generic_kernel, the generic kernel of
// paged_generic.cuh, through its own entry.
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
// read from device memory.  The probability codes depend only on exp(s -
// page max), so a running max over a tile of whole pages gives the Pallas
// kernel's function up to fp32 rounding (and, rarely, a code that rounds
// the other way at a .5 boundary).
//
// Two kernels.
// - ragged_tc_kernel (bf16 q: bf16 pools, and int8 pools of block size 8,
//   16, 32 or 64), the serving path.  A host-built work list (one small
//   int32 array per step, ops/paged_attention.py::ragged_work) gives one
//   block of 8 warps per (item, kv head): a chunk item is 128 query
//   vectors (rows x the kv head's groups) of a span, a decode item a whole
//   span of one row.  Chunk items run on the tensor cores (mma.sync:
//   m16n8k16 bf16 for bf16 pools; m16n8k32 s8 with exact int32 sums for
//   int8 pools), 64-key tiles gathered page by page into shared memory by
//   cp.async, two stages deep; see chunk_item.  A decode item gives the
//   span's pages to all 8 warps (paged_decode_attention.cu's design) and
//   merges their softmax states in warp order; see decode_item.  Decode
//   items need groups <= 8 and bs <= 32; other one-row spans run as chunk
//   items.
// - ragged_paged_attention_kernel (fp32 q, and bf16 q over int8 pools of
//   the block sizes the s8 tiles do not take), on the CUDA cores.  One block per (span, row
//   tile, kv head), 8 warps, up to 32 query vectors a block; keys stream
//   through shared memory 64 at a time as fp32; fp32 stays off the tensor
//   cores (TF32 keeps about three decimal digits).  The int8 tile holds
//   whole pages (floor(64 / bs) of them).  Code products summed over
//   D <= 128 (or over <= 64 keys) stay below 2^24, so its fp32 sums are
//   exact.
//
// Bound on the card: bytes for decode (each span reads kv_len x D x 2
// values per kv head and does 4 operations per value); a chunk of C rows
// does ~4 C operations per value read, above the ~295 operations per byte
// where the H100 turns compute bound only for C beyond ~150 (bf16), so the
// served mixed step (8 decodes + a 256-row chunk) is bounded by bytes.
// The tensor cores keep the chunk rows off the fp32 cores (at 67 TFLOP/s
// a 256-row chunk at kv 1024 took ~0.5 ms there); the decode split keeps
// every warp of a decode block reading keys.
//
// Where trouble is likely, and what the design does about it:
// - Garbage-row stores race on the GPU.  The Pallas kernel computes and
//   writes back rows r >= q_len inside its fixed span window, relying on
//   the TPU's sequential grid to let the next span overwrite them.  Here
//   blocks run concurrently, so only rows r < q_len are ever stored; the
//   wrapper allocates the output with zeros, so padding rows are 0.
// - No pool copy.  The Pallas wrapper moves the head axis and casts both
//   pools to fp32 on every call (a whole-pool copy per layer per step).
//   These kernels read [phys, bs, Hkv, D] in place, in their own dtype,
//   with the page and slot strides they are given.
// - Poison-page invariant.  A block reads block-table entries j <
//   min(ceil(n_keys / bs), W) only, where n_keys <= kv_len is the last
//   key its rows can see, and never reads a key at or past n_keys (such
//   slots enter shared memory as zeros; an unused page's scales as 0).
//   Spans with q_len == 0 (the engine's padding spans) get no work item
//   and read nothing.
// - Blocks that return at once.  The grid of the CUDA-core kernel is
//   (S x row tiles of the longest span, Hkv): a decode span's other tiles
//   launch only to return.  The work list launches only used tiles.
// - int8 P.V crosses pages (see chunk_item): one s8 MMA per page of a
//   32-key step, the other pages' A bytes zeroed, each folded apart.
// - Registers: two blocks an SM (at most 128 registers a thread) keep 16
//   decode warps an SM reading keys; the cost is spills in the widest
//   chunk paths (ptxas -v, bytes of spill stores: bf16 D 128 24 with one
//   query head per kv head, 232 with GQA; int8 D 128 212 and 696, D 96
//   48 and 184; D <= 64 at most 28).
// - Bank conflicts without a swizzle: every shared tile row is D values
//   plus 16 bytes, an odd number of 16-byte chunks, so the 8 rows an
//   ldmatrix reads fall in 8 distinct bank groups at every head dim
//   (D 96 has 12 or 6 chunks a row, which the XOR swizzle of
//   flash_attention_sm90.cu does not cover).
#include <math.h>

#include "common.cuh"
#include "mma.cuh"
#include "paged_generic.cuh"

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
        int Hkv, int bs, int page_stride, int slot_stride, int dr,
        int n_tiles, int rows_per_tile, int tile_keys, float scale,
        float c_qk,
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
      if (key < tile_keys && col < key_end && d < dr) {
        const int page = bt[col / bs];
        const size_t at = (size_t)page * page_stride +
                          (size_t)(col % bs) * slot_stride + (size_t)h * dr +
                          d;
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

// ===========================================================================
// bf16 q: the tensor-core kernel (bf16 or int8 pools)
// ===========================================================================
typedef __nv_bfloat16 bf16;

constexpr int kTcWarps = 8;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRows = kTcWarps * 16;  // query vectors per chunk item
constexpr int kTcKeys = 64;             // keys per k tile
constexpr int kDecodeItem = 0x8000;     // an item's code: a decode item, of
constexpr int kSplitShift = 7;          // (bits 7-14) + 1 splits, split bits 0-6
constexpr int kMaxGroups = 8;           // decode items: query heads per kv head
constexpr int kPcLd = kTcKeys + 16;     // bytes per row of the int8 p / V^T

// a lane's N consecutive values as one load where the width allows (the
// alignment is the largest power of two dividing the width)
template <typename P, int N>
struct alignas((sizeof(P) * N) & -(sizeof(P) * N)) Vec {
  P v[N];
};


// ldmatrix x4 over a row-major shared tile (row stride ld bytes; every
// row stride here is an odd number of 16-byte chunks, so the 8 rows of a
// matrix hit 8 distinct bank groups).  ld_a: the A operand of 16 rows
// from r0 and 32 bytes from c0 (matrices: rows +8, then bytes +16).
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const unsigned char* t,
                                     int ld, int r0, int c0, int lane) {
  const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldsm_x4(a, smem_u32(t + r * ld + c0 + (lane >> 4) * 16));
}
// ld_b: B operands of two n8 tiles from a tile stored [n][k]: b[0..1]
// rows r0.. (bytes c0.., c0 + 16..), b[2..3] rows r0 + 8..
__device__ __forceinline__ void ld_b(uint32_t (&b)[4], const unsigned char* t,
                                     int ld, int r0, int c0, int lane) {
  const int r = r0 + (lane & 7) + (lane >> 4) * 8;
  ldsm_x4(b, smem_u32(t + r * ld + c0 + ((lane >> 3) & 1) * 16));
}
// ld_bt: B operands of two n8 tiles from a bf16 tile stored [k][n]: k
// rows r0.., n columns from byte c0 (b[0..1]) and c0 + 16 (b[2..3])
__device__ __forceinline__ void ld_bt(uint32_t (&b)[4],
                                      const unsigned char* t, int ld, int r0,
                                      int c0, int lane) {
  const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldsm_x4_t(b, smem_u32(t + r * ld + c0 + (lane >> 4) * 16));
}

struct TcArgs {
  const bf16* q;
  const void *k_pool, *v_pool;
  const float *k_scale, *v_scale;
  const int *bt, *q_off, *q_len, *kv_len, *work;
  float* partials;  // split decode items' states [item][Hkv][groups][D + 2]
  int* counters;    // their arrivals [item][Hkv], zero between calls
  bf16* out;
  int W, H, Hkv, bs;
  int dr;       // the pools' head dim (the kernel's D, or less)
  float scale;  // softmax scale; int8 pools: float32(scale / 127^2)
  // the pools are contiguous [phys, bs, Hkv, dr] (the wrapper checks):
  // slot stride Hkv dr, page stride bs Hkv dr
  __device__ int slot_stride() const { return Hkv * dr; }
};
// The struct stays within 128 bytes: grown past them (two more pointers)
// it slowed both item kinds markedly on the card with the same code, so
// the strides are derived, the p.V fold is a constant and one field holds
// the score scale of either pool type.
// float32(1 / 127^2), the p.V fold of the plain int8 version (the float
// division is correctly rounded, as the double one rounded to float32)
constexpr float kCpv = 1.f / (127.f * 127.f);

// One decode span (q_len 1, groups <= GMAX, bs <= 32), or split `split`
// of `n_split` of it: the row at position kv_len - 1 sees every key below
// kv_len.  The design of paged_decode_attention.cu: the 8 warps share the
// block's pages (warp w takes pages w, w + 8, ... of the block's run),
// lane l holds D/32 columns of q, of every key row it reads and of the
// output; per page a warp scores each key (a warp sum per key and head;
// lane `key` keeps key's score), updates its running max once, and
// accumulates p.V reading each value row once.  The warps' (m, l, acc)
// merge through shared memory in warp order.  A split block writes that
// state to `partials` instead; the last split block of the span to
// arrive (an atomic count per span and kv head) merges the splits' states
// in split order and resets the count, so the result does not depend on
// which block arrives last.
template <typename P, int D, int GMAX, bool Q8>
__device__ __forceinline__ void decode_item(const TcArgs& a, int s, int h,
                                            int split, int n_split,
                                            float* smem) {
  constexpr int DPL = D / 32;
  const P* k_pool = (const P*)a.k_pool;
  const P* v_pool = (const P*)a.v_pool;
  const int G = a.H / a.Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q_off = a.q_off[s], kv_len = a.kv_len[s];
  const int n_pages = kv_len > 0 ? min((kv_len + a.bs - 1) / a.bs, a.W) : 0;
  const int* bt = a.bt + (size_t)s * a.W;
  // this block's run of pages: split `split` of n_split equal runs
  const int run = (n_pages + n_split - 1) / n_split;
  const int p_begin = split * run, p_end = min(n_pages, p_begin + run);

  float qv[GMAX][DPL], qs[GMAX];
#pragma unroll
  for (int j = 0; j < GMAX; ++j) {
    qs[j] = 1.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) qv[j][i] = 0.f;
    if (j >= G) continue;
    const Vec<bf16, DPL> raw = *reinterpret_cast<const Vec<bf16, DPL>*>(
        a.q + ((size_t)q_off * a.H + h * G + j) * D + lane * DPL);
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      qv[j][i] = ptt::to_f32(raw.v[i]);
      amax = fmaxf(amax, fabsf(qv[j][i]));
    }
    if constexpr (Q8) {
      qs[j] = fmaxf(ptt::warp_max(amax), 1e-30f);
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        qv[j][i] = ptt::quant_code(qv[j][i], qs[j]);
    } else {
#pragma unroll
      for (int i = 0; i < DPL; ++i) qv[j][i] = __fmul_rn(qv[j][i], a.scale);
    }
  }

  float m[GMAX], l[GMAX], acc[GMAX][DPL];
#pragma unroll
  for (int j = 0; j < GMAX; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[j][i] = 0.f;
  }

  // the lane's columns of a pool row, whose real width is dr: a lane whose
  // columns lie past dr (ptt::paged_width never splits a lane's columns)
  // reads the row's first ones instead, finite values that meet q's zero
  // columns in the scores and land in output columns the wrapper drops
  const int at = lane * DPL < a.dr ? lane * DPL : 0;
  for (int p = p_begin + warp; p < p_end; p += kTcWarps) {
    const int page = bt[p];
    const int nk = min(a.bs, kv_len - p * a.bs);  // >= 1 keys of this page
    const size_t row0 =
        (size_t)page * a.bs * a.slot_stride() + (size_t)h * a.dr;
    float sk = 1.f, sv = 1.f;
    if constexpr (Q8) {
      sk = a.k_scale[(size_t)page * a.Hkv + h];
      sv = a.v_scale[(size_t)page * a.Hkv + h];
    }
    float my_s[GMAX];
#pragma unroll
    for (int j = 0; j < GMAX; ++j) my_s[j] = -INFINITY;
#pragma unroll 4
    for (int key = 0; key < nk; ++key) {
      const Vec<P, DPL> kr = *reinterpret_cast<const Vec<P, DPL>*>(
          k_pool + row0 + (size_t)key * a.slot_stride() + at);
#pragma unroll
      for (int j = 0; j < GMAX; ++j) {
        if (j >= G) continue;
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) d += qv[j][i] * ptt::to_f32(kr.v[i]);
        d = ptt::warp_sum(d);
        if (Q8) d = d * (qs[j] * (sk * a.scale));
        if (lane == key) my_s[j] = d;
      }
    }
    const bool ok = lane < nk;
    float pj[GMAX], fold[GMAX];
#pragma unroll
    for (int j = 0; j < GMAX; ++j) {
      pj[j] = 0.f;
      fold[j] = 1.f;
      if (j >= G) continue;
      const float m_new = fmaxf(m[j], ptt::warp_max(my_s[j]));
      const float p_ = ok ? expf(my_s[j] - m_new) : 0.f;
      const float alpha = expf(m[j] - m_new);
      l[j] = l[j] * alpha + ptt::warp_sum(p_);
      m[j] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[j][i] *= alpha;
      pj[j] = p_;
      if constexpr (Q8) {
        const float ps = fmaxf(ptt::warp_max(p_), 1e-30f);
        pj[j] = ptt::quant_code(p_, ps);
        fold[j] = ps * (sv * kCpv);
      }
    }
    float pv[GMAX][DPL];
#pragma unroll
    for (int j = 0; j < GMAX; ++j)
#pragma unroll
      for (int i = 0; i < DPL; ++i) pv[j][i] = 0.f;
#pragma unroll 4
    for (int key = 0; key < nk; ++key) {
      const Vec<P, DPL> vr = *reinterpret_cast<const Vec<P, DPL>*>(
          v_pool + row0 + (size_t)key * a.slot_stride() + at);
#pragma unroll
      for (int j = 0; j < GMAX; ++j) {
        if (j >= G) continue;
        const float pk = __shfl_sync(0xffffffffu, pj[j], key);
#pragma unroll
        for (int i = 0; i < DPL; ++i) pv[j][i] += pk * ptt::to_f32(vr.v[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < GMAX; ++j)
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[j][i] += pv[j][i] * fold[j];
  }

  // merge the warps' partial states, in warp order
  float* m_s = smem;                        // [kTcWarps][GMAX]
  float* l_s = m_s + kTcWarps * GMAX;       // [kTcWarps][GMAX]
  float* acc_s = l_s + kTcWarps * GMAX;     // [kTcWarps][GMAX][D]
#pragma unroll
  for (int j = 0; j < GMAX; ++j) {
    if (lane == 0) {
      m_s[warp * GMAX + j] = m[j];
      l_s[warp * GMAX + j] = l[j];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      acc_s[(warp * GMAX + j) * D + lane * DPL + i] = acc[j][i];
  }
  __syncthreads();
  // a split's state: [Hkv][groups][M, L, acc[D]] of its item
  const size_t item0 = blockIdx.x - split;  // the span's first split item
  float* part = a.partials + ((size_t)blockIdx.x * a.Hkv + h) * G * (D + 2);
  for (int idx = threadIdx.x; idx < G * D; idx += kTcThreads) {
    const int j = idx / D, d = idx % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) M = fmaxf(M, m_s[w * GMAX + j]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kTcWarps; ++w) {
        const float e = expf(m_s[w * GMAX + j] - M);  // 0: a warp, no page
        L += l_s[w * GMAX + j] * e;
        A += acc_s[(w * GMAX + j) * D + d] * e;
      }
    }
    if (n_split == 1) {
      a.out[((size_t)q_off * a.H + h * G + j) * D + d] =
          __float2bfloat16_rn(A / fmaxf(L, 1e-30f));
    } else {
      float* pj = part + (size_t)j * (D + 2);
      if (d == 0) pj[0] = M, pj[1] = L;
      pj[2 + d] = A;
    }
  }
  if (n_split == 1) return;
  // the last split to arrive merges the splits' states in split order
  __shared__ int last;
  __threadfence();
  __syncthreads();
  int* count = a.counters + item0 * a.Hkv + h;
  if (threadIdx.x == 0) last = atomicAdd(count, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int idx = threadIdx.x; idx < G * D; idx += kTcThreads) {
    const int j = idx / D, d = idx % D;
    float M = -INFINITY;
    for (int i = 0; i < n_split; ++i)
      M = fmaxf(M, __ldcg(a.partials +
                          (((item0 + i) * a.Hkv + h) * G + j) * (D + 2)));
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
      for (int i = 0; i < n_split; ++i) {
        const float* pj =
            a.partials + (((item0 + i) * a.Hkv + h) * G + j) * (D + 2);
        const float e = expf(__ldcg(pj) - M);  // 0: a split with no page
        L += __ldcg(pj + 1) * e;
        A += __ldcg(pj + 2 + d) * e;
      }
    }
    a.out[((size_t)q_off * a.H + h * G + j) * D + d] =
        __float2bfloat16_rn(A / fmaxf(L, 1e-30f));
  }
  if (threadIdx.x == 0) *count = 0;  // zero for the next call
}

// One chunk item: query vectors [i0, i0 + kTcRows) of span s (vector i =
// row i / G, query head h G + i % G), 16 a warp, against 64-key tiles
// gathered page by page into shared memory by cp.async (two stages: the
// next tile is in flight while this one is multiplied).  S = Q K^T and
// P.V on mma.sync, online softmax in registers (the accumulator layout of
// m16n8 is the A layout of the next product).
// - bf16 pools: m16n8k16 bf16, fp32 accumulate; q enters unscaled and
//   exact, the scale multiplies the fp32 scores; p is rounded to bf16 as
//   the A operand of P.V.
// - int8 pools: q quantized per vector (codes and absmax), S on
//   m16n8k32 s8 with exact int32 sums, folded per column with the page's
//   k scale.  p per (vector, page) is quantized against its page max
//   (codes in shared memory, read back by ldmatrix); V^T int8 codes are
//   written transposed into shared memory (the s8 B operand needs keys
//   contiguous).  P.V reduces over keys across pages whose fold differs
//   (p scale x v scale): each page of a k32 step gets its own MMA into a
//   fresh int32 accumulator with the A bytes of the other pages zeroed
//   (a 4-key group of A never straddles pages: bs >= 8), and is folded
//   into the fp32 accumulator on its own.  That costs one MMA per page of
//   the step (two at block size 16) instead of an accumulator per page
//   in registers, which D/8 n-tiles x pages would not fit.
template <typename P, int D, bool Q8>
__device__ __forceinline__ void chunk_item(const TcArgs& a, int s, int tile,
                                           int h, unsigned char* smem) {
  constexpr int LDR = D * (int)sizeof(P) + 16;  // bytes per Q / K / V row
  constexpr int CH = D * (int)sizeof(P) / 16;   // 16-byte chunks per row
  constexpr int NJ = kTcKeys / 8, ND = D / 8;
  const P* k_pool = (const P*)a.k_pool;
  const P* v_pool = (const P*)a.v_pool;
  const int G = a.H / a.Hkv, bs = a.bs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, m0 = warp * 16;
  const int q_off = a.q_off[s], q_len = a.q_len[s], kv_len = a.kv_len[s];
  const int i0 = tile * kTcRows;
  const int nq = min(kTcRows, q_len * G - i0);
  // the last key any vector of the item sees, and the pages it spans
  const int n_keys = kv_len - q_len + (i0 + nq - 1) / G + 1;
  const int n_pages = min((n_keys + bs - 1) / bs, a.W);
  const int key_end = min(n_keys, n_pages * bs);
  const int n_kt = (key_end + kTcKeys - 1) / kTcKeys;
  const int* bt = a.bt + (size_t)s * a.W;

  unsigned char* Qs = smem;                     // [kTcRows][LDR]
  unsigned char* Ks = Qs + kTcRows * LDR;       // [2][kTcKeys][LDR]
  unsigned char* Vs = Ks + 2 * kTcKeys * LDR;   // bf16: [2][kTcKeys][LDR]
  // int8 (after Ks): V^T [D][kPcLd], p codes [warps][16][kPcLd], q scales
  // [kTcRows], p scales [warps][16][8], page scales [2][8]
  unsigned char* Vt = Vs;
  unsigned char* Pc = Vt + D * kPcLd;
  float* Qsc = reinterpret_cast<float*>(Pc + kTcWarps * 16 * kPcLd);
  float* Psc = Qsc + kTcRows;
  float* Ksc = Psc + kTcWarps * 16 * 8;
  float* Vsc = Ksc + 8;

  // the vectors' positions: rows g and g + 8 of this warp (-1: no vector)
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = m0 + g + 8 * i;
    qpos[i] = v < nq ? kv_len - q_len + (i0 + v) / G : -1;
  }

  auto kv_tile = [&](int stage, int kt) {
    for (int idx = tid; idx < kTcKeys * CH; idx += kTcThreads) {
      const int key = idx / CH, ch = idx % CH, col = kt * kTcKeys + key;
      const bool ok = col < key_end && ch * (16 / (int)sizeof(P)) < a.dr;
      const size_t at = ok ? (size_t)bt[col / bs] * bs * a.slot_stride() +
                                 (size_t)(col % bs) * a.slot_stride() +
                                 (size_t)h * a.dr + ch * (16 / sizeof(P))
                           : 0;
      cp_async16(Ks + (stage * kTcKeys + key) * LDR + ch * 16, k_pool + at,
                 ok);
      if constexpr (!Q8)
        cp_async16(Vs + (stage * kTcKeys + key) * LDR + ch * 16,
                   v_pool + at, ok);
    }
  };

  if constexpr (Q8) {
    // each warp quantizes its own 16 vectors per row (codes and absmax)
    for (int r = 0; r < 16; ++r) {
      const int v = m0 + r;
      float x[D / 32], amax = 0.f;
#pragma unroll
      for (int e = 0; e < D / 32; ++e) {
        x[e] = 0.f;
        if (v < nq) {
          const int row = (i0 + v) / G, head = h * G + (i0 + v) % G;
          x[e] = ptt::to_f32(
              a.q[((size_t)(q_off + row) * a.H + head) * D + lane + 32 * e]);
        }
        amax = fmaxf(amax, fabsf(x[e]));
      }
      const float qs = fmaxf(ptt::warp_max(amax), 1e-30f);
#pragma unroll
      for (int e = 0; e < D / 32; ++e)
        Qs[v * LDR + lane + 32 * e] =
            (unsigned char)(int8_t)ptt::quant_code(x[e], qs);
      if (lane == 0) Qsc[v] = qs;
    }
  } else {
    for (int idx = tid; idx < kTcRows * CH; idx += kTcThreads) {
      const int v = idx / CH, ch = idx % CH;
      const bool ok = v < nq;
      const int row = (i0 + v) / G, head = h * G + (i0 + v) % G;
      cp_async16(Qs + v * LDR + ch * 16,
                 a.q + (ok ? ((size_t)(q_off + row) * a.H + head) * D +
                                 ch * 8
                           : 0),
                 ok);
    }
  }
  if (n_kt > 0) kv_tile(0, 0);
  cp_async_commit();

  float o[ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1, k0 = kt * kTcKeys;
    if (kt + 1 < n_kt) kv_tile(st ^ 1, kt + 1);
    cp_async_commit();
    if constexpr (Q8) {
      // V^T codes of this tile, and its pages' scales (never a page past
      // n_pages: its scales may be NaN).  A warp takes 32 keys of one
      // 16-byte column chunk, so each byte store of the transpose writes
      // 32 neighbouring bytes of one V^T row (no bank conflict)
      for (int idx = tid; idx < kTcKeys * CH; idx += kTcThreads) {
        const int key = idx % kTcKeys, ch = idx / kTcKeys, col = k0 + key;
        uint4 raw = make_uint4(0, 0, 0, 0);
        if (col < key_end && ch * 16 < a.dr)
          raw = *reinterpret_cast<const uint4*>(
              v_pool + (size_t)bt[col / bs] * bs * a.slot_stride() +
              (size_t)(col % bs) * a.slot_stride() + (size_t)h * a.dr +
              ch * 16);
        const unsigned char* b8 = reinterpret_cast<const unsigned char*>(&raw);
#pragma unroll
        for (int e = 0; e < 16; ++e) Vt[(ch * 16 + e) * kPcLd + key] = b8[e];
      }
      if (tid < kTcKeys / bs) {
        const int pg = k0 / bs + tid;
        const bool used = pg < n_pages;
        const size_t at = (size_t)(used ? bt[pg] : 0) * a.Hkv + h;
        Ksc[tid] = used ? a.k_scale[at] : 0.f;
        Vsc[tid] = used ? a.v_scale[at] : 0.f;
      }
    }
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* Kt = Ks + st * kTcKeys * LDR;

    // S = Q K^T for this warp's 16 vectors x 64 keys
    float sc[NJ][4];
    if constexpr (Q8) {
      int si[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) si[j][e] = 0;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        uint32_t af[4];
        ld_a(af, Qs, LDR, m0, kk * 32, lane);
#pragma unroll
        for (int jj = 0; jj < NJ / 2; ++jj) {
          uint32_t bf[4];
          ld_b(bf, Kt, LDR, jj * 16, kk * 32, lane);
          mma_s8(si[2 * jj], af, bf[0], bf[1]);
          mma_s8(si[2 * jj + 1], af, bf[2], bf[3]);
        }
      }
      const float qsr[2] = {Qsc[m0 + g], Qsc[m0 + g + 8]};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)  // fold the exact integer score
          sc[j][e] = (float)si[j][e] *
                     (qsr[e >> 1] * (Ksc[(8 * j + 2 * t) / bs] * a.scale));
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t af[4];
        ld_a(af, Qs, LDR, m0, kk * 32, lane);
#pragma unroll
        for (int jj = 0; jj < NJ / 2; ++jj) {
          uint32_t bf[4];
          ld_b(bf, Kt, LDR, jj * 16, kk * 32, lane);
          mma(sc[2 * jj], af, bf[0], bf[1]);
          mma(sc[2 * jj + 1], af, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= a.scale;
    }

    // mask, then the online softmax (natural exp, as the plain version)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          if (!(col < key_end && col <= qpos[i])) sc[j][e] = -INFINITY;
          mx = fmaxf(mx, sc[j][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          sc[j][e] = expf(sc[j][e] - m_use);  // masked: exp(-inf) = 0
          ps += sc[j][e];
        }
      l[i] = l[i] * alpha + ps;  // this thread's columns; summed at the end
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }

    if constexpr (Q8) {
      // p codes per (vector, page): the page max over the 4 lanes of the
      // row and the page's n8 tiles (bs is a multiple of 8 dividing 64)
      float tm[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float x = fmaxf(sc[j][2 * i], sc[j][2 * i + 1]);
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
          tm[j][i] = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        }
      unsigned char* Pw = Pc + warp * 16 * kPcLd;
      float* Pscw = Psc + warp * 16 * 8;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float pm = 0.f;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
            if ((8 * jj) / bs == (8 * j) / bs) pm = fmaxf(pm, tm[jj][i]);
          const float psc = fmaxf(pm, 1e-30f);
          const int r = g + 8 * i, c = 8 * j + 2 * t;
          const int c0 = (int)ptt::quant_code(sc[j][2 * i], psc);
          const int c1 = (int)ptt::quant_code(sc[j][2 * i + 1], psc);
          *reinterpret_cast<uint16_t*>(Pw + r * kPcLd + c) =
              (uint16_t)((c0 & 0xff) | ((c1 & 0xff) << 8));
          if (t == 0 && (8 * j) % bs == 0) Pscw[r * 8 + (8 * j) / bs] = psc;
        }
      __syncwarp();
      // P.V per page: A = the p codes of one 32-key step with the other
      // pages' bytes zeroed, B = V^T codes; each page folded on its own
#pragma unroll
      for (int kst = 0; kst < kTcKeys / 32; ++kst) {
        uint32_t af[4];
        ld_a(af, Pw, kPcLd, 0, kst * 32, lane);
        for (int pg = kst * 32 / bs; pg <= (kst * 32 + 31) / bs; ++pg) {
          uint32_t am[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            am[r] = (kst * 32 + (r >> 1) * 16 + 4 * t) / bs == pg ? af[r] : 0u;
          const float f0 = Pscw[g * 8 + pg] * (Vsc[pg] * kCpv);
          const float f1 = Pscw[(g + 8) * 8 + pg] * (Vsc[pg] * kCpv);
#pragma unroll
          for (int nn = 0; nn < D / 16; ++nn) {
            uint32_t bf[4];
            ld_b(bf, Vt, kPcLd, nn * 16, kst * 32, lane);
            int c0[4] = {0, 0, 0, 0}, c1[4] = {0, 0, 0, 0};
            mma_s8(c0, am, bf[0], bf[1]);
            mma_s8(c1, am, bf[2], bf[3]);
            o[2 * nn][0] += (float)c0[0] * f0;
            o[2 * nn][1] += (float)c0[1] * f0;
            o[2 * nn][2] += (float)c0[2] * f1;
            o[2 * nn][3] += (float)c0[3] * f1;
            o[2 * nn + 1][0] += (float)c1[0] * f0;
            o[2 * nn + 1][1] += (float)c1[1] * f0;
            o[2 * nn + 1][2] += (float)c1[2] * f1;
            o[2 * nn + 1][3] += (float)c1[3] * f1;
          }
        }
      }
    } else {
      // O += P V: p rounded to bf16 is the A operand from registers, V
      // [keys][D] the transposed B operand
      const unsigned char* Vtile = Vs + st * kTcKeys * LDR;
#pragma unroll
      for (int kk = 0; kk < kTcKeys / 16; ++kk) {
        const uint32_t af[4] = {
            pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
            pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
            pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
            pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int nn = 0; nn < D / 16; ++nn) {
          uint32_t bf[4];
          ld_bt(bf, Vtile, LDR, kk * 16, nn * 32, lane);
          mma(o[2 * nn], af, bf[0], bf[1]);
          mma(o[2 * nn + 1], af, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // stage st (and V^T, p codes) consumed before reuse
  }
  cp_async_wait<0>();

  // store only the item's own vectors; padding rows stay as allocated (0)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float inv = 1.f / fmaxf(li, 1e-30f);
    const int v = m0 + g + 8 * i;
    if (v >= nq) continue;
    const int row = (i0 + v) / G, head = h * G + (i0 + v) % G;
    bf16* dst = a.out + ((size_t)(q_off + row) * a.H + head) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
}

// One block per (work item, kv head): the host's work list (built with the
// step's spans, see ops/paged_attention.py::ragged_work) holds, chunk
// tiles first, one item per kTcRows query vectors of each chunk span and
// one per decode span, so no block is launched to return at once.
// two blocks an SM (at most 128 registers a thread): the decode items are
// bound by loads in flight, so warps per SM count more than the chunk
// path's few spilled registers
template <typename P, int D, int GMAX, bool Q8>
__global__ void __launch_bounds__(kTcThreads, 2)
    ragged_tc_kernel(TcArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int item = a.work[blockIdx.x];
  const int s = item >> 16, tile = item & 0xFFFF, h = blockIdx.y;
  const int q_len = a.q_len[s];
  if (tile & kDecodeItem) {
    if (q_len == 1)
      decode_item<P, D, GMAX, Q8>(a, s, h, tile & ((1 << kSplitShift) - 1),
                                  ((tile & ~kDecodeItem) >> kSplitShift) + 1,
                                  reinterpret_cast<float*>(smem_raw));
    return;
  }
  if (q_len <= 0 || tile * kTcRows >= q_len * (a.H / a.Hkv)) return;
  chunk_item<P, D, Q8>(a, s, tile, h, smem_raw);
}

template <typename P, int D, bool Q8>
constexpr size_t tc_smem() {
  constexpr size_t LDR = D * sizeof(P) + 16;
  constexpr size_t qk = (size_t)(kTcRows + 2 * kTcKeys) * LDR;
  constexpr size_t chunk =
      Q8 ? qk + (size_t)(D + kTcWarps * 16) * kPcLd +
               (kTcRows + kTcWarps * 16 * 8 + 16) * sizeof(float)
         : qk + 2 * kTcKeys * LDR;
  constexpr size_t decode =
      (size_t)kTcWarps * kMaxGroups * (D + 2) * sizeof(float);
  return chunk > decode ? chunk : decode;
}

template <typename P, int D, int GMAX, bool Q8>
int launch_tc(const TcArgs& a, int n_items, cudaStream_t st) {
  auto kern = ragged_tc_kernel<P, D, GMAX, Q8>;
  constexpr size_t smem = tc_smem<P, D, Q8>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(n_items, a.Hkv), kTcThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename P, bool Q8>
int dispatch_tc(int D, const TcArgs& a, int n_items, cudaStream_t st) {
  const bool g1 = a.H == a.Hkv;  // one query head per kv head: lean decode
  switch (D) {
#define PTT_TC_CASE(DD)                                                   \
  case DD:                                                                \
    return g1 ? launch_tc<P, DD, 1, Q8>(a, n_items, st)                   \
              : launch_tc<P, DD, kMaxGroups, Q8>(a, n_items, st);
    PTT_TC_CASE(32)
    PTT_TC_CASE(64)
    PTT_TC_CASE(96)
    PTT_TC_CASE(128)
#undef PTT_TC_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename P, int D, bool Q8>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale,
           const void* block_tables, const void* q_offsets,
           const void* q_lens, const void* kv_lens, void* out, int S, int W,
           int H, int Hkv, int bs, int page_stride, int slot_stride,
           int dr, int span_q, float scale, float c_qk, float c_pv,
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
          page_stride, slot_stride, dr, n_tiles, rows_per_tile, tile_keys,
          scale, c_qk, c_pv);
  return (int)cudaGetLastError();
}

#define PTT_RAGGED_ARGS                                                     \
  q, k_pool, v_pool, k_scale, v_scale, bt, q_off, q_len, kv_len, out, S, W, \
      H, Hkv, bs, page_stride, slot_stride, dr, span_q, scale, c_qk, c_pv, \
      st

template <typename T, typename P, bool Q8>
int dispatch_d(int D, const void* q, const void* k_pool, const void* v_pool,
               const void* k_scale, const void* v_scale, const void* bt,
               const void* q_off, const void* q_len, const void* kv_len,
               void* out, int S, int W, int H, int Hkv, int bs,
               int page_stride, int slot_stride, int dr, int span_q,
               float scale, float c_qk, float c_pv, cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, P, 32, Q8>(PTT_RAGGED_ARGS);
    case 64: return launch<T, P, 64, Q8>(PTT_RAGGED_ARGS);
    case 96: return launch<T, P, 96, Q8>(PTT_RAGGED_ARGS);
    case 128: return launch<T, P, 128, Q8>(PTT_RAGGED_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}


// The generic kernel (paged_generic.cuh) over the packed batch: one warp
// per query vector (token, query head); a token that lies in no span
// returns, its row left as the wrapper allocated it (0).
template <typename T, typename P, bool Q8>
__global__ void __launch_bounds__(ptt::kGenWarps * 32)
    ragged_paged_attention_generic_kernel(const ptt::GenericArgs a) {
  extern __shared__ float gen_smem[];
  const int warp = threadIdx.x >> 5;
  const long long v = (long long)blockIdx.x * ptt::kGenWarps + warp;
  if (v >= (long long)a.T * a.H) return;
  const int t = (int)(v / a.H), hq = (int)(v % a.H);
  for (int s = 0; s < a.S; ++s) {
    const int ql = a.q_len[s], qo = a.q_off[s];
    if (ql > 0 && t >= qo && t < qo + ql) {
      ptt::generic_attend<T, P, Q8>(a, gen_smem + warp * (2 * a.D + a.bs),
                                    t, hq, s, qo, ql, a.kv_len[s]);
      return;
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and out share it; the pools too
// unless quantized, when they are int8 with float32 scales [phys, Hkv]
// and bs <= 64).  dr: the pools' head dim, a multiple of 8 up to 128; q
// and out are [T, H, D] at D = ptt::paged_width(dr) (the wrapper pads
// them; q's columns past dr are 0).  Strides are in elements.  With
// a work list (bf16 only: n_items int32 items from
// ops/paged_attention.py::ragged_work, chunk tiles of kTcRows query
// vectors and decode spans) the tensor-core kernel runs (bf16 q needs one
// over bf16 pools), else the CUDA-core kernel (fp32 q; bf16 q over int8
// pools whose block size is not a multiple of 8 dividing 64, or whose dr
// is not a multiple of 16).  partials (n_items * H * (D + 2) float32) and
// counters (n_items * Hkv int32, zero; left zero) serve the split decode
// items.  Returns the launch's cudaGetLastError().
extern "C" int ptt_ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* bt,
    const void* q_off, const void* q_len, const void* kv_len,
    const void* work, void* partials, void* counters, void* out, int S,
    int W, int H, int Hkv, int dr,
    int bs, int page_stride, int slot_stride, int span_q, int n_items,
    float scale, float c_qk, float c_pv, int dtype, int quantized,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bs < 1 || (quantized && bs > kTileKeys) || Hkv < 1 || H % Hkv ||
      ptt::paged_width(dr) == 0)
    return (int)cudaErrorInvalidValue;
  const int D = ptt::paged_width(dr);
  if (work != nullptr) {
    if (dtype != 1 || n_items < 1 ||
        (quantized && (bs % 8 || kTcKeys % bs || dr % 16)))
      return (int)cudaErrorInvalidValue;
    TcArgs a = {(const bf16*)q, k_pool, v_pool, (const float*)k_scale,
                (const float*)v_scale, (const int*)bt, (const int*)q_off,
                (const int*)q_len, (const int*)kv_len, (const int*)work,
                (float*)partials, (int*)counters, (bf16*)out, W, H, Hkv,
                bs, dr, quantized ? c_qk : scale};
    return quantized ? dispatch_tc<int8_t, true>(D, a, n_items, st)
                     : dispatch_tc<bf16, false>(D, a, n_items, st);
  }
  if (dtype == 0 && !quantized)
    return dispatch_d<float, float, false>(D, PTT_RAGGED_ARGS);
  if (dtype == 0 && quantized)
    return dispatch_d<float, int8_t, true>(D, PTT_RAGGED_ARGS);
  if (dtype == 1 && quantized)
    return dispatch_d<__nv_bfloat16, int8_t, true>(D, PTT_RAGGED_ARGS);
  return (int)cudaErrorInvalidValue;
}

// The generic kernel (paged_generic.cuh) for the shapes the kernels above
// do not take: any head dim D >= 1, block size, and group count (H a
// multiple of Hkv); dtype as above (q, out and fp pools share it; int8
// pools with float32 scales [phys, Hkv]).  q and out are [T, H, D] at the
// pools' own D (no padding).  Strides in elements.  Returns the launch's
// cudaGetLastError().
extern "C" int ptt_ragged_paged_attention_generic(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* bt,
    const void* q_off, const void* q_len, const void* kv_len, void* out,
    int T, int S, int W, int H, int Hkv, int D, int bs, int page_stride,
    int slot_stride, float scale, float c_qk, float c_pv, int dtype,
    int quantized, void* stream) {
  if (T < 1 || S < 1 || W < 1 || Hkv < 1 || H % Hkv || D < 1 || bs < 1 ||
      (dtype != 0 && dtype != 1) ||
      (quantized && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const ptt::GenericArgs a = {
      q, k_pool, v_pool, (const float*)k_scale, (const float*)v_scale,
      (const int*)bt, (const int*)q_off, (const int*)q_len,
      (const int*)kv_len, out, T, S, W, H, Hkv, D, bs, page_stride,
      slot_stride, scale, c_qk, c_pv};
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)T * H;
  if (quantized)
    return dtype == 1
               ? ptt::launch_generic(
                     ragged_paged_attention_generic_kernel<__nv_bfloat16,
                                                           int8_t, true>,
                     a, n, st)
               : ptt::launch_generic(
                     ragged_paged_attention_generic_kernel<float, int8_t,
                                                           true>,
                     a, n, st);
  return dtype == 1
             ? ptt::launch_generic(
                   ragged_paged_attention_generic_kernel<
                       __nv_bfloat16, __nv_bfloat16, false>,
                   a, n, st)
             : ptt::launch_generic(
                   ragged_paged_attention_generic_kernel<float, float, false>,
                   a, n, st);
}
