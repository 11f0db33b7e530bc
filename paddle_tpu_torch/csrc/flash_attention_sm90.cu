// Flash attention with fused neox rope on Hopper's tensor cores (sm_90a),
// bf16 at head dims 64 and 128: the forward and both backward forms of
// the training path.
//
// Replaces (paddle_tpu/ops/pallas_kernels.py), bf16 variants:
// - _flash_fwd_kernel (launched by _flash_attention_value): fwd_tc_kernel
// - _flash_bwd_kv_kernel with emit_dq (launched by
//   _flash_attention_bwd_fused): bwd_kv_tc_kernel<EMIT_DQ=true> +
//   dq_finalize_kernel
// - _flash_bwd_dq_kernel + _flash_bwd_kv_kernel without emit_dq (launched
//   by _flash_attention_bwd): bwd_dq_tc_kernel + bwd_kv_tc_kernel<false>
// Built at head dims 64 and 128; the wrapper pads every other multiple
// of 8 up to 128 to the next of them, each half of the head on its own.
// The fp32 variants run on the CUDA cores in flash_attention.cu.
//
// What they compute: what flash_attention.cu's kernels compute, at the
// same rounding points.  q/out/dout [B, Sq, H, D], k/v [B, Sk, H, D] bf16,
// lse [B, H, Sq] fp32 (natural log, -inf for a row that sees nothing);
// query row i sees key j iff j <= i + Sk - Sq when causal.  Scores live in
// exp2 space with c = scale * log2(e) on exactly one operand: the forward
// and the dq kernel use round(rope(q) c) . round(rope(k)), the dk/dv
// kernel (and the one-pass dq share, ds . Ks / log2(e)) round(rope(q)) .
// round(rope(k) c).  p is rounded to bf16 before p.V and p^T.dO, ds
// before ds.K and ds^T.Q; dq and dk leave through the inverse rotation.
// Accumulation is fp32.
//
// Bound on the card: operations.  At the training shapes (S 2048 and
// 16384, D 128) a 64-row tile does 2 x 64 x D operations per key element
// it reads, far above the ~295 operations per byte where the H100 turns
// compute bound; the least time is the function's operations at the bf16
// tensor-core rate, 989 TFLOP/s.
//
// Design.  Every product runs on the tensor cores, bf16 in, fp32
// accumulate.  The forward uses wgmma, Hopper's warpgroup product: S =
// Q K^T with both operands read from shared memory through 128-byte-
// swizzled descriptors, O += P V with p from registers and V as the
// transposed (MN-major) operand.  The backward kernels use
// mma.sync.m16n8k16 fed by ldmatrix, each warp owning 16 rows (onto
// wgmma is their next step).
// - Tiles are bf16 in shared memory: for wgmma in the descriptors'
//   128-byte swizzle (64-column halves of 128-byte rows, 16-byte chunks
//   XOR row % 8), for ldmatrix rows of D elements with the same XOR, so
//   that neither sees bank conflicts.  Streamed tiles go through a
//   two-stage ring filled by cp.async (zero-fill past the sequence end):
//   the next tile is in flight while the current one is multiplied.
// - The score accumulator has the layout of the A operand of the next
//   product (m16n8k16's, and per warp wgmma's), so p (and ds) go from
//   registers, rounded to bf16, straight into it (FlashAttention-2's
//   register reuse); nothing of the [S, S] scores reaches device memory.
// - Rope: a pre-pass writes round(rope(k)) (and, for the backward,
//   round(rope(q))) once per call as bf16 scratch, so no streamed tile is
//   roped again per block; each block ropes and scales its resident tile
//   once.  A pre-pass writes delta = rowsum(dO * O) and lse * log2(e)
//   [B, H, Sq] fp32, so neither backward kernel reads O.
// - The inverse rope runs in registers: column d and d +- D/2 sit in the
//   same thread's accumulator fragments.  Outputs go through the warp's
//   own rows of shared memory to 16-byte stores.
// - Forward: one block of two warpgroups per (128-row q tile, b*h), each
//   warpgroup 64 rows, two blocks per SM; 64-key tiles, online exp2
//   softmax with an unnormalised accumulator and one division by l at
//   the store.
// - dq kernel: one block of 4 warps per (64-row q tile, b*h), k and v
//   tiles streamed.  dk/dv kernel, in the transposed form: one block of 8
//   warps per (128-key tile, b*h), keys as the M rows, q, dO, lse and
//   delta tiles streamed 64 rows at a time, S^T = K~ Q^T and dP^T = V
//   dO^T in 32-column halves; both are deterministic (no atomics); memory
//   stays O(S D + S).
// - The one-pass form (EMIT_DQ) adds, per half tile, the dq share of the
//   block's 128 keys, dS Ks / log2(e): ds^T goes through shared memory
//   (its rounding point) and comes back by ldmatrix.trans as the A
//   operand with q rows as M; each warp multiplies a 16 x D/4 piece and
//   adds it to the fp32 workspace at once (dq_share: D/8 floats a thread
//   live, so the share never sits in registers beside dk and dv for
//   long).  The shares are added in k-tile order: a counter per (b*h,
//   half tile) passes the turn (common.cuh's wait_turn / pass_turn), and
//   blocks take their (b*h, k tile) from a ticket drawn as they start,
//   b*h fastest, so a block waits only for lower tickets, which have
//   started and are resident or done (no deadlock, whatever the card's
//   dispatch order).  The reference sums per-k-block partials in order;
//   this sums per-k-tile shares in order, so dq is bitwise deterministic
//   with one [B, Sq, H, D] fp32 workspace (67 MB at the 7B shape) where
//   per-tile partials would take 16 of them.  128 keys a block (not 64)
//   halve the workspace's read-modify-write traffic and the chain's
//   length; the wait comes before the share's product, so the workspace
//   reads are in flight during it.  dq_finalize_kernel applies the
//   inverse rope and the cast.
// - Grids are (b*h, tile) with the heaviest causal tiles at tile 0: the
//   card starts blocks x first, so every head's heaviest tiles start in
//   the first waves and the last wave holds the lightest.
// - Only tiles that hold a masked element (the causal diagonal, ragged
//   tails) evaluate the mask; tiles no row sees are skipped.
//
// Registers (ptxas -v, sm_90a): the D-128 dk/dv kernel uses all 255
// registers of its 256-thread block (one block an SM) with small spills:
// 28-36 bytes of spill stores in the two-kernel form, 48-60 in the
// one-pass form; the D-128 forward 32-36 (128 registers, two blocks an
// SM); the D-64 kernels and the dq kernels (240 registers) do not spill
// (D-64 dq with rope: 4 bytes).
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBN = 64;          // keys per streamed k tile, rows per q tile
constexpr int kFwdWG = 2;        // forward: 2 warpgroups x 64 = 128 q rows
constexpr int kBwdWarps = 4;     // dq kernel: 4 x 16 = 64 q rows a block
constexpr int kKvWarps = 8;      // dk/dv kernel: 8 x 16 = 128 keys a block
constexpr int kSub = 32;         // q columns per half of the dk/dv tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kInvLog2e = 0.6931471805599453f;  // 1 / log2(e)

// ---------------------------------------------------------------------------
// shared-memory tiles: [rows][D] bf16, 16-byte chunks swizzled by row % 8
// ---------------------------------------------------------------------------
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((((c >> 3) ^ (r & 7)) << 3) | (c & 7));
}

// The two tile layouts, as the element offset of (row r, column c):
// - RowSwz (the mma.sync tiles): rows of D elements, swz above.
// - Sw128 (the wgmma tiles): D/64 column halves of [ROWS][64], each in the
//   128-byte swizzle of wgmma's descriptors (16-byte chunk XOR row % 8
//   inside 8-row, 1024-byte atoms); the tile base is 1024-byte aligned.
template <int D>
struct RowSwz {
  static __device__ __forceinline__ int at(int r, int c) {
    return swz<D>(r, c);
  }
};
template <int ROWS>
struct Sw128 {
  static __device__ __forceinline__ int at(int r, int c) {
    return (c >> 6) * ROWS * 64 + r * 64 +
           (((((c & 63) >> 3) ^ (r & 7)) << 3) | (c & 7));
  }
};

// rows [r0, r0 + ROWS) of one head (row stride rs elements) into a tile of
// layout L, rows >= S zero-filled; the whole block (NT threads) takes part
template <class L, int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int rs, int r0, int S) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, ch = i % CH;
    const bool ok = r0 + r < S;
    cp_async16(dst + L::at(r, ch * 8),
               src + (size_t)(ok ? r0 + r : 0) * rs + ch * 8, ok);
  }
}

// A operand (16 x 16, row-major) at rows m0.., columns k0.. of a tile
template <int D>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t,
                                       int m0, int k0, int lane) {
  const int r = m0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = k0 + (lane >> 4) * 8;
  ldsm_x4(a, smem_u32(t + swz<D>(r, c)));
}

// B operands of two n8 tiles from a tile stored [n][k] (n = row): b[0..1]
// for rows n0..n0+7, b[2..3] for rows n0+8..n0+15, columns k0..k0+15
template <int D>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* t,
                                       int n0, int k0, int lane) {
  const int r = n0 + (lane & 7) + (lane >> 4) * 8;
  const int c = k0 + ((lane >> 3) & 1) * 8;
  ldsm_x4(b, smem_u32(t + swz<D>(r, c)));
}

// B operands of two n8 tiles from a tile stored [k][n] (k = row):
// columns n0..n0+7 in b[0..1], n0+8..n0+15 in b[2..3], rows k0..k0+15
template <int D>
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], const bf16* t,
                                        int k0, int n0, int lane) {
  const int r = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = n0 + (lane >> 4) * 8;
  ldsm_x4_t(b, smem_u32(t + swz<D>(r, c)));
}

// acc[j] (+)= A(16 rows at m0 of ta) . B^T(rows n0 + 8j of tb), over D
template <int D, int NJ>
__device__ __forceinline__ void mm_rows(float (&acc)[NJ][4], const bf16* ta,
                                        int m0, const bf16* tb, int n0,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    frag_a<D>(a, ta, m0, kk * 16, lane);
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      uint32_t b[4];
      frag_b<D>(b, tb, n0 + jj * 16, kk * 16, lane);
      mma(acc[2 * jj], a, b[0], b[1]);
      mma(acc[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

// acc[n] += P . T with P (16 x 16 KC) in registers as accumulator
// fragments p[j] (rounded to bf16 here) and T the tile rows k0.. [k][D]
template <int D, int KC, int NJ>
__device__ __forceinline__ void mm_p_tile(float (&acc)[D / 8][4],
                                          const float (&p)[NJ][4],
                                          const bf16* t, int k0, int lane) {
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn) {
      uint32_t b[4];
      frag_bt<D>(b, t, k0 + kk * 16, nn * 16, lane);
      mma(acc[2 * nn], a, b[0], b[1]);
      mma(acc[2 * nn + 1], a, b[2], b[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma (the forward): a warpgroup of 4 warps multiplies a 64-row tile
// ---------------------------------------------------------------------------
// the shared-memory descriptor of a 128-byte-swizzled operand: LBO is the
// byte stride between 64-column halves along MN of an MN-major operand
// (unused for K-major ones), SBO the byte stride between 8-row atoms
__device__ __forceinline__ uint64_t sw128_desc(const bf16* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  return d | (uint64_t)1 << 62;  // 128-byte swizzle
}

// shared-memory writes of this thread (st.shared, cp.async) made visible
// to wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// registers that ordinary code wrote are ready for the wgmma that follows
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (+)= A . B, m64nNk16, bf16 operands, fp32 accumulator; A and B in
// shared memory (both K-major)
__device__ __forceinline__ void wgmma_ss_n64(
    float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      " %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A . B with A in registers (the m16n8k16 A layout per warp) and
// B in shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_t(
    float (&d)[32], const uint32_t (&a)[4],
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      " %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_t(
    float (&d)[64], const uint32_t (&a)[4],
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      " %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34,"
      " %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45,"
      " %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56,"
      " %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


// the 1024-byte-aligned start of the dynamic shared memory (wgmma's
// swizzle atoms)
__device__ __forceinline__ bf16* align1024(unsigned char* p) {
  return reinterpret_cast<bf16*>(p + ((1024u - (smem_u32(p) & 1023u)) &
                                      1023u));
}

// ---------------------------------------------------------------------------
// rope (neox): element d of the rotation pairs d with d +- D/2.  The
// expressions use __fmul_rn/__fadd_rn so that nvcc cannot contract them
// into FMAs: the rounded operands are bitwise the plain version's.
// ---------------------------------------------------------------------------
// lo/hi: elements [8ch, 8ch + 8) and [D/2 + 8ch, ...) of a row at table
// row cs/sn
template <int D>
__device__ __forceinline__ void rope8(float (&lo)[8], float (&hi)[8],
                                      const float* cs, const float* sn,
                                      int ch) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int d = ch * 8 + e;
    const float x = lo[e], y = hi[e];
    lo[e] = __fadd_rn(__fmul_rn(x, cs[d]), __fmul_rn(-y, sn[d]));
    hi[e] = __fadd_rn(__fmul_rn(y, cs[d + D / 2]), __fmul_rn(x, sn[d + D / 2]));
  }
}

__device__ __forceinline__ void unpack8(float (&f)[8], uint4 u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = bf16_lo(w[i]);
    f[2 * i + 1] = bf16_hi(w[i]);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                    pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

// round(rope(x) * mul) (rope optional) of rows [r0, r0 + ROWS) into a
// tile; rows >= S are zeros.  The block's resident operand, once per block.
template <class L, int D, bool ROPE, int ROWS, int NT>
__device__ __forceinline__ void load_scaled(bf16* __restrict__ dst,
                                            const bf16* __restrict__ src,
                                            int rs, int r0, int S,
                                            const float* __restrict__ cos,
                                            const float* __restrict__ sin,
                                            float mul) {
  constexpr int HC = D / 16;  // chunks per half row
  static_assert(ROWS * HC % NT == 0, "whole iterations");
  // unrolled, with restrict pointers: every iteration's loads can issue
  // before the first shared store
#pragma unroll
  for (int it = 0; it < ROWS * HC / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / HC, ch = i % HC, s = r0 + r;
    float lo[8] = {}, hi[8] = {};
    if (s < S) {
      const bf16* row = src + (size_t)s * rs;
      unpack8(lo, *reinterpret_cast<const uint4*>(row + ch * 8));
      unpack8(hi, *reinterpret_cast<const uint4*>(row + D / 2 + ch * 8));
      if (ROPE) rope8<D>(lo, hi, cos + (size_t)s * D, sin + (size_t)s * D, ch);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        lo[e] = __fmul_rn(lo[e], mul);
        hi[e] = __fmul_rn(hi[e], mul);
      }
    }
    *reinterpret_cast<uint4*>(dst + L::at(r, ch * 8)) = pack8(lo);
    *reinterpret_cast<uint4*>(dst + L::at(r, D / 2 + ch * 8)) = pack8(hi);
  }
}

// y = round(rope(x)) for x [B, S, H, D]: the streamed operands' pre-pass
template <int D>
__global__ void rope_round_kernel(const bf16* __restrict__ x,
                                  const float* __restrict__ cos,
                                  const float* __restrict__ sin,
                                  bf16* __restrict__ y, int H, int S,
                                  size_t rows) {
  constexpr int HC = D / 16;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * HC) return;
  const size_t row = i / HC;
  const int ch = (int)(i % HC);
  const int s = (int)((row / H) % S);
  const bf16* src = x + row * D;
  float lo[8], hi[8];
  unpack8(lo, *reinterpret_cast<const uint4*>(src + ch * 8));
  unpack8(hi, *reinterpret_cast<const uint4*>(src + D / 2 + ch * 8));
  rope8<D>(lo, hi, cos + (size_t)s * D, sin + (size_t)s * D, ch);
  *reinterpret_cast<uint4*>(y + row * D + ch * 8) = pack8(lo);
  *reinterpret_cast<uint4*>(y + row * D + D / 2 + ch * 8) = pack8(hi);
}

// delta = rowsum(dO * O) and lse2 = lse * log2(e), both [B, H, Sq]; one
// warp per (b, s, h) row
template <int D>
__global__ void delta_kernel(const bf16* __restrict__ o,
                             const bf16* __restrict__ g,
                             const float* __restrict__ lse,
                             float* __restrict__ delta,
                             float* __restrict__ lse2, int H, int Sq,
                             size_t rows) {
  const size_t row = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float sum = 0.f;
#pragma unroll
  for (int d = lane * 2; d < D; d += 64) {
    const uint32_t ov = *reinterpret_cast<const uint32_t*>(o + row * D + d);
    const uint32_t gv = *reinterpret_cast<const uint32_t*>(g + row * D + d);
    sum += bf16_lo(gv) * bf16_lo(ov) + bf16_hi(gv) * bf16_hi(ov);
  }
  sum = ptt::warp_sum(sum);
  if (lane == 0) {
    const int h = (int)(row % H);
    const size_t bs = row / H;  // b * Sq + s
    const size_t at = ((bs / Sq) * H + h) * Sq + bs % Sq;
    delta[at] = sum;
    lse2[at] = __fmul_rn(lse[at], kLog2e);
  }
}

// the number of k tiles that query rows [q0, min(q0 + BM, Sq)) see
__device__ __forceinline__ int k_tiles_seen(int q0, int BM, int Sq, int Sk,
                                            int causal) {
  const int n = (Sk + kBN - 1) / kBN;
  if (!causal) return n;
  const int last = min(q0 + BM, Sq) - 1 + (Sk - Sq);
  return last < 0 ? 0 : min(n, last / kBN + 1);
}

// this warp's 16 rows of acc (times mul, inverse-roped at table row
// pos0 + row with ROPE) through its own rows [m0, m0 + 16) of the tile ts
// to dst rows (row stride rs), rows >= S skipped.  The caller has made
// the block's earlier use of those rows complete.
template <int D, bool ROPE>
__device__ __forceinline__ void store_rows(bf16* dst, int rs, int r0, int S,
                                           float (&acc)[D / 8][4],
                                           const float (&mul)[2], bf16* ts,
                                           int m0, const float* cos,
                                           const float* sin, int lane) {
  constexpr int ND = D / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = __fmul_rn(acc[n][e], mul[e >> 1]);
  if (ROPE) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pos = min(r0 + m0 + g + 8 * i, S - 1);
      const float* cs = cos + (size_t)pos * D;
      const float* sn = sin + (size_t)pos * D;
#pragma unroll
      for (int n = 0; n < ND / 2; ++n)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          const int d = 8 * n + 2 * t + (e & 1);
          const float x = acc[n][e], y = acc[n + ND / 2][e];
          acc[n][e] = __fsub_rn(__fmul_rn(x, cs[d]), __fmul_rn(-y, sn[d]));
          acc[n + ND / 2][e] = __fsub_rn(__fmul_rn(y, cs[d + D / 2]),
                                         __fmul_rn(x, sn[d + D / 2]));
        }
    }
  }
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(ts + swz<D>(m0 + g + 8 * i,
                                               8 * n + 2 * t)) =
          pack_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
  __syncwarp();
  constexpr int CH = D / 8;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, ch = i % CH, row = r0 + m0 + r;
    if (row < S)
      *reinterpret_cast<uint4*>(dst + (size_t)row * rs + ch * 8) =
          *reinterpret_cast<const uint4*>(ts + swz<D>(m0 + r, ch * 8));
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
// two blocks per SM (at most 128 registers a thread): one block's softmax
// runs while the other's wgmma products do
template <int D, bool ROPE>
__global__ void __launch_bounds__(kFwdWG * 128, 2)
    fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ cos,
                  const float* __restrict__ sin, bf16* __restrict__ out,
                  float* __restrict__ lse, int H, int Sq, int Sk, int causal,
                  float c) {
  constexpr int NT = kFwdWG * 128, BM = kFwdWG * 64;
  constexpr int NJ = kBN / 8, ND = D / 8;
  typedef Sw128<BM> LQ;
  typedef Sw128<kBN> LK;
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = align1024(smem_raw);  // [BM][D] exp2-space q
  bf16* Ks = Qs + BM * D;          // [2][kBN][D] roped k
  bf16* Vs = Ks + 2 * kBN * D;     // [2][kBN][D]

  const int n_qt = (Sq + BM - 1) / BM;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * BM;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int rs = H * D, off = Sk - Sq;
  const bf16* qb = q + ((size_t)b * Sq * H + h) * D;
  const bf16* kb = k + ((size_t)b * Sk * H + h) * D;
  const bf16* vb = v + ((size_t)b * Sk * H + h) * D;
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int m0 = warp * 16;                // this warp's 16 rows of the tile
  const int row0 = q0 + m0 + (lane >> 2);  // rows row0 and row0 + 8
  const int n_kt = k_tiles_seen(q0, BM, Sq, Sk, causal);
  // the warpgroup's 64 rows of the q tile, in each 64-column half
  const bf16* Qw = Qs + wg * 64 * 64;

  if (n_kt > 0) {
    load_tile_async<LK, D, kBN, NT>(Ks, kb, rs, 0, Sk);
    load_tile_async<LK, D, kBN, NT>(Vs, vb, rs, 0, Sk);
  }
  cp_async_commit();
  load_scaled<LQ, D, ROPE, BM, NT>(Qs, qb, rs, q0, Sq, cos, sin, c);

  // accumulators in the m16n8 layout of each warp: o[4j + e] is row
  // row0 + 8 (e >> 1), column 8j + 2t + (e & 1); s likewise
  float o[D / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1, k0 = kt * kBN;
    if (kt + 1 < n_kt) {
      load_tile_async<LK, D, kBN, NT>(Ks + (st ^ 1) * kBN * D, kb, rs,
                                      k0 + kBN, Sk);
      load_tile_async<LK, D, kBN, NT>(Vs + (st ^ 1) * kBN * D, vb, rs,
                                      k0 + kBN, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const bf16* Kt = Ks + st * kBN * D;
    const bf16* Vt = Vs + st * kBN * D;
    // S = Q K^T: both K-major, 16 columns of D per step
    float s[NJ * 4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int half = kk >> 2, col = (kk & 3) * 16;
      wgmma_ss_n64(s, sw128_desc(Qw + half * BM * 64 + col, 16, 1024),
                   sw128_desc(Kt + half * kBN * 64 + col, 16, 1024), kk > 0);
    }
    wgmma_commit_wait();
    if (k0 + kBN > Sk || (causal && k0 + kBN - 1 > q0 + off)) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (!(col < Sk && (!causal || col <= row + off)))
            s[4 * j + e] = -INFINITY;
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      // a row that has seen nothing yet: p = exp2(-inf) = 0 everywhere
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[i] - m_use);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          s[4 * j + e] = exp2f(s[4 * j + e] - m_use);
          ps += s[4 * j + e];
        }
      l[i] = l[i] * alpha + ps;  // this thread's columns; summed at the end
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[4 * n + 2 * i] *= alpha;
        o[4 * n + 2 * i + 1] *= alpha;
      }
    }
    // O += P V: p, rounded to bf16, is the A operand from registers (the
    // score accumulator's layout is wgmma's A layout); V [keys][D] is the
    // MN-major B operand, its two 64-column halves kBN * 128 bytes apart
    uint32_t a[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_rs_t(o, a[kk], sw128_desc(Vt + kk * 16 * 64, kBN * 128, 1024), 1);
    wgmma_commit_wait();
    __syncthreads();  // stage st is consumed before it is refilled
  }
  __syncthreads();  // Qs is free for the stores (n_kt may be 0)

  float linv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    linv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
    const int row = row0 + 8 * i;
    if (t == 0 && row < Sq)
      lse[(size_t)bh * Sq + row] =
          l[i] > 0.f ? m[i] * kLn2 + logf(l[i]) : -INFINITY;
  }
  store_rows<D, false>(out + ((size_t)b * Sq * H + h) * D, rs, q0, Sq,
                       reinterpret_cast<float(&)[ND][4]>(o), linv, Qs, m0,
                       cos, sin, lane);
}

// ---------------------------------------------------------------------------
// backward, dq kernel: one block per (64-row q tile, b*h)
// ---------------------------------------------------------------------------
template <int D, bool ROPE>
__global__ void __launch_bounds__(kBwdWarps * 32)
    bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kr,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ delta,
                     const float* __restrict__ lse2,
                     const float* __restrict__ cos,
                     const float* __restrict__ sin, bf16* __restrict__ dq,
                     int H, int Sq, int Sk, int causal, float c,
                     float scale) {
  constexpr int NT = kBwdWarps * 32, BM = kBwdWarps * 16;
  constexpr int NJ = kBN / 8, ND = D / 8;
  typedef RowSwz<D> L;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BM][D] exp2-space q
  bf16* dOs = Qs + BM * D;                        // [BM][D]
  bf16* Ks = dOs + BM * D;                        // [2][kBN][D] roped k
  bf16* Vs = Ks + 2 * kBN * D;                    // [2][kBN][D]

  const int n_qt = (Sq + BM - 1) / BM;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * BM;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int rs = H * D, off = Sk - Sq;
  const size_t qhead = ((size_t)b * Sq * H + h) * D;
  const bf16* kb = kr + ((size_t)b * Sk * H + h) * D;
  const bf16* vb = v + ((size_t)b * Sk * H + h) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = warp * 16, t = lane & 3;
  const int row0 = q0 + m0 + (lane >> 2);
  const int n_kt = k_tiles_seen(q0, BM, Sq, Sk, causal);

  load_tile_async<L, D, BM, NT>(dOs, g + qhead, rs, q0, Sq);
  if (n_kt > 0) {
    load_tile_async<L, D, kBN, NT>(Ks, kb, rs, 0, Sk);
    load_tile_async<L, D, kBN, NT>(Vs, vb, rs, 0, Sk);
  }
  cp_async_commit();
  load_scaled<L, D, ROPE, BM, NT>(Qs, q + qhead, rs, q0, Sq, cos, sin, c);
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    l2[i] = row < Sq ? lse2[(size_t)bh * Sq + row] : -INFINITY;
    dl[i] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
  }

  float dqa[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1, k0 = kt * kBN;
    if (kt + 1 < n_kt) {
      load_tile_async<L, D, kBN, NT>(Ks + (st ^ 1) * kBN * D, kb, rs,
                                     k0 + kBN, Sk);
      load_tile_async<L, D, kBN, NT>(Vs + (st ^ 1) * kBN * D, vb, rs,
                                     k0 + kBN, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + st * kBN * D;
    const bf16* Vt = Vs + st * kBN * D;
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mm_rows<D, NJ>(s, Qs, m0, Kt, 0, lane);
    mm_rows<D, NJ>(dp, dOs, m0, Vt, 0, lane);
    const bool need_mask = k0 + kBN > Sk || (causal && k0 + kBN - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = k0 + 8 * j + 2 * t + (e & 1), row = row0 + 8 * i;
        const bool vis = l2[i] != -INFINITY &&
                         (!need_mask ||
                          (col < Sk && (!causal || col <= row + off)));
        const float p = vis ? exp2f(s[j][e] - l2[i]) : 0.f;
        // ds, rounded to bf16 as it enters ds . K
        dp[j][e] = p * (dp[j][e] - dl[i]);
      }
    mm_p_tile<D, kBN / 16, NJ>(dqa, dp, Kt, 0, lane);
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();
  const float mul[2] = {scale, scale};
  store_rows<D, ROPE>(dq + qhead, rs, q0, Sq, dqa, mul, Qs, m0, cos, sin,
                      lane);
}

// ---------------------------------------------------------------------------
// backward, dk/dv kernel (transposed): one block per (64-key tile, b*h)
// ---------------------------------------------------------------------------
// dS^T of one half tile, [kBN keys][kSub q] bf16 (64-byte rows), its
// 16-byte chunks swizzled by (key >> 1) & 3: the 32-bit stores of the
// accumulator layout and the ldmatrix.trans reads are conflict-free
__device__ __forceinline__ int dst_at(int key, int col) {
  return key * kSub + ((((col >> 3) ^ (key >> 1)) & 3) << 3) + (col & 7);
}

// The one-pass form's dq share of one half tile (q rows r0 .. r0 + kSub),
// dQ += dS Ks / log2(e), added into dq_acc in k-tile order.  ds^T (keys
// as rows, in the accumulator layout of the calling warp's 16 keys) goes
// through shared memory, rounded to bf16 as for dS^T Q; warp w then
// computes q rows 16 (w & 1) .. of the half over D columns (w >> 1) D/4 ..
// from the block's 128 keys: A = dS by ldmatrix.trans of dS^T, B = Ks
// ([keys][D], row-major) by ldmatrix.trans.  The share lives in registers
// only until it is added (D/8 floats a thread).
template <int D>
__device__ __forceinline__ void dq_share(
    bf16* dSt, const float (&ds)[kSub / 8][4], const bf16* Ks, int m0,
    int lane, float* __restrict__ dq_acc, int* __restrict__ dq_turn, int kt,
    int bh, int b, int h, int H, int Sq, int r0, int half_idx) {
  constexpr int BN = kKvWarps * 16, NJ = kSub / 8;
  constexpr int NC = D / (kKvWarps / 2), NH = NC / 8;  // columns, n8 tiles
  const int g = lane >> 2, t = lane & 3, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(dSt + dst_at(m0 + g + 8 * i,
                                                8 * j + 2 * t)) =
          pack_bf16(ds[j][2 * i], ds[j][2 * i + 1]);
  // this k tile's turn on the half (one counter per b*h and half tile, 2
  // per 64-row q tile, after the ticket); its barrier also publishes dS^T.
  // The workspace is then read at once, every load before the first
  // store (one L2 round trip, not one per element: the compiler moves no
  // load past a store that may alias), so the reads are in flight while
  // the share is multiplied
  int* turn =
      dq_turn + 1 + (size_t)bh * 2 * ((Sq + kBN - 1) / kBN) + half_idx;
  ptt::wait_turn(turn, kt);
  const int qm = (warp & 1) * 16, n0 = (warp >> 1) * NC;
  float2* dst[2];
  float2 cur[2][NH];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = min(r0 + qm + g + 8 * i, Sq - 1);
    dst[i] = reinterpret_cast<float2*>(
        dq_acc + (((size_t)b * Sq + row) * H + h) * D + n0 + 2 * t);
#pragma unroll
    for (int n = 0; n < NH; ++n) cur[i][n] = __ldcg(dst[i] + 4 * n);
  }
  float acc[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    uint32_t a[4];
    const int key = kk * 16 + (lane & 7) + (lane >> 4) * 8;
    ldsm_x4_t(a, smem_u32(dSt + dst_at(key, qm + ((lane >> 3) & 1) * 8)));
#pragma unroll
    for (int nn = 0; nn < NH / 2; ++nn) {
      uint32_t bb[4];
      frag_bt<D>(bb, Ks, kk * 16, n0 + nn * 16, lane);
      mma(acc[2 * nn], a, bb[0], bb[1]);
      mma(acc[2 * nn + 1], a, bb[2], bb[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r0 + qm + g + 8 * i >= Sq) continue;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      cur[i][n].x += acc[n][2 * i] * kInvLog2e;
      cur[i][n].y += acc[n][2 * i + 1] * kInvLog2e;
      __stcg(dst[i] + 4 * n, cur[i][n]);
    }
  }
  ptt::pass_turn(turn, kt + 1);  // also frees dSt for the next half
}

template <int D, bool ROPE, bool EMIT_DQ>
__global__ void __launch_bounds__(kKvWarps * 32)
    bwd_kv_tc_kernel(const bf16* __restrict__ qr, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ delta,
                     const float* __restrict__ lse2,
                     const float* __restrict__ cos,
                     const float* __restrict__ sin, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, float* __restrict__ dq_acc,
                     int* __restrict__ dq_turn, int H, int Sq, int Sk,
                     int causal, float c, float scale) {
  constexpr int NT = kKvWarps * 32, BN = kKvWarps * 16;
  constexpr int NJ = kSub / 8, ND = D / 8;
  typedef RowSwz<D> L;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BN][D] exp2-space k
  bf16* Vs = Ks + BN * D;                         // [BN][D]
  bf16* Qs = Vs + BN * D;                         // [2][kBN][D] roped q
  bf16* dOs = Qs + 2 * kBN * D;                   // [2][kBN][D]
  float* L2s = reinterpret_cast<float*>(dOs + 2 * kBN * D);  // [2][kBN]
  float* DLs = L2s + 2 * kBN;                                 // [2][kBN]
  bf16* dSt = reinterpret_cast<bf16*>(DLs + 2 * kBN);  // [BN][kSub] (dq)

  // (b*h, k tile), b*h fastest; the one-pass form in the order blocks
  // start (dq_turn[0] is the ticket counter, the turns follow)
  int bx = blockIdx.x, kt = blockIdx.y;
  if (EMIT_DQ) {
    const int tk = ptt::take_ticket(dq_turn);
    bx = tk % gridDim.x;
    kt = tk / gridDim.x;
  }
  const int k0 = kt * BN;  // early (causal: heaviest) k tiles first
  const int bh = bx, b = bh / H, h = bh % H;
  const int rs = H * D, off = Sk - Sq;
  const size_t qhead = ((size_t)b * Sq * H + h) * D;
  const size_t khead = ((size_t)b * Sk * H + h) * D;
  const float* l2b = lse2 + (size_t)bh * Sq;
  const float* dlb = delta + (size_t)bh * Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = warp * 16, t = lane & 3;
  const int key0 = k0 + m0 + (lane >> 2);  // keys key0 and key0 + 8
  const int n_qt = (Sq + kBN - 1) / kBN;
  const int qt0 = causal ? max(0, k0 - off) / kBN : 0;

  auto load_q_tile = [&](int stage, int q0) {
    load_tile_async<L, D, kBN, NT>(Qs + stage * kBN * D, qr + qhead, rs, q0,
                                   Sq);
    load_tile_async<L, D, kBN, NT>(dOs + stage * kBN * D, g + qhead, rs, q0,
                                   Sq);
    const int i = threadIdx.x & (kBN - 1), row = q0 + i;
    const bool ok = row < Sq;
    if (threadIdx.x < kBN)
      cp_async4(L2s + stage * kBN + i, l2b + (ok ? row : 0), ok);
    else if (threadIdx.x < 2 * kBN)
      cp_async4(DLs + stage * kBN + i, dlb + (ok ? row : 0), ok);
  };

  load_tile_async<L, D, BN, NT>(Vs, v + khead, rs, k0, Sk);
  if (qt0 < n_qt) load_q_tile(0, qt0 * kBN);
  cp_async_commit();
  load_scaled<L, D, ROPE, BN, NT>(Ks, k + khead, rs, k0, Sk, cos, sin, c);

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int st = (qt - qt0) & 1, q0 = qt * kBN;
    if (qt + 1 < n_qt) load_q_tile(st ^ 1, q0 + kBN);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qt = Qs + st * kBN * D;
    const bf16* dOt = dOs + st * kBN * D;
    const float* l2t = L2s + st * kBN;
    const float* dlt = DLs + st * kBN;
    const bool need_mask = q0 + kBN > Sq || k0 + BN > Sk ||
                           (causal && k0 + BN - 1 > q0 + off);
#pragma unroll
    for (int half = 0; half < kBN / kSub; ++half) {
      const int c0 = half * kSub;  // q columns [c0, c0 + kSub) of the tile
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mm_rows<D, NJ>(s, Ks, m0, Qt, c0, lane);   // S^T = K~ Q^T
      mm_rows<D, NJ>(dp, Vs, m0, dOt, c0, lane);  // dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = c0 + 8 * j + 2 * t + (e & 1);
          const int row = q0 + cl, key = key0 + 8 * (e >> 1);
          const float lr = l2t[cl];
          const bool vis = !need_mask ||
                           (row < Sq && key < Sk && lr != -INFINITY &&
                            (!causal || key <= row + off));
          const float p = vis ? exp2f(s[j][e] - lr) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dlt[cl]);
        }
      mm_p_tile<D, kSub / 16, NJ>(dva, s, dOt, c0, lane);  // dV += P^T dO
      mm_p_tile<D, kSub / 16, NJ>(dka, dp, Qt, c0, lane);  // dK += dS^T Q
      if (EMIT_DQ) dq_share<D>(dSt, dp, Ks, m0, lane, dq_acc, dq_turn, kt,
                               bh, b, h, H, Sq, q0 + c0,
                               (qt * kBN + c0) / kSub);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();
  const float kmul[2] = {scale, scale}, vmul[2] = {1.f, 1.f};
  store_rows<D, ROPE>(dk + khead, rs, k0, Sk, dka, kmul, Ks, m0, cos, sin,
                      lane);
  store_rows<D, false>(dv + khead, rs, k0, Sk, dva, vmul, Vs, m0, cos, sin,
                       lane);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t fwd_smem() {
  // + 1024: the tiles start at the first 1024-byte boundary
  return (size_t)(kFwdWG * 64 + 4 * kBN) * D * sizeof(bf16) + 1024;
}
template <int D>
constexpr size_t dq_smem() {
  return (size_t)(2 * kBwdWarps * 16 + 4 * kBN) * D * sizeof(bf16);
}
template <int D>
constexpr size_t kv_smem() {
  // + the one-pass form's dS^T half tile
  return (size_t)(2 * kKvWarps * 16 + 4 * kBN) * D * sizeof(bf16) +
         4 * kBN * sizeof(float) + kKvWarps * 16 * kSub * sizeof(bf16);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

struct Args {
  const void *q, *k, *v, *o, *g, *lse, *cos, *sin;
  void *out, *lse_out, *dq, *dk, *dv, *kr, *qr, *delta, *lse2, *dq_acc,
      *dq_turn;
  int B, H, Sq, Sk, causal;
  float c, scale;
  cudaStream_t st;
};

// y = round(rope(x)), x [B, S, H, D]
template <int D>
int rope_round(const void* x, void* y, const Args& a, int S) {
  const size_t rows = (size_t)a.B * S * a.H;
  const size_t n = rows * (D / 16);
  rope_round_kernel<D><<<(unsigned)((n + 255) / 256), 256, 0, a.st>>>(
      (const bf16*)x, (const float*)a.cos, (const float*)a.sin, (bf16*)y,
      a.H, S, rows);
  return (int)cudaGetLastError();
}

template <int D, bool ROPE>
int fwd(const Args& a) {
  int err;
  const bf16* kk = (const bf16*)a.k;
  if (ROPE) {
    if ((err = rope_round<D>(a.k, a.kr, a, a.Sk)) != 0) return err;
    kk = (const bf16*)a.kr;
  }
  auto kern = fwd_tc_kernel<D, ROPE>;
  if ((err = (int)set_smem(kern, fwd_smem<D>())) != 0) return err;
  constexpr int BM = kFwdWG * 64;
  kern<<<dim3(a.B * a.H, (a.Sq + BM - 1) / BM), kFwdWG * 128,
         fwd_smem<D>(), a.st>>>(
      (const bf16*)a.q, kk, (const bf16*)a.v, (const float*)a.cos,
      (const float*)a.sin, (bf16*)a.out, (float*)a.lse_out, a.H, a.Sq, a.Sk,
      a.causal, a.c);
  return (int)cudaGetLastError();
}

// the pre-passes of both backward forms: delta and lse2, and with rope
// round(rope(q)) into qr (and, for the two-kernel form, round(rope(k))
// into kr)
template <int D, bool ROPE>
int bwd_prepasses(const Args& a, bool rope_k) {
  int err;
  const size_t rows = (size_t)a.B * a.Sq * a.H;
  delta_kernel<D><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, a.st>>>(
      (const bf16*)a.o, (const bf16*)a.g, (const float*)a.lse,
      (float*)a.delta, (float*)a.lse2, a.H, a.Sq, rows);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if (ROPE && rope_k && (err = rope_round<D>(a.k, a.kr, a, a.Sk)) != 0)
    return err;
  if (ROPE) return rope_round<D>(a.q, a.qr, a, a.Sq);
  return 0;
}

template <int D, bool ROPE, bool EMIT_DQ>
int launch_kv(const Args& a) {
  int err;
  auto kvk = bwd_kv_tc_kernel<D, ROPE, EMIT_DQ>;
  if ((err = (int)set_smem(kvk, kv_smem<D>())) != 0) return err;
  constexpr int BN = kKvWarps * 16;
  kvk<<<dim3(a.B * a.H, (a.Sk + BN - 1) / BN), kKvWarps * 32, kv_smem<D>(),
        a.st>>>(ROPE ? (const bf16*)a.qr : (const bf16*)a.q,
                (const bf16*)a.k, (const bf16*)a.v, (const bf16*)a.g,
                (const float*)a.delta, (const float*)a.lse2,
                (const float*)a.cos, (const float*)a.sin, (bf16*)a.dk,
                (bf16*)a.dv, (float*)a.dq_acc, (int*)a.dq_turn, a.H, a.Sq,
                a.Sk, a.causal, a.c, a.scale);
  return (int)cudaGetLastError();
}

template <int D, bool ROPE>
int bwd(const Args& a) {
  int err;
  if ((err = bwd_prepasses<D, ROPE>(a, true)) != 0) return err;
  const bf16* kk = ROPE ? (const bf16*)a.kr : (const bf16*)a.k;
  constexpr int BM = kBwdWarps * 16;
  auto dqk = bwd_dq_tc_kernel<D, ROPE>;
  if ((err = (int)set_smem(dqk, dq_smem<D>())) != 0) return err;
  dqk<<<dim3(a.B * a.H, (a.Sq + BM - 1) / BM), kBwdWarps * 32, dq_smem<D>(),
        a.st>>>((const bf16*)a.q, kk, (const bf16*)a.v, (const bf16*)a.g,
                (const float*)a.delta, (const float*)a.lse2,
                (const float*)a.cos, (const float*)a.sin, (bf16*)a.dq, a.H,
                a.Sq, a.Sk, a.causal, a.c, a.scale);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  return launch_kv<D, ROPE, false>(a);
}

// the one-pass backward: the dk/dv kernel adding the dq shares in k-tile
// order, then the finishing pass
template <int D, bool ROPE>
int bwd_fused(const Args& a) {
  int err;
  if ((err = bwd_prepasses<D, ROPE>(a, false)) != 0) return err;
  if ((err = launch_kv<D, ROPE, true>(a)) != 0) return err;
  const size_t n = (size_t)a.B * a.Sq * a.H * D;
  ptt::dq_finalize_kernel<bf16, D, ROPE>
      <<<(unsigned)((n + 255) / 256), 256, 0, a.st>>>(
          (const float*)a.dq_acc, (const float*)a.cos, (const float*)a.sin,
          (bf16*)a.dq, a.H, a.Sq, n);
  return (int)cudaGetLastError();
}

template <int D, bool ROPE>
struct FwdOp {
  static int run(const Args& a) { return fwd<D, ROPE>(a); }
};
template <int D, bool ROPE>
struct BwdOp {
  static int run(const Args& a) { return bwd<D, ROPE>(a); }
};
template <int D, bool ROPE>
struct FusedOp {
  static int run(const Args& a) { return bwd_fused<D, ROPE>(a); }
};

// head dim x rope -> one instantiation
template <template <int, bool> class Op>
int dispatch(int D, int rope, const Args& a) {
  if (D == 64) return rope ? Op<64, true>::run(a) : Op<64, false>::run(a);
  if (D == 128) return rope ? Op<128, true>::run(a) : Op<128, false>::run(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// bf16 only.  Layouts: q/out [B, Sq, H, D], k/v [B, Sk, H, D] contiguous;
// lse [B, H, Sq] float32; cos/sin [S, D] float32 and kr (scratch like k,
// receives round(rope(k))) with rope, else null.  c = log2(e) / sqrt(D).
// Returns the launches' cudaGetLastError().
extern "C" int ptt_flash_fwd_tc(const void* q, const void* k, const void* v,
                                const void* cos, const void* sin, void* out,
                                void* lse, void* kr, int B, int H, int Sq,
                                int Sk, int D, int causal, int rope, float c,
                                void* stream) {
  Args a = {};
  a.q = q, a.k = k, a.v = v, a.cos = cos, a.sin = sin, a.out = out;
  a.lse_out = lse, a.kr = kr;
  a.B = B, a.H = H, a.Sq = Sq, a.Sk = Sk, a.causal = causal, a.c = c;
  a.st = (cudaStream_t)stream;
  return dispatch<FwdOp>(D, rope, a);
}

// The two-kernel backward, bf16: dq, dk, dv like q, k, v.  Scratch from
// the caller: delta and lse2 [B, H, Sq] float32; with rope kr like k and
// qr like q (round(rope(k)), round(rope(q))), else null.  scale =
// 1 / sqrt(D).
extern "C" int ptt_flash_bwd_two_kernel_tc(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, const void* cos, const void* sin,
    void* dq, void* dk, void* dv, void* kr, void* qr, void* delta,
    void* lse2, int B, int H, int Sq, int Sk, int D, int causal, int rope,
    float c, float scale, void* stream) {
  Args a = {};
  a.q = q, a.k = k, a.v = v, a.o = out, a.g = dout, a.lse = lse;
  a.cos = cos, a.sin = sin, a.dq = dq, a.dk = dk, a.dv = dv;
  a.kr = kr, a.qr = qr, a.delta = delta, a.lse2 = lse2;
  a.B = B, a.H = H, a.Sq = Sq, a.Sk = Sk, a.causal = causal, a.c = c;
  a.scale = scale, a.st = (cudaStream_t)stream;
  return dispatch<BwdOp>(D, rope, a);
}

// The one-pass backward, bf16: dq, dk, dv like q, k, v.  Scratch from the
// caller: delta and lse2 [B, H, Sq] float32; with rope qr like q
// (round(rope(q))), else null; dq_acc [B, Sq, H, D] float32 and dq_turn
// (1 + B * H * 2 * ceil(Sq / 64) int32: the ticket, then the turns), both
// zeroed.  scale = 1 / sqrt(D).
extern "C" int ptt_flash_bwd_fused_tc(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, const void* cos, const void* sin,
    void* dq, void* dk, void* dv, void* qr, void* delta, void* lse2,
    void* dq_acc, void* dq_turn, int B, int H, int Sq, int Sk, int D,
    int causal, int rope, float c, float scale, void* stream) {
  Args a = {};
  a.q = q, a.k = k, a.v = v, a.o = out, a.g = dout, a.lse = lse;
  a.cos = cos, a.sin = sin, a.dq = dq, a.dk = dk, a.dv = dv;
  a.qr = qr, a.delta = delta, a.lse2 = lse2, a.dq_acc = dq_acc;
  a.dq_turn = dq_turn;
  a.B = B, a.H = H, a.Sq = Sq, a.Sk = Sk, a.causal = causal, a.c = c;
  a.scale = scale, a.st = (cudaStream_t)stream;
  return dispatch<FusedOp>(D, rope, a);
}
