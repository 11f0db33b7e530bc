// Flash attention with fused neox rope for Hopper (sm_90a): the forward,
// the one-pass backward and the two-kernel backward of the training path.
//
// Replaces (paddle_tpu/ops/pallas_kernels.py):
// - _flash_fwd_kernel (launched by _flash_attention_value): flash_fwd_kernel
// - _flash_bwd_kv_kernel with emit_dq (launched by
//   _flash_attention_bwd_fused): flash_bwd_kv_kernel<EMIT_DQ=true> followed
//   by dq_finalize_kernel
// - _flash_bwd_dq_kernel + _flash_bwd_kv_kernel (launched by
//   _flash_attention_bwd): flash_bwd_dq_kernel + flash_bwd_kv_kernel<false>
//
// What they compute.  q [B, Sq, H, D], k/v [B, Sk, H, D], out/dout like
// q, lse [B, H, Sq] fp32 (natural log, -inf for a row that sees nothing);
// query row i sees key j iff j <= i + Sk - Sq when causal.  Scores are
// kept in exp2 space: the q tile is roped (optional), multiplied by
// c = scale * log2(e) and rounded to the input type once; k is roped and
// rounded; p is rounded to the input type before p.V (and before
// p^T.dO), ds before ds.K and ds^T.Q; the gradients of q and k leave
// through the inverse rotation (the rope VJP, cos and -sin).  All math is
// fp32.  The rope expressions use __fmul_rn/__fadd_rn so that nvcc cannot
// contract them into FMAs: the rounded operands are then bitwise those of
// the plain PyTorch version (paddle_tpu_torch/ops/flash_attention.py).
//
// Design (simple and right first; tensor cores, TMA and pipelining later).
// 256 threads per block; q and k tiles of 64 rows; every tile lives in
// shared memory as fp32, rows padded to D + 1 floats where a product reads
// them across rows.  Thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty + 16a (a < 4) and columns tx + 16b of every 64-row product, so a
// row's 64 columns sit in 16 lanes of one warp (row max / sum with four
// shuffles), and the partner column d +- D/2 of the rope lies in the same
// thread (the inverse rope runs in registers).
// - Forward: one block per (q tile, b*h), late q tiles first (the causal
//   ones carry the most keys).  It loops over the k tiles up to the causal
//   limit with an online softmax (FA2: unnormalised accumulator, one
//   division by l at the store) and stores only rows < Sq.
// - Backward, k-tile kernel: one block per (k tile, b*h), dk and dv in
//   registers; it loops over the q tiles from the first that sees the k
//   tile, recomputing p from the lse and delta = rowsum(dO * O) per q
//   tile.  With EMIT_DQ it also adds each (k tile, q tile) share of dq,
//   times scale, into a zeroed fp32 workspace with atomicAdd: the TPU
//   kernel writes per-k-tile partials because it has no atomics.  The
//   order of the additions changes from run to run, so dq is not bitwise
//   deterministic.  dq_finalize_kernel then applies the inverse rope and
//   the cast.
// - Backward, q-tile kernel (two-kernel form): one block per (q tile,
//   b*h), dq in registers, loops over the k tiles up to the causal limit;
//   no atomics, so the two-kernel backward is deterministic.
//
// Bound on the card: operations.  At the training shapes (S 2048, D 128)
// a q tile does 64 x 2 x D operations per key it reads, far above the
// ~295 operations per byte where the H100 turns compute bound.  These
// kernels run on the fp32 CUDA cores (67 TFLOP/s peak, and the 4x4
// register tile reads two shared-memory words per two FMAs), not on the
// bf16 tensor cores (989 TFLOP/s), so they sit well above their bound:
// mma/wgmma tiles are the next step.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kB = 64;        // rows of a q tile and of a k tile
constexpr int kLdP = kB + 1;  // padded row of a [64, 64] score tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return ptt::to_f32(ptt::from_f32<T>(x));
}

// Element d of the neox rotation of `row` at the table row cs / sn.
template <typename T, int D>
__device__ __forceinline__ float rope_elem(const T* row, const float* cs,
                                           const float* sn, int d) {
  constexpr int half = D / 2;
  const float x = ptt::to_f32(row[d]);
  const float rot = d < half ? -ptt::to_f32(row[d + half])
                             : ptt::to_f32(row[d - half]);
  return __fadd_rn(__fmul_rn(x, cs[d]), __fmul_rn(rot, sn[d]));
}

// Rows [r0, r0 + 64) of one head into dst (row stride ld) as fp32; rows
// >= S are zeros.  ROPE rotates at the row's position; SCALED multiplies
// by mul; either rounds the result to T (the input type).
template <typename T, int D, bool ROPE, bool SCALED>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base,
                                          int row_stride, int r0, int S,
                                          const float* cos, const float* sin,
                                          float mul) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = r0 + r;
    float x = 0.f;
    if (s < S) {
      const T* row = base + (size_t)s * row_stride;
      if (ROPE)
        x = rope_elem<T, D>(row, cos + (size_t)s * D, sin + (size_t)s * D, d);
      else
        x = ptt::to_f32(row[d]);
      if (SCALED) x = __fmul_rn(x, mul);
      if (ROPE || SCALED) x = round_to<T>(x);
    }
    dst[r * ld + d] = x;
  }
}

// acc[a][b] += sum_k A[(ty+16a)*lda + k] * B[(tx+16b)*ldb + k]
template <int K>
__device__ __forceinline__ void mm_nt(float (&acc)[4][4], const float* A,
                                      int lda, const float* B, int ldb,
                                      int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * ldb + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[a][c] += sum_k A[(ty+16a)*lda + k] * B[k*ldb + tx+16c]
template <int K, int NC>
__device__ __forceinline__ void mm_nn(float (&acc)[4][NC], const float* A,
                                      int lda, const float* B, int ldb,
                                      int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4], b[NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < NC; ++j) b[j] = B[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[a][c] += sum_k A[k*lda + ty+16a] * B[k*ldb + tx+16c]
template <int K, int NC>
__device__ __forceinline__ void mm_tn(float (&acc)[4][NC], const float* A,
                                      int lda, const float* B, int ldb,
                                      int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4], b[NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[k * lda + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < NC; ++j) b[j] = B[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// max / sum over the 16 lanes that hold one row (a half warp)
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Scale a row's D/16 register columns (tx + 16c) and, with ROPE, apply
// the inverse rotation at table row `pos`; the partner of column c is
// c +- NC/2 in the same thread.  Then store the row to `dst` in T.
template <typename T, int D, bool ROPE>
__device__ __forceinline__ void store_row(T* dst, const float (&x)[D / 16],
                                          float scale, const float* cos,
                                          const float* sin, int pos, int tx) {
  constexpr int NC = D / 16;
  float y[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) y[c] = __fmul_rn(x[c], scale);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float val = y[c];
    if (ROPE) {
      const int d = tx + 16 * c;
      const float rot = c < NC / 2 ? -y[c + NC / 2] : y[c - NC / 2];
      val = __fsub_rn(__fmul_rn(y[c], cos[(size_t)pos * D + d]),
                      __fmul_rn(rot, sin[(size_t)pos * D + d]));
    }
    dst[tx + 16 * c] = ptt::from_f32<T>(val);
  }
}

// delta = rowsum(dO * O) and lse2 = lse * log2(e) (-inf past Sq) of the
// 64 rows from q0, one warp per row.
template <typename T, int D>
__device__ __forceinline__ void row_stats(float* dl, float* l2, const T* ob,
                                          const T* gb, const float* lse_bh,
                                          int row_stride, int q0, int Sq) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kB; r += kThreads / 32) {
    const int row = q0 + r;
    float sum = 0.f;
    if (row < Sq) {
      const size_t at = (size_t)row * row_stride;
      for (int d = lane; d < D; d += 32)
        sum += ptt::to_f32(gb[at + d]) * ptt::to_f32(ob[at + d]);
    }
    sum = ptt::warp_sum(sum);
    if (lane == 0) {
      dl[r] = sum;
      l2[r] = row < Sq ? lse_bh[row] * kLog2e : -INFINITY;
    }
  }
}

// The number of k tiles that query rows [q0, min(q0 + 64, Sq)) see.
__device__ __forceinline__ int k_tiles_seen(int q0, int Sq, int Sk,
                                            int causal) {
  const int n = (Sk + kB - 1) / kB;
  if (!causal) return n;
  const int last = min(q0 + kB, Sq) - 1 + (Sk - Sq);
  return last < 0 ? 0 : min(n, last / kB + 1);
}

// p and ds of one (q tile, k tile) pair into Ps / dSs (rounded to T), from
// the score and dO.V^T tiles; masked and dead entries are 0.
template <typename T>
__device__ __forceinline__ void p_ds(float* Ps, float* dSs,
                                     const float (&s)[4][4],
                                     const float (&dp)[4][4], const float* dl,
                                     const float* l2, int q0, int k0, int Sq,
                                     int Sk, int causal, int ty, int tx) {
  const int off = Sk - Sq;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a, row = q0 + r;
    const float lr = l2[r], de = dl[r];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = tx + 16 * b, col = k0 + j;
      const bool vis = row < Sq && col < Sk && (!causal || col <= row + off) &&
                       lr != -INFINITY;
      const float p = vis ? exp2f(s[a][b] - lr) : 0.f;
      if (Ps) Ps[r * kLdP + j] = round_to<T>(p);
      dSs[r * kLdP + j] = round_to<T>(p * (dp[a][b] - de));
    }
  }
}

template <typename T, int D, bool ROPE>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ cos,
                     const float* __restrict__ sin, T* __restrict__ out,
                     float* __restrict__ lse, int H, int Sq, int Sk,
                     int causal, float c) {
  constexpr int NC = D / 16, LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;            // [64][LD] exp2-space q
  float* Ks = Qs + kB * LD;    // [64][LD]
  float* Vs = Ks + kB * LD;    // [64][D]
  float* Ps = Vs + kB * D;     // [64][kLdP]

  const int n_qt = (Sq + kB - 1) / kB;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kB;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int rs = H * D, off = Sk - Sq;
  const T* qb = q + ((size_t)b * Sq * H + h) * D;
  const T* kb = k + ((size_t)b * Sk * H + h) * D;
  const T* vb = v + ((size_t)b * Sk * H + h) * D;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_tile<T, D, ROPE, true>(Qs, LD, qb, rs, q0, Sq, cos, sin, c);
  const int n_kt = k_tiles_seen(q0, Sq, Sk, causal);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[a][j] = 0.f;
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    load_tile<T, D, ROPE, false>(Ks, LD, kb, rs, k0, Sk, cos, sin, 1.f);
    load_tile<T, D, false, false>(Vs, D, vb, rs, k0, Sk, cos, sin, 1.f);
    __syncthreads();
    float s[4][4] = {};
    mm_nt<D>(s, Qs, LD, Ks, LD, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + ty + 16 * a;
      float tmax = -INFINITY;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int col = k0 + tx + 16 * bb;
        if (!(col < Sk && (!causal || col <= row + off)))
          s[a][bb] = -INFINITY;
        tmax = fmaxf(tmax, s[a][bb]);
      }
      const float m_new = fmaxf(m[a], row_max16(tmax));
      float alpha = 1.f, psum = 0.f;
      if (m_new != -INFINITY) {  // uniform over the row's 16 lanes
        alpha = exp2f(m[a] - m_new);
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const float p = exp2f(s[a][bb] - m_new);  // masked: exp2(-inf) = 0
          Ps[(ty + 16 * a) * kLdP + tx + 16 * bb] = round_to<T>(p);
          psum += p;
        }
      } else {
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
          Ps[(ty + 16 * a) * kLdP + tx + 16 * bb] = 0.f;
      }
      l[a] = row_sum16(psum) + alpha * l[a];
      m[a] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[a][j] *= alpha;
    }
    __syncthreads();
    mm_nn<kB, NC>(acc, Ps, kLdP, Vs, D, ty, tx);
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= Sq) continue;
    const float l_inv = l[a] > 0.f ? 1.f / l[a] : 0.f;
    T* o = out + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      o[tx + 16 * j] = ptt::from_f32<T>(acc[a][j] * l_inv);
    if (tx == 0)
      lse[(size_t)bh * Sq + row] =
          l[a] > 0.f ? m[a] * kLn2 + logf(l[a]) : -INFINITY;
  }
}

template <typename T, int D, bool ROPE, bool EMIT_DQ>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ cos,
                        const float* __restrict__ sin, T* __restrict__ dk,
                        T* __restrict__ dv, float* __restrict__ dq_acc,
                        int H, int Sq, int Sk, int causal, float c,
                        float scale) {
  constexpr int NC = D / 16, LD = D + 1;
  extern __shared__ float smem[];
  float* Ks = smem;            // [64][LD] roped k
  float* Vs = Ks + kB * LD;    // [64][LD]
  float* Qs = Vs + kB * LD;    // [64][LD] exp2-space q
  float* dOs = Qs + kB * LD;   // [64][LD]
  float* Qr = dOs + kB * LD;   // [64][D]  roped q (the dk operand)
  float* Ps = Qr + kB * D;     // [64][kLdP]
  float* dSs = Ps + kB * kLdP; // [64][kLdP]
  float* dl = dSs + kB * kLdP; // [64] delta
  float* l2 = dl + kB;         // [64] lse * log2(e)

  const int k0 = blockIdx.x * kB;  // early k tiles (the heavy ones) first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int rs = H * D, off = Sk - Sq;
  const size_t qhead = ((size_t)b * Sq * H + h) * D;
  const size_t khead = ((size_t)b * Sk * H + h) * D;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_tile<T, D, ROPE, false>(Ks, LD, k + khead, rs, k0, Sk, cos, sin, 1.f);
  load_tile<T, D, false, false>(Vs, LD, v + khead, rs, k0, Sk, cos, sin, 1.f);
  const int n_qt = (Sq + kB - 1) / kB;
  const int first_row = causal ? max(0, k0 - off) : 0;

  float dka[4][NC], dva[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NC; ++j) dka[a][j] = dva[a][j] = 0.f;

  for (int qt = first_row / kB; qt < n_qt; ++qt) {
    const int q0 = qt * kB;
    __syncthreads();  // the previous q tile is consumed
    load_tile<T, D, ROPE, true>(Qs, LD, q + qhead, rs, q0, Sq, cos, sin, c);
    load_tile<T, D, ROPE, false>(Qr, D, q + qhead, rs, q0, Sq, cos, sin, 1.f);
    load_tile<T, D, false, false>(dOs, LD, g + qhead, rs, q0, Sq, cos, sin,
                                  1.f);
    row_stats<T, D>(dl, l2, o + qhead, g + qhead, lse + (size_t)bh * Sq, rs,
                    q0, Sq);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mm_nt<D>(s, Qs, LD, Ks, LD, ty, tx);
    mm_nt<D>(dp, dOs, LD, Vs, LD, ty, tx);
    p_ds<T>(Ps, dSs, s, dp, dl, l2, q0, k0, Sq, Sk, causal, ty, tx);
    __syncthreads();
    mm_tn<kB, NC>(dva, Ps, kLdP, dOs, LD, ty, tx);
    mm_tn<kB, NC>(dka, dSs, kLdP, Qr, D, ty, tx);
    if (EMIT_DQ) {
      float dqp[4][NC] = {};
      mm_nn<kB, NC>(dqp, dSs, kLdP, Ks, LD, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int row = q0 + ty + 16 * a;
        if (row >= Sq) continue;
        float* dst = dq_acc + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
        for (int j = 0; j < NC; ++j)
          atomicAdd(dst + tx + 16 * j, dqp[a][j] * scale);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int col = k0 + ty + 16 * a;
    if (col >= Sk) continue;
    const size_t at = (((size_t)b * Sk + col) * H + h) * D;
    store_row<T, D, ROPE>(dk + at, dka[a], scale, cos, sin, col, tx);
    store_row<T, D, false>(dv + at, dva[a], 1.f, cos, sin, col, tx);
  }
}

template <typename T, int D, bool ROPE>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ cos,
                        const float* __restrict__ sin, T* __restrict__ dq,
                        int H, int Sq, int Sk, int causal, float c,
                        float scale) {
  constexpr int NC = D / 16, LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;            // [64][LD] exp2-space q
  float* dOs = Qs + kB * LD;   // [64][LD]
  float* Ks = dOs + kB * LD;   // [64][LD] roped k
  float* Vs = Ks + kB * LD;    // [64][LD]
  float* dSs = Vs + kB * LD;   // [64][kLdP]
  float* dl = dSs + kB * kLdP; // [64]
  float* l2 = dl + kB;         // [64]

  const int n_qt = (Sq + kB - 1) / kB;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kB;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int rs = H * D;
  const size_t qhead = ((size_t)b * Sq * H + h) * D;
  const size_t khead = ((size_t)b * Sk * H + h) * D;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_tile<T, D, ROPE, true>(Qs, LD, q + qhead, rs, q0, Sq, cos, sin, c);
  load_tile<T, D, false, false>(dOs, LD, g + qhead, rs, q0, Sq, cos, sin,
                                1.f);
  row_stats<T, D>(dl, l2, o + qhead, g + qhead, lse + (size_t)bh * Sq, rs, q0,
                  Sq);
  const int n_kt = k_tiles_seen(q0, Sq, Sk, causal);

  float dqa[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < NC; ++j) dqa[a][j] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();
    load_tile<T, D, ROPE, false>(Ks, LD, k + khead, rs, k0, Sk, cos, sin,
                                 1.f);
    load_tile<T, D, false, false>(Vs, LD, v + khead, rs, k0, Sk, cos, sin,
                                  1.f);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mm_nt<D>(s, Qs, LD, Ks, LD, ty, tx);
    mm_nt<D>(dp, dOs, LD, Vs, LD, ty, tx);
    p_ds<T>(nullptr, dSs, s, dp, dl, l2, q0, k0, Sq, Sk, causal, ty, tx);
    __syncthreads();
    mm_nn<kB, NC>(dqa, dSs, kLdP, Ks, LD, ty, tx);
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= Sq) continue;
    store_row<T, D, ROPE>(dq + (((size_t)b * Sq + row) * H + h) * D, dqa[a],
                          scale, cos, sin, row, tx);
  }
}

// dq = inverse-rope(dq_acc) cast to T, one thread per element.
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
    constexpr int half = D / 2;
    const int d = (int)(e % D);
    const size_t pos = (e / ((size_t)D * H)) % Sq;
    const float rot = d < half ? -acc[e + half] : acc[e - half];
    x = __fsub_rn(__fmul_rn(x, cos[pos * D + d]),
                  __fmul_rn(rot, sin[pos * D + d]));
  }
  dq[e] = ptt::from_f32<T>(x);
}

template <int D>
constexpr size_t fwd_smem() {
  return (2 * kB * (D + 1) + kB * D + kB * kLdP) * sizeof(float);
}
template <int D>
constexpr size_t bwd_kv_smem() {
  return (4 * kB * (D + 1) + kB * D + 2 * kB * kLdP + 2 * kB) * sizeof(float);
}
template <int D>
constexpr size_t bwd_dq_smem() {
  return (4 * kB * (D + 1) + kB * kLdP + 2 * kB) * sizeof(float);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

struct Args {
  const void *q, *k, *v, *o, *g, *lse, *cos, *sin;
  void *out, *lse_out, *dq, *dk, *dv, *dq_acc;
  int B, H, Sq, Sk, causal;
  float c, scale;
  cudaStream_t st;
};

template <typename T, int D, bool ROPE>
int fwd(const Args& a) {
  auto kern = flash_fwd_kernel<T, D, ROPE>;
  cudaError_t err = set_smem(kern, fwd_smem<D>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + kB - 1) / kB, a.B * a.H);
  kern<<<grid, kThreads, fwd_smem<D>(), a.st>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const float*)a.cos,
      (const float*)a.sin, (T*)a.out, (float*)a.lse_out, a.H, a.Sq, a.Sk,
      a.causal, a.c);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool ROPE>
int bwd(const Args& a, bool fused) {
  const dim3 kv_grid((a.Sk + kB - 1) / kB, a.B * a.H);
  cudaError_t err;
  if (!fused) {
    auto dqk = flash_bwd_dq_kernel<T, D, ROPE>;
    if ((err = set_smem(dqk, bwd_dq_smem<D>())) != cudaSuccess)
      return (int)err;
    dim3 grid((a.Sq + kB - 1) / kB, a.B * a.H);
    dqk<<<grid, kThreads, bwd_dq_smem<D>(), a.st>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.o,
        (const T*)a.g, (const float*)a.lse, (const float*)a.cos,
        (const float*)a.sin, (T*)a.dq, a.H, a.Sq, a.Sk, a.causal, a.c,
        a.scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  auto kvk = fused ? flash_bwd_kv_kernel<T, D, ROPE, true>
                   : flash_bwd_kv_kernel<T, D, ROPE, false>;
  if ((err = set_smem(kvk, bwd_kv_smem<D>())) != cudaSuccess) return (int)err;
  kvk<<<kv_grid, kThreads, bwd_kv_smem<D>(), a.st>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.o,
      (const T*)a.g, (const float*)a.lse, (const float*)a.cos,
      (const float*)a.sin, (T*)a.dk, (T*)a.dv, (float*)a.dq_acc, a.H, a.Sq,
      a.Sk, a.causal, a.c, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (fused) {
    const size_t n = (size_t)a.B * a.Sq * a.H * D;
    dq_finalize_kernel<T, D, ROPE><<<(unsigned)((n + 255) / 256), 256, 0,
                                     a.st>>>(
        (const float*)a.dq_acc, (const float*)a.cos, (const float*)a.sin,
        (T*)a.dq, a.H, a.Sq, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// dtype x head dim x rope -> one instantiation
template <template <typename, int, bool> class Op>
int dispatch(int dtype, int D, int rope, const Args& a, bool fused) {
#define PTT_CASE(T, DD, R) \
  if (D == DD && (rope != 0) == R) return Op<T, DD, R>::run(a, fused);
  if (dtype == 0) {
    PTT_CASE(float, 64, false) PTT_CASE(float, 64, true)
    PTT_CASE(float, 128, false) PTT_CASE(float, 128, true)
  } else if (dtype == 1) {
    PTT_CASE(__nv_bfloat16, 64, false) PTT_CASE(__nv_bfloat16, 64, true)
    PTT_CASE(__nv_bfloat16, 128, false) PTT_CASE(__nv_bfloat16, 128, true)
  }
#undef PTT_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T, int D, bool ROPE>
struct FwdOp {
  static int run(const Args& a, bool) { return fwd<T, D, ROPE>(a); }
};
template <typename T, int D, bool ROPE>
struct BwdOp {
  static int run(const Args& a, bool fused) {
    return bwd<T, D, ROPE>(a, fused);
  }
};

}  // namespace

// Layouts: q/out [B, Sq, H, D], k/v [B, Sk, H, D], all contiguous in the
// input type (dtype 0 = float32, 1 = bfloat16); lse [B, H, Sq] float32;
// cos/sin [S, D] float32 (null without rope).  c = log2(e) / sqrt(D).
// Returns the launches' cudaGetLastError().
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             const void* cos, const void* sin, void* out,
                             void* lse, int B, int H, int Sq, int Sk, int D,
                             int causal, int rope, float c, int dtype,
                             void* stream) {
  Args a = {};
  a.q = q, a.k = k, a.v = v, a.cos = cos, a.sin = sin, a.out = out;
  a.lse_out = lse;
  a.B = B, a.H = H, a.Sq = Sq, a.Sk = Sk, a.causal = causal, a.c = c;
  a.st = (cudaStream_t)stream;
  return dispatch<FwdOp>(dtype, D, rope, a, false);
}

// fused = 1: the one-pass backward, adding dq into dq_acc ([B, Sq, H, D]
// float32, zeroed by the caller) and finishing it into dq; fused = 0: the
// two-kernel backward (dq_acc unused).  scale = 1 / sqrt(D).
extern "C" int ptt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const void* lse, const void* cos,
                             const void* sin, void* dq, void* dk, void* dv,
                             void* dq_acc, int B, int H, int Sq, int Sk,
                             int D, int causal, int rope, float c,
                             float scale, int dtype, int fused,
                             void* stream) {
  Args a = {};
  a.q = q, a.k = k, a.v = v, a.o = out, a.g = dout, a.lse = lse;
  a.cos = cos, a.sin = sin, a.dq = dq, a.dk = dk, a.dv = dv;
  a.dq_acc = dq_acc;
  a.B = B, a.H = H, a.Sq = Sq, a.Sk = Sk, a.causal = causal, a.c = c;
  a.scale = scale, a.st = (cudaStream_t)stream;
  return dispatch<BwdOp>(dtype, D, rope, a, fused != 0);
}
