// Dequant-on-use of int8 serving weights for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference dequantizes its int8 weight
// tree inside each compiled serving step, where XLA fuses the expression
// into the consuming matmuls (paddle_tpu/quantization/functional.py
// dequantize_param_tree, traced by paddle_tpu/jit/serving_step.py
// _materialize_params).  The port runs its matmuls eagerly, so this pass
// writes one decoder layer's projection weights (or the LM head) into a
// scratch buffer that the layer's matmuls then read.  out = q * (scale /
// 127), computed in fp32 and rounded to nearest even to the model dtype,
// per output channel (a row of a [out, in] weight).
//
// Input: the int8 codes of up to 8 weights held back to back in one
// buffer, each [rows_i, cols_i] row-major, and one fp32 scale per row of
// all of them, in the same order.  Output: the same layout in float32
// (dtype code 0) or bfloat16 (code 1).
//
// Bound on the card: bytes.  Each code is read once and each output
// written once (1 + 2 bytes an element in bf16) with one multiply, far
// below the ~295 operations per byte where the card turns compute bound.
// The design is one block per weight row (its scale read once), 16 codes
// a thread in one 16-byte load and the outputs in 16-byte stores,
// neighbouring threads on neighbouring addresses; a row whose width or
// offset is not a multiple of 16 takes a one-element-a-thread loop.
//
// Bit identity with the plain PyTorch version (dequantize_param_tree's
// expression): scale / 127 is an IEEE division (__fdiv_rn), the product
// __fmul_rn, the cast round-to-nearest-even, as torch computes them.
#include "common.cuh"

namespace {

constexpr int kMaxSegs = 8;

struct Segs {
  long long elem_off[kMaxSegs];  // first element of each weight
  int row_off[kMaxSegs + 1];     // first row (and scale) of each weight
  int cols[kMaxSegs];
  int n;
};

template <typename T>
__global__ void dequant_int8_kernel(const int8_t* __restrict__ codes,
                                    const float* __restrict__ scales,
                                    T* __restrict__ out, Segs segs,
                                    int aligned) {
  const int row = blockIdx.x;
  int s = 0;
  while (s + 1 < segs.n && row >= segs.row_off[s + 1]) ++s;
  const int cols = segs.cols[s];
  const long long base =
      segs.elem_off[s] + (long long)(row - segs.row_off[s]) * cols;
  const float f = __fdiv_rn(scales[row], 127.f);
  const int8_t* src = codes + base;
  T* dst = out + base;
  if (aligned && (cols & 15) == 0 && (base & 15) == 0) {
    for (int i = threadIdx.x * 16; i < cols; i += blockDim.x * 16) {
      const int4 c = *reinterpret_cast<const int4*>(src + i);
      const int8_t* b = reinterpret_cast<const int8_t*>(&c);
      __align__(16) T v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        v[j] = ptt::from_f32<T>(__fmul_rn((float)b[j], f));
      uint4* d = reinterpret_cast<uint4*>(dst + i);
      const uint4* w = reinterpret_cast<const uint4*>(v);
#pragma unroll
      for (int j = 0; j < (int)(16 * sizeof(T) / 16); ++j) d[j] = w[j];
    }
  } else {
    for (int i = threadIdx.x; i < cols; i += blockDim.x)
      dst[i] = ptt::from_f32<T>(__fmul_rn((float)src[i], f));
  }
}

}  // namespace

// seg: n_seg (rows, cols) pairs on the host, in buffer order.  dtype: 0 =
// float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int ptt_dequant_int8(const void* codes, const void* scales,
                                void* out, const long long* seg, int n_seg,
                                int dtype, void* stream) {
  if (n_seg < 1 || n_seg > kMaxSegs) return (int)cudaErrorInvalidValue;
  Segs segs;
  segs.n = n_seg;
  long long elems = 0;
  long long rows = 0;
  for (int i = 0; i < n_seg; ++i) {
    const long long r = seg[2 * i], c = seg[2 * i + 1];
    if (r < 1 || c < 1 || rows + r > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    segs.elem_off[i] = elems;
    segs.row_off[i] = (int)rows;
    segs.cols[i] = (int)c;
    elems += r * c;
    rows += r;
  }
  segs.row_off[n_seg] = (int)rows;
  const int aligned =
      (((uintptr_t)codes | (uintptr_t)out) & 15) == 0 ? 1 : 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 128;
  if (dtype == 0)
    dequant_int8_kernel<float><<<(unsigned)rows, threads, 0, st>>>(
        (const int8_t*)codes, (const float*)scales, (float*)out, segs,
        aligned);
  else if (dtype == 1)
    dequant_int8_kernel<__nv_bfloat16><<<(unsigned)rows, threads, 0, st>>>(
        (const int8_t*)codes, (const float*)scales, (__nv_bfloat16*)out,
        segs, aligned);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
