// K3 — the strided conv of strided block 1, computing only the selected rows.
//
// Replaces: uplift_upsample_tpu/ops/pallas_strided.py make_strided_b1_epilogue
//   (fused into the last call of fused_temporal_stack_v3). Strided block 1 is
//   PE, LN, qkv, full-window attention, proj, residual, LN, fc1 + relu (the
//   GEMM, LayerNorm and attention kernels of temporal.cu, no key mask), then
//   this kernel: a k=3 conv with stride s0 plus the residual.
//
// The TPU epilogue computes the conv at every token with lane shifts and the
// caller keeps every s0-th; here each output row t is computed directly:
//   out[b, t] = x[b, s0*t + (p0 == 0)] + bc + sum_j h1[b, s0*t + j - p0] . W_j
// where a tap outside [0, N) reads zero. That covers paddings (0,0) (crop-1
// residual, h36m_351) and (1,1) (zero-padded conv, uncropped residual, h36m_81).
//
// Bound: a GEMM of (B*n_out) x (3*hidden) x C. In 3xTF32 operations: at
// serving 23,552 x 2,304 x 384 = 41.7 GFLOP, three TF32 products each, 0.253
// ms at the 495 TFLOP/s TF32 peak, against 0.087 ms for its ~290 MB. On the
// bf16 rung bytes: the products take 0.042 ms at the 989 TFLOP/s bf16 peak.
// Design: the persistent TMA + wgmma kernel of gemm_tc.cuh (a fresh partial
// per 32-deep stage: K = 2,304 is 72 of them) with A = the taps matrix T
// read by TMA's im2col mode from h1 (conv_taps.cuh ConvTapsTma: a box a
// stage of 128 of T's rows across windows, each tap's rows s0 apart, zeros
// for taps outside the window), so neither T, the padded h1 nor the
// unselected rows are ever written; the tiles are a dense A's 128 rows
// (whole windows, 11 x 11 = 121 rows at h36m_81, took 141 tiles where 132
// SMs run 132 at once: two rounds, 0.1753 ms against 0.1518 before, NVIDIA
// H100 80GB HBM3, 700 W), and the epilogue warps write them from the
// staged sums under the next tile's products. Wc's TF32 halves are
// split once, with the block's dense matrices (ops/strided.py). The bf16
// rung (`strided_conv_bf16`): native bf16, Wc's bf16 plane (torch.bfloat16,
// prepared with the block's operands) by TMA, T rounded to bf16 pairs
// (cvt.rn.bf16x2) into wgmma's register operand, wgmma k16 with fp32 sums.

#include <cuda_runtime.h>

#include "conv_taps.cuh"

namespace {

struct ConvResidual {
  const float* x;  // (windows * n, c) block input after attention
  const float* bias;
  float* out;  // (windows * n_out, c)
  int n, c, n_out, stride, res_off;
  __device__ __forceinline__ void operator()(int r, int col, float v) const {
    const int b = r / n_out, t = r - b * n_out;
    out[(size_t)r * c + col] =
        x[((size_t)b * n + stride * t + res_off) * c + col] + (v + bias[col]);
  }
  bool quads() const { return c % 4 == 0 && uu::aligned16(x) && uu::aligned16(out); }
  struct Ld {
    float4 x;
  };
  __device__ __forceinline__ Ld load4(int r, int col) const {
    const int b = r / n_out, t = r - b * n_out;
    return {uu::ld4(x + ((size_t)b * n + stride * t + res_off) * c + col)};
  }
  __device__ __forceinline__ void store4(int r, int col, float4 v, const Ld& l) const {
    uu::st4(out + (size_t)r * c + col,
            make_float4(l.x.x + (v.x + bias[col]), l.x.y + (v.y + bias[col + 1]),
                        l.x.z + (v.z + bias[col + 2]), l.x.w + (v.w + bias[col + 3])));
  }
};

template <int kMode>
int conv(const float* h1, const float* x, const void* w, const float* bias, float* out,
         int windows, int n, int hidden, int c, int stride, int p0, int n_out, void* stream) {
  if (windows <= 0 || n_out <= 0 || stride <= 0 || stride > uu::CONV_MAX_STRIDE || p0 < 0 ||
      p0 > 1 || hidden <= 0 || hidden % 4 || c <= 0 || !uu::aligned16(h1) || !uu::aligned16(w))
    return cudaErrorInvalidValue;
  const int res_off = p0 == 0 ? 1 : 0;
  if (stride * (n_out - 1) + res_off >= n) return cudaErrorInvalidValue;
  const uu::ConvTapsTma taps{{}, n_out, stride, p0, hidden, (hidden + uu::TC_BK - 1) / uu::TC_BK};
  CUtensorMap map_a, map_w;
  if (!uu::make_taps_map(&map_a, h1, hidden, n, windows, stride, p0, n_out))
    return cudaErrorInvalidValue;
  const int k = 3 * hidden;
  if (kMode == uu::TC_BF16 ? !uu::make_bf16_tile_map(&map_w, w, c, k)
                           : !uu::make_w_map(&map_w, static_cast<const float*>(w), c, k, c))
    return cudaErrorInvalidValue;
  return uu::launch_tc<kMode>(map_a, taps, map_w, c, windows * n_out, c, k,
                              ConvResidual{x, bias, out, n, c, n_out, stride, res_off},
                              (cudaStream_t)stream);
}

}  // namespace

// halves (2, c, 3 * hidden): the TF32 halves of Wc transposed (tf32_halves_f32
// of the flax Conv1D kernel (3, hidden, c) flattened to (3 * hidden, c)).
extern "C" int strided_conv_f32(const float* h1, const float* x, const float* halves,
                                const float* bias, float* out, int windows, int n,
                                int hidden, int c, int stride, int p0, int n_out,
                                void* stream) {
  return conv<uu::TC_3XTF32>(h1, x, halves, bias, out, windows, n, hidden, c, stride, p0,
                             n_out, stream);
}

// The bf16 rung: plane (c, 3 * hidden) bf16, Wc rounded to bf16 and transposed.
extern "C" int strided_conv_bf16(const float* h1, const float* x, const void* plane,
                                 const float* bias, float* out, int windows, int n,
                                 int hidden, int c, int stride, int p0, int n_out,
                                 void* stream) {
  return conv<uu::TC_BF16>(h1, x, plane, bias, out, windows, n, hidden, c, stride, p0, n_out,
                           stream);
}
