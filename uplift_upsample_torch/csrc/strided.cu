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
// Bound: a GEMM of (B*n_out) x (3*hidden) x C, operations: at serving
// 23,552 x 2,304 x 384 = 41.7 GFLOP, three TF32 products each in 3xTF32,
// 0.253 ms at the 495 TFLOP/s TF32 peak, against 0.087 ms for its ~290 MB.
// Design: the persistent TMA + wgmma kernel of gemm_tc.cuh (3xTF32, a fresh
// partial per 32-deep stage: K = 2,304 is 72 of them), with A = the taps
// matrix T gathered from h1 by the producer warpgroup (conv_taps.cuh:
// cp.async, zero-fill for taps outside the window), so neither T, the padded
// h1 nor the unselected rows are ever written. Wc's TF32 halves are split
// once, with the block's dense matrices (ops/strided.py). The bf16 rung
// (`strided_conv_bf16`): the same kernel's bf16 mode, T rounded to bf16 as
// it leaves shared memory, one TF32 pass on Wc's bf16-rounded plane.

#include <cuda_runtime.h>

#include "conv_taps.cuh"
#include "gemm_tc.cuh"

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
};

template <bool kBf16>
int conv(const float* h1, const float* x, const float* halves, const float* bias, float* out,
         int windows, int n, int hidden, int c, int stride, int p0, int n_out, void* stream) {
  if (windows <= 0 || n_out <= 0 || stride <= 0 || p0 < 0 || p0 > 1 || hidden <= 0 ||
      hidden % 4 || reinterpret_cast<uintptr_t>(h1) % 16)
    return cudaErrorInvalidValue;
  const int res_off = p0 == 0 ? 1 : 0;
  if (stride * (n_out - 1) + res_off >= n) return cudaErrorInvalidValue;
  return uu::launch_gemm_tc_gather<kBf16>(
      uu::ConvTaps{h1, windows, n, hidden, n_out, stride, p0}, halves, windows * n_out, c,
      3 * hidden, ConvResidual{x, bias, out, n, c, n_out, stride, res_off},
      (cudaStream_t)stream);
}

}  // namespace

// halves (2, c, 3 * hidden): the TF32 halves of Wc transposed (tf32_halves_f32
// of the flax Conv1D kernel (3, hidden, c) flattened to (3 * hidden, c)).
extern "C" int strided_conv_f32(const float* h1, const float* x, const float* halves,
                                const float* bias, float* out, int windows, int n,
                                int hidden, int c, int stride, int p0, int n_out,
                                void* stream) {
  return conv<false>(h1, x, halves, bias, out, windows, n, hidden, c, stride, p0, n_out,
                     stream);
}

// The bf16 rung: plane (c, 3 * hidden), Wc's bf16-rounded plane transposed.
extern "C" int strided_conv_bf16(const float* h1, const float* x, const float* plane,
                                 const float* bias, float* out, int windows, int n,
                                 int hidden, int c, int stride, int p0, int n_out,
                                 void* stream) {
  return conv<true>(h1, x, plane, bias, out, windows, n, hidden, c, stride, p0, n_out,
                    stream);
}
