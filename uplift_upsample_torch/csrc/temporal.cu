// K2 — the temporal transformer stack, as a few hand-written kernels per block.
//
// Replaces: uplift_upsample_tpu/ops/pallas_temporal_v3.py
//   fused_temporal_stack_v3 (kernel _make_kernel_v3, attn_mode="full"): 4
//   pre-norm blocks over (B, 71, 384), 8 heads of depth 48, relu MLP
//   384 -> 768 -> 384, additive -1e9 key mask on stride-masked frames for the
//   first `first_masked_blocks` blocks. K3 (strided.cu) reuses these kernels.
//
// What bounds it here: the dense layers, ~0.17 TFLOP per block at B=1,024
// windows. They run on the tensor cores in 3xTF32 (gemm_tc.cuh: persistent
// TMA + wgmma, fp32-level error), bound by operations at 3 x 0.17 TFLOP per
// block over the 495 TFLOP/s TF32 peak (1.04 ms); W's TF32 halves are split
// once, when the operands are stacked (`tf32_halves_f32`). The weights (4.7
// MB per block in fp32) do not fit in shared memory, so one block is seven
// launches: LayerNorm, qkv GEMM, window attention, proj GEMM (+ residual),
// LayerNorm, fc1 GEMM (+ relu), fc2 GEMM (+ residual). The activations of
// one launch stay in L2 (50 MB) for the next where they fit.
//
// Design: rows are the B*71 real tokens; no 72-token padding, no
// block-diagonal window mask (the TPU kernel's Mosaic workarounds): each
// attention thread block owns one (window, head) and attends only inside it
// (attention.cuh, shared with row 11's packed attention).
//
// The bf16 rung (the TPU's one-pass DEFAULT dots): `gemm_bf16` and
// `window_attention_bf16` launch the same kernels' bf16 instances (operands
// rounded to bf16, one TF32 pass, fp32 sums; gemm_tc.cuh, attention.cuh),
// the GEMM on W's bf16-rounded plane; the LayerNorm is the same fp32 kernel.
// Bound at 1,024 windows: ~0.17 TFLOP per block at the 989 TFLOP/s dense
// bf16 peak, 0.18 ms; this simple instance runs one TF32 pass (495 TFLOP/s).

#include <cuda_runtime.h>
#include <math.h>

#include "attention.cuh"
#include "gemm.cuh"
#include "gemm_tc.cuh"

namespace {

// One warp per row of c values: y = LN(x + pe) * gamma + beta; optionally
// also writes x + pe to x_out (the residual stream of a block that adds a PE).
__global__ void layernorm_kernel(const float* __restrict__ x, const float* __restrict__ pe,
                                 const float* __restrict__ gamma, const float* __restrict__ beta,
                                 float* x_out, float* __restrict__ y, int rows, int c,
                                 int pe_rows, float eps) {
  const int warps = blockDim.x / 32;
  const int row = blockIdx.x * warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * c;
  const float* pr = pe ? pe + (size_t)(row % pe_rows) * c : nullptr;
  float s = 0.f;
  for (int e = lane; e < c; e += 32) s += pr ? xr[e] + pr[e] : xr[e];
  const float mu = uu::warp_sum(s) / c;
  float v = 0.f;
  for (int e = lane; e < c; e += 32) {
    const float d = (pr ? xr[e] + pr[e] : xr[e]) - mu;
    v += d * d;
  }
  const float inv = 1.f / sqrtf(uu::warp_sum(v) / c + eps);
  for (int e = lane; e < c; e += 32) {
    const float xv = pr ? xr[e] + pr[e] : xr[e];
    if (x_out) x_out[(size_t)row * c + e] = xv;
    y[(size_t)row * c + e] = (xv - mu) * inv * gamma[e] + beta[e];
  }
}

}  // namespace

// out (m, n) = act(a . w + bias) + residual; a (m, k) row-major, k % 4 == 0;
// halves (2, n, k): w's TF32 halves transposed (tf32_halves_f32); bias and
// residual optional, residual may alias out.
extern "C" int gemm_f32(const float* a, const float* halves, const float* bias,
                        const float* residual, float* out, int m, int n, int k,
                        int relu, void* stream) {
  return uu::launch_gemm_tc(a, halves, m, n, k,
                            uu::BiasActResidual{bias, residual, out, n, relu},
                            (cudaStream_t)stream);
}

// gemm_f32 on the bf16 rung: plane (n, k), w's bf16-rounded plane transposed.
extern "C" int gemm_bf16(const float* a, const float* plane, const float* bias,
                         const float* residual, float* out, int m, int n, int k,
                         int relu, void* stream) {
  return uu::launch_gemm_tc<true>(a, plane, m, n, k,
                                  uu::BiasActResidual{bias, residual, out, n, relu},
                                  (cudaStream_t)stream);
}

// w (batch, k, n) row-major -> halves (batch, 2, n, k) with transpose (for
// x . w), else (batch, 2, k, n) (for dy . w^T): [0] = tf32(w), [1] = w - [0].
extern "C" int tf32_halves_f32(const float* w, float* halves, int batch, int k, int n,
                               int transpose, void* stream) {
  return uu::launch_tf32_halves(w, halves, batch, k, n, transpose, (cudaStream_t)stream);
}

extern "C" int layernorm_f32(const float* x, const float* pe, const float* gamma,
                             const float* beta, float* x_out, float* y, int rows,
                             int c, int pe_rows, float eps, void* stream) {
  if (rows <= 0 || c <= 0 || (pe && pe_rows <= 0)) return cudaErrorInvalidValue;
  const int warps = 8;
  layernorm_kernel<<<(rows + warps - 1) / warps, warps * 32, 0, (cudaStream_t)stream>>>(
      x, pe, gamma, beta, x_out, y, rows, c, pe_rows, eps);
  return cudaGetLastError();
}

extern "C" int window_attention_f32(const float* qkv, const float* key_mask, float* out,
                                    int windows, int n, int c, int heads, void* stream) {
  return uu::launch_head_attention(qkv, qkv + c, qkv + 2 * c, 3 * c, key_mask, out, windows,
                                   n, c, heads, (cudaStream_t)stream);
}

extern "C" int window_attention_bf16(const float* qkv, const float* key_mask, float* out,
                                     int windows, int n, int c, int heads, void* stream) {
  return uu::launch_head_attention<true>(qkv, qkv + c, qkv + 2 * c, 3 * c, key_mask, out,
                                         windows, n, c, heads, (cudaStream_t)stream);
}
