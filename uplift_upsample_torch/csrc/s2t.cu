// The s2t prologue — the spatial-to-temporal Dense, the strided-input token
// and the temporal PE, as one GEMM with a fused epilogue.
//
// Replaces: uplift_upsample_tpu/ops/pallas_temporal_v3.py
//   fused_temporal_stack_v3_tiled's prologue (_make_kernel_v3 with s2t=True,
//   :156-168), which the TPU computes inside the tiled temporal kernel on the
//   (P*C_sp, R) spatial tile. Per frame row r of (B*N, P*C_sp):
//     out[r] = m_r * (sp[r] @ W + b) + (1 - m_r) * token + pe[r mod N]
//   with m the stride mask (1 on frames carrying real input, the reference
//   model's order: uplift_upsample_transformer.py:332-352). Without a mask
//   every m_r is 1 (a model without strided input).
//
// Bound: at h36m_351 (B*N = 72,704 rows, K = 544, C = 384) the product is
// 30.4 GFLOP against ~271 MB of input and output. On the tensor cores in
// 3xTF32 (three TF32 products per fp32 one) the operations bound it: 3 x 30.4
// GFLOP at the 495 TFLOP/s dense TF32 peak is 0.184 ms, the bytes 0.081 ms.
// Design: gemm_tc.cuh's wgmma GEMM (TMA ring, A split into TF32 halves in
// registers, W's halves from shared memory), with an epilogue that applies
// the bias, the token select and the PE as each output element leaves the
// accumulator registers, so the Dense's output is written once and never
// read back. W's halves come from `tf32_halves_f32` (temporal.cu), split
// once when the operands are prepared (ops/s2t.py s2t_params). The bf16 rung
// (`s2t_prologue_bf16`): gemm_tc.cuh's bf16 mode on W's bf16-rounded plane,
// the same epilogue.

#include <cuda_runtime.h>

#include "gemm_tc.cuh"

namespace {

struct BiasTokenPe {
  const float* bias;   // (c,)
  const float* mask;   // (rows,), 1 = real input; null = all real
  const float* token;  // (c,); read only where mask is 0
  const float* pe;     // (pe_rows, c)
  float* out;          // (rows, c)
  int c, pe_rows;
  __device__ __forceinline__ void operator()(int r, int col, float v) const {
    v += bias[col];
    if (mask) {
      const float m = mask[r];
      v = m * v + (1.f - m) * token[col];
    }
    out[(size_t)r * c + col] = v + pe[(size_t)(r % pe_rows) * c + col];
  }
};

}  // namespace

// sp: (rows, k) row-major, k % 4 == 0; split (2, c, k): the TF32 halves of
// the Dense's (in, out) kernel w (k, c), transposed (temporal.cu's
// tf32_halves_f32).
extern "C" int s2t_prologue_f32(const float* sp, const float* split, const float* bias,
                                const float* mask, const float* token, const float* pe,
                                float* out, int rows, int c, int k, int pe_rows,
                                void* stream) {
  if (pe_rows <= 0 || (mask && !token)) return cudaErrorInvalidValue;
  return uu::launch_gemm_tc(sp, split, rows, c, k,
                            BiasTokenPe{bias, mask, token, pe, out, c, pe_rows},
                            (cudaStream_t)stream);
}

// The bf16 rung: plane (c, k), w's bf16-rounded plane transposed.
extern "C" int s2t_prologue_bf16(const float* sp, const float* plane, const float* bias,
                                 const float* mask, const float* token, const float* pe,
                                 float* out, int rows, int c, int k, int pe_rows,
                                 void* stream) {
  if (pe_rows <= 0 || (mask && !token)) return cudaErrorInvalidValue;
  return uu::launch_gemm_tc<true>(sp, plane, rows, c, k,
                                  BiasTokenPe{bias, mask, token, pe, out, c, pe_rows},
                                  (cudaStream_t)stream);
}
