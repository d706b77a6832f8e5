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
// 30.4 GFLOP against ~271 MB of input and output, so fp32 operations bound it
// (0.45 ms at 67 TFLOP/s). Design: gemm.cuh's tile loop with its row-major
// loaders, and an epilogue that applies the bias, the token select and the PE
// as each output element leaves the registers, so the Dense's output is
// written once and never read back.

#include <cuda_runtime.h>

#include "gemm.cuh"

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

// sp: (rows, k) row-major; w: (k, c) row-major, the Dense's (in, out) kernel.
extern "C" int s2t_prologue_f32(const float* sp, const float* w, const float* bias,
                                const float* mask, const float* token, const float* pe,
                                float* out, int rows, int c, int k, int pe_rows,
                                void* stream) {
  if (pe_rows <= 0 || (mask && !token)) return cudaErrorInvalidValue;
  return uu::launch_gemm(uu::RowMajorA{sp, k}, uu::RowMajorB{w, c}, rows, c, k,
                         BiasTokenPe{bias, mask, token, pe, out, c, pe_rows},
                         (cudaStream_t)stream);
}
