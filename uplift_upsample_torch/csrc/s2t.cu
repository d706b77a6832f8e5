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
// (`s2t_prologue_bf16`): gemm_tc.cuh's native bf16 mode on W's bf16 plane
// (torch.bfloat16), the same epilogue.

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
  __device__ __forceinline__ float value(int col, float v, float m, float pe_v) const {
    v += bias[col];
    if (mask) v = m * v + (1.f - m) * token[col];
    return v + pe_v;
  }
  __device__ __forceinline__ void operator()(int r, int col, float v) const {
    out[(size_t)r * c + col] =
        value(col, v, mask ? mask[r] : 0.f, pe[(size_t)(r % pe_rows) * c + col]);
  }
  bool quads() const { return c % 4 == 0 && uu::aligned16(pe) && uu::aligned16(out); }
  struct Ld {
    float4 pe;
    float m;
  };
  __device__ __forceinline__ Ld load4(int r, int col) const {
    return {uu::ld4(pe + (size_t)(r % pe_rows) * c + col), mask ? mask[r] : 0.f};
  }
  __device__ __forceinline__ void store4(int r, int col, float4 v, const Ld& l) const {
    uu::st4(out + (size_t)r * c + col,
            make_float4(value(col, v.x, l.m, l.pe.x), value(col + 1, v.y, l.m, l.pe.y),
                        value(col + 2, v.z, l.m, l.pe.z), value(col + 3, v.w, l.m, l.pe.w)));
  }
};

// BiasTokenPe written by the consumers (gemm_tc.cuh's kDirect): the
// row's mask and PE row read once a tile, the bias, token and PE from the
// caches; nothing comes in by TMA. The same arithmetic.
struct BiasTokenPeDirect {
  static constexpr bool kTmaStore = false, kDirect = true;
  struct Maps {
    CUtensorMap in[1];
  };
  struct Row {
    float m;
    const float* pe;
  };
  BiasTokenPe e;
  bool quads() const { return false; }
  __device__ __forceinline__ bool tile_in() const { return false; }
  __device__ __forceinline__ Row row(int r) const {
    return {e.mask ? e.mask[r] : 0.f, e.pe + (size_t)(r % e.pe_rows) * e.c};
  }
  __device__ __forceinline__ void put(int r, int col, float v0, float v1, float2,
                                      const Row& row) const {
    const float2 pe = *reinterpret_cast<const float2*>(row.pe + col);
    *reinterpret_cast<float2*>(e.out + (size_t)r * e.c + col) =
        make_float2(e.value(col, v0, row.m, pe.x), e.value(col + 1, v1, row.m, pe.y));
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

// The bf16 rung: plane (c, k) bf16, w rounded to bf16 and transposed; sp
// rounded as it is read; the output written by the consumers
// (BiasTokenPeDirect); k % 8 == 0, c % 4 == 0, 16-byte aligned out.
extern "C" int s2t_prologue_bf16(const float* sp, const void* plane, const float* bias,
                                 const float* mask, const float* token, const float* pe,
                                 float* out, int rows, int c, int k, int pe_rows,
                                 void* stream) {
  if (pe_rows <= 0 || (mask && !token) || c % 4 || !uu::aligned16(out) || !uu::aligned16(pe))
    return cudaErrorInvalidValue;
  return uu::launch_gemm_bf16(sp, plane, rows, c, k,
                              BiasTokenPeDirect{{bias, mask, token, pe, out, c, pe_rows}},
                              (cudaStream_t)stream);
}
