// Row 11 on the bf16 rung and on bf16 tensors: the compile-time modes of
// attention.cu's three kernels (packed_attention.cuh, attention.cuh).
//
// Replaces: uplift_upsample_tpu/ops/pallas_attention.py
//   packed_multihead_attention (:75, pallas_call at :113) under
//   `jax.default_matmul_precision("default")` (the eval's one-pass bf16
//   rung) and on the bf16 q, k and v that COMPUTE_DTYPE bfloat16 hands it
//   (:63-66; its output takes q's dtype, :118).
//
// What it computes (pallas_attention._head_attention, :33-50):
//  - the bf16 rung: at head depth D <= 8 (the spatial blocks' 4) the logits
//    are fp32 FMAs with no rounding; beyond 8 (the temporal and strided
//    blocks' 48) bf16(q)·bf16(k) with fp32 sums; the logits scaled after the
//    product and masked; the softmax in fp32; P·V on bf16(normalised P) and
//    bf16(v), fp32 sums. The long sequences take attention.cuh's BF16 mode
//    without QS, whose logits' factor is log2(e)/sqrt(D);
//  - bf16 tensors: loaded as bf16, the rung's function with fp32-level sums
//    (the short kernels widen in registers; the long sequences take
//    attention.cuh's head_attention_bf16_kernel, native bf16 products on
//    bf16 tiles), the context rounded to bf16 (to nearest even) as it is
//    stored. No fp32 copy of q, k, v or the output is made.
//
// Bound: as attention.cu's, bytes; bf16 tensors halve them. The products on
// the tensor cores at 989 TFLOP/s (bf16) take a fraction of the bytes' time.
// A library of its own so that nvcc builds its ~60 instantiations of the
// tensor-core kernel beside attention.cu's, not after them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "packed_attention.cuh"

// fp32 tensors on the bf16 rung.
extern "C" int packed_attention_bf16(const float* q, const float* k, const float* v,
                                     const float* key_mask, float* out, int frames, int s,
                                     int c, int heads, void* stream) {
  return uu::packed_attention<true>(q, k, v, key_mask, out, frames, s, c, heads,
                                    (cudaStream_t)stream);
}

// bf16 tensors (q, k, v, out), fp32-level products ("high", "highest").
extern "C" int packed_attention_bf16io(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                       const __nv_bfloat16* v, const float* key_mask,
                                       __nv_bfloat16* out, int frames, int s, int c, int heads,
                                       void* stream) {
  return uu::packed_attention<false>(q, k, v, key_mask, out, frames, s, c, heads,
                                     (cudaStream_t)stream);
}

// bf16 tensors on the bf16 rung.
extern "C" int packed_attention_bf16io_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                            const __nv_bfloat16* v, const float* key_mask,
                                            __nv_bfloat16* out, int frames, int s, int c,
                                            int heads, void* stream) {
  return uu::packed_attention<true>(q, k, v, key_mask, out, frames, s, c, heads,
                                    (cudaStream_t)stream);
}
