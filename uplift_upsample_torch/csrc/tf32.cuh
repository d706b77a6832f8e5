// 3xTF32 on the tensor cores: fp32-level products from TF32 instructions.
//
// Each fp32 operand x is split into big = tf32(x), rounded to nearest, and
// small = x - big, and a product takes big·big + big·small + small·big with
// fp32 accumulation. The tensor cores read a TF32 operand's top 19 bits, so
// small enters truncated to TF32; with the dropped small·small term that
// leaves an error of about 2^-21 of each product, near fp32's own rounding,
// where one TF32 pass keeps 10 bits. Shared by the window attention
// (attention.cuh, mma.sync) and the tensor-core GEMMs (gemm_tc.cuh: wgmma
// for A·B, mma.sync for the backward's Xᵀ·dY).
//
// The bf16 mode (the TPU's one-pass DEFAULT precision, a compile-time
// choice of each kernel that takes it): each operand rounded to bf16
// (bf16_round) is a TF32 operand with its low bits zero, so one TF32
// product per pair computes the rounded operands' product exactly, summed
// in fp32.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace uu {

// x rounded to TF32 (nearest, ties away from zero), as cvt.rna.tf32.f32 does,
// in integer operations, which issue faster than that conversion: add half
// a TF32 ulp to the bits, clear the 13 low bits. Infinities and NaNs keep
// their bits (and stay what they are).
__device__ __forceinline__ uint32_t tf32_round(float x) {
  uint32_t bits = __float_as_uint(x);
  if (fabsf(x) < INFINITY) bits += 0x1000u;
  return bits & 0xffffe000u;
}

// Four integer and float operations per element: the split's cost is what
// binds the attention kernel, and rounding small too (three more) bought no
// accuracy on the card.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_round(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// x rounded to bf16 (to nearest, ties to even: cvt.rn.bf16.f32), widened
// back to 32 bits: the bits of an exact TF32 operand.
__device__ __forceinline__ uint32_t bf16_round(float x) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(h) : "f"(x));
  return static_cast<uint32_t>(h) << 16;
}

__device__ __forceinline__ float bf16_roundf(float x) { return __uint_as_float(bf16_round(x)); }

// 16 bytes from global to shared memory, asynchronously; src_bytes 0 fills
// dst with zeros (the ragged edge of a tile).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

// d += a·b on one m16n8k8 tile: a row-major 16x8, b 8x8 (k by n), fp32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big);
  mma_tf32(d, a_big, b_small);
  mma_tf32(d, a_big, b_big);
}

}  // namespace uu
