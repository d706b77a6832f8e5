// Native bf16 on the tensor cores through mma.sync, for the attention
// kernels whose tiles are bf16 in shared memory: row 11 on bf16 tensors
// (attention.cuh, head_attention_bf16_kernel) and the window-attention
// backward's bf16 rung (temporal_bwd.cu); pack_bf16 serves gemm_tc.cuh too.
//
// mma.sync.m16n8k16 (bf16 operands, fp32 sums) takes twice the depth of the
// m16n8k8 TF32 product per instruction at the same issue cost, and its
// operands are bf16 pairs: a tile of bf16 rows in shared memory gives its
// fragments by ldmatrix (four 8x8 matrices a warp, transposed on the way
// where the product wants the tile's columns), and a fragment of sums leaves
// as bf16 pairs by stmatrix. A bf16 value times a bf16 value is exact in
// fp32, so a product of two bf16 operands loses nothing before its sum.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace uu {

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes 0 fills
// dst with zeros.
__device__ __forceinline__ void cp_async16_bytes(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(shared_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 (16 bytes, 16-byte aligned). Lane (g, t) = (l / 4, l % 4) receives in
// r[m] matrix m's row g, columns 2t and 2t+1 (the low half the first).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(shared_addr(row)));
}

// ldmatrix_x4 transposed: lane (g, t) receives matrix m's rows 2t and 2t+1
// of column g.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(shared_addr(row)));
}

// Four 8x8 bf16 matrices stored transposed: lane (g, t) holds in r[m] matrix
// m's row g, columns 2t and 2t+1; lane l gives the address of row l % 8 of
// matrix l / 8's transpose, which receives the matrix's column l % 8.
__device__ __forceinline__ void stmatrix_x4_trans(void* row, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :: "r"(shared_addr(row)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// d += a·b on one m16n8k16 tile, bf16 operands, fp32 sums: a (16 x 16,
// row-major) as four pairs: rows g and g+8 of columns 2t.., then the same of
// columns 8+2t..; b (16 x 8, k by n) as two pairs: rows 2t.. and 8+2t.. of
// column g; d rows g, g+8 of columns 2t, 2t+1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 (to nearest, ties to even, as tf32.cuh's
// bf16_round) and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float bf16_lo(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }

}  // namespace uu
