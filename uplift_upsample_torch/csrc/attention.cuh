// Shared device code of K2's window attention (temporal.cu) and row 11's
// packed attention (attention.cu): softmax(q kᵀ · scale + mask · -1e9) v per
// (sequence, head), one thread block each, on the tensor cores.
//
// Replaces: uplift_upsample_tpu/ops/pallas_attention.py
//   packed_multihead_attention (:75, pallas_call at :113) for sequences of
//   more than 1,536 / C tokens, and the window attention inside
//   pallas_temporal_v3.py's temporal blocks (:248), which K2, K3, K5's and
//   K6's forward launch through `launch_head_attention`.
//
// q, k and v are read through base pointers and one row stride, so the same
// kernel serves K2's packed q|k|v rows (k = q + C, v = q + 2C, stride 3C) and
// row 11's three (F, S, C) tensors (stride C). The output is (F, S, C). Any
// S <= 128 and any head depth D whose tiles fit in shared memory. Row 11 on
// bf16 tensors (COMPUTE_DTYPE bfloat16) takes a kernel of its own below,
// head_attention_bf16_kernel: bf16 tiles and native bf16 products.
//
// What bounds it: bytes. At 1,024 windows x 71 tokens x 384 channels a call
// reads q, k and v and writes the context, 447 MB (0.133 ms at 3.35 TB/s);
// its 7.9 GFLOP would take 0.118 ms even on the CUDA cores, and 3xTF32 on
// the tensor cores triples the products at a ~7x higher peak. In practice
// the products bind it, not the copies (kernel_probe.py times the kernel
// without each part): the splits into TF32 halves (4 operations an element,
// tf32.cuh), the two extra mma.sync of each product and the warps' serial
// steps each take a share. The registers are sized for 4 blocks of 5 warps
// per SM, as many as the ~49 KB of shared memory a block stages allows.
//
// Design (Hopper):
//  - The block stages its head's q, k and v slices into shared memory with
//    16-byte cp.async copies (4-byte ones when D or the strides are not a
//    multiple of 4 floats), zero-filling the padding: queries to a multiple
//    of 16 (a warp's m16 tile; 71 -> 80), keys to a multiple of 8 (72), D to
//    a multiple of 8. Row pitches are chosen so that the fragment loads below
//    hit 32 distinct banks.
//  - Warp w owns query rows 16w..16w+15. Q·Kᵀ and P·V run as
//    mma.sync.m16n8k8 TF32 in the 3-term split (tf32.cuh), so the sums keep
//    fp32-level error. m16 tiles pad 71 queries to 80 rows; wgmma's 64-row
//    warpgroup tiles would pad them to 128.
//  - The logits stay in the accumulator registers: scale, mask, row max and
//    row sum (quad shuffles) and exp (in base 2) in place. The keys are
//    taken in a permuted order inside each 8-key step (A column t <-> key
//    2t, t+4 <-> 2t+1, and the same rows of V), so the accumulator fragment
//    of P is its A fragment for P·V with no shuffle; the same trick on D
//    lets q and k fragments load as float2.
//  - The additive mask is finite (-1e9 per blocked key), so a row whose real
//    keys are all blocked still takes a softmax over them. Padded keys
//    (j >= S) get -inf instead: with -1e9 they would share the weight of
//    such a row.
//  - The context is normalised by the row sum as it leaves the registers;
//    only the real query rows and the D real columns are written.
//  - The logits' factor `scale` (base 2) is the caller's: log2(e)/sqrt(D),
//    or log2(e) alone where q's columns of the qkv weights carry 1/sqrt(D)
//    already (K2's and K3's operands, folded as the TPU's eval kernels fold
//    them: `_transposed_operands(q_scale=)`, pallas_temporal_v3.py:319-322).
//  - The bf16 mode (BF16, the one-pass bf16 rung; K2's and K3's
//    `window_attention_bf16`, row 11's `packed_attention_bf16`): q and k
//    rounded to bf16 as they are loaded (the logits' factor after the
//    product, as the TPU's DEFAULT dot on q and k computes them), and P·V on
//    the probabilities normalised first, then rounded, with v rounded: one
//    TF32 product per pair of rounded operands (tf32.cuh), fp32 sums.
//  - Its training variant (QS, K5's and K6's `window_attention_train_bf16`,
//    temporal_bwd.cu): q multiplied by 1/sqrt(D) before it is rounded, the
//    logits then only carry log2(e), as the TPU's training kernel scales q
//    before its DEFAULT dot (pallas_temporal_bwd.py:420-426).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "tf32.cuh"

namespace uu {

constexpr int ATTN_MAX_SEQ = 128;  // 8 warps of 16 query rows
// The softmax runs in base 2: scale and mask carry log2(e), and
// exp2f(x·log2 e) is expf(x) in fewer operations.
constexpr float ATTN_LOG2E = 1.4426950408889634f;

// Row pitches (floats) of the staged tiles, D padded to dp (a multiple of 8):
// q and k are read as float2 at (row g, column 2t), so their pitch is 8 mod
// 16; v is read at (row 2t, column g), so its pitch is 4 mod 8. Both keep
// rows 16-byte aligned for cp.async.
__host__ __device__ __forceinline__ int attn_qk_pitch(int dp) {
  return dp % 16 == 8 ? dp : dp + 8;
}
__host__ __device__ __forceinline__ int attn_v_pitch(int dp) { return dp + 4; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

// rows x dp floats of one head into dst (row pitch `pitch`); rows >= real
// and columns >= d are zero-filled (a copy of 0 source bytes). `vec`: 16-byte
// copies (D and the strides multiples of 4 floats, 16-byte aligned bases).
__device__ __forceinline__ void stage_head(float* dst, int pitch, const float* src,
                                           int row_stride, int rows, int real, int d,
                                           int dp, bool vec) {
  const int step = vec ? 4 : 1;
  const int chunks = dp / step;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, e = (i % chunks) * step;
    const bool in = r < real && e < d;
    const float* s = in ? src + (size_t)r * row_stride + e : src;
    if (vec)
      cp_async16(dst + r * pitch + e, s, in ? 16 : 0);
    else
      cp_async4(dst + r * pitch + e, s, in ? 4 : 0);
  }
}

// Warps per SM the register budget is sized for (see the note at the top).
constexpr int ATTN_WARPS_PER_SM = 20;
constexpr int attn_min_blocks(int warps) {
  return ATTN_WARPS_PER_SM / warps > 1 ? ATTN_WARPS_PER_SM / warps : 1;
}

// Q·Kᵀ over the 8 columns kk of D: the warp's 16 query rows (qw) against
// every 8-key step, into the logit fragments s (3xTF32; BF16: one pass on
// the operands rounded to bf16; QS: q multiplied by qmul before rounding).
template <int NT, bool BF16, bool QS = false>
__device__ __forceinline__ void qk_step(float (&s)[NT][4], const float* qw, const float* ks,
                                        int pq, int kk, int nt, int g, int t, float qmul = 1.f) {
  const float2 qa = *reinterpret_cast<const float2*>(qw + g * pq + 8 * kk + 2 * t);
  const float2 qb = *reinterpret_cast<const float2*>(qw + (g + 8) * pq + 8 * kk + 2 * t);
  if constexpr (BF16) {
    const auto q = [&](float v) { return bf16_round(QS ? v * qmul : v); };
    const uint32_t ab[4] = {q(qa.x), q(qb.x), q(qa.y), q(qb.y)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const float2 kv =
            *reinterpret_cast<const float2*>(ks + (8 * j + g) * pq + 8 * kk + 2 * t);
        const uint32_t bb[2] = {bf16_round(kv.x), bf16_round(kv.y)};
        mma_tf32(s[j], ab, bb);
      }
    }
    return;
  }
  uint32_t ab[4], as[4];
  tf32_split(qa.x, ab[0], as[0]);
  tf32_split(qb.x, ab[1], as[1]);
  tf32_split(qa.y, ab[2], as[2]);
  tf32_split(qb.y, ab[3], as[3]);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      const float2 kv = *reinterpret_cast<const float2*>(ks + (8 * j + g) * pq + 8 * kk + 2 * t);
      uint32_t bb[2], bs[2];
      tf32_split(kv.x, bb[0], bs[0]);
      tf32_split(kv.y, bb[1], bs[1]);
      mma_3xtf32(s[j], ab, as, bb, bs);
    }
  }
}

// NT: the most 8-key steps the instantiation holds in registers (S <= 8·NT,
// so at most (NT+1)/2 warps); CW: 8-column steps of D per pass of P·V (the
// context accumulators in registers), D <= 8·CW in one pass; BF16: the bf16
// mode, QS its training variant (the note at the top: `scale` is then q's
// factor 1/sqrt(D), and the logits take log2(e) alone); RQK false keeps
// Q·Kᵀ at 3xTF32 in the bf16 mode (row 11 at head depth <= 8, whose TPU
// logits are fp32 FMAs), P·V still one pass on rounded operands.
template <int NT, int CW, bool BF16, bool QS = false, bool RQK = true>
__global__ void __launch_bounds__((NT + 1) / 2 * 32, attn_min_blocks((NT + 1) / 2))
head_attention_tc_kernel(const float* __restrict__ q_base, const float* __restrict__ k_base,
                         const float* __restrict__ v_base, int row_stride,
                         const float* __restrict__ key_mask, float* __restrict__ out,
                         int n, int c, int heads, float scale, bool vec) {
  static_assert(BF16 || !QS, "q's rounding after its scale is a bf16 mode");
  extern __shared__ float4 attn_smem[];  // 16-byte aligned for cp.async
  float* sm = reinterpret_cast<float*>(attn_smem);
  const int d = c / heads, dp = (d + 7) & ~7, dk = dp / 8;
  const int pq = attn_qk_pitch(dp), pv = attn_v_pitch(dp);
  const int nq = blockDim.x / 2, nk = (n + 7) & ~7, nt = nk / 8;
  float* qs = sm;              // nq x pq
  float* ks = qs + nq * pq;    // nk x pq
  float* vs = ks + nk * pq;    // nk x pv
  float* mk = vs + nk * pv;    // nk additive key mask; -inf on padded keys
  const int seq = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t first = (size_t)seq * n * row_stride + (size_t)h * d;
  // two copy groups: q and k first, v's copy overlaps Q·Kᵀ and the softmax
  stage_head(qs, pq, q_base + first, row_stride, nq, n, d, dp, vec);
  stage_head(ks, pq, k_base + first, row_stride, nk, n, d, dp, vec);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  stage_head(vs, pv, v_base + first, row_stride, nk, n, d, dp, vec);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int j = threadIdx.x; j < nk; j += blockDim.x)
    mk[j] = j >= n ? -INFINITY
                   : key_mask ? key_mask[(size_t)seq * n + j] * (-1e9f * ATTN_LOG2E) : 0.f;
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, thread in group
  const float* qw = qs + warp * 16 * pq;

  // logits: s[j] holds rows g, g+8 of keys 8j+2t, 8j+2t+1 (c0 c1 | c2 c3)
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  // D's first CW steps unrolled (all of D up to 64), so that one step's loads
  // and splits overlap the previous step's mma.sync; the rest in a loop
#pragma unroll
  for (int kk = 0; kk < CW; ++kk) {
    if (kk >= dk) break;
    qk_step<NT, BF16 && RQK, QS>(s, qw, ks, pq, kk, nt, g, t, scale);
  }
  for (int kk = CW; kk < dk; ++kk)
    qk_step<NT, BF16 && RQK, QS>(s, qw, ks, pq, kk, nt, g, t, scale);

  // softmax over each row in registers: a row's 8·nt keys sit in one quad
  const float ls = QS ? ATTN_LOG2E : scale;  // QS: the scale is in q already
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      const float m0 = mk[8 * j + 2 * t], m1 = mk[8 * j + 2 * t + 1];
      s[j][0] = s[j][0] * ls + m0;
      s[j][1] = s[j][1] * ls + m1;
      s[j][2] = s[j][2] * ls + m0;
      s[j][3] = s[j][3] * ls + m1;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      s[j][0] = exp2f(s[j][0] - mx0);
      s[j][1] = exp2f(s[j][1] - mx0);
      s[j][2] = exp2f(s[j][2] - mx1);
      s[j][3] = exp2f(s[j][3] - mx1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
  }
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // context = P·V, 8·CW columns of D per pass
  const int row0 = warp * 16 + g, row1 = row0 + 8;
  float* out0 = out + ((size_t)seq * n + row0) * c + (size_t)h * d;
  float* out1 = out0 + (size_t)8 * c;
  for (int c0 = 0; c0 < dk; c0 += CW) {
    float o[CW][4];
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) o[cc][0] = o[cc][1] = o[cc][2] = o[cc][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if constexpr (BF16) {
        if (j < nt) {
          // the probabilities normalised, then rounded (P's own fragment, below)
          const uint32_t ab[4] = {bf16_round(s[j][0] * inv0), bf16_round(s[j][2] * inv1),
                                  bf16_round(s[j][1] * inv0), bf16_round(s[j][3] * inv1)};
          const float* vj = vs + (8 * j + 2 * t) * pv + 8 * c0 + g;
#pragma unroll
          for (int cc = 0; cc < CW; ++cc) {
            if (c0 + cc < dk) {
              const uint32_t bb[2] = {bf16_round(vj[8 * cc]), bf16_round(vj[pv + 8 * cc])};
              mma_tf32(o[cc], ab, bb);
            }
          }
        }
      } else if (j < nt) {
        // A column t is key 2t, column t+4 key 2t+1: P's own fragment
        uint32_t ab[4], as[4];
        tf32_split(s[j][0], ab[0], as[0]);
        tf32_split(s[j][2], ab[1], as[1]);
        tf32_split(s[j][1], ab[2], as[2]);
        tf32_split(s[j][3], ab[3], as[3]);
        const float* vj = vs + (8 * j + 2 * t) * pv + 8 * c0 + g;
#pragma unroll
        for (int cc = 0; cc < CW; ++cc) {
          if (c0 + cc < dk) {
            uint32_t bb[2], bs[2];
            tf32_split(vj[8 * cc], bb[0], bs[0]);
            tf32_split(vj[pv + 8 * cc], bb[1], bs[1]);
            mma_3xtf32(o[cc], ab, as, bb, bs);
          }
        }
      }
    }
    const float f0 = BF16 ? 1.f : inv0, f1 = BF16 ? 1.f : inv1;  // BF16: P normalised
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) {
      const int col = 8 * (c0 + cc) + 2 * t;
      if (c0 + cc < dk) {
        if (row0 < n) {
          if (col < d) out0[col] = o[cc][0] * f0;
          if (col + 1 < d) out0[col + 1] = o[cc][1] * f0;
        }
        if (row1 < n) {
          if (col < d) out1[col] = o[cc][2] * f1;
          if (col + 1 < d) out1[col + 1] = o[cc][3] * f1;
        }
      }
    }
  }
}

// ---- Row 11 on bf16 tensors ---------------------------------------------------
// Row pitch (bf16 values) of a bf16 tile whose rows hold dp16, a multiple of
// 16: an odd number of 16-byte pieces, so that the 8 rows an ldmatrix or
// stmatrix phase touches fall on 8 distinct 16-byte bank groups.
__host__ __device__ __forceinline__ int attn_bf16_pitch(int dp16) { return dp16 + 8; }

// rows x dp16 bf16 values of one head into dst (row pitch `pitch`); rows >=
// real and columns >= d zero-filled. `vec`: 16-byte cp.async copies (D and the
// row stride multiples of 8 values, 16-byte aligned bases); else loaded and
// stored a value at a time.
__device__ __forceinline__ void stage_head_bf16(__nv_bfloat16* dst, int pitch,
                                                const __nv_bfloat16* src, int row_stride,
                                                int rows, int real, int d, int dp16, bool vec) {
  if (vec) {
    const int pieces = dp16 / 8;
    for (int i = threadIdx.x; i < rows * pieces; i += blockDim.x) {
      const int r = i / pieces, e = (i % pieces) * 8;
      const bool in = r < real && e < d;
      cp_async16_bytes(dst + r * pitch + e, in ? src + (size_t)r * row_stride + e : src,
                       in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * dp16; i += blockDim.x) {
      const int r = i / dp16, e = i % dp16;
      dst[r * pitch + e] =
          r < real && e < d ? src[(size_t)r * row_stride + e] : __float2bfloat16_rn(0.f);
    }
  }
}

// Row 11 on bf16 tensors (packed_attention_bf16io, "high"; BF16:
// packed_attention_bf16io_bf16, the bf16 rung), the function of
// head_attention_tc_kernel on the widened operands, its context rounded to
// bf16 as it is stored (pallas_attention.py:63-66, :118).
//
// What bounds it: bytes (q, k, v read and the context written, 2 bytes a
// value: 0.067 ms at 1,024 x 71 x 384 on an H100). Design: q, k and v are
// staged as bf16 tiles by 16-byte cp.async (two copy groups: q and k, then v
// behind Q·Kᵀ and the softmax), half the shared memory of the fp32 tiles;
// every product runs on native bf16 mma.sync.m16n8k16 with its operands'
// fragments loaded by ldmatrix (V's transposed), and a bf16 value's product
// with another is exact in fp32:
//  - Q·Kᵀ: one pass per 16-deep step of D, each step a fresh partial that
//    joins the fp32 sums (the tensor cores truncate as they accumulate); the
//    logits' factor after the product. Both rungs: q and k are bf16 already.
//  - P·V: the keys padded to a multiple of 16; two 8-key tiles of S's
//    accumulators are P's A fragment of one 16-key step, rows g and g+8,
//    keys 2t.. and 8+2t.., with no shuffle. BF16: P normalised, rounded,
//    one pass, fp32 sums. "high": P unnormalised in three bf16 terms (P's
//    rounding, its remainder's, the remainder's remainder: 24 bits of P)
//    against v's exact bf16, the smallest first, a fresh partial per 16-key
//    step; the row sum divides after.
//  - The context leaves through a staging tile (the warp's own q rows, read
//    by no other warp) in 16-byte pieces.
// NT: the most 8-key tiles held (even: S <= 8·NT, NT/2 warps); CW: 8-column
// tiles of D per pass of P·V (even).
template <int NT, int CW, bool BF16>
__global__ void __launch_bounds__(NT / 2 * 32, attn_min_blocks(NT / 2))
head_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q_base,
                           const __nv_bfloat16* __restrict__ k_base,
                           const __nv_bfloat16* __restrict__ v_base, int row_stride,
                           const float* __restrict__ key_mask,
                           __nv_bfloat16* __restrict__ out, int n, int c, int heads,
                           float scale, bool vec) {
  static_assert(NT % 2 == 0 && CW % 2 == 0, "16-key steps, pairs of 8-column tiles");
  extern __shared__ float4 attn_smem[];  // 16-byte aligned for cp.async
  const int d = c / heads, dp = (d + 15) & ~15, pb = attn_bf16_pitch(dp), dn = dp / 8;
  const int nk = (n + 15) & ~15, nt = nk / 8;  // queries and keys padded to 16
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(attn_smem);  // nk x pb
  __nv_bfloat16* ks = qs + nk * pb;                                 // nk x pb
  __nv_bfloat16* vs = ks + nk * pb;                                 // nk x pb
  float* mk = reinterpret_cast<float*>(vs + nk * pb);  // nk additive key mask; -inf on padding
  const int seq = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t first = (size_t)seq * n * row_stride + (size_t)h * d;
  stage_head_bf16(qs, pb, q_base + first, row_stride, nk, n, d, dp, vec);
  stage_head_bf16(ks, pb, k_base + first, row_stride, nk, n, d, dp, vec);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  stage_head_bf16(vs, pb, v_base + first, row_stride, nk, n, d, dp, vec);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int j = threadIdx.x; j < nk; j += blockDim.x)
    mk[j] = j >= n ? -INFINITY
                   : key_mask ? key_mask[(size_t)seq * n + j] * (-1e9f * ATTN_LOG2E) : 0.f;
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;    // fragment row group, thread in group
  const int lr = lane & 7, lm = lane >> 3;  // the row and the matrix this lane's ldmatrix addresses

  // logits: s[j] holds rows g, g+8 of keys 8j+2t, 8j+2t+1
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  // q's A fragment: rows 0-7 | 8-15 of the warp's 16, columns 0-7 | 8-15 of
  // the step; k's B fragments of key tiles j, j+1: columns 0-7 | 8-15
  const __nv_bfloat16* qa = qs + (warp * 16 + lr + 8 * (lm & 1)) * pb + 8 * (lm >> 1);
  const __nv_bfloat16* kb = ks + (lr + 8 * (lm >> 1)) * pb + 8 * (lm & 1);
  const auto qk = [&](int kk, bool fresh) {
    uint32_t a[4];
    ldmatrix_x4(a, qa + 16 * kk);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j < nt) {
        uint32_t b[4];
        ldmatrix_x4(b, kb + 8 * j * pb + 16 * kk);
        if (fresh) {
          float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(p0, a, b[0], b[1]);
          mma_bf16(p1, a, b[2], b[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] += p0[e];
            s[j + 1][e] += p1[e];
          }
        } else {
          mma_bf16(s[j], a, b[0], b[1]);
          mma_bf16(s[j + 1], a, b[2], b[3]);
        }
      }
    }
  };
  qk(0, false);  // the first step's partial is the sum
#pragma unroll
  for (int kk = 1; kk < CW / 2; ++kk) {
    if (kk >= dp / 16) break;
    qk(kk, true);
  }
  for (int kk = CW / 2; kk < dp / 16; ++kk) qk(kk, true);

  // softmax over each row in registers: a row's keys sit in one quad
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      const float m0 = mk[8 * j + 2 * t], m1 = mk[8 * j + 2 * t + 1];
      s[j][0] = s[j][0] * scale + m0;
      s[j][1] = s[j][1] * scale + m1;
      s[j][2] = s[j][2] * scale + m0;
      s[j][3] = s[j][3] * scale + m1;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      s[j][0] = exp2f(s[j][0] - mx0);
      s[j][1] = exp2f(s[j][1] - mx0);
      s[j][2] = exp2f(s[j][2] - mx1);
      s[j][3] = exp2f(s[j][3] - mx1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
  }
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // context = P·V, CW 8-column tiles of D per pass; v's B fragments of the
  // 16-key step (keys 0-7 | 8-15) for column tiles cc, cc+1, transposed
  const __nv_bfloat16* vb = vs + (lr + 8 * (lm & 1)) * pb + 8 * (lm >> 1);
  __nv_bfloat16* stage = qs + warp * 16 * pb;  // the warp's q rows: the context's staging tile
  const float f0 = BF16 ? 1.f : inv0, f1 = BF16 ? 1.f : inv1;  // BF16: P normalised
  for (int c0 = 0; c0 < dn; c0 += CW) {
    float o[CW][4];
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) o[cc][0] = o[cc][1] = o[cc][2] = o[cc][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j < nt) {
        // P's A fragment of keys 8j..8j+15: tile j's rows g, g+8, then tile j+1's
        const float x[8] = {s[j][0], s[j][1], s[j][2], s[j][3],
                            s[j + 1][0], s[j + 1][1], s[j + 1][2], s[j + 1][3]};
        uint32_t a1[4], a2[4], a3[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (BF16) {
            a1[e] = pack_bf16(x[2 * e] * (e & 1 ? inv1 : inv0),
                              x[2 * e + 1] * (e & 1 ? inv1 : inv0));
          } else {  // three bf16 terms: P's rounding, then its remainders'
            a1[e] = pack_bf16(x[2 * e], x[2 * e + 1]);
            const float r0 = x[2 * e] - bf16_lo(a1[e]), r1 = x[2 * e + 1] - bf16_hi(a1[e]);
            a2[e] = pack_bf16(r0, r1);
            a3[e] = pack_bf16(r0 - bf16_lo(a2[e]), r1 - bf16_hi(a2[e]));
          }
        }
#pragma unroll
        for (int cc = 0; cc < CW; cc += 2) {
          if (c0 + cc < dn) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, vb + 8 * j * pb + 8 * (c0 + cc));
            if constexpr (BF16) {
              mma_bf16(o[cc], a1, b[0], b[1]);
              mma_bf16(o[cc + 1], a1, b[2], b[3]);
            } else {
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                float p[4] = {0.f, 0.f, 0.f, 0.f};
                mma_bf16(p, a3, b[2 * u], b[2 * u + 1]);
                mma_bf16(p, a2, b[2 * u], b[2 * u + 1]);
                mma_bf16(p, a1, b[2 * u], b[2 * u + 1]);
#pragma unroll
                for (int e = 0; e < 4; ++e) o[cc + u][e] += p[e];
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) {
      if (c0 + cc < dn) {
        const int col = 8 * (c0 + cc) + 2 * t;
        *reinterpret_cast<uint32_t*>(stage + g * pb + col) =
            pack_bf16(o[cc][0] * f0, o[cc][1] * f0);
        *reinterpret_cast<uint32_t*>(stage + (g + 8) * pb + col) =
            pack_bf16(o[cc][2] * f1, o[cc][3] * f1);
      }
    }
  }
  __syncwarp();
  // the warp's real rows and the D real columns leave the staging tile
  const int row0 = warp * 16;
  __nv_bfloat16* ob = out + (size_t)seq * n * c + (size_t)h * d;
  if (vec) {
    const int pieces = d / 8;
    for (int i = lane; i < 16 * pieces; i += 32) {
      const int r = i / pieces, e = (i % pieces) * 8;
      if (row0 + r < n)
        *reinterpret_cast<uint4*>(ob + (size_t)(row0 + r) * c + e) =
            *reinterpret_cast<const uint4*>(stage + r * pb + e);
    }
  } else {
    for (int i = lane; i < 16 * d; i += 32) {
      const int r = i / d, e = i % d;
      if (row0 + r < n) ob[(size_t)(row0 + r) * c + e] = stage[r * pb + e];
    }
  }
}

// Shared memory above 48 KB is opted into first; an error if the card has less.
template <typename Kernel>
cudaError_t attn_opt_in(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int NT, int CW, bool BF16, bool QS, bool RQK>
cudaError_t launch_head_attention_tc(const float* q, const float* k, const float* v,
                                     int row_stride, const float* key_mask, float* out,
                                     int seqs, int n, int c, int heads, float scale, size_t smem,
                                     int threads, bool vec, cudaStream_t stream) {
  auto kernel = head_attention_tc_kernel<NT, CW, BF16, QS, RQK>;
  const cudaError_t err = attn_opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)seqs * heads, threads, smem, stream>>>(
      q, k, v, row_stride, key_mask, out, n, c, heads, scale, vec);
  return cudaGetLastError();
}

template <int CW, bool BF16, bool QS, bool RQK = true>
cudaError_t launch_head_attention_nt(const float* q, const float* k, const float* v,
                                     int row_stride, const float* key_mask, float* out,
                                     int seqs, int n, int c, int heads, float scale, size_t smem,
                                     int threads, bool vec, cudaStream_t stream) {
  const int nt = (n + 7) / 8;
#define UU_ATTN_CASE(NT_)                                                                 \
  if (nt <= NT_)                                                                          \
    return launch_head_attention_tc<NT_, CW, BF16, QS, RQK>(                              \
        q, k, v, row_stride, key_mask, out, seqs, n, c, heads, scale, smem, threads, vec, \
        stream);
  UU_ATTN_CASE(3)
  UU_ATTN_CASE(6)
  UU_ATTN_CASE(9)
  UU_ATTN_CASE(12)
  UU_ATTN_CASE(16)
#undef UU_ATTN_CASE
  return cudaErrorInvalidValue;
}

template <int CW, bool BF16>
cudaError_t launch_head_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                       const __nv_bfloat16* v, int row_stride,
                                       const float* key_mask, __nv_bfloat16* out, int seqs,
                                       int n, int c, int heads, float scale,
                                       cudaStream_t stream) {
  const int d = c / heads, dp = (d + 15) & ~15, nk = (n + 15) & ~15;
  const size_t smem = 3 * sizeof(__nv_bfloat16) * nk * attn_bf16_pitch(dp) + sizeof(float) * nk;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = aligned(q) && aligned(k) && aligned(v) && aligned(out) &&
                   row_stride % 8 == 0 && c % 8 == 0 && d % 8 == 0;
  const int nt = nk / 8;
#define UU_ATTN_BF16_CASE(NT_)                                                             \
  if (nt <= NT_) {                                                                         \
    auto kernel = head_attention_bf16_kernel<NT_, CW, BF16>;                               \
    const cudaError_t err = attn_opt_in(kernel, smem);                                     \
    if (err != cudaSuccess) return err;                                                    \
    kernel<<<(unsigned)seqs * heads, nk / 16 * 32, smem, stream>>>(                        \
        q, k, v, row_stride, key_mask, out, n, c, heads, scale, vec);                      \
    return cudaGetLastError();                                                             \
  }
  UU_ATTN_BF16_CASE(2)
  UU_ATTN_BF16_CASE(4)
  UU_ATTN_BF16_CASE(6)
  UU_ATTN_BF16_CASE(10)
  UU_ATTN_BF16_CASE(16)
#undef UU_ATTN_BF16_CASE
  return cudaErrorInvalidValue;
}

// The logits' factor in base 2 for head depth d, q unscaled: log2(e)/sqrt(d)
// (row 11, K5's and K6's forward at fp32). With q's 1/sqrt(d) folded into
// the weights (K2, K3) it is ATTN_LOG2E alone.
inline float attn_scale2(int d) { return ATTN_LOG2E / sqrtf((float)d); }

// Attention on `seqs` sequences of n <= 128 tokens (BF16: the bf16 mode, QS
// its training variant; T: the tensors' type, float or __nv_bfloat16 (row
// 11's bf16 tensors: head_attention_bf16_kernel, whose products take q and k
// exactly at either rung); RQK false: the bf16 mode keeps Q·Kᵀ at 3xTF32 on
// fp32 tensors, for head depths <= 8 only, as row 11 picks it). `scale` is
// the logits' factor in base 2 (attn_scale2, or ATTN_LOG2E on folded q);
// with QS, q's factor fp32(1/sqrt(D)) (the logits then take ATTN_LOG2E).
// Returns the launch's error (shared memory above 48 KB is opted into first).
template <bool BF16 = false, bool QS = false, typename T = float, bool RQK = true>
inline cudaError_t launch_head_attention(const T* q, const T* k, const T* v, int row_stride,
                                         const float* key_mask, T* out, int seqs, int n,
                                         int c, int heads, float scale, cudaStream_t stream) {
  if (seqs <= 0 || n <= 0 || n > ATTN_MAX_SEQ || heads <= 0 || c % heads != 0)
    return cudaErrorInvalidValue;
  const int d = c / heads, dp = (d + 7) & ~7, dk = dp / 8;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    static_assert(!QS, "bf16 tensors take no training variant");
    const int dn = (d + 15) / 16 * 2;  // 8-column tiles of D padded to 16
#define UU_ATTN_BF16_CW(CW_)                                                                 \
  return launch_head_attention_bf16<CW_, BF16>(q, k, v, row_stride, key_mask, out, seqs, n, \
                                               c, heads, scale, stream);
    if (dn <= 2) UU_ATTN_BF16_CW(2)
    if (dn <= 4) UU_ATTN_BF16_CW(4)
    if (dn <= 6) UU_ATTN_BF16_CW(6)
    UU_ATTN_BF16_CW(8)
#undef UU_ATTN_BF16_CW
  } else {
    const int warps = (n + 15) / 16, nk = (n + 7) & ~7;
    const size_t smem = sizeof(float) * ((size_t)(16 * warps + nk) * attn_qk_pitch(dp) +
                                         (size_t)nk * attn_v_pitch(dp) + nk);
    const auto aligned = [](const T* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    const bool vec =
        aligned(q) && aligned(k) && aligned(v) && row_stride % 4 == 0 && d % 4 == 0;
    const int threads = warps * 32;
    if constexpr (!RQK) {
      static_assert(BF16, "Q·Kᵀ unrounded is a choice of the bf16 mode");
      if (dk > 1) return cudaErrorInvalidValue;  // one 8-column step of D: CW 2 holds it
      return launch_head_attention_nt<2, BF16, QS, false>(q, k, v, row_stride, key_mask, out,
                                                          seqs, n, c, heads, scale, smem,
                                                          threads, vec, stream);
    } else {
#define UU_ATTN_CW(CW_)                                                                    \
  return launch_head_attention_nt<CW_, BF16, QS>(q, k, v, row_stride, key_mask, out, seqs, \
                                                 n, c, heads, scale, smem, threads, vec,   \
                                                 stream);
      if (dk <= 2) UU_ATTN_CW(2)
      if (dk <= 4) UU_ATTN_CW(4)
      if (dk <= 6) UU_ATTN_CW(6)
      UU_ATTN_CW(8)
#undef UU_ATTN_CW
    }
  }
}

}  // namespace uu
