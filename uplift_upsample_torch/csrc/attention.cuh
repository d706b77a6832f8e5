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
// S <= 128 and any head depth D whose tiles fit in shared memory.
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
//  - The bf16 mode (BF16, the one-pass bf16 rung; K2's and K3's
//    `window_attention_bf16`): q and k rounded to bf16 as they are loaded
//    (the scale applied to the logits after the product, as the TPU's
//    DEFAULT dot on q and k computes them), and P·V on the probabilities
//    normalised first, then rounded, with v rounded: one TF32 product per
//    pair of rounded operands (tf32.cuh), fp32 sums.
//  - Its training variant (QS, K5's and K6's `window_attention_train_bf16`,
//    temporal_bwd.cu): q multiplied by 1/sqrt(D) before it is rounded, the
//    logits then only carry log2(e), as the TPU's training kernel scales q
//    before its DEFAULT dot (pallas_temporal_bwd.py:420-426).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// factor 1/sqrt(D), and the logits take log2(e) alone).
template <int NT, int CW, bool BF16, bool QS = false>
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
    qk_step<NT, BF16, QS>(s, qw, ks, pq, kk, nt, g, t, scale);
  }
  for (int kk = CW; kk < dk; ++kk) qk_step<NT, BF16, QS>(s, qw, ks, pq, kk, nt, g, t, scale);

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

template <int NT, int CW, bool BF16, bool QS>
cudaError_t launch_head_attention_tc(const float* q, const float* k, const float* v,
                                     int row_stride, const float* key_mask, float* out,
                                     int seqs, int n, int c, int heads, size_t smem,
                                     int threads, bool vec, cudaStream_t stream) {
  auto kernel = head_attention_tc_kernel<NT, CW, BF16, QS>;
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (smem > (size_t)optin) return cudaErrorInvalidValue;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // QS: q's factor, fp32(1/sqrt(D)) rounded once from double as the TPU
  // kernel's np.float32 constant
  const float scale = QS ? (float)(1.0 / sqrt((double)(c / heads)))
                         : ATTN_LOG2E / sqrtf((float)(c / heads));
  kernel<<<(unsigned)seqs * heads, threads, smem, stream>>>(
      q, k, v, row_stride, key_mask, out, n, c, heads, scale, vec);
  return cudaGetLastError();
}

template <int CW, bool BF16, bool QS>
cudaError_t launch_head_attention_nt(const float* q, const float* k, const float* v,
                                     int row_stride, const float* key_mask, float* out,
                                     int seqs, int n, int c, int heads, size_t smem,
                                     int threads, bool vec, cudaStream_t stream) {
  const int nt = (n + 7) / 8;
#define UU_ATTN_CASE(NT_)                                                                   \
  if (nt <= NT_)                                                                            \
    return launch_head_attention_tc<NT_, CW, BF16, QS>(q, k, v, row_stride, key_mask, out,  \
                                                       seqs, n, c, heads, smem, threads, vec, \
                                                       stream);
  UU_ATTN_CASE(3)
  UU_ATTN_CASE(6)
  UU_ATTN_CASE(9)
  UU_ATTN_CASE(12)
  UU_ATTN_CASE(16)
#undef UU_ATTN_CASE
  return cudaErrorInvalidValue;
}

// Attention on `seqs` sequences of n <= 128 tokens (BF16: the bf16 mode, QS
// its training variant); returns the launch's error (shared memory above
// 48 KB is opted into first).
template <bool BF16 = false, bool QS = false>
inline cudaError_t launch_head_attention(const float* q, const float* k, const float* v,
                                         int row_stride, const float* key_mask, float* out,
                                         int seqs, int n, int c, int heads,
                                         cudaStream_t stream) {
  if (seqs <= 0 || n <= 0 || n > ATTN_MAX_SEQ || heads <= 0 || c % heads != 0)
    return cudaErrorInvalidValue;
  const int d = c / heads, dp = (d + 7) & ~7, dk = dp / 8;
  const int warps = (n + 15) / 16, nk = (n + 7) & ~7;
  const size_t smem = sizeof(float) * ((size_t)(16 * warps + nk) * attn_qk_pitch(dp) +
                                       (size_t)nk * attn_v_pitch(dp) + nk);
  const auto aligned = [](const float* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = aligned(q) && aligned(k) && aligned(v) && row_stride % 4 == 0 && d % 4 == 0;
  const int threads = warps * 32;
  if (dk <= 2)
    return launch_head_attention_nt<2, BF16, QS>(q, k, v, row_stride, key_mask, out, seqs, n, c,
                                             heads, smem, threads, vec, stream);
  if (dk <= 4)
    return launch_head_attention_nt<4, BF16, QS>(q, k, v, row_stride, key_mask, out, seqs, n, c,
                                             heads, smem, threads, vec, stream);
  if (dk <= 6)
    return launch_head_attention_nt<6, BF16, QS>(q, k, v, row_stride, key_mask, out, seqs, n, c,
                                             heads, smem, threads, vec, stream);
  return launch_head_attention_nt<8, BF16, QS>(q, k, v, row_stride, key_mask, out, seqs, n, c,
                                           heads, smem, threads, vec, stream);
}

}  // namespace uu
