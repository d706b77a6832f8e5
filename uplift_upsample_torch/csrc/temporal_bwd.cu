// K5 — the temporal stack in training: the kernels its forward adds to K2's
// and every kernel of its backward.
//
// Replaces: uplift_upsample_tpu/ops/pallas_temporal_bwd.py
//   fused_temporal_stack_train (_make_group_kernels, _fts_impl_fwd,
//   _fts_impl_bwd). Per block: x2 = x + s1 * proj(attn(LN1(x))),
//   out = x2 + s2 * fc2(relu(fc1(LN2(x2)))), with per-window stochastic-depth
//   scales s1, s2 and the additive -1e9 key mask in the first `fmb` blocks.
//
// Forward: K2's launches (temporal.cu: LayerNorm, GEMM, window attention)
// plus gemm_branch_f32 here, which writes both the residual sum with the
// window's scale and the unscaled branch the backward needs for the scale
// gradients. The TPU kernel replays each block from its input because VMEM is
// small; here the forward keeps every intermediate in device memory (~0.6 GB
// per block at 512 windows x 71 x 384) and the backward reads them back.
//
// Backward, per block (ops/temporal_train.py drives the order):
//   dX = dY . W^T   gemm_dx_f32   (row scale on dY, relu mask in the epilogue)
//   dW = X^T . dY   gemm_dw_f32   split-K over the 36,352 rows into partials,
//                                 summed in a fixed order by sum_rows_f32
//   bias grads      colsum_f32    per-chunk column sums, then sum_rows_f32
//   LN backward     layernorm_bwd_f32 (+ per-warp gamma/beta partials)
//   window attention backward   window_attention_bwd_f32, one block per
//                                 (window, head), softmax recomputed, its
//                                 five products on mma.sync (below)
//   scale grads     window_dot_f32: per-window sum of g . branch
// Nothing adds floats with atomics, so repeated runs agree bit for bit.
// The TPU's 72-token padding, block-diagonal mask, windows-per-tile tiling
// and block groups are TPU layout and have no counterpart here.
//
// What bounds it: the GEMMs (~0.27 TFLOP per block backward at 36,352 rows,
// twice the forward's), bound by operations; the rest is memory-bound. Every
// product runs on the tensor cores in 3xTF32 (gemm_tc.cuh, fp32-level
// error): the forward's and dX on the persistent TMA + wgmma kernel, with
// W's halves split once per step when the operands are stacked (dX reads W
// as stored, which is the K-major layout wgmma wants); dW = X^T . dY, whose
// operands are both MN-major, on wgmma too (gemm_atb_kernel: bulk copies of
// the rows, converter warps writing the operand tiles the tensor cores read).
//
// The bf16 rung (TRAIN_MATMUL_PRECISION "default" and "mixed";
// pallas_temporal_bwd.py at DEFAULT, where every dot rounds both operands):
// each product's bf16 instance on bf16-rounded operands with fp32 sums:
// native bf16 wgmma for the dense layers (gemm_tc.cuh TC_BF16, W's bf16 plane
// as a torch.bfloat16 tensor) and dW, one TF32 pass for the attention
// (tf32.cuh):
//   gemm_branch_bf16  the forward's scaled branch
//   window_attention_train_bf16  the forward's attention (attention.cuh QS:
//                     q·1/sqrt(D) rounded, as the training kernel scales q
//                     before its dot; K2's eval instance rounds q unscaled)
//   gemm_dx_bf16      dY scaled by its droppath factor, then rounded
//                     (TmaAScaled: the factor 1/keep is no power of two, so
//                     scaling after the product would round another value)
//   gemm_dw_bf16      X and s . dY rounded (gemm_atb_kernel kBf16)
//   window_attention_bwd_bf16  S = round(q/sqrt(D)) . round(k), dP =
//                     round(dO) . round(v), dq = round(dS) . round(k) then
//                     1/sqrt(D), dk = round(dS)^T . round(q/sqrt(D)), dv =
//                     round(P)^T . round(dO) (pallas_temporal_bwd.py:510-521)
// LayerNorm, softmax, relu, biases, scales, residuals and sums stay fp32;
// every 3xTF32 instance compiles as before.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "attention.cuh"
#include "gemm.cuh"
#include "gemm_tc.cuh"

namespace {

// v = act(v + bias); branch = v; out = residual + v * scale[r / rows_per_scale].
struct ScaledBranch {
  const float* bias;
  const float* scale;
  int rows_per_scale;
  const float* residual;
  float* branch;
  float* out;
  int n;
  int relu;
  __device__ __forceinline__ float pre(int c, float v) const {
    if (bias) v += bias[c];
    if (relu) v = fmaxf(v, 0.f);
    return v;
  }
  __device__ __forceinline__ float post(float v, float f, float res) const {
    v *= f;
    return residual ? res + v : v;
  }
  __device__ __forceinline__ void operator()(int r, int c, float v) const {
    const size_t o = (size_t)r * n + c;
    v = pre(c, v);
    if (branch) branch[o] = v;
    out[o] = post(v, uu::row_factor(scale, rows_per_scale, r), residual ? residual[o] : 0.f);
  }
  bool quads() const {
    return n % 4 == 0 && uu::aligned16(residual) && uu::aligned16(branch) &&
           uu::aligned16(out);
  }
  struct Ld {
    float4 res;
  };
  __device__ __forceinline__ Ld load4(int r, int c) const {
    return {residual ? uu::ld4(residual + (size_t)r * n + c) : make_float4(0.f, 0.f, 0.f, 0.f)};
  }
  __device__ __forceinline__ void store4(int r, int c, float4 v, const Ld& l) const {
    const size_t o = (size_t)r * n + c;
    const float4 b = make_float4(pre(c, v.x), pre(c + 1, v.y), pre(c + 2, v.z), pre(c + 3, v.w));
    if (branch) uu::st4(branch + o, b);
    const float f = uu::row_factor(scale, rows_per_scale, r);
    uu::st4(out + o, make_float4(post(b.x, f, l.res.x), post(b.y, f, l.res.y),
                                 post(b.z, f, l.res.z), post(b.w, f, l.res.w)));
  }
};

// ScaledBranch written by the consumers (gemm_tc.cuh's kDirect): the
// residual comes in by TMA (e.residual only marks it), the row's factor is
// read once a tile.
struct ScaledBranchDirect {
  static constexpr bool kTmaStore = false, kDirect = true;
  struct Maps {
    CUtensorMap in[1];
  };
  struct Row {
    float f;
  };
  ScaledBranch e;
  bool quads() const { return false; }
  __device__ __forceinline__ bool tile_in() const { return e.residual != nullptr; }
  __device__ __forceinline__ Row row(int r) const {
    return {uu::row_factor(e.scale, e.rows_per_scale, r)};
  }
  __device__ __forceinline__ void put(int r, int c, float v0, float v1, float2 in,
                                      const Row& row) const {
    const size_t o = (size_t)r * e.n + c;
    const float2 b = make_float2(e.pre(c, v0), e.pre(c + 1, v1));
    if (e.branch) *reinterpret_cast<float2*>(e.branch + o) = b;
    *reinterpret_cast<float2*>(e.out + o) =
        make_float2(e.post(b.x, row.f, in.x), e.post(b.y, row.f, in.y));
  }
};

// out = v * scale[r / rows_per_scale], zeroed where mask <= 0 (the relu
// derivative through its output). The row scale belongs to dY; it is applied
// here, to the product, which equals (s . dY) . W^T up to rounding.
struct ScaledMaskStore {
  const float* scale;
  int rows_per_scale;
  const float* mask;
  float* out;
  int n;
  __device__ __forceinline__ float value(float v, float f, float mk) const {
    return (mask && !(mk > 0.f)) ? 0.f : v * f;
  }
  __device__ __forceinline__ void operator()(int r, int c, float v) const {
    const size_t o = (size_t)r * n + c;
    out[o] = value(v, uu::row_factor(scale, rows_per_scale, r), mask ? mask[o] : 0.f);
  }
  bool quads() const { return n % 4 == 0 && uu::aligned16(mask) && uu::aligned16(out); }
  struct Ld {
    float4 mk;
  };
  __device__ __forceinline__ Ld load4(int r, int c) const {
    return {mask ? uu::ld4(mask + (size_t)r * n + c) : make_float4(0.f, 0.f, 0.f, 0.f)};
  }
  __device__ __forceinline__ void store4(int r, int c, float4 v, const Ld& l) const {
    const float f = uu::row_factor(scale, rows_per_scale, r);
    uu::st4(out + (size_t)r * n + c, make_float4(value(v.x, f, l.mk.x), value(v.y, f, l.mk.y),
                                                 value(v.z, f, l.mk.z), value(v.w, f, l.mk.w)));
  }
};

constexpr int COLSUM_ROWS = 256;

// part[chunk, c] = sum over the chunk's rows r of x[r, c] * scale[r / rps].
__global__ void colsum_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                              int rows_per_scale, float* __restrict__ part, int rows,
                              int cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * COLSUM_ROWS;
  const int r1 = min(rows, r0 + COLSUM_ROWS);
  float s = 0.f;
  for (int r = r0; r < r1; ++r)
    s = fmaf(x[(size_t)r * cols + c], uu::row_factor(scale, rows_per_scale, r), s);
  part[(size_t)blockIdx.y * cols + c] = s;
}

constexpr int LN_WARPS = 8;
constexpr int LN_MAX_V = 16;  // channels per lane: c <= 512

// Backward of y = LN(x) * gamma + beta over rows of c: dx = LN'(dy) (+ residual),
// and per warp the partial sums of dgamma = sum dy * xhat and dbeta = sum dy
// over the rows the warp takes (row w, w + workers, ...), into part[w, 0:2c].
__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                     const float* __restrict__ gamma, const float* residual, float* dx,
                     float* __restrict__ part, int rows, int c, float eps) {
  const int workers = gridDim.x * LN_WARPS;
  const int w = blockIdx.x * LN_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float gm[LN_MAX_V], acc_g[LN_MAX_V], acc_b[LN_MAX_V];
#pragma unroll
  for (int j = 0; j < LN_MAX_V; ++j) {
    const int e = lane + 32 * j;
    gm[j] = e < c ? gamma[e] : 0.f;
    acc_g[j] = 0.f;
    acc_b[j] = 0.f;
  }
  for (int r = w; r < rows; r += workers) {
    const float* xr = x + (size_t)r * c;
    const float* gr = dy + (size_t)r * c;
    float xv[LN_MAX_V], dv[LN_MAX_V];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < LN_MAX_V; ++j) {
      const int e = lane + 32 * j;
      xv[j] = e < c ? xr[e] : 0.f;
      dv[j] = e < c ? gr[e] : 0.f;
      s += xv[j];
    }
    const float mu = uu::warp_sum(s) / c;
    float var = 0.f;
#pragma unroll
    for (int j = 0; j < LN_MAX_V; ++j) {
      const int e = lane + 32 * j;
      const float d = e < c ? xv[j] - mu : 0.f;
      xv[j] = d;
      var = fmaf(d, d, var);
    }
    const float inv = 1.f / sqrtf(uu::warp_sum(var) / c + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < LN_MAX_V; ++j) {
      xv[j] *= inv;  // xhat
      acc_g[j] = fmaf(dv[j], xv[j], acc_g[j]);
      acc_b[j] += dv[j];
      dv[j] *= gm[j];  // dxhat
      m1 += dv[j];
      m2 = fmaf(dv[j], xv[j], m2);
    }
    m1 = uu::warp_sum(m1) / c;
    m2 = uu::warp_sum(m2) / c;
#pragma unroll
    for (int j = 0; j < LN_MAX_V; ++j) {
      const int e = lane + 32 * j;
      if (e < c) {
        float v = (dv[j] - m1 - xv[j] * m2) * inv;
        if (residual) v += residual[(size_t)r * c + e];
        dx[(size_t)r * c + e] = v;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < LN_MAX_V; ++j) {
    const int e = lane + 32 * j;
    if (e < c) {
      part[(size_t)w * 2 * c + e] = acc_g[j];
      part[(size_t)w * 2 * c + c + e] = acc_b[j];
    }
  }
}

constexpr int DOT_THREADS = 256;

// out[win] = sum over the window's rows and channels of a * b.
__global__ void __launch_bounds__(DOT_THREADS)
window_dot_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, int per_window) {
  __shared__ float red[DOT_THREADS];
  const size_t base = (size_t)blockIdx.x * per_window;
  float s = 0.f;
  for (int i = threadIdx.x; i < per_window; i += DOT_THREADS)
    s = fmaf(a[base + i], b[base + i], s);
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = DOT_THREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = red[0];
}

// The window-attention backward on the tensor cores, one thread block per
// (window, head): dS = P * (dP - rowsum(P * dP)) with P recomputed and
// dP = dO . v^T; dq = scale * dS . k, dk = scale * dS^T . q, dv = P^T . dO.
//
// Replaces: uplift_upsample_tpu/ops/pallas_temporal_bwd.py:510-521, the
//   per-head loop inside _fts_impl_bwd (pallas_call at :681).
//
// What bounds it: bytes at best (q, k, v and dO read, dq, dk, dv written:
// 391 MB at 512 windows x 71 x 384, 0.117 ms); its five products, 9.9
// GFLOP with S recomputed, run on mma.sync in 3xTF32 (tf32.cuh), and they
// take most of its time (kernel_probe.py on an H100: 0.59 ms, 0.20 without
// them).
//
// Design (attention.cuh's register fragments):
//  - q, k, v and dO of the head are staged with cp.async, zero-filled:
//    queries to nq = 16 x warps rows (a warp's m16 tile), keys to a multiple
//    of 8, D to a multiple of 8; every pitch is 4 mod 8 floats, so the
//    scalar fragment loads below (rows g, columns t and t+4; or rows 2t,
//    2t+1, column g) hit 32 distinct banks.
//  - Pass 1: warp w owns query rows 16w..16w+15. S = q k^T and dP = dO v^T
//    land in accumulator registers; scale, the key mask (-1e9 per blocked
//    key, -inf on padded keys), the softmax in base 2 and the row sums of
//    P * dP (quad shuffles) run there, and dS replaces dP. dq = dS . k takes
//    dS's accumulator fragment as its A fragment, the keys permuted inside
//    each 8-key step (A column t <-> key 2t, t+4 <-> 2t+1, and the same rows
//    of k), so no value moves between lanes.
//  - Pass 2: dk and dv sum over every warp's queries, so P^T and dS^T go to
//    shared memory once (over k and v, which pass 2 no longer reads: 90 KB a
//    block at 71 tokens, two blocks per SM), and warp w then owns key rows
//    16w..16w+15 for dk = dS^T . q and dv = P^T . dO, the queries permuted
//    the same way so that each A fragment is one float2 load per row.
//  - Every 8-deep step's three products go into a fresh partial that joins
//    the fp32 accumulators with a rounded add: the tensor cores round toward
//    zero as they accumulate (tests/test_torch_attention_bwd_tc.py emulates
//    the order). Each output element has one writer, no atomics: repeated
//    runs agree bit for bit.
//  - The bf16 mode (BF16): q is multiplied by 1/sqrt(D) once staged; every
//    operand is rounded to bf16 where the 3xTF32 instance splits it (split
//    below: q, k, v and dO as they are read, P and dS from the registers or
//    from P^T and dS^T), one TF32 product per step into the fresh partial;
//    the logits then take log2(e) alone and dk no 1/sqrt(D).
template <bool BF16>
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  if constexpr (BF16) {
    big = uu::bf16_round(x);
    small = 0u;
  } else {
    uu::tf32_split(x, big, small);
  }
}

template <bool BF16 = false>
__device__ __forceinline__ void add_part(float (&acc)[4], const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                         const uint32_t (&bs)[2]) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (BF16)
    uu::mma_tf32(part, ab, bb);
  else
    uu::mma_3xtf32(part, ab, as, bb, bs);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// acc[j] += a . b^T for the warp's 16 rows of a (at aw) against rows
// 8j..8j+7 of b, over the dk 8-column steps of D; both with pitch p.
template <int NT, bool BF16>
__device__ __forceinline__ void rows_dot(float (&acc)[NT][4], const float* aw, const float* b,
                                         int p, int dk, int nt, int g, int t) {
  for (int kk = 0; kk < dk; ++kk) {
    const float* a0 = aw + g * p + 8 * kk + t;
    uint32_t ab[4], as[4];
    split<BF16>(a0[0], ab[0], as[0]);
    split<BF16>(a0[8 * p], ab[1], as[1]);
    split<BF16>(a0[4], ab[2], as[2]);
    split<BF16>(a0[8 * p + 4], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const float* b0 = b + (8 * j + g) * p + 8 * kk + t;
        uint32_t bb[2], bs[2];
        split<BF16>(b0[0], bb[0], bs[0]);
        split<BF16>(b0[4], bb[1], bs[1]);
        add_part<BF16>(acc[j], ab, as, bb, bs);
      }
    }
  }
}

template <int NT, int CW, bool BF16>
__global__ void __launch_bounds__((NT + 1) / 2 * 32, NT <= 9 ? 2 : 1)
window_attention_bwd_tc_kernel(const float* __restrict__ qkv, const float* __restrict__ dctx,
                               const float* __restrict__ key_mask, float* __restrict__ dqkv,
                               int n, int c, int heads, float scale, bool vec) {
  extern __shared__ float4 bwd_smem[];  // 16-byte aligned for cp.async
  float* sm = reinterpret_cast<float*>(bwd_smem);
  const int d = c / heads, dp = (d + 7) & ~7, dk = dp / 8, p = uu::attn_v_pitch(dp);
  const int warps = blockDim.x / 32, nq = 16 * warps, nk = (n + 7) & ~7, nt = nk / 8;
  const int pp = uu::attn_qk_pitch(nq);
  float* qs = sm;             // nq x p
  float* gs = qs + nq * p;    // dO: nq x p
  float* ks = gs + nq * p;    // pass 1: nk x p
  float* vs = ks + nk * p;    // pass 1: nk x p
  float* pt = ks;             // pass 2: P^T, nq x pp (keys x queries)
  float* dst = pt + nq * pp;  // pass 2: dS^T
  float* mk = ks + max(2 * nk * p, 2 * nq * pp);  // nk additive key mask (log2 units)
  const int win = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t first = (size_t)win * n * 3 * c + (size_t)h * d;
  const float* dbase = dctx + (size_t)win * n * c + (size_t)h * d;
  uu::stage_head(qs, p, qkv + first, 3 * c, nq, n, d, dp, vec);
  uu::stage_head(ks, p, qkv + first + c, 3 * c, nk, n, d, dp, vec);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  uu::stage_head(gs, p, dbase, c, nq, n, d, dp, vec);
  uu::stage_head(vs, p, qkv + first + 2 * c, 3 * c, nk, n, d, dp, vec);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int j = threadIdx.x; j < nk; j += blockDim.x)
    mk[j] = j >= n ? -INFINITY
                   : key_mask ? key_mask[(size_t)win * n + j] * (-1e9f * uu::ATTN_LOG2E) : 0.f;
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
  if constexpr (BF16) {  // q / sqrt(D), the operand the TPU rounds
    for (int i = threadIdx.x; i < nq * p; i += blockDim.x) qs[i] *= scale;
    __syncthreads();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // ---- pass 1: the warp's 16 query rows ----------------------------------
  float s[NT][4], ds[NT][4];  // s: logits, then P; ds: dP, then dS
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = ds[j][e] = 0.f;
  rows_dot<NT, BF16>(s, qs + warp * 16 * p, ks, p, dk, nt, g, t);
  const float sl = BF16 ? uu::ATTN_LOG2E : scale * uu::ATTN_LOG2E;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      const float m0 = mk[8 * j + 2 * t], m1 = mk[8 * j + 2 * t + 1];
      s[j][0] = s[j][0] * sl + m0;
      s[j][1] = s[j][1] * sl + m1;
      s[j][2] = s[j][2] * sl + m0;
      s[j][3] = s[j][3] * sl + m1;
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
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] *= inv0;
    s[j][1] *= inv0;
    s[j][2] *= inv1;
    s[j][3] *= inv1;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  rows_dot<NT, BF16>(ds, gs + warp * 16 * p, vs, p, dk, nt, g, t);
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      rs0 = fmaf(s[j][0], ds[j][0], fmaf(s[j][1], ds[j][1], rs0));
      rs1 = fmaf(s[j][2], ds[j][2], fmaf(s[j][3], ds[j][3], rs1));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, o);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, o);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    ds[j][0] = s[j][0] * (ds[j][0] - rs0);
    ds[j][1] = s[j][1] * (ds[j][1] - rs0);
    ds[j][2] = s[j][2] * (ds[j][2] - rs1);
    ds[j][3] = s[j][3] * (ds[j][3] - rs1);
  }

  // dq = scale * dS . k, 8·CW columns of D per pass
  const int row0 = warp * 16 + g, row1 = row0 + 8;
  float* dq0 = dqkv + ((size_t)win * n + row0) * 3 * c + (size_t)h * d;
  float* dq1 = dq0 + (size_t)8 * 3 * c;
  for (int c0 = 0; c0 < dk; c0 += CW) {
    float o[CW][4];
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) o[cc][0] = o[cc][1] = o[cc][2] = o[cc][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        uint32_t ab[4], as[4];  // A column t is key 2t, column t+4 key 2t+1
        split<BF16>(ds[j][0], ab[0], as[0]);
        split<BF16>(ds[j][2], ab[1], as[1]);
        split<BF16>(ds[j][1], ab[2], as[2]);
        split<BF16>(ds[j][3], ab[3], as[3]);
        const float* kj = ks + (8 * j + 2 * t) * p + 8 * c0 + g;
#pragma unroll
        for (int cc = 0; cc < CW; ++cc) {
          if (c0 + cc < dk) {
            uint32_t bb[2], bs[2];
            split<BF16>(kj[8 * cc], bb[0], bs[0]);
            split<BF16>(kj[p + 8 * cc], bb[1], bs[1]);
            add_part<BF16>(o[cc], ab, as, bb, bs);
          }
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) {
      const int col = 8 * (c0 + cc) + 2 * t;
      if (c0 + cc < dk) {
        if (row0 < n) {
          if (col < d) dq0[col] = o[cc][0] * scale;
          if (col + 1 < d) dq0[col + 1] = o[cc][1] * scale;
        }
        if (row1 < n) {
          if (col < d) dq1[col] = o[cc][2] * scale;
          if (col + 1 < d) dq1[col + 1] = o[cc][3] * scale;
        }
      }
    }
  }

  // ---- P^T and dS^T over k and v ------------------------------------------
  __syncthreads();  // every warp is done with k and v
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      const int k0 = (8 * j + 2 * t) * pp, k1 = k0 + pp;
      pt[k0 + row0] = s[j][0];
      pt[k1 + row0] = s[j][1];
      pt[k0 + row1] = s[j][2];
      pt[k1 + row1] = s[j][3];
      dst[k0 + row0] = ds[j][0];
      dst[k1 + row0] = ds[j][1];
      dst[k0 + row1] = ds[j][2];
      dst[k1 + row1] = ds[j][3];
    }
  }
  for (int i = threadIdx.x; i < (nq - nk) * nq; i += blockDim.x) {  // padded key rows
    const int o = (nk + i / nq) * pp + i % nq;
    pt[o] = 0.f;
    dst[o] = 0.f;
  }
  __syncthreads();

  // ---- pass 2: the warp's 16 key rows ---------------------------------------
  const int key0 = warp * 16 + g, key1 = key0 + 8;
  float* dk0 = dqkv + ((size_t)win * n + key0) * 3 * c + c + (size_t)h * d;
  float* dk1 = dk0 + (size_t)8 * 3 * c;
  const float kscale = BF16 ? 1.f : scale;  // BF16: q carries 1/sqrt(D) already
  for (int c0 = 0; c0 < dk; c0 += CW) {
    float ok[CW][4], ov[CW][4];
#pragma unroll
    for (int cc = 0; cc < CW; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e) ok[cc][e] = ov[cc][e] = 0.f;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      if (i < nt) {
        // A column t is query 8i+2t, column t+4 query 8i+2t+1: one float2 a row
        const int a_off = key0 * pp + 8 * i + 2 * t;
        const float2 p0 = *reinterpret_cast<const float2*>(pt + a_off);
        const float2 p1 = *reinterpret_cast<const float2*>(pt + a_off + 8 * pp);
        const float2 s0 = *reinterpret_cast<const float2*>(dst + a_off);
        const float2 s1 = *reinterpret_cast<const float2*>(dst + a_off + 8 * pp);
        uint32_t pb[4], ps[4], sb[4], ss[4];
        split<BF16>(p0.x, pb[0], ps[0]);
        split<BF16>(p1.x, pb[1], ps[1]);
        split<BF16>(p0.y, pb[2], ps[2]);
        split<BF16>(p1.y, pb[3], ps[3]);
        split<BF16>(s0.x, sb[0], ss[0]);
        split<BF16>(s1.x, sb[1], ss[1]);
        split<BF16>(s0.y, sb[2], ss[2]);
        split<BF16>(s1.y, sb[3], ss[3]);
        const float* gi = gs + (8 * i + 2 * t) * p + 8 * c0 + g;
        const float* qi = qs + (8 * i + 2 * t) * p + 8 * c0 + g;
#pragma unroll
        for (int cc = 0; cc < CW; ++cc) {
          if (c0 + cc < dk) {
            uint32_t bb[2], bs[2];
            split<BF16>(gi[8 * cc], bb[0], bs[0]);
            split<BF16>(gi[p + 8 * cc], bb[1], bs[1]);
            add_part<BF16>(ov[cc], pb, ps, bb, bs);
            split<BF16>(qi[8 * cc], bb[0], bs[0]);
            split<BF16>(qi[p + 8 * cc], bb[1], bs[1]);
            add_part<BF16>(ok[cc], sb, ss, bb, bs);
          }
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) {
      const int col = 8 * (c0 + cc) + 2 * t;
      if (c0 + cc < dk) {
        // dk at column c + h*d + col of the row, dv C further
        if (key0 < n && col < d) {
          dk0[col] = ok[cc][0] * kscale;
          dk0[c + col] = ov[cc][0];
        }
        if (key0 < n && col + 1 < d) {
          dk0[col + 1] = ok[cc][1] * kscale;
          dk0[c + col + 1] = ov[cc][1];
        }
        if (key1 < n && col < d) {
          dk1[col] = ok[cc][2] * kscale;
          dk1[c + col] = ov[cc][2];
        }
        if (key1 < n && col + 1 < d) {
          dk1[col + 1] = ok[cc][3] * kscale;
          dk1[c + col + 1] = ov[cc][3];
        }
      }
    }
  }
}

template <int NT, int CW, bool BF16>
cudaError_t launch_attention_bwd_tc(const float* qkv, const float* dctx, const float* key_mask,
                                    float* dqkv, int windows, int n, int c, int heads,
                                    size_t smem, int threads, bool vec, cudaStream_t stream) {
  auto kernel = window_attention_bwd_tc_kernel<NT, CW, BF16>;
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (smem > (size_t)optin) return cudaErrorInvalidValue;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // BF16: fp32(1/sqrt(D)) rounded once from double, as the TPU kernel's
  // np.float32 constant and the forward's (attention.cuh QS)
  const float scale = BF16 ? (float)(1.0 / sqrt((double)(c / heads)))
                           : 1.f / sqrtf((float)(c / heads));
  kernel<<<(unsigned)windows * heads, threads, smem, stream>>>(
      qkv, dctx, key_mask, dqkv, n, c, heads, scale, vec);
  return cudaGetLastError();
}

template <int CW, bool BF16>
cudaError_t launch_attention_bwd_nt(const float* qkv, const float* dctx, const float* key_mask,
                                    float* dqkv, int windows, int n, int c, int heads,
                                    size_t smem, int threads, bool vec, cudaStream_t stream) {
  const int nt = (n + 7) / 8;
#define UU_ATTN_BWD_CASE(NT_)                                                            \
  if (nt <= NT_)                                                                         \
    return launch_attention_bwd_tc<NT_, CW, BF16>(qkv, dctx, key_mask, dqkv, windows, n, c, \
                                                  heads, smem, threads, vec, stream);
  UU_ATTN_BWD_CASE(3)
  UU_ATTN_BWD_CASE(6)
  UU_ATTN_BWD_CASE(9)
  UU_ATTN_BWD_CASE(12)
  UU_ATTN_BWD_CASE(16)
#undef UU_ATTN_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// out = residual + scale[row / rows_per_scale] * act(a . w + bias), branch =
// act(a . w + bias); a (m, k) row-major, k % 4 == 0; halves (2, n, k): w's
// TF32 halves transposed (temporal.cu's tf32_halves_f32); residual, branch,
// scale and bias optional; residual may alias out.
extern "C" int gemm_branch_f32(const float* a, const float* halves, const float* bias,
                               const float* scale, int rows_per_scale, const float* residual,
                               float* branch, float* out, int m, int n, int k, int relu,
                               void* stream) {
  if (scale && rows_per_scale <= 0) return cudaErrorInvalidValue;
  return uu::launch_gemm_tc(
      a, halves, m, n, k,
      ScaledBranch{bias, scale, rows_per_scale, residual, branch, out, n, relu},
      (cudaStream_t)stream);
}

// gemm_branch_f32 on the bf16 rung: plane (n, k) bf16, w rounded to bf16 and
// transposed; a rounded as it is read; the residual in by TMA, both outputs
// written by the consumers (ScaledBranchDirect); k % 8 == 0, n % 4 == 0,
// 16-byte aligned pointers.
extern "C" int gemm_branch_bf16(const float* a, const void* plane, const float* bias,
                                const float* scale, int rows_per_scale, const float* residual,
                                float* branch, float* out, int m, int n, int k, int relu,
                                void* stream) {
  ScaledBranchDirect::Maps maps;
  memset(&maps, 0, sizeof(maps));
  if ((scale && rows_per_scale <= 0) || m <= 0 || n % 4 || !uu::aligned16(out) ||
      !uu::aligned16(branch) || (residual && !uu::make_rows_map(&maps.in[0], residual, m, n)))
    return cudaErrorInvalidValue;
  return uu::launch_gemm_bf16(
      a, plane, m, n, k,
      ScaledBranchDirect{{bias, scale, rows_per_scale, residual, branch, out, n, relu}},
      (cudaStream_t)stream, uu::TmaA{}, maps);
}

// out (m, n) = ((a * scale[row / rows_per_scale]) . w^T), zeroed where
// mask <= 0; a (m, k) row-major, k % 4 == 0; halves (2, n, k): the TF32
// halves of w (n, k), the forward's (in, out) kernel, as stored.
extern "C" int gemm_dx_f32(const float* a, const float* scale, int rows_per_scale,
                           const float* halves, const float* mask, float* out, int m, int n,
                           int k, void* stream) {
  if (scale && rows_per_scale <= 0) return cudaErrorInvalidValue;
  return uu::launch_gemm_tc(a, halves, m, n, k,
                            ScaledMaskStore{scale, rows_per_scale, mask, out, n},
                            (cudaStream_t)stream);
}

// gemm_dx_f32 on the bf16 rung: plane (n, k) bf16, w rounded to bf16 as
// stored; a * scale rounded to bf16 (the factor applied before the rounding);
// the mask in and the output out by TMA (uu::DenseTmaStore); k % 8 == 0,
// n % 4 == 0, 16-byte aligned pointers.
extern "C" int gemm_dx_bf16(const float* a, const float* scale, int rows_per_scale,
                            const void* plane, const float* mask, float* out, int m, int n,
                            int k, void* stream) {
  if (scale && rows_per_scale <= 0) return cudaErrorInvalidValue;
  uu::TmaAScaled src;
  src.scale = scale;
  src.rows_per_scale = rows_per_scale;
  return uu::launch_gemm_bf16_tma(a, plane, m, n, k,
                                  uu::DenseTmaStore{nullptr, n, 0, mask ? 2 : 0}, mask, out,
                                  (cudaStream_t)stream, src);
}

// part (splits, m, n): chunk z of x^T . (dy * scale[row / rows_per_scale])
// over rows; x (rows, m), dy (rows, n), m and n multiples of 4. sum_rows_f32
// over the splits finishes it.
extern "C" int gemm_dw_f32(const float* x, const float* dy, const float* scale,
                           int rows_per_scale, float* part, int m, int n, int rows,
                           int splits, void* stream) {
  return uu::launch_gemm_atb(x, dy, scale, rows_per_scale, part, m, n, rows, splits,
                             (cudaStream_t)stream);
}

// gemm_dw_f32 on the bf16 rung: x and dy * scale rounded to bf16.
extern "C" int gemm_dw_bf16(const float* x, const float* dy, const float* scale,
                            int rows_per_scale, float* part, int m, int n, int rows,
                            int splits, void* stream) {
  return uu::launch_gemm_atb<true>(x, dy, scale, rows_per_scale, part, m, n, rows, splits,
                                   (cudaStream_t)stream);
}

// part (ceil(rows / 256), cols): column sums of x * scale[row / rows_per_scale]
// per chunk of 256 rows.
extern "C" int colsum_f32(const float* x, const float* scale, int rows_per_scale, float* part,
                          int rows, int cols, void* stream) {
  if (rows <= 0 || cols <= 0 || (scale && rows_per_scale <= 0)) return cudaErrorInvalidValue;
  const dim3 grid((cols + 255) / 256, (rows + COLSUM_ROWS - 1) / COLSUM_ROWS);
  colsum_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(x, scale, rows_per_scale, part, rows,
                                                        cols);
  return cudaGetLastError();
}

// dx = LN backward of dy (+ residual); part (workers, 2c) gamma/beta partials.
// workers must be a multiple of 8.
extern "C" int layernorm_bwd_f32(const float* x, const float* dy, const float* gamma,
                                 const float* residual, float* dx, float* part, int rows,
                                 int c, float eps, int workers, void* stream) {
  if (rows <= 0 || c <= 0 || c > 32 * LN_MAX_V || workers <= 0 || workers % LN_WARPS)
    return cudaErrorInvalidValue;
  layernorm_bwd_kernel<<<workers / LN_WARPS, LN_WARPS * 32, 0, (cudaStream_t)stream>>>(
      x, dy, gamma, residual, dx, part, rows, c, eps);
  return cudaGetLastError();
}

// out[w] = sum over window w's rows_per_window * c values of a * b.
extern "C" int window_dot_f32(const float* a, const float* b, float* out, int windows,
                              int rows_per_window, int c, void* stream) {
  if (windows <= 0 || rows_per_window <= 0 || c <= 0) return cudaErrorInvalidValue;
  window_dot_kernel<<<windows, DOT_THREADS, 0, (cudaStream_t)stream>>>(a, b, out,
                                                                      rows_per_window * c);
  return cudaGetLastError();
}

namespace {

template <bool BF16>
int attention_bwd_entry(const float* qkv, const float* dctx, const float* key_mask, float* dqkv,
                        int windows, int n, int c, int heads, void* stream) {
  if (windows <= 0 || n <= 0 || n > uu::ATTN_MAX_SEQ || heads <= 0 || c % heads != 0)
    return cudaErrorInvalidValue;
  const int d = c / heads, dp = (d + 7) & ~7, dk = dp / 8;
  const int warps = (n + 15) / 16, nq = 16 * warps, nk = (n + 7) & ~7;
  const int p = uu::attn_v_pitch(dp), pp = uu::attn_qk_pitch(nq);
  const size_t smem =
      sizeof(float) * (2 * (size_t)nq * p + std::max(2 * nk * p, 2 * nq * pp) + (size_t)nk);
  const auto aligned = [](const float* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; };
  const bool vec = aligned(qkv) && aligned(dctx) && c % 4 == 0 && d % 4 == 0;
  const int threads = warps * 32;
  cudaStream_t st = (cudaStream_t)stream;
  if (dk <= 2)
    return launch_attention_bwd_nt<2, BF16>(qkv, dctx, key_mask, dqkv, windows, n, c, heads,
                                            smem, threads, vec, st);
  if (dk <= 4)
    return launch_attention_bwd_nt<4, BF16>(qkv, dctx, key_mask, dqkv, windows, n, c, heads,
                                            smem, threads, vec, st);
  if (dk <= 6)
    return launch_attention_bwd_nt<6, BF16>(qkv, dctx, key_mask, dqkv, windows, n, c, heads,
                                            smem, threads, vec, st);
  return launch_attention_bwd_nt<8, BF16>(qkv, dctx, key_mask, dqkv, windows, n, c, heads,
                                          smem, threads, vec, st);
}

}  // namespace

// dqkv (windows*n, 3c) from qkv (windows*n, 3c) and dctx (windows*n, c);
// key_mask (windows, n), 1 = blocked, or null; n <= uu::ATTN_MAX_SEQ.
extern "C" int window_attention_bwd_f32(const float* qkv, const float* dctx,
                                        const float* key_mask, float* dqkv, int windows, int n,
                                        int c, int heads, void* stream) {
  return attention_bwd_entry<false>(qkv, dctx, key_mask, dqkv, windows, n, c, heads, stream);
}

// window_attention_bwd_f32 on the bf16 rung (the note at the top).
extern "C" int window_attention_bwd_bf16(const float* qkv, const float* dctx,
                                         const float* key_mask, float* dqkv, int windows,
                                         int n, int c, int heads, void* stream) {
  return attention_bwd_entry<true>(qkv, dctx, key_mask, dqkv, windows, n, c, heads, stream);
}

// K5's and K6's forward window attention on the bf16 rung: q scaled by
// 1/sqrt(D), then rounded (attention.cuh QS); qkv (windows*n, 3c).
extern "C" int window_attention_train_bf16(const float* qkv, const float* key_mask, float* out,
                                           int windows, int n, int c, int heads,
                                           void* stream) {
  // q's factor fp32(1/sqrt(D)), rounded once from double as the TPU
  // kernel's np.float32 constant
  return uu::launch_head_attention<true, true>(qkv, qkv + c, qkv + 2 * c, 3 * c, key_mask, out,
                                               windows, n, c, heads,
                                               (float)(1.0 / sqrt((double)(c / heads))),
                                               (cudaStream_t)stream);
}

// out[c] = sum over r (in order) of part[r, c].
extern "C" int sum_rows_f32(const float* part, float* out, int rows, int cols, void* stream) {
  return uu::launch_sum_rows(part, out, rows, cols, (cudaStream_t)stream);
}
