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
// as a torch.bfloat16 tensor) and dW, native bf16 mma.sync for the attention
// backward (mma_bf16.cuh) and one TF32 pass for the forward attention
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
//                     round(P)^T . round(dO) (pallas_temporal_bwd.py:510-521;
//                     window_attention_bwd_bf16_kernel: bf16 tiles, k16)
// LayerNorm, softmax, relu, biases, scales, residuals and sums stay fp32;
// every 3xTF32 instance compiles as before.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "attention.cuh"
#include "mma_bf16.cuh"
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

// The warp's 16 x 8 tile of sums (lane (g, t): rows g, g+8 of columns 2t,
// 2t+1, as an mma.sync accumulator leaves them) times f into `out` (row
// pitch `pitch`, the tile's first row and column at row0, col0), real rows
// < n and columns < d only. With `vec` (d and the pitch multiples of 4,
// 16-byte aligned rows) lanes t and t^1 trade a pair first, so that each
// lane writes 4 columns of one row in one 16-byte piece: even t row g's, odd
// t row g+8's, and a row's 8 columns fill one 32-byte sector.
__device__ __forceinline__ void store_tile(float* out, size_t pitch, int row0, int col0,
                                           const float (&o)[4], float f, int n, int d,
                                           bool vec, int g, int t) {
  if (vec) {
    const bool odd = t & 1;
    const float r0 = __shfl_xor_sync(0xffffffffu, odd ? o[0] : o[2], 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, odd ? o[1] : o[3], 1);
    const int row = row0 + g + (odd ? 8 : 0), col = col0 + 4 * (t >> 1);
    if (row < n && col < d)
      *reinterpret_cast<float4*>(out + row * pitch + col) =
          odd ? make_float4(r0 * f, r1 * f, o[2] * f, o[3] * f)
              : make_float4(o[0] * f, o[1] * f, r0 * f, r1 * f);
    return;
  }
  const int col = col0 + 2 * t;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = row0 + g + (e & 2 ? 8 : 0), cl = col + (e & 1);
    if (row < n && cl < d) out[row * pitch + cl] = o[e] * f;
  }
}

// rows x dp16 values of one head of an fp32 tensor (row stride `stride`) into
// a bf16 tile (row pitch pb): each value times `mul`, rounded to bf16; rows
// >= real and columns >= d zero. `vec`: float4 loads (d and the stride
// multiples of 4, a 16-byte aligned base), four in flight a thread.
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, int pb,
                                           const float* __restrict__ src, int stride, int rows,
                                           int real, int d, int dp16, float mul, bool vec) {
  if (vec) {
    const int quads = dp16 / 4, total = rows * quads;
    for (int i0 = threadIdx.x; i0 < total; i0 += 4 * blockDim.x) {
      float4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * blockDim.x, r = i / quads, e = (i % quads) * 4;
        x[u] = i < total && r < real && e < d
                   ? __ldg(reinterpret_cast<const float4*>(src + (size_t)r * stride + e))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * blockDim.x, r = i / quads, e = (i % quads) * 4;
        if (i < total)
          *reinterpret_cast<uint2*>(dst + r * pb + e) =
              make_uint2(uu::pack_bf16(x[u].x * mul, x[u].y * mul),
                         uu::pack_bf16(x[u].z * mul, x[u].w * mul));
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * dp16; i += blockDim.x) {
      const int r = i / dp16, e = i % dp16;
      dst[r * pb + e] =
          __float2bfloat16_rn(r < real && e < d ? src[(size_t)r * stride + e] * mul : 0.f);
    }
  }
}

// acc[j] += a . b^T on native bf16 for the warp's 16 rows of a (at aw)
// against rows 8j..8j+7 of b, over the dk16 16-column steps of D; both
// tiles of pitch pb. A fresh partial per step joins the fp32 sums. NT may be
// odd: key tile NT-1 then takes half of its pair's ldmatrix.
template <int NT>
__device__ __forceinline__ void rows_dot16(float (&acc)[NT][4], const __nv_bfloat16* aw,
                                           const __nv_bfloat16* b, int pb, int dk16, int nt,
                                           int lane) {
  const int lr = lane & 7, lm = lane >> 3;
  const __nv_bfloat16* pa = aw + (lr + 8 * (lm & 1)) * pb + 8 * (lm >> 1);
  const __nv_bfloat16* pbk = b + (lr + 8 * (lm >> 1)) * pb + 8 * (lm & 1);
  for (int kk = 0; kk < dk16; ++kk) {
    uint32_t a[4];
    uu::ldmatrix_x4(a, pa + 16 * kk);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j < nt) {
        uint32_t bb[4];  // key tiles j, j+1: columns 0-7 | 8-15 of the step
        uu::ldmatrix_x4(bb, pbk + 8 * j * pb + 16 * kk);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (j + u < NT) {
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            uu::mma_bf16(part, a, bb[2 * u], bb[2 * u + 1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j + u][e] += part[e];
          }
        }
      }
    }
  }
}

// The window-attention backward on the bf16 rung (window_attention_bwd_bf16),
// one thread block per (window, head), on native bf16 mma.sync.m16n8k16.
//
// What it computes (pallas_temporal_bwd.py:510-521 at DEFAULT): S =
// bf16(q/sqrt(D)) . bf16(k), P = softmax(S + mask) in fp32; dP = bf16(dO) .
// bf16(v)^T, dS = P * (dP - rowsum(P * dP)) in fp32; dq = bf16(dS) . bf16(k)
// times 1/sqrt(D), dk = bf16(dS)^T . bf16(q/sqrt(D)), dv = bf16(P)^T .
// bf16(dO); every sum fp32, a fresh partial per 16-deep step.
//
// Design: each operand is rounded once, as it is staged (float4 loads, four
// in flight a thread, into bf16 tiles: half the fp32 tiles' room), and every
// fragment comes by ldmatrix (transposed where the product wants a tile's
// columns: k for dq, q and dO for dk and dv). Pass 1, warp w: the query rows
// 16w..16w+15 of S and dP in registers, the softmax and dS there; dq takes
// dS's accumulators as its A fragments (two 8-key tiles are one 16-key
// step). P and dS, rounded, go to shared memory transposed by stmatrix over
// k's and v's room (pass 2 reads neither); pass 2, warp w: key rows
// 16w..16w+15 of dk and dv. dq, dk and dv leave as 16-byte pieces
// (store_tile). 45 KB of shared memory a block at 71 tokens (the 3xTF32
// instance's: 90 KB), so 4 blocks share an SM at a 96-register cap (3 at
// 115 registers ran 1.13x slower, kernel_probe.py on an H100); no atomics,
// one writer an output.
template <int NT, int CW>
__global__ void __launch_bounds__((NT + 1) / 2 * 32, NT <= 10 ? 4 : 1)
window_attention_bwd_bf16_kernel(const float* __restrict__ qkv, const float* __restrict__ dctx,
                                 const float* __restrict__ key_mask, float* __restrict__ dqkv,
                                 int n, int c, int heads, float scale, bool vec) {
  static_assert(CW % 2 == 0, "pairs of 8-column tiles");
  extern __shared__ float4 bwd_smem[];
  const int d = c / heads, dp = (d + 15) & ~15, pb = uu::attn_bf16_pitch(dp), dn = dp / 8;
  const int warps = blockDim.x / 32, nq = 16 * warps, nt = (n + 7) / 8;
  const int pp = uu::attn_bf16_pitch(nq);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(bwd_smem);  // bf16(q/sqrt(D)): nq x pb
  __nv_bfloat16* gs = qs + nq * pb;                                // bf16(dO)
  __nv_bfloat16* ks = gs + nq * pb;                                // pass 1: bf16(k)
  __nv_bfloat16* vs = ks + nq * pb;                                // pass 1: bf16(v)
  __nv_bfloat16* pt = ks;             // pass 2: bf16(P)^T, nq x pp (keys x queries)
  __nv_bfloat16* dst = pt + nq * pp;  // pass 2: bf16(dS)^T
  float* mk = reinterpret_cast<float*>(ks + max(2 * nq * pb, 2 * nq * pp));
  const int win = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t first = (size_t)win * n * 3 * c + (size_t)h * d;
  stage_bf16(qs, pb, qkv + first, 3 * c, nq, n, d, dp, scale, vec);
  stage_bf16(ks, pb, qkv + first + c, 3 * c, nq, n, d, dp, 1.f, vec);
  stage_bf16(gs, pb, dctx + (size_t)win * n * c + (size_t)h * d, c, nq, n, d, dp, 1.f, vec);
  stage_bf16(vs, pb, qkv + first + 2 * c, 3 * c, nq, n, d, dp, 1.f, vec);
  for (int j = threadIdx.x; j < nq; j += blockDim.x)
    mk[j] = j >= n ? -INFINITY
                   : key_mask ? key_mask[(size_t)win * n + j] * (-1e9f * uu::ATTN_LOG2E) : 0.f;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, lr = lane & 7, lm = lane >> 3;
  // ---- pass 1: the warp's 16 query rows -----------------------------------
  float s[NT][4], ds[NT][4];  // s: logits, then P; ds: dP
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = ds[j][e] = 0.f;
  rows_dot16<NT>(s, qs + warp * 16 * pb, ks, pb, dp / 16, nt, lane);
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      const float m0 = mk[8 * j + 2 * t], m1 = mk[8 * j + 2 * t + 1];
      s[j][0] = s[j][0] * uu::ATTN_LOG2E + m0;
      s[j][1] = s[j][1] * uu::ATTN_LOG2E + m1;
      s[j][2] = s[j][2] * uu::ATTN_LOG2E + m0;
      s[j][3] = s[j][3] * uu::ATTN_LOG2E + m1;
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
  rows_dot16<NT>(ds, gs + warp * 16 * pb, vs, pb, dp / 16, nt, lane);
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
  // bf16(P) and bf16(dS) as pairs: [j][0] row g, [j][1] row g+8, keys 8j+2t..
  uint32_t pr[NT][2], dr[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    pr[j][0] = uu::pack_bf16(s[j][0], s[j][1]);
    pr[j][1] = uu::pack_bf16(s[j][2], s[j][3]);
    dr[j][0] = uu::pack_bf16(s[j][0] * (ds[j][0] - rs0), s[j][1] * (ds[j][1] - rs0));
    dr[j][1] = uu::pack_bf16(s[j][2] * (ds[j][2] - rs1), s[j][3] * (ds[j][3] - rs1));
  }

  // dq = bf16(dS) . bf16(k) / sqrt(D), CW 8-column tiles of D per pass; k's
  // B fragments of the 16-key step (keys 0-7 | 8-15), transposed, for column
  // tiles cc, cc+1
  const __nv_bfloat16* kt = ks + (lr + 8 * (lm & 1)) * pb + 8 * (lm >> 1);
  float* dq = dqkv + (size_t)win * n * 3 * c + (size_t)h * d;
  for (int c0 = 0; c0 < dn; c0 += CW) {
    float o[CW][4];
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) o[cc][0] = o[cc][1] = o[cc][2] = o[cc][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j < nt) {
        const uint32_t a[4] = {dr[j][0], dr[j][1], j + 1 < NT ? dr[j + 1][0] : 0u,
                               j + 1 < NT ? dr[j + 1][1] : 0u};
#pragma unroll
        for (int cc = 0; cc < CW; cc += 2) {
          if (c0 + cc < dn) {
            uint32_t b[4];
            uu::ldmatrix_x4_trans(b, kt + 8 * j * pb + 8 * (c0 + cc));
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              float part[4] = {0.f, 0.f, 0.f, 0.f};
              uu::mma_bf16(part, a, b[2 * u], b[2 * u + 1]);
#pragma unroll
              for (int e = 0; e < 4; ++e) o[cc + u][e] += part[e];
            }
          }
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < CW; ++cc)
      if (c0 + cc < dn)
        store_tile(dq, 3 * (size_t)c, warp * 16, 8 * (c0 + cc), o[cc], scale, n, d, vec, g, t);
  }

  // ---- bf16(P)^T and bf16(dS)^T over k and v --------------------------------
  __syncthreads();  // every warp is done with k and v
  {
    // matrices: tile j rows g | g+8, tile j+1 rows g | g+8; lane l addresses
    // row l % 8 of its matrix's transpose: key 8(j + m/2) + l % 8
    const int key = 8 * (lm >> 1) + lr, q0 = warp * 16 + 8 * (lm & 1);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j < 2 * warps) {  // tiles past the real keys hold zeros (P = 0 there)
        const uint32_t rp[4] = {pr[j][0], pr[j][1], j + 1 < NT ? pr[j + 1][0] : 0u,
                                j + 1 < NT ? pr[j + 1][1] : 0u};
        const uint32_t rd[4] = {dr[j][0], dr[j][1], j + 1 < NT ? dr[j + 1][0] : 0u,
                                j + 1 < NT ? dr[j + 1][1] : 0u};
        uu::stmatrix_x4_trans(pt + (8 * j + key) * pp + q0, rp);
        uu::stmatrix_x4_trans(dst + (8 * j + key) * pp + q0, rd);
      }
    }
  }
  __syncthreads();

  // ---- pass 2: the warp's 16 key rows of dk and dv -------------------------
  // A fragments of P^T and dS^T: key rows 0-7 | 8-15, query columns 0-7 |
  // 8-15 of the step; B fragments of q and dO, transposed: query rows 0-7 |
  // 8-15 of the step, column tiles cc, cc+1
  const int a_off = (warp * 16 + lr + 8 * (lm & 1)) * pp + 8 * (lm >> 1);
  const int b_off = (lr + 8 * (lm & 1)) * pb + 8 * (lm >> 1);
  float* dk = dqkv + (size_t)win * n * 3 * c + c + (size_t)h * d;
  for (int c0 = 0; c0 < dn; c0 += CW) {
    float ok[CW][4], ov[CW][4];
#pragma unroll
    for (int cc = 0; cc < CW; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e) ok[cc][e] = ov[cc][e] = 0.f;
    for (int i = 0; i < warps; ++i) {  // 16-query steps
      uint32_t ap[4], as[4];
      uu::ldmatrix_x4(ap, pt + a_off + 16 * i);
      uu::ldmatrix_x4(as, dst + a_off + 16 * i);
#pragma unroll
      for (int cc = 0; cc < CW; cc += 2) {
        if (c0 + cc < dn) {
          uint32_t bq[4], bg[4];
          uu::ldmatrix_x4_trans(bq, qs + b_off + 16 * i * pb + 8 * (c0 + cc));
          uu::ldmatrix_x4_trans(bg, gs + b_off + 16 * i * pb + 8 * (c0 + cc));
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float pk[4] = {0.f, 0.f, 0.f, 0.f}, pv[4] = {0.f, 0.f, 0.f, 0.f};
            uu::mma_bf16(pk, as, bq[2 * u], bq[2 * u + 1]);
            uu::mma_bf16(pv, ap, bg[2 * u], bg[2 * u + 1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ok[cc + u][e] += pk[e];
              ov[cc + u][e] += pv[e];
            }
          }
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) {
      if (c0 + cc < dn) {  // dk at column c + h*d of the row, dv C further
        store_tile(dk, 3 * (size_t)c, warp * 16, 8 * (c0 + cc), ok[cc], 1.f, n, d, vec, g, t);
        store_tile(dk + c, 3 * (size_t)c, warp * 16, 8 * (c0 + cc), ov[cc], 1.f, n, d, vec, g,
                   t);
      }
    }
  }
}

// The window-attention backward on the tensor cores in 3xTF32
// (window_attention_bwd_f32, "high" and "highest"), one thread block per
// (window, head): dS = P * (dP - rowsum(P * dP)) with P recomputed and
// dP = dO . v^T; dq = scale * dS . k, dk = scale * dS^T . q, dv = P^T . dO.
//
// Replaces: uplift_upsample_tpu/ops/pallas_temporal_bwd.py:510-521, the
//   per-head loop inside _fts_impl_bwd (pallas_call at :681).
//
// What bounds it: bytes at best (q, k, v and dO read, dq, dk, dv written:
// 391 MB at 512 windows x 71 x 384, 0.117 ms); its five products, 9.9
// GFLOP with S recomputed, run on mma.sync in 3xTF32 (tf32.cuh), and they
// take most of its time (kernel_probe.py on an H100: 0.586 ms, 0.195
// without them, 0.519 without the TF32 splits).
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
//  - Pass 2: dk and dv sum over every warp's queries, so dS^T, then P^T, go
//    to shared memory (one tile over k and v, which pass 2 no longer reads),
//    and warp w owns key rows 16w..16w+15 for dk = dS^T . q, then dv = P^T .
//    dO, the queries permuted the same way so that each A fragment is one
//    float2 load per row. One transposed tile at a time: 63 KB a block at 71
//    tokens, so 3 blocks share an SM (the two tiles at once took 90 KB: 2).
//  - Every 8-deep step's three products go into a fresh partial that joins
//    the fp32 accumulators with a rounded add: the tensor cores round toward
//    zero as they accumulate (tests/test_torch_attention_bwd_tc.py emulates
//    the order). The splits into TF32 halves stay per warp: they cost 11 %
//    of the kernel (kernel_probe.py on an H100), and halves split once as
//    staged would double the tiles. dq, dk and dv leave as 16-byte pieces
//    (store_tile). Each output element has one writer, no atomics: repeated
//    runs agree bit for bit.
__device__ __forceinline__ void add_part(float (&acc)[4], const uint32_t (&ab)[4],
                                         const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                         const uint32_t (&bs)[2]) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  uu::mma_3xtf32(part, ab, as, bb, bs);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// acc[j] += a . b^T for the warp's 16 rows of a (at aw) against rows
// 8j..8j+7 of b, over the dk 8-column steps of D; both with pitch p.
template <int NT>
__device__ __forceinline__ void rows_dot(float (&acc)[NT][4], const float* aw, const float* b,
                                         int p, int dk, int nt, int g, int t) {
  for (int kk = 0; kk < dk; ++kk) {
    const float* a0 = aw + g * p + 8 * kk + t;
    uint32_t ab[4], as[4];
    uu::tf32_split(a0[0], ab[0], as[0]);
    uu::tf32_split(a0[8 * p], ab[1], as[1]);
    uu::tf32_split(a0[4], ab[2], as[2]);
    uu::tf32_split(a0[8 * p + 4], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const float* b0 = b + (8 * j + g) * p + 8 * kk + t;
        uint32_t bb[2], bs[2];
        uu::tf32_split(b0[0], bb[0], bs[0]);
        uu::tf32_split(b0[4], bb[1], bs[1]);
        add_part(acc[j], ab, as, bb, bs);
      }
    }
  }
}

// One of pass 2's products for the warp's 16 key rows: acc += xt^T . y over
// the queries, xt the transposed tile (keys x queries, pitch pp), y q or dO
// (pitch p), 8·CW columns of D from c0; every warp's tile rows written first.
template <int NT, int CW>
__device__ __forceinline__ void keys_dot(float (&acc)[CW][4], const float* xt, const float* y,
                                         int pp, int p, int c0, int dk, int nt, int key0, int g,
                                         int t) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    if (i < nt) {
      // A column t is query 8i+2t, column t+4 query 8i+2t+1: one float2 a row
      const int a_off = key0 * pp + 8 * i + 2 * t;
      const float2 x0 = *reinterpret_cast<const float2*>(xt + a_off);
      const float2 x1 = *reinterpret_cast<const float2*>(xt + a_off + 8 * pp);
      uint32_t ab[4], as[4];
      uu::tf32_split(x0.x, ab[0], as[0]);
      uu::tf32_split(x1.x, ab[1], as[1]);
      uu::tf32_split(x0.y, ab[2], as[2]);
      uu::tf32_split(x1.y, ab[3], as[3]);
      const float* yi = y + (8 * i + 2 * t) * p + 8 * c0 + g;
#pragma unroll
      for (int cc = 0; cc < CW; ++cc) {
        if (c0 + cc < dk) {
          uint32_t bb[2], bs[2];
          uu::tf32_split(yi[8 * cc], bb[0], bs[0]);
          uu::tf32_split(yi[p + 8 * cc], bb[1], bs[1]);
          add_part(acc[cc], ab, as, bb, bs);
        }
      }
    }
  }
}

// P^T or dS^T (x: the warp's accumulators, rows g, g+8 of keys 8j+2t, 8j+2t+1)
// into the keys x queries tile xt (pitch pp); padded key rows zero.
template <int NT>
__device__ __forceinline__ void store_transposed(float* xt, const float (&x)[NT][4], int pp,
                                                 int nq, int nk, int nt, int row0, int t) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      const int k0 = (8 * j + 2 * t) * pp, k1 = k0 + pp;
      xt[k0 + row0] = x[j][0];
      xt[k1 + row0] = x[j][1];
      xt[k0 + row1] = x[j][2];
      xt[k1 + row1] = x[j][3];
    }
  }
  for (int i = threadIdx.x; i < (nq - nk) * nq; i += blockDim.x)  // padded key rows
    xt[(nk + i / nq) * pp + i % nq] = 0.f;
}

template <int NT, int CW>
__global__ void __launch_bounds__((NT + 1) / 2 * 32, NT <= 9 ? 3 : 1)
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
  float* xt = ks;             // pass 2: dS^T, then P^T, nq x pp (keys x queries)
  float* mk = ks + max(2 * nk * p, nq * pp);  // nk additive key mask (log2 units)
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

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // ---- pass 1: the warp's 16 query rows ----------------------------------
  float s[NT][4], ds[NT][4];  // s: logits, then P; ds: dP, then dS
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = ds[j][e] = 0.f;
  rows_dot<NT>(s, qs + warp * 16 * p, ks, p, dk, nt, g, t);
  const float sl = scale * uu::ATTN_LOG2E;
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
  rows_dot<NT>(ds, gs + warp * 16 * p, vs, p, dk, nt, g, t);
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
  float* dq = dqkv + (size_t)win * n * 3 * c + (size_t)h * d;
  for (int c0 = 0; c0 < dk; c0 += CW) {
    float o[CW][4];
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) o[cc][0] = o[cc][1] = o[cc][2] = o[cc][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        uint32_t ab[4], as[4];  // A column t is key 2t, column t+4 key 2t+1
        uu::tf32_split(ds[j][0], ab[0], as[0]);
        uu::tf32_split(ds[j][2], ab[1], as[1]);
        uu::tf32_split(ds[j][1], ab[2], as[2]);
        uu::tf32_split(ds[j][3], ab[3], as[3]);
        const float* kj = ks + (8 * j + 2 * t) * p + 8 * c0 + g;
#pragma unroll
        for (int cc = 0; cc < CW; ++cc) {
          if (c0 + cc < dk) {
            uint32_t bb[2], bs[2];
            uu::tf32_split(kj[8 * cc], bb[0], bs[0]);
            uu::tf32_split(kj[p + 8 * cc], bb[1], bs[1]);
            add_part(o[cc], ab, as, bb, bs);
          }
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < CW; ++cc)
      if (c0 + cc < dk)
        store_tile(dq, 3 * (size_t)c, warp * 16, 8 * (c0 + cc), o[cc], scale, n, d, vec, g, t);
  }

  // ---- pass 2: the warp's 16 key rows; dS^T, then P^T, over k and v ----------
  const int key0 = warp * 16 + g;
  float* dk_out = dqkv + (size_t)win * n * 3 * c + c + (size_t)h * d;
  __syncthreads();  // every warp is done with k and v
  store_transposed<NT>(xt, ds, pp, nq, nk, nt, warp * 16 + g, t);
  __syncthreads();
  for (int c0 = 0; c0 < dk; c0 += CW) {  // dk = scale * dS^T . q
    float acc[CW][4];
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) acc[cc][0] = acc[cc][1] = acc[cc][2] = acc[cc][3] = 0.f;
    keys_dot<NT, CW>(acc, xt, qs, pp, p, c0, dk, nt, key0, g, t);
#pragma unroll
    for (int cc = 0; cc < CW; ++cc)
      if (c0 + cc < dk)
        store_tile(dk_out, 3 * (size_t)c, warp * 16, 8 * (c0 + cc), acc[cc], scale, n, d, vec,
                   g, t);
  }
  __syncthreads();  // every warp is done with dS^T
  store_transposed<NT>(xt, s, pp, nq, nk, nt, warp * 16 + g, t);
  __syncthreads();
  for (int c0 = 0; c0 < dk; c0 += CW) {  // dv = P^T . dO
    float acc[CW][4];
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) acc[cc][0] = acc[cc][1] = acc[cc][2] = acc[cc][3] = 0.f;
    keys_dot<NT, CW>(acc, xt, gs, pp, p, c0, dk, nt, key0, g, t);
#pragma unroll
    for (int cc = 0; cc < CW; ++cc)
      if (c0 + cc < dk)
        store_tile(dk_out + c, 3 * (size_t)c, warp * 16, 8 * (c0 + cc), acc[cc], 1.f, n, d, vec,
                   g, t);
  }
}

template <int NT, int CW>
cudaError_t launch_attention_bwd_tc(const float* qkv, const float* dctx, const float* key_mask,
                                    float* dqkv, int windows, int n, int c, int heads,
                                    size_t smem, int threads, bool vec, cudaStream_t stream) {
  auto kernel = window_attention_bwd_tc_kernel<NT, CW>;
  const cudaError_t err = uu::attn_opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)windows * heads, threads, smem, stream>>>(
      qkv, dctx, key_mask, dqkv, n, c, heads, 1.f / sqrtf((float)(c / heads)), vec);
  return cudaGetLastError();
}

template <int CW>
cudaError_t launch_attention_bwd_nt(const float* qkv, const float* dctx, const float* key_mask,
                                    float* dqkv, int windows, int n, int c, int heads,
                                    size_t smem, int threads, bool vec, cudaStream_t stream) {
  const int nt = (n + 7) / 8;
#define UU_ATTN_BWD_CASE(NT_)                                                                \
  if (nt <= NT_)                                                                             \
    return launch_attention_bwd_tc<NT_, CW>(qkv, dctx, key_mask, dqkv, windows, n, c, heads, \
                                            smem, threads, vec, stream);
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

template <int CW>
cudaError_t launch_attention_bwd_bf16(const float* qkv, const float* dctx, const float* key_mask,
                                      float* dqkv, int windows, int n, int c, int heads,
                                      bool vec, cudaStream_t stream) {
  const int d = c / heads, dp = (d + 15) & ~15, pb = uu::attn_bf16_pitch(dp);
  const int warps = (n + 15) / 16, nq = 16 * warps, pp = uu::attn_bf16_pitch(nq);
  const size_t smem = sizeof(__nv_bfloat16) * (2 * (size_t)nq * pb +
                                               std::max(2 * nq * pb, 2 * nq * pp)) +
                      sizeof(float) * nq;
  // fp32(1/sqrt(D)) rounded once from double, as the TPU kernel's np.float32
  // constant and the forward's (attention.cuh QS)
  const float scale = (float)(1.0 / sqrt((double)d));
  const int nt = (n + 7) / 8;
#define UU_ATTN_BWD_BF16_CASE(NT_)                                                     \
  if (nt <= NT_) {                                                                     \
    auto kernel = window_attention_bwd_bf16_kernel<NT_, CW>;                           \
    const cudaError_t err = uu::attn_opt_in(kernel, smem);                             \
    if (err != cudaSuccess) return err;                                                \
    kernel<<<(unsigned)windows * heads, warps * 32, smem, stream>>>(qkv, dctx, key_mask, \
                                                                    dqkv, n, c, heads,   \
                                                                    scale, vec);         \
    return cudaGetLastError();                                                         \
  }
  UU_ATTN_BWD_BF16_CASE(3)
  UU_ATTN_BWD_BF16_CASE(6)
  UU_ATTN_BWD_BF16_CASE(9)
  UU_ATTN_BWD_BF16_CASE(12)
  UU_ATTN_BWD_BF16_CASE(16)
#undef UU_ATTN_BWD_BF16_CASE
  return cudaErrorInvalidValue;
}

template <bool BF16>
int attention_bwd_entry(const float* qkv, const float* dctx, const float* key_mask, float* dqkv,
                        int windows, int n, int c, int heads, void* stream) {
  if (windows <= 0 || n <= 0 || n > uu::ATTN_MAX_SEQ || heads <= 0 || c % heads != 0)
    return cudaErrorInvalidValue;
  const auto aligned = [](const float* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; };
  const int d = c / heads;
  // 16-byte loads and stores: D and the rows multiples of 4 floats, aligned bases
  const bool vec = aligned(qkv) && aligned(dctx) && aligned(dqkv) && c % 4 == 0 && d % 4 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (BF16) {
    const int dn = (d + 15) / 16 * 2;  // 8-column tiles of D padded to 16
#define UU_ATTN_BWD_BF16_CW(CW_)                                                              \
  return launch_attention_bwd_bf16<CW_>(qkv, dctx, key_mask, dqkv, windows, n, c, heads, vec, \
                                        st);
    if (dn <= 2) UU_ATTN_BWD_BF16_CW(2)
    if (dn <= 4) UU_ATTN_BWD_BF16_CW(4)
    if (dn <= 6) UU_ATTN_BWD_BF16_CW(6)
    UU_ATTN_BWD_BF16_CW(8)
#undef UU_ATTN_BWD_BF16_CW
  } else {
    const int dp = (d + 7) & ~7, dk = dp / 8;
    const int warps = (n + 15) / 16, nq = 16 * warps, nk = (n + 7) & ~7;
    const int p = uu::attn_v_pitch(dp), pp = uu::attn_qk_pitch(nq);
    const size_t smem =
        sizeof(float) * (2 * (size_t)nq * p + std::max(2 * nk * p, nq * pp) + (size_t)nk);
    const int threads = warps * 32;
#define UU_ATTN_BWD_CW(CW_)                                                                 \
  return launch_attention_bwd_nt<CW_>(qkv, dctx, key_mask, dqkv, windows, n, c, heads, smem, \
                                      threads, vec, st);
    if (dk <= 2) UU_ATTN_BWD_CW(2)
    if (dk <= 4) UU_ATTN_BWD_CW(4)
    if (dk <= 6) UU_ATTN_BWD_CW(6)
    UU_ATTN_BWD_CW(8)
#undef UU_ATTN_BWD_CW
  }
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
