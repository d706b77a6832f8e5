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
//                                 (window, head), softmax recomputed
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
// operands are both MN-major, on mma.sync (gemm_atb_kernel).

#include <cuda_runtime.h>
#include <math.h>

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
  __device__ __forceinline__ void operator()(int r, int c, float v) const {
    if (bias) v += bias[c];
    if (relu) v = fmaxf(v, 0.f);
    const size_t o = (size_t)r * n + c;
    if (branch) branch[o] = v;
    v *= uu::row_factor(scale, rows_per_scale, r);
    out[o] = residual ? residual[o] + v : v;
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
  __device__ __forceinline__ void operator()(int r, int c, float v) const {
    const size_t o = (size_t)r * n + c;
    out[o] = (mask && !(mask[o] > 0.f)) ? 0.f : v * uu::row_factor(scale, rows_per_scale, r);
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

constexpr int ATTN_WARPS = 8;

// One thread block per (window, head): recompute the softmax P, then
// dS = P * (dP - rowsum(P * dP)) with dP = dctx . v^T, and
// dq = scale * dS . k, dk = scale * dS^T . q, dv = P^T . dctx.
// q/k/v/dctx rows use a stride of d+1 floats so a warp's lanes, one key
// each, hit distinct banks.
__global__ void __launch_bounds__(ATTN_WARPS * 32)
window_attention_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ dctx,
                            const float* __restrict__ key_mask, float* __restrict__ dqkv,
                            int n, int c, int heads, float scale) {
  extern __shared__ float sm[];
  const int d = c / heads, ds = d + 1;
  const int win = blockIdx.x / heads, h = blockIdx.x % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qs = sm;
  float* ks = qs + n * ds;
  float* vs = ks + n * ds;
  float* gs = vs + n * ds;  // dctx
  float* mk = gs + n * ds;
  float* pm = mk + n;        // n x (n+1): P
  float* dsm = pm + n * (n + 1);  // n x (n+1): dS
  const int ps = n + 1;
  const float* base = qkv + (size_t)win * n * 3 * c;
  const float* gbase = dctx + (size_t)win * n * c;
  for (int idx = threadIdx.x; idx < n * d; idx += blockDim.x) {
    const int t = idx / d, e = idx % d;
    qs[t * ds + e] = base[(size_t)t * 3 * c + h * d + e];
    ks[t * ds + e] = base[(size_t)t * 3 * c + c + h * d + e];
    vs[t * ds + e] = base[(size_t)t * 3 * c + 2 * c + h * d + e];
    gs[t * ds + e] = gbase[(size_t)t * c + h * d + e];
  }
  for (int t = threadIdx.x; t < n; t += blockDim.x)
    mk[t] = key_mask ? key_mask[(size_t)win * n + t] * -1e9f : 0.f;
  __syncthreads();
  for (int t = warp; t < n; t += ATTN_WARPS) {
    const float* q = qs + t * ds;
    const float* g = gs + t * ds;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kj = ks + j * ds;
      float s = 0.f;
      for (int e = 0; e < d; ++e) s = fmaf(q[e], kj[e], s);
      s = s * scale + mk[j];
      pm[t * ps + j] = s;
      mx = fmaxf(mx, s);
    }
    mx = uu::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float ex = expf(pm[t * ps + j] - mx);
      pm[t * ps + j] = ex;
      sum += ex;
    }
    sum = uu::warp_sum(sum);
    float sd = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = pm[t * ps + j] / sum;
      const float* vj = vs + j * ds;
      float dp = 0.f;
      for (int e = 0; e < d; ++e) dp = fmaf(g[e], vj[e], dp);
      pm[t * ps + j] = p;
      dsm[t * ps + j] = dp;
      sd = fmaf(p, dp, sd);
    }
    sd = uu::warp_sum(sd);
    for (int j = lane; j < n; j += 32)
      dsm[t * ps + j] = pm[t * ps + j] * (dsm[t * ps + j] - sd);
  }
  __syncthreads();
  float* out = dqkv + (size_t)win * n * 3 * c;
  for (int idx = threadIdx.x; idx < n * d; idx += blockDim.x) {
    const int t = idx / d, e = idx % d;
    float dq = 0.f, dk = 0.f, dv = 0.f;
    for (int j = 0; j < n; ++j) {
      dq = fmaf(dsm[t * ps + j], ks[j * ds + e], dq);
      dk = fmaf(dsm[j * ps + t], qs[j * ds + e], dk);
      dv = fmaf(pm[j * ps + t], gs[j * ds + e], dv);
    }
    out[(size_t)t * 3 * c + h * d + e] = dq * scale;
    out[(size_t)t * 3 * c + c + h * d + e] = dk * scale;
    out[(size_t)t * 3 * c + 2 * c + h * d + e] = dv;
  }
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

// part (splits, m, n): chunk z of x^T . (dy * scale[row / rows_per_scale])
// over rows; x (rows, m), dy (rows, n), m and n multiples of 4. sum_rows_f32
// over the splits finishes it.
extern "C" int gemm_dw_f32(const float* x, const float* dy, const float* scale,
                           int rows_per_scale, float* part, int m, int n, int rows,
                           int splits, void* stream) {
  if (reinterpret_cast<uintptr_t>(x) % 16) return cudaErrorInvalidValue;
  return uu::launch_gemm_atb(uu::DenseRows{x, m}, dy, scale, rows_per_scale, part, m, n, rows,
                             splits, (cudaStream_t)stream);
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

// dqkv (windows*n, 3c) from qkv (windows*n, 3c) and dctx (windows*n, c);
// key_mask (windows, n), 1 = blocked, or null.
extern "C" int window_attention_bwd_f32(const float* qkv, const float* dctx,
                                        const float* key_mask, float* dqkv, int windows, int n,
                                        int c, int heads, void* stream) {
  if (windows <= 0 || n <= 0 || heads <= 0 || c % heads != 0) return cudaErrorInvalidValue;
  const int d = c / heads;
  const size_t smem = sizeof(float) * (4 * (size_t)n * (d + 1) + n + 2 * (size_t)n * (n + 1));
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (smem > (size_t)optin) return cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        window_attention_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  window_attention_bwd_kernel<<<windows * heads, ATTN_WARPS * 32, smem,
                                (cudaStream_t)stream>>>(qkv, dctx, key_mask, dqkv, n, c,
                                                        heads, 1.f / sqrtf((float)d));
  return cudaGetLastError();
}

// out[c] = sum over r (in order) of part[r, c].
extern "C" int sum_rows_f32(const float* part, float* out, int rows, int cols, void* stream) {
  return uu::launch_sum_rows(part, out, rows, cols, (cudaStream_t)stream);
}
