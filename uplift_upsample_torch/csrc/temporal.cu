// K2 — the temporal transformer stack, as a few hand-written kernels per block.
//
// Replaces: uplift_upsample_tpu/ops/pallas_temporal_v3.py
//   fused_temporal_stack_v3 (kernel _make_kernel_v3, attn_mode="full"): 4
//   pre-norm blocks over (B, 71, 384), 8 heads of depth 48, relu MLP
//   384 -> 768 -> 384, additive -1e9 key mask on stride-masked frames for the
//   first `first_masked_blocks` blocks. K3 (strided.cu) reuses these kernels.
//
// What bounds it here: the dense layers, ~0.17 TFLOP per block at B=1,024
// windows, are compute-bound against the 67 TFLOP/s fp32 CUDA-core peak; the
// weights (4.7 MB per block in fp32) do not fit in shared memory, so one block
// is seven launches: LayerNorm, qkv GEMM, window attention, proj GEMM (+
// residual), LayerNorm, fc1 GEMM (+ relu), fc2 GEMM (+ residual). The
// activations of one launch stay in L2 (50 MB) for the next where they fit.
//
// Design: rows are the B*71 real tokens; no 72-token padding, no
// block-diagonal window mask (the TPU kernel's Mosaic workarounds): each
// attention thread block owns one (window, head) and attends only inside it.

#include <cuda_runtime.h>
#include <math.h>

#include "gemm.cuh"

namespace {

// One warp per row of c values: y = LN(x + pe) * gamma + beta; optionally
// also writes x + pe to x_out (the residual stream of a block that adds a PE).
__global__ void layernorm_kernel(const float* __restrict__ x, const float* __restrict__ pe,
                                 const float* __restrict__ gamma, const float* __restrict__ beta,
                                 float* x_out, float* __restrict__ y, int rows, int c,
                                 int pe_rows, float eps) {
  const int warps = blockDim.x / 32;
  const int row = blockIdx.x * warps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * c;
  const float* pr = pe ? pe + (size_t)(row % pe_rows) * c : nullptr;
  float s = 0.f;
  for (int e = lane; e < c; e += 32) s += pr ? xr[e] + pr[e] : xr[e];
  const float mu = uu::warp_sum(s) / c;
  float v = 0.f;
  for (int e = lane; e < c; e += 32) {
    const float d = (pr ? xr[e] + pr[e] : xr[e]) - mu;
    v += d * d;
  }
  const float inv = 1.f / sqrtf(uu::warp_sum(v) / c + eps);
  for (int e = lane; e < c; e += 32) {
    const float xv = pr ? xr[e] + pr[e] : xr[e];
    if (x_out) x_out[(size_t)row * c + e] = xv;
    y[(size_t)row * c + e] = (xv - mu) * inv * gamma[e] + beta[e];
  }
}

constexpr int ATTN_WARPS = 8;

// One thread block per (window, head). The window's keys and values for the
// head sit in shared memory (keys with a padded row stride d+1, so the lanes
// of a warp, one key each, hit distinct banks); each warp takes query rows in
// turn: logits = q.k * scale + mask, max-subtracted softmax, context.
__global__ void __launch_bounds__(ATTN_WARPS * 32)
window_attention_kernel(const float* __restrict__ qkv, const float* __restrict__ key_mask,
                        float* __restrict__ out, int n, int c, int heads, float scale) {
  extern __shared__ float sm[];
  const int d = c / heads;
  const int win = blockIdx.x / heads, h = blockIdx.x % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* ks = sm;                    // n x (d + 1)
  float* vs = ks + n * (d + 1);      // n x d
  float* mk = vs + n * d;            // n additive key mask
  float* qrow = mk + n;              // ATTN_WARPS x d
  float* prow = qrow + ATTN_WARPS * d;  // ATTN_WARPS x n
  const float* base = qkv + (size_t)win * n * 3 * c;
  for (int idx = threadIdx.x; idx < n * d; idx += blockDim.x) {
    const int t = idx / d, e = idx % d;
    ks[t * (d + 1) + e] = base[(size_t)t * 3 * c + c + h * d + e];
    vs[t * d + e] = base[(size_t)t * 3 * c + 2 * c + h * d + e];
  }
  for (int t = threadIdx.x; t < n; t += blockDim.x)
    mk[t] = key_mask ? key_mask[(size_t)win * n + t] * -1e9f : 0.f;
  __syncthreads();
  float* q = qrow + warp * d;
  float* p = prow + warp * n;
  for (int t = warp; t < n; t += ATTN_WARPS) {
    for (int e = lane; e < d; e += 32) q[e] = base[(size_t)t * 3 * c + h * d + e];
    __syncwarp();
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kj = ks + j * (d + 1);
      float s = 0.f;
      for (int e = 0; e < d; ++e) s = fmaf(q[e], kj[e], s);
      s = s * scale + mk[j];
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = uu::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float ex = expf(p[j] - mx);
      p[j] = ex;
      sum += ex;
    }
    sum = uu::warp_sum(sum);
    __syncwarp();
    for (int e = lane; e < d; e += 32) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(p[j], vs[j * d + e], acc);
      out[((size_t)win * n + t) * c + h * d + e] = acc / sum;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int gemm_f32(const float* a, const float* w, const float* bias,
                        const float* residual, float* out, int m, int n, int k,
                        int relu, void* stream) {
  return uu::launch_gemm(uu::RowMajorA{a, k}, uu::RowMajorB{w, n}, m, n, k,
                         uu::BiasActResidual{bias, residual, out, n, relu},
                         (cudaStream_t)stream);
}

extern "C" int layernorm_f32(const float* x, const float* pe, const float* gamma,
                             const float* beta, float* x_out, float* y, int rows,
                             int c, int pe_rows, float eps, void* stream) {
  if (rows <= 0 || c <= 0 || (pe && pe_rows <= 0)) return cudaErrorInvalidValue;
  const int warps = 8;
  layernorm_kernel<<<(rows + warps - 1) / warps, warps * 32, 0, (cudaStream_t)stream>>>(
      x, pe, gamma, beta, x_out, y, rows, c, pe_rows, eps);
  return cudaGetLastError();
}

extern "C" int window_attention_f32(const float* qkv, const float* key_mask, float* out,
                                    int windows, int n, int c, int heads, void* stream) {
  if (windows <= 0 || n <= 0 || heads <= 0 || c % heads != 0) return cudaErrorInvalidValue;
  const int d = c / heads;
  const size_t smem = sizeof(float) *
      ((size_t)n * (d + 1) + (size_t)n * d + n + ATTN_WARPS * d + ATTN_WARPS * (size_t)n);
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (smem > (size_t)optin) return cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        window_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  window_attention_kernel<<<windows * heads, ATTN_WARPS * 32, smem, (cudaStream_t)stream>>>(
      qkv, key_mask, out, n, c, heads, 1.f / sqrtf((float)d));
  return cudaGetLastError();
}
