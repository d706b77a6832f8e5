// Shared device code of K2's window attention (temporal.cu) and row 11's
// packed attention (attention.cu): softmax(q kᵀ · scale + mask · -1e9) v per
// (sequence, head), one thread block each.
//
// q, k and v are read through base pointers and one row stride, so the same
// kernel serves K2's packed q|k|v rows (k = q + C, v = q + 2C, stride 3C) and
// row 11's three (F, S, C) tensors (stride C). The output is (F, S, C).
//
// The head's keys and values sit in shared memory (keys with a padded row
// stride d+1, so the lanes of a warp, one key each, hit distinct banks); each
// warp takes query rows in turn: logits = q.k * scale + mask, max-subtracted
// softmax, context. The mask is additive and finite (-1e9 per blocked key),
// so a row whose keys are all blocked still takes a softmax over them.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "gemm.cuh"

namespace uu {

constexpr int ATTN_WARPS = 8;

__global__ void __launch_bounds__(ATTN_WARPS * 32)
head_attention_kernel(const float* __restrict__ q_base, const float* __restrict__ k_base,
                      const float* __restrict__ v_base, int row_stride,
                      const float* __restrict__ key_mask, float* __restrict__ out,
                      int n, int c, int heads, float scale) {
  extern __shared__ float sm[];
  const int d = c / heads;
  const int seq = blockIdx.x / heads, h = blockIdx.x % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* ks = sm;                    // n x (d + 1)
  float* vs = ks + n * (d + 1);      // n x d
  float* mk = vs + n * d;            // n additive key mask
  float* qrow = mk + n;              // ATTN_WARPS x d
  float* prow = qrow + ATTN_WARPS * d;  // ATTN_WARPS x n
  const size_t first = (size_t)seq * n * row_stride + h * d;
  for (int idx = threadIdx.x; idx < n * d; idx += blockDim.x) {
    const int t = idx / d, e = idx % d;
    ks[t * (d + 1) + e] = k_base[first + (size_t)t * row_stride + e];
    vs[t * d + e] = v_base[first + (size_t)t * row_stride + e];
  }
  for (int t = threadIdx.x; t < n; t += blockDim.x)
    mk[t] = key_mask ? key_mask[(size_t)seq * n + t] * -1e9f : 0.f;
  __syncthreads();
  float* q = qrow + warp * d;
  float* p = prow + warp * n;
  for (int t = warp; t < n; t += ATTN_WARPS) {
    for (int e = lane; e < d; e += 32) q[e] = q_base[first + (size_t)t * row_stride + e];
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
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float ex = expf(p[j] - mx);
      p[j] = ex;
      sum += ex;
    }
    sum = warp_sum(sum);
    __syncwarp();
    for (int e = lane; e < d; e += 32) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(p[j], vs[j * d + e], acc);
      out[((size_t)seq * n + t) * c + h * d + e] = acc / sum;
    }
    __syncwarp();
  }
}

// Launch head_attention_kernel on `seqs` sequences of n tokens; returns the
// launch's error (shared memory above 48 KB is opted into first).
inline cudaError_t launch_head_attention(const float* q, const float* k, const float* v,
                                         int row_stride, const float* key_mask, float* out,
                                         int seqs, int n, int c, int heads,
                                         cudaStream_t stream) {
  if (seqs <= 0 || n <= 0 || heads <= 0 || c % heads != 0) return cudaErrorInvalidValue;
  const int d = c / heads;
  const size_t smem = sizeof(float) *
      ((size_t)n * (d + 1) + (size_t)n * d + n + ATTN_WARPS * d + ATTN_WARPS * (size_t)n);
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (smem > (size_t)optin) return cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        head_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  head_attention_kernel<<<seqs * heads, ATTN_WARPS * 32, smem, stream>>>(
      q, k, v, row_stride, key_mask, out, n, c, heads, 1.f / sqrtf((float)d));
  return cudaGetLastError();
}

}  // namespace uu
