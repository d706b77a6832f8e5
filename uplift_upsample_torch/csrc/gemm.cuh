// Shared device code of the temporal (K2) and strided-block-1 (K3) kernels:
// warp reductions and a tiled fp32 GEMM on CUDA cores.
//
// The GEMM computes out = epilogue(A · W) with W (k, n) row-major, the
// Keras/flax Dense layout. A is read through a loader functor, so the same
// tile loop serves a plain row-major A (the dense layers) and the gathered
// taps of the strided conv (strided.cu). Tiles are 128 x 64 x 16 in shared
// memory; each of the 256 threads keeps an 8 x 4 block of the output in
// registers, so every shared-memory read feeds 8 or 4 FMAs.
//
// Bound: these products are compute-bound on this card (K = 384-2304 against
// the 67 TFLOP/s fp32 peak). A SIMT tile loop reaches a fraction of that peak;
// the tensor-core route (wgmma, TMA) comes in a later change.
#pragma once

#include <cuda_runtime.h>

namespace uu {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int GEMM_BM = 128;
constexpr int GEMM_BN = 64;
constexpr int GEMM_BK = 16;
constexpr int GEMM_THREADS = 256;

// A (m, k) row-major.
struct RowMajorA {
  const float* a;
  int k;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return a[(size_t)r * k + c];
  }
};

// out[r, c] = act(v + bias[c]) + residual[r, c]; bias and residual optional.
// residual may alias out: each element is read and written by one thread.
struct BiasActResidual {
  const float* bias;
  const float* residual;
  float* out;
  int n;
  int relu;
  __device__ __forceinline__ void operator()(int r, int c, float v) const {
    if (bias) v += bias[c];
    if (relu) v = fmaxf(v, 0.f);
    const size_t o = (size_t)r * n + c;
    if (residual) v += residual[o];
    out[o] = v;
  }
};

template <class ALoad, class Epilogue>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(ALoad a_at, const float* __restrict__ w, int m, int n, int k, Epilogue epi) {
  __shared__ __align__(16) float As[GEMM_BK][GEMM_BM + 4];  // A tile, transposed
  __shared__ __align__(16) float Bs[GEMM_BK][GEMM_BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // output block: rows ty*8.., cols tx*4..
  const int row0 = blockIdx.y * GEMM_BM, col0 = blockIdx.x * GEMM_BN;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += GEMM_BK) {
#pragma unroll
    for (int i = 0; i < (GEMM_BM * GEMM_BK) / GEMM_THREADS; ++i) {
      const int idx = tid + i * GEMM_THREADS;
      const int r = idx / GEMM_BK, kk = idx % GEMM_BK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < m && gk < k) ? a_at(gr, gk) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (GEMM_BN * GEMM_BK) / GEMM_THREADS; ++i) {
      const int idx = tid + i * GEMM_THREADS;
      const int kk = idx / GEMM_BN, c = idx % GEMM_BN;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < k && gc < n) ? w[(size_t)gk * n + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + ty * 8 + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c < n) epi(r, c, acc[i][j]);
    }
  }
}

template <class ALoad, class Epilogue>
inline cudaError_t launch_gemm(ALoad a_at, const float* w, int m, int n, int k,
                               Epilogue epi, cudaStream_t stream) {
  if (m <= 0 || n <= 0 || k <= 0) return cudaErrorInvalidValue;
  const long long tiles_m = (m + GEMM_BM - 1) / GEMM_BM;
  if (tiles_m > 65535) return cudaErrorInvalidValue;
  const dim3 grid((n + GEMM_BN - 1) / GEMM_BN, (unsigned)tiles_m);
  gemm_kernel<<<grid, GEMM_THREADS, 0, stream>>>(a_at, w, m, n, k, epi);
  return cudaGetLastError();
}

}  // namespace uu
