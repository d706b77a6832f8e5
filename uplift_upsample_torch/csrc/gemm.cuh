// Shared device code of the temporal (K2, K5) and strided-block-1 (K3, K6)
// kernels: warp reductions, the fixed-order sum of partials, and a tiled
// fp32 GEMM on CUDA cores for the strided conv's products.
//
// The GEMM computes out = epilogue(A · B). A and B are read through loader
// functors: strided.cu gathers the conv's taps of h1 as A, strided_bwd.cu
// reads the taps transposed for the conv kernel's dW and the kernel
// transposed for dH1. A loader says with `kAlongK` whether neighbouring
// threads should fetch neighbouring k (row-major A, transposed B) or
// neighbouring rows/columns (transposed A, row-major B), so every tile fetch
// is coalesced. Tiles are 128 x 64 x 16 in shared memory; each of the 256
// threads keeps an 8 x 4 block of the output in registers, so every
// shared-memory read feeds 8 or 4 FMAs.
//
// Split-K: with gridDim.z > 1, block z sums k in [z*k_split, (z+1)*k_split)
// and hands the epilogue row r + z*m, so partial products land in a
// (splits*m, n) buffer that a second pass sums in a fixed order (no atomics:
// repeated runs agree bit for bit).
//
// Bound: operations, against the 67 TFLOP/s fp32 CUDA-core peak, which a
// SIMT tile loop reaches a fraction of. The dense layers moved to the tensor
// cores (gemm_tc.cuh, 3xTF32, same epilogue interface); the conv's gathered
// loaders have no TMA counterpart yet, so they stay here.
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

// Row r's factor: scale[r / rows_per_scale], or 1 without a scale.
__device__ __forceinline__ float row_factor(const float* scale, int rows_per_scale, int r) {
  return scale ? scale[r / rows_per_scale] : 1.f;
}

// A (m, k) row-major.
struct RowMajorA {
  const float* a;
  int k;
  static constexpr bool kAlongK = true;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return a[(size_t)r * k + c];
  }
};

// B (k, n) row-major.
struct RowMajorB {
  const float* w;
  int n;
  static constexpr bool kAlongK = false;
  __device__ __forceinline__ float operator()(int kk, int c) const {
    return w[(size_t)kk * n + c];
  }
};

// B = Wᵀ with W (n, k) row-major: B(kk, c) = W[c, kk].
struct TransposedB {
  const float* w;
  int k;
  static constexpr bool kAlongK = true;
  __device__ __forceinline__ float operator()(int kk, int c) const {
    return w[(size_t)c * k + kk];
  }
};

template <class ALoad, class BLoad, class Epilogue>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(ALoad a_at, BLoad b_at, int m, int n, int k, int k_split, Epilogue epi) {
  __shared__ __align__(16) float As[GEMM_BK][GEMM_BM + 4];  // A tile, transposed
  __shared__ __align__(16) float Bs[GEMM_BK][GEMM_BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // output block: rows ty*8.., cols tx*4..
  const int row0 = blockIdx.y * GEMM_BM, col0 = blockIdx.x * GEMM_BN;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(k, k_begin + k_split);
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += GEMM_BK) {
#pragma unroll
    for (int i = 0; i < (GEMM_BM * GEMM_BK) / GEMM_THREADS; ++i) {
      const int idx = tid + i * GEMM_THREADS;
      const int r = ALoad::kAlongK ? idx / GEMM_BK : idx % GEMM_BM;
      const int kk = ALoad::kAlongK ? idx % GEMM_BK : idx / GEMM_BM;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < m && gk < k_end) ? a_at(gr, gk) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (GEMM_BN * GEMM_BK) / GEMM_THREADS; ++i) {
      const int idx = tid + i * GEMM_THREADS;
      const int kk = BLoad::kAlongK ? idx % GEMM_BK : idx / GEMM_BN;
      const int c = BLoad::kAlongK ? idx / GEMM_BK : idx % GEMM_BN;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < k_end && gc < n) ? b_at(gk, gc) : 0.f;
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
  const int r_off = blockIdx.z * m;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + ty * 8 + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c < n) epi(r + r_off, c, acc[i][j]);
    }
  }
}

// out[c] = sum of part[r, c] over r = 0, 1, ..., rows-1 in that order: the
// fixed-order second pass over per-block partials (split-K products,
// per-warp gradient partials), so repeated runs agree bit for bit.
static __global__ void sum_rows_kernel(const float* __restrict__ part, float* __restrict__ out,
                                       int rows, int cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part[(size_t)r * cols + c];
  out[c] = s;
}

inline cudaError_t launch_sum_rows(const float* part, float* out, int rows, int cols,
                                   cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return cudaErrorInvalidValue;
  sum_rows_kernel<<<(cols + 255) / 256, 256, 0, stream>>>(part, out, rows, cols);
  return cudaGetLastError();
}

// splits > 1: k is cut into `splits` chunks of a multiple of GEMM_BK and the
// epilogue sees row r + z*m for chunk z (see the note at the top).
template <class ALoad, class BLoad, class Epilogue>
inline cudaError_t launch_gemm(ALoad a_at, BLoad b_at, int m, int n, int k,
                               Epilogue epi, cudaStream_t stream, int splits = 1) {
  if (m <= 0 || n <= 0 || k <= 0 || splits <= 0) return cudaErrorInvalidValue;
  const long long tiles_m = (m + GEMM_BM - 1) / GEMM_BM;
  if (tiles_m > 65535 || splits > 65535) return cudaErrorInvalidValue;
  int k_split = (k + splits - 1) / splits;
  k_split = (k_split + GEMM_BK - 1) / GEMM_BK * GEMM_BK;
  const dim3 grid((n + GEMM_BN - 1) / GEMM_BN, (unsigned)tiles_m, splits);
  gemm_kernel<<<grid, GEMM_THREADS, 0, stream>>>(a_at, b_at, m, n, k, k_split, epi);
  return cudaGetLastError();
}

}  // namespace uu
