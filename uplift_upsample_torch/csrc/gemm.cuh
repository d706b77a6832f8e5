// Shared device code of the temporal (K2, K5), strided-block-1 (K3, K6) and
// spatial kernels: a warp sum, a row's scale factor, and the
// fixed-order sum of partials that the split-K products (gemm_tc.cuh) and
// the per-block gradient partials end with. The products run on the tensor
// cores (gemm_tc.cuh, attention.cuh, temporal_bwd.cu's attention backward,
// K1's and K4's dense layers) except K1's and K4's 17-token attention, which
// runs on the CUDA cores inside their own kernels.
#pragma once

#include <cuda_runtime.h>

namespace uu {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row r's factor: scale[r / rows_per_scale], or 1 without a scale.
__device__ __forceinline__ float row_factor(const float* scale, int rows_per_scale, int r) {
  return scale ? scale[r / rows_per_scale] : 1.f;
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

}  // namespace uu
