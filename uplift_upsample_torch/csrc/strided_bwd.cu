// K6 — strided block 1 in training: the kernels its backward adds to K5's.
//
// Replaces: uplift_upsample_tpu/ops/pallas_strided_bwd.py
//   fused_strided_block1_train (_make_kernels, _fsb_fwd_impl, _fsb_bwd_rule).
//   The block: x += pe; x2 = x + proj(attn(LN1(x))); h1 = relu(fc1(LN2(x2)));
//   out[t] = x2[s0*t + (p0 == 0)] + bc + sum_j h1[s0*t + j - p0] . W_j, for
//   the n_out selected rows t (a tap outside [0, n) reads zero).
//
// Forward (ops/strided_train.py): K3's launches (temporal.cu LayerNorm, GEMM
// and window attention, strided.cu's conv on the selected rows), keeping
// x + pe, LN1, qkv, the context, x2, LN2 and h1 in device memory for the
// backward. The TPU kernel replays the block from its input because VMEM is
// small; here the intermediates take ~0.6 GB at 512 windows x 71 x 384.
//
// Backward: everything up to h1 reuses K5's kernels (temporal_bwd.cu: dX and
// dW GEMMs, column sums, LayerNorm and window-attention backward). The conv's
// backward is new, and lives here:
//   strided_dh1_f32   dH1 = the taps' gradient: for tap j, the selected rows
//                     of g times W_j^T, added into the h1 row the tap read,
//                     zeroed where relu cut (h1 <= 0). One GEMM per tap over
//                     the B*n_out selected rows, launched in tap order on one
//                     stream, so rows that several taps read (s0 < 3) sum in
//                     a fixed order; rows no tap reads stay 0.
//   strided_dwc_f32   dW_j = sum_t h1[s0*t + j - p0]^T . g[t]: per tap a
//                     split-K GEMM whose A loader gathers the tap's h1 rows,
//                     partials summed in a fixed order by sum_rows_f32.
//   crop_residual_add_f32  the residual: dx2[s0*t + (p0 == 0)] += g[t].
// The TPU computes the conv at every token with lane shifts and transposes
// its slice; here only the selected rows are read and written. No float
// atomics anywhere, so a second backward gives the same bits.
//
// What bounds it: the GEMMs (~178 GFLOP for the whole backward at 512
// windows, fp32 on CUDA cores at 67 TFLOP/s); the tap GEMMs are 21 GFLOP of it.

#include <cuda_runtime.h>

#include "gemm.cuh"

namespace {

// A(r, kk) = h1[b*n + s0*t + off, r] for kk = b*n_out + t: tap (off + p0)'s
// h1 row of selected row kk, transposed; zero outside the window.
struct TapRowsT {
  const float* h1;
  int n, n_out, hidden, stride, off;
  static constexpr bool kAlongK = false;
  __device__ __forceinline__ float operator()(int r, int kk) const {
    const int b = kk / n_out, t = kk - b * n_out;
    const int src = stride * t + off;
    return (src >= 0 && src < n) ? h1[((size_t)b * n + src) * hidden + r] : 0.f;
  }
};

// Selected row r = b*n_out + t adds v into the h1 row its tap read, where
// relu passed; elsewhere that element is 0.
struct TapScatterAdd {
  const float* h1;  // the forward's relu output: the mask
  float* out;       // (windows * n, hidden)
  int n, n_out, hidden, stride, off;
  __device__ __forceinline__ void operator()(int r, int col, float v) const {
    const int b = r / n_out, t = r - b * n_out;
    const int src = stride * t + off;
    if (src < 0 || src >= n) return;
    const size_t o = ((size_t)b * n + src) * hidden + col;
    out[o] = h1[o] > 0.f ? out[o] + v : 0.f;
  }
};

// Split-K partial of tap `tap`: epilogue row r + z*m lands in
// part[z, tap, r, :] of a (splits, taps, m, n) buffer.
struct TapPartStore {
  float* part;
  int m, n, taps, tap;
  __device__ __forceinline__ void operator()(int r, int c, float v) const {
    const int z = r / m, rr = r - z * m;
    part[(((size_t)z * taps + tap) * m + rr) * n + c] = v;
  }
};

__global__ void crop_residual_add_kernel(const float* __restrict__ g, float* __restrict__ dx2,
                                         int n, int c, int stride, int res_off, int n_out,
                                         size_t total) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const size_t row = i / c;
  const int col = (int)(i - row * c);
  const int b = (int)(row / n_out), t = (int)(row - (size_t)b * n_out);
  dx2[((size_t)b * n + stride * t + res_off) * c + col] += g[i];
}

bool geometry_ok(int windows, int n, int hidden, int c, int stride, int p0, int n_out) {
  if (windows <= 0 || n <= 0 || hidden <= 0 || c <= 0 || stride <= 0 || n_out <= 0)
    return false;
  if (p0 < 0 || p0 > 1) return false;
  return stride * (n_out - 1) + (p0 == 0 ? 1 : 0) < n;
}

}  // namespace

// dh1 (windows*n, hidden) = relu'(h1) * sum over taps j of the selected rows
// of g (windows*n_out, c) times W_j^T, placed at the h1 row each tap read.
// wc: (3*hidden, c), the flax Conv1D kernel (3, hidden, c) flattened.
extern "C" int strided_dh1_f32(const float* g, const float* wc, const float* h1, float* dh1,
                               int windows, int n, int hidden, int c, int stride, int p0,
                               int n_out, void* stream) {
  if (!geometry_ok(windows, n, hidden, c, stride, p0, n_out)) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(dh1, 0, sizeof(float) * (size_t)windows * n * hidden, s);
  if (err != cudaSuccess) return err;
  for (int j = 0; j < 3; ++j) {
    err = uu::launch_gemm(uu::RowMajorA{g, c}, uu::TransposedB{wc + (size_t)j * hidden * c, c},
                          windows * n_out, hidden, c,
                          TapScatterAdd{h1, dh1, n, n_out, hidden, stride, j - p0}, s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// part (splits, 3*hidden, c): chunk z of dW_j = sum over the selected rows of
// h1[tap row]^T . g; sum_rows_f32 over the splits gives dW in wc's layout.
extern "C" int strided_dwc_f32(const float* h1, const float* g, float* part, int windows,
                               int n, int hidden, int c, int stride, int p0, int n_out,
                               int splits, void* stream) {
  if (!geometry_ok(windows, n, hidden, c, stride, p0, n_out) || splits <= 0)
    return cudaErrorInvalidValue;
  for (int j = 0; j < 3; ++j) {
    const cudaError_t err = uu::launch_gemm(
        TapRowsT{h1, n, n_out, hidden, stride, j - p0}, uu::RowMajorB{g, c}, hidden, c,
        windows * n_out, TapPartStore{part, hidden, c, 3, j}, (cudaStream_t)stream, splits);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// dx2[b, stride*t + res_off] += g[b, t] for the n_out selected rows t.
extern "C" int crop_residual_add_f32(const float* g, float* dx2, int windows, int n, int c,
                                     int stride, int res_off, int n_out, void* stream) {
  if (windows <= 0 || c <= 0 || n_out <= 0 || stride <= 0 || res_off < 0 ||
      stride * (n_out - 1) + res_off >= n)
    return cudaErrorInvalidValue;
  const size_t total = (size_t)windows * n_out * c;
  crop_residual_add_kernel<<<(unsigned)((total + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      g, dx2, n, c, stride, res_off, n_out, total);
  return cudaGetLastError();
}
