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
// backward is new, and lives here; both of its products run on the tensor
// cores in 3xTF32 (gemm_tc.cuh) over the taps matrix T (conv_taps.cuh):
//   strided_dh1_f32   dH1 = g . Wc^T, column j*hidden + i placed at channel i
//                     of the h1 row tap j read, zeroed where relu cut
//                     (h1 <= 0): the persistent TMA + wgmma kernel with A = g
//                     and Wc's halves as stored (the K-major B it wants, as
//                     dX reads W). With s0 >= 3 the taps read disjoint rows
//                     and one launch writes them all; with s0 < 3 one launch
//                     per tap in tap order, each adding into what the one
//                     before wrote, so rows several taps read sum in a fixed
//                     order. Rows no tap reads stay 0.
//   strided_dwc_f32   dWc = T^T . g: gemm_atb_kernel (mma.sync) with X
//                     gathered from h1, split over the selected rows into
//                     partials that sum_rows_f32 adds in a fixed order.
//   crop_residual_add_f32  the residual: dx2[s0*t + (p0 == 0)] += g[t].
// The TPU computes the conv at every token with lane shifts and transposes
// its slice; here only the selected rows are read and written. No float
// atomics anywhere, so a second backward gives the same bits.
//
// The bf16 rung (TRAIN_MATMUL_PRECISION "default" and "mixed";
// pallas_strided_bwd.py at DEFAULT): strided_dh1_bf16 (g and Wc's
// bf16-rounded plane as stored, one TF32 pass: gemm_tc.cuh kBf16),
// strided_dwc_bf16 (the taps and g rounded: gemm_atb_kernel kBf16) and
// sum_rows_bf16, the PE's gradient as the sum over windows of the input
// gradient rounded to bf16 (the TPU kernel takes it with a DEFAULT dot
// against a one-hot matrix, pallas_strided_bwd.py:152). The TPU's conv is
// three tap dots summed in fp32; one product over 3*hidden on the same
// rounded operands is the same sum in another order.
//
// What bounds it: the GEMMs, operations. At 512 windows the backward's dense
// and conv products are ~0.17 TFLOP (each of the conv's two 20.8 GFLOP, 0.126
// ms in 3xTF32 at the 495 TFLOP/s TF32 peak); its attention backward runs on
// the CUDA cores (temporal_bwd.cu).

#include <cuda_runtime.h>

#include "conv_taps.cuh"
#include "gemm_tc.cuh"

namespace {

// Selected row r = b*n_out + t, column col of g . Wc^T (tap tap0 + col /
// hidden, channel col % hidden) lands in the h1 row that tap read, 0 where
// relu cut; with `accumulate` it adds to what is there.
struct TapScatter {
  const float* h1;  // the forward's relu output: the mask
  float* out;       // (windows * n, hidden)
  int n, n_out, hidden, stride, p0, tap0, accumulate;
  __device__ __forceinline__ void operator()(int r, int col, float v) const {
    const int b = r / n_out, t = r - b * n_out;
    const int j = col / hidden;
    const int src = stride * t + tap0 + j - p0;
    if (src < 0 || src >= n) return;
    const size_t o = ((size_t)b * n + src) * hidden + (col - j * hidden);
    out[o] = h1[o] > 0.f ? (accumulate ? out[o] + v : v) : 0.f;
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

// out[c] = sum over r (in order) of part[r, c] rounded to bf16.
__global__ void sum_rows_bf16_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     int rows, int cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += uu::bf16_roundf(part[(size_t)r * cols + c]);
  out[c] = s;
}

bool geometry_ok(int windows, int n, int hidden, int c, int stride, int p0, int n_out) {
  if (windows <= 0 || n <= 0 || hidden <= 0 || c <= 0 || stride <= 0 || n_out <= 0 ||
      hidden % 4 || c % 4)
    return false;
  if (p0 < 0 || p0 > 1) return false;
  return stride * (n_out - 1) + (p0 == 0 ? 1 : 0) < n;
}

}  // namespace

// dh1 (windows*n, hidden) = relu'(h1) * sum over taps j of the selected rows
// of g (windows*n_out, c) times W_j^T, placed at the h1 row each tap read.
// halves (2, 3*hidden, c): Wc's TF32 halves as stored (tf32_halves_f32 without
// the transpose); dh1 must not alias h1.
namespace {

template <bool kBf16>
int dh1_entry(const float* g, const float* w, const float* h1, float* dh1, int windows, int n,
              int hidden, int c, int stride, int p0, int n_out, void* stream) {
  if (!geometry_ok(windows, n, hidden, c, stride, p0, n_out) || dh1 == h1)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(dh1, 0, sizeof(float) * (size_t)windows * n * hidden, s);
  if (err != cudaSuccess) return err;
  const int m = windows * n_out;
  if (stride >= 3)
    return uu::launch_gemm_tc<kBf16>(g, w, m, 3 * hidden, c,
                                     TapScatter{h1, dh1, n, n_out, hidden, stride, p0, 0, 0},
                                     s);
  for (int j = 0; j < 3; ++j) {  // tap j: rows j*hidden.. of each half (kBf16: of the plane)
    err = uu::launch_gemm_tc<kBf16>(g, w + (size_t)j * hidden * c, m, hidden, c,
                                    TapScatter{h1, dh1, n, n_out, hidden, stride, p0, j, 1}, s,
                                    3 * hidden);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool kBf16>
int dwc_entry(const float* h1, const float* g, float* part, int windows, int n, int hidden,
              int c, int stride, int p0, int n_out, int splits, void* stream) {
  if (!geometry_ok(windows, n, hidden, c, stride, p0, n_out) ||
      reinterpret_cast<uintptr_t>(h1) % 16)
    return cudaErrorInvalidValue;
  return uu::launch_gemm_atb<kBf16>(uu::ConvTaps{h1, windows, n, hidden, n_out, stride, p0}, g,
                                    nullptr, 1, part, 3 * hidden, c, windows * n_out, splits,
                                    (cudaStream_t)stream);
}

}  // namespace

extern "C" int strided_dh1_f32(const float* g, const float* halves, const float* h1,
                               float* dh1, int windows, int n, int hidden, int c, int stride,
                               int p0, int n_out, void* stream) {
  return dh1_entry<false>(g, halves, h1, dh1, windows, n, hidden, c, stride, p0, n_out,
                          stream);
}

// strided_dh1_f32 on the bf16 rung: plane (3*hidden, c), Wc rounded to bf16
// as stored; g rounded as it is read.
extern "C" int strided_dh1_bf16(const float* g, const float* plane, const float* h1,
                                float* dh1, int windows, int n, int hidden, int c, int stride,
                                int p0, int n_out, void* stream) {
  return dh1_entry<true>(g, plane, h1, dh1, windows, n, hidden, c, stride, p0, n_out, stream);
}

// part (splits, 3*hidden, c): chunk z of dWc = T^T . g over the selected rows;
// sum_rows_f32 over the splits gives dWc in wc's layout.
extern "C" int strided_dwc_f32(const float* h1, const float* g, float* part, int windows,
                               int n, int hidden, int c, int stride, int p0, int n_out,
                               int splits, void* stream) {
  return dwc_entry<false>(h1, g, part, windows, n, hidden, c, stride, p0, n_out, splits,
                          stream);
}

// strided_dwc_f32 on the bf16 rung: the taps and g rounded to bf16.
extern "C" int strided_dwc_bf16(const float* h1, const float* g, float* part, int windows,
                                int n, int hidden, int c, int stride, int p0, int n_out,
                                int splits, void* stream) {
  return dwc_entry<true>(h1, g, part, windows, n, hidden, c, stride, p0, n_out, splits, stream);
}

// out[c] = sum over r (in order) of part[r, c] rounded to bf16: K6's PE
// gradient on the bf16 rung (part the input gradient, one row per window).
extern "C" int sum_rows_bf16(const float* part, float* out, int rows, int cols, void* stream) {
  if (rows <= 0 || cols <= 0) return cudaErrorInvalidValue;
  sum_rows_bf16_kernel<<<(cols + 255) / 256, 256, 0, (cudaStream_t)stream>>>(part, out, rows,
                                                                            cols);
  return cudaGetLastError();
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
