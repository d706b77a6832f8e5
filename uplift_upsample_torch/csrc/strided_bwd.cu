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
// cores (gemm_tc.cuh) over the conv's operands (conv_taps.cuh):
//   strided_dh1_f32   dH1 = relu'(h1) · (the taps of g · Wcᵀ added back onto
//                     the h1 rows they read): the persistent TMA + wgmma
//                     kernel over dH1's rows, phase by phase (Dh1Rows: rows
//                     ρ, ρ + s0, ... of a window; the taps j ≡ ρ + p0 mod s0
//                     reach them, each one product of g's shifted rows, read
//                     by TMA with zeros outside [0, n_out), and Wc's rows of
//                     tap j as stored: the K-major B it wants, as dX reads
//                     W), so a row's taps sum in the accumulator in tap
//                     order and every row of dH1 is written once: one
//                     launch at every s0, no memset, no read-modify-write. Its
//                     epilogue (Dh1Store) brings the tile's h1 by TMA into the
//                     staging tile, the consumers write their sums where h1 >
//                     0 (else 0), and the tile leaves by TMA, both through a
//                     map of the phase's rows (rows no tap reads come out 0).
//   strided_dwc_f32   dWc = T^T . g: gemm_atb_kernel (wgmma) with X
//                     gathered from h1, split over the selected rows into
//                     partials that sum_rows_f32 adds in a fixed order.
//   crop_residual_add_f32  the residual: dx2[s0*t + (p0 == 0)] += g[t].
// The TPU computes the conv at every token with lane shifts and transposes
// its slice; here only the selected rows are read and written. No float
// atomics anywhere, so a second backward gives the same bits.
//
// The bf16 rung (TRAIN_MATMUL_PRECISION "default" and "mixed";
// pallas_strided_bwd.py at DEFAULT): strided_dh1_bf16 (native bf16: Wc's
// bf16 plane as stored, torch.bfloat16, and g rounded to bf16 pairs into
// wgmma's register operand; gemm_tc.cuh TC_BF16), strided_dwc_bf16 (the
// taps and g rounded: gemm_atb_kernel kBf16) and sum_rows_bf16, the PE's
// gradient as the sum over windows of the input gradient rounded to bf16
// (the TPU kernel takes it with a DEFAULT dot against a one-hot matrix,
// pallas_strided_bwd.py:152). The TPU's conv is three tap dots summed in
// fp32; one product over the taps on the same rounded operands is the same
// sum in another order.
//
// What bounds it: at 512 windows the backward's dense and conv products are
// ~0.17 TFLOP (each of the conv's two 20.8 GFLOP, 0.126 ms in 3xTF32 at the
// 495 TFLOP/s TF32 peak); on the bf16 rung dH1 is bytes (g, h1 and dH1:
// 0.072 ms at 3.35 TB/s); its attention backward runs on the CUDA cores
// (temporal_bwd.cu).

#include <cuda_runtime.h>

#include <string.h>

#include "conv_taps.cuh"

namespace {

// dH1's epilogue: the tile's h1 (the relu mask) in through in[ρ] and the
// masked sums out through out[ρ], the maps of phase ρ's rows of h1 and of
// dH1 (make_phase_map).
struct Dh1Store {
  static constexpr bool kTmaStore = true;
  struct Maps {
    CUtensorMap in[uu::CONV_MAX_STRIDE], out[uu::CONV_MAX_STRIDE];
  };
  bool quads() const { return false; }
  __device__ __forceinline__ bool tile_in() const { return true; }
  __device__ __forceinline__ float value(int, float v, float h1) const {
    return h1 > 0.f ? v : 0.f;
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
// w: Wc's TF32 halves (2, 3*hidden, c) as stored (tf32_halves_f32 without
// the transpose), or its bf16 plane (3*hidden, c); dh1 must not alias h1.
namespace {

template <int kMode>
int dh1_entry(const float* g, const void* w, const float* h1, float* dh1, int windows, int n,
              int hidden, int c, int stride, int p0, int n_out, void* stream) {
  if (!geometry_ok(windows, n, hidden, c, stride, p0, n_out) || stride > uu::CONV_MAX_STRIDE ||
      dh1 == h1 || !uu::aligned16(g) || !uu::aligned16(h1) || !uu::aligned16(dh1) ||
      !uu::aligned16(w))
    return cudaErrorInvalidValue;
  const int per = (n + stride - 1) / stride;  // rows of phase 0 a window
  const uu::TileRows tr = uu::tile_rows(per);
  const int phases = stride < n ? stride : n;
  const uu::Dh1Rows rows{windows, hidden, n_out, stride, p0, (c + uu::TC_BK - 1) / uu::TC_BK,
                         (windows + tr.wpt - 1) / tr.wpt, tr, phases};
  CUtensorMap map_a, map_w;
  Dh1Store::Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (!uu::make_box_map(&map_a, g, c, n_out, windows, tr))
    return cudaErrorInvalidValue;
  for (int rho = 0; rho < phases; ++rho)
    if (!uu::make_phase_map(&maps.in[rho], h1, hidden, n, windows, stride, rho, tr) ||
        !uu::make_phase_map(&maps.out[rho], dh1, hidden, n, windows, stride, rho, tr))
      return cudaErrorInvalidValue;
  if (kMode == uu::TC_BF16
          ? !uu::make_bf16_tile_map(&map_w, w, 3 * hidden, c)
          : !uu::make_w_map(&map_w, static_cast<const float*>(w), 3 * hidden, c, 3 * hidden))
    return cudaErrorInvalidValue;
  return uu::launch_tc<kMode>(map_a, rows, map_w, 3 * hidden, windows * n, hidden, c,
                              Dh1Store{}, (cudaStream_t)stream, maps);
}

template <bool kBf16>
int dwc_entry(const float* h1, const float* g, float* part, int windows, int n, int hidden,
              int c, int stride, int p0, int n_out, int splits, void* stream) {
  if (!geometry_ok(windows, n, hidden, c, stride, p0, n_out) ||
      reinterpret_cast<uintptr_t>(h1) % 16)
    return cudaErrorInvalidValue;
  return uu::launch_gemm_atb_gather<kBf16>(uu::ConvTaps{h1, windows, n, hidden, n_out, stride,
                                                      p0},
                                           g, nullptr, 1, part, 3 * hidden, c, windows * n_out,
                                           splits, (cudaStream_t)stream);
}

}  // namespace

extern "C" int strided_dh1_f32(const float* g, const float* halves, const float* h1,
                               float* dh1, int windows, int n, int hidden, int c, int stride,
                               int p0, int n_out, void* stream) {
  return dh1_entry<uu::TC_3XTF32>(g, halves, h1, dh1, windows, n, hidden, c, stride, p0, n_out,
                                  stream);
}

// strided_dh1_f32 on the bf16 rung: plane (3*hidden, c) bf16, Wc rounded to
// bf16 as stored; g rounded as it is read.
extern "C" int strided_dh1_bf16(const float* g, const void* plane, const float* h1, float* dh1,
                                int windows, int n, int hidden, int c, int stride, int p0,
                                int n_out, void* stream) {
  return dh1_entry<uu::TC_BF16>(g, plane, h1, dh1, windows, n, hidden, c, stride, p0, n_out,
                                stream);
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
