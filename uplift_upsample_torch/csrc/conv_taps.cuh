// The strided conv's operands as its tensor-core products read them
// (gemm_tc.cuh): K3's and K6's conv forward, K6's dH1 and dWc.
//
// T (windows·n_out, 3·hidden) is the taps matrix: row r = (b, t) holds h1's
// rows s0·t + j − p0 of window b for the taps j = 0, 1, 2 side by side, zero
// where a tap falls outside [0, n). The forward is T · Wc, dWc is Tᵀ · g and
// dH1 is g · Wcᵀ added back onto the rows the taps read. T is never written
// to device memory:
//  - ConvTapsTma: the forward's A by TMA's im2col mode, one map over h1
//    (hidden, n, windows) whose pixels are the conv's origins s0·t − p0 of
//    each window (the traversal stride s0, the box corners −p0 and the last
//    origin): stage (tap j, channels c0..c0+31) of a tile is one box of 128
//    pixels, T's rows m0..m0+127 across windows, each from its origin's row
//    + j (the im2col offset), zeros outside the window and past the last;
//    the tiles are a dense A's;
//  - Dh1Rows: dH1 as one product per h1 row, the rows taken phase by phase
//    (rows ρ, ρ + s0, ... of a window): the taps j ≡ ρ + p0 (mod s0) reach
//    phase ρ, each from g's rows shifted by (ρ + p0 − j) / s0, so a row's
//    taps sum in one accumulator in tap order; its tiles are whole windows'
//    rows of a phase, which leave by TMA through a map of the phase's rows
//    of dH1 (and their relu mask comes the same way from h1);
//  - ConvTaps: dWc's X, gathered by gemm_atb_kernel's loaders with cp.async,
//    16 bytes at a time (4 channels of one tap: hidden % 4 == 0).
// ops/strided.py mirrors this arithmetic: `conv_tap_rows` (ConvTaps'
// index), `conv_forward_tiles` and `tma_im2col` (ConvTapsTma's boxes),
// `conv_tile_rows`, `dh1_tiles`, `tma_box` and `tma_box_store` (Dh1Rows').
#pragma once

#include <cuda_runtime.h>

#include "gemm_tc.cuh"

namespace uu {

constexpr int CONV_MAX_STRIDE = 8;  // TMA's largest traversal stride

// dH1's tile rows: `per` rows of a phase a window (ceil(n / s0)) as boxes
// of `rb` rows a window and `wpt` windows: whole windows side by side (5 x
// 24 = 120 rows at h36m_351), or, past 128 rows, a window in `chunks` tiles
// of rb rows.
struct TileRows {
  int rb, wpt, chunks;
};

inline TileRows tile_rows(int per) {
  if (per <= TC_BM) return {per, TC_BM / per, 1};
  return {TC_BM, 1, (per + TC_BM - 1) / TC_BM};
}

// An fp32 tensor (windows, rows, cols) row-major as a rank-3 map (cols,
// rows, windows), boxes of 32 columns x tr.rb rows x tr.wpt windows with the
// 128-byte swizzle: a box lands as wpt · rb rows of 128 bytes. What lies
// outside the tensor reads as zeros (negative coordinates too) and is not
// written. x + offset's rows `step` rows apart, `rows` of them a window:
// phase ρ's rows of dH1 and h1 (offset ρ·cols; TMA takes a traversal stride
// in loads only, and a store through such a box faults).
inline bool make_box_map(CUtensorMap* map, const float* x, int cols, int rows, int windows,
                         TileRows tr, int step = 1, size_t offset = 0, int window_rows = 0) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (!encode || cols % 4 || rows < 1 || tr.rb * tr.wpt > TC_BM) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)windows};
  const cuuint64_t strides[2] = {(cuuint64_t)step * cols * 4,
                                 (cuuint64_t)(window_rows ? window_rows : rows) * cols * 4};
  const cuuint32_t box[3] = {(cuuint32_t)TC_BK, (cuuint32_t)tr.rb, (cuuint32_t)tr.wpt};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(x) + offset, dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Phase ρ's rows ρ, ρ + s0, ... of each window of x (windows, n, cols):
// ceil((n − ρ) / s0) rows a window.
inline bool make_phase_map(CUtensorMap* map, const float* x, int cols, int n, int windows,
                           int stride, int rho, TileRows tr) {
  return make_box_map(map, x, cols, (n - rho + stride - 1) / stride, windows, tr, stride,
                      (size_t)rho * cols, n);
}

typedef CUresult (*TensorMapEncodeIm2col)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                          const cuuint64_t*, const cuuint64_t*, const int*,
                                          const int*, cuuint32_t, cuuint32_t,
                                          const cuuint32_t*, CUtensorMapInterleave,
                                          CUtensorMapSwizzle, CUtensorMapL2promotion,
                                          CUtensorMapFloatOOBfill);

// cuTensorMapEncodeIm2col of libcuda, found through the runtime (no -lcuda).
inline TensorMapEncodeIm2col im2col_encoder() {
  static TensorMapEncodeIm2col fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeIm2col", &p,
                                                             12000, cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TensorMapEncodeIm2col>(p);
  }
  return fn;
}

// h1 (windows, n, hidden) as the forward's im2col map: the pixels of a
// window are the origins −p0, s0 − p0, ..., s0·(n_out − 1) − p0 (the box
// corners −p0 and that last origin's distance from n − 1, traversal stride
// s0), a box 128 pixels of 32 channels, the 128-byte swizzle.
inline bool make_taps_map(CUtensorMap* map, const float* h1, int hidden, int n, int windows,
                          int stride, int p0, int n_out) {
  const TensorMapEncodeIm2col encode = im2col_encoder();
  if (!encode || hidden % 4) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)hidden, (cuuint64_t)n, (cuuint64_t)windows};
  const cuuint64_t strides[2] = {(cuuint64_t)hidden * 4, (cuuint64_t)n * hidden * 4};
  const int lower[1] = {-p0}, upper[1] = {stride * (n_out - 1) - p0 - (n - 1)};
  const cuuint32_t elem[3] = {1, (cuuint32_t)stride, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(h1), dims, strides,
                lower, upper, TC_BK, TC_BM, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One im2col box of 128 pixels from the origin (w, window) on, each pixel's
// row w + `offset`, into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_im2col_3d(uint32_t dst, const CUtensorMap* map, int c0,
                                                   int w, int window, uint16_t offset,
                                                   uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2], {%6};\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(w), "r"(window),
         "h"(offset)
      : "memory");
}

// T by TMA through map_a = make_taps_map(h1, ...): tiles of 128 of T's rows,
// as a dense A's; stage kt is tap j = kt / kc, channels c0 = 32 (kt % kc):
// the box of the tile's first row's origin with offset j, and W's columns
// j·hidden + c0.. (with hidden % 32 == 0 the stages are T's 32-column
// slices in order, as a dense A's).
struct ConvTapsTma : TmaA {
  int n_out, stride, p0, hidden, kc;
  __device__ __forceinline__ int ktiles(int, int) const { return 3 * kc; }
  __device__ __forceinline__ int2 load(uint32_t dst, const CUtensorMap* map, int tm, int kt,
                                       uint32_t bar) const {
    const int j = kt / kc, c0 = (kt - j * kc) * TC_BK;
    const int b = tm * TC_BM / n_out, t = tm * TC_BM - b * n_out;
    tma_load_im2col_3d(dst, map, c0, stride * t - p0, b, (uint16_t)j, bar);
    return make_int2(j * hidden + c0, 0);
  }
};

// dH1's rows phase by phase, A = g read by TMA through map_a =
// make_box_map(g, c, n_out, windows, tr). m-tile tm is phase ρ = tm /
// (wblocks · chunks), then window block tm / chunks (wpt windows from b0)
// and row chunk q = tm % chunks (t0 = q·rb), its rows u = ρ + s0 (t0 + i)
// of each window. Its stages:
// for each tap j ≡ ρ + p0 (mod s0) in order, kc of g's 32-column slices
// c0.. at g's rows (ρ + p0 − j) / s0 + t0.. (zeros outside [0, n_out)),
// against W's rows j·hidden + n0.. (Wc as stored, columns c0..).
struct Dh1Rows {
  int windows, hidden, n_out, stride, p0, kc, wblocks;
  TileRows tr;
  int phases;  // min(s0, n): phases past n hold no rows
  __host__ __device__ int tiles_m(int) const { return phases * wblocks * tr.chunks; }
  __host__ __device__ int a_bytes() const { return tr.rb * tr.wpt * TC_BK * 4; }
  // (ρ, t0, b0) of m-tile tm: the phase's map and the box's coordinates
  __device__ __forceinline__ int3 out_at(int tm) const {
    const int per = wblocks * tr.chunks, rho = tm / per, rest = tm - rho * per;
    const int wb = rest / tr.chunks;
    return make_int3(rho, (rest - wb * tr.chunks) * tr.rb, wb * tr.wpt);
  }
  // does tap j reach phase ρ's rows?
  __device__ __forceinline__ bool reaches(int rho, int j) const {
    return (rho + p0 - j) % stride == 0;
  }
  __device__ __forceinline__ int ktiles(int tm, int) const {
    const int rho = out_at(tm).x;
    return kc * (reaches(rho, 0) + reaches(rho, 1) + reaches(rho, 2));
  }
  __device__ __forceinline__ int2 load(uint32_t dst, const CUtensorMap* map, int tm, int kt,
                                       uint32_t bar) const {
    const int3 at = out_at(tm);
    const int i = kt / kc, c0 = (kt - i * kc) * TC_BK;
    int j = 0;  // the i-th tap that reaches the phase
    for (int seen = -1; j < 3; ++j)
      if (reaches(at.x, j) && ++seen == i) break;
    tma_load_3d(dst, map, c0, (at.x + p0 - j) / stride + at.y, at.z, bar);
    return make_int2(c0, j * hidden);
  }
};

// dWc's X: the taps gathered from h1 by gemm_atb_kernel's loaders.
struct ConvTaps {
  const float* h1;  // (windows * n, hidden)
  int windows, n, hidden, n_out, stride, p0;
  static constexpr bool kGather = true;

  struct Row {
    long long off;  // h1 offset of tap 0's row (below 0 at t = 0 with p0 = 1)
    int first;      // that row's index in its window: tap j reads row first + j
  };

  __device__ __forceinline__ Row row(int r) const {
    const int b = r / n_out, t = r - b * n_out;
    const int first = r < windows * n_out ? stride * t - p0 : -4;  // past T: every tap zero
    return {((long long)b * n + first) * hidden, first};
  }

  // T[r, k..k+3] (k % 4 == 0, k < 3·hidden), k's tap (k / hidden) known: 4
  // floats of h1, or nullptr where the tap reads zeros. dWc's loader walks a
  // row's columns in order and counts the taps it crosses.
  __device__ __forceinline__ const float* at(Row row, int k, int tap) const {
    return (unsigned)(row.first + tap) < (unsigned)n ? h1 + row.off + k : nullptr;
  }
};

}  // namespace uu
