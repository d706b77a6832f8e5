// The strided conv's taps matrix, read in place: the gathered operand of
// K3's and K6's conv products on the tensor cores (gemm_tc.cuh).
//
// T (windows·n_out, 3·hidden): row r = (b, t) holds h1's rows s0·t + j − p0
// of window b for the taps j = 0, 1, 2 side by side, zero where a tap falls
// outside [0, n). The conv forward is T · Wc, its dWc is Tᵀ · g, and dH1 is
// g · Wcᵀ scattered back through the same index. The loaders fetch T 16
// bytes at a time (4 channels of one tap: hidden % 4 == 0) straight from
// h1, so T is never written to device memory. ops/strided.py
// `conv_tap_rows` is the same index in PyTorch.
#pragma once

#include <cuda_runtime.h>

namespace uu {

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

  // T[r, k..k+3] (k % 4 == 0, k < 3·hidden): 4 floats of h1, or nullptr where
  // the tap reads zeros.
  __device__ __forceinline__ const float* at(Row row, int k) const {
    const int src = row.first + k / hidden;
    return (unsigned)src < (unsigned)n ? h1 + row.off + k : nullptr;
  }

  __device__ __forceinline__ const float* operator()(int r, int k) const {
    return at(row(r), k);
  }

  // at(row, k) where k's tap (k / hidden) is known: dWc's loader walks a
  // row's columns in order and counts the taps it crosses.
  __device__ __forceinline__ const float* at(Row row, int k, int tap) const {
    return (unsigned)(row.first + tap) < (unsigned)n ? h1 + row.off + k : nullptr;
  }
};

}  // namespace uu
