// Device code shared by the spatial stack's forward (K1, spatial.cu) and
// backward (K4, spatial_bwd.cu): the packed weights' layout and the gelu;
// and K1's helpers, where one warp owns one frame, lane = channel (C <= 32),
// a frame's activations (17 tokens x C) sit in the warp's slice of shared
// memory, and weights are read from the flat packed buffer.
//
// Packed parameter buffer (float32, this order): emb_w (2, C), emb_b (C),
// pe (17, C); per block: ln1_g, ln1_b, wq (C, C), bq, wk, bk, wv, bv, wp, bp,
// ln2_g, ln2_b, w1 (C, 2C), b1 (2C), w2 (2C, C), b2; then norm_g, norm_b.
// Every matrix is (in, out) row-major, the flax Dense layout. K4 writes its
// parameter gradients in the same layout.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "gemm.cuh"

namespace sp {

constexpr int P = 17;  // joint tokens

using uu::warp_sum;

template <int C>
struct Layout {
  static constexpr int HID = 2 * C;
  static constexpr int EMB_W = 0, EMB_B = 2 * C, PE = 3 * C, BLOCKS = PE + P * C;
  static constexpr int LN1_G = 0, LN1_B = C, WQ = 2 * C, BQ = WQ + C * C;
  static constexpr int WK = BQ + C, BK = WK + C * C, WV = BK + C, BV = WV + C * C;
  static constexpr int WP = BV + C, BP = WP + C * C, LN2_G = BP + C, LN2_B = LN2_G + C;
  static constexpr int W1 = LN2_B + C, B1 = W1 + C * HID, W2 = B1 + HID, B2 = W2 + HID * C;
  static constexpr int BLOCK = B2 + C;
  static __host__ __device__ int params(int blocks) { return BLOCKS + blocks * BLOCK + 2 * C; }
};

// out[p, lane] = LN(in[p, :]) for every token; lane = channel (C <= 32).
template <int C>
__device__ __forceinline__ void layer_norm(const float* in, float* out, const float* g,
                                           const float* b, float eps, int lane) {
  const bool on = lane < C;
#pragma unroll 1
  for (int p = 0; p < P; ++p) {
    const float v = on ? in[p * C + lane] : 0.f;
    const float mu = warp_sum(v) / C;
    const float d = on ? v - mu : 0.f;
    const float inv = 1.f / sqrtf(warp_sum(d * d) / C + eps);
    if (on) out[p * C + lane] = d * inv * g[lane] + b[lane];
  }
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// MODE 0: out = in.W + b; 1: out = gelu(in.W + b); 2: out += (in.W + b) * s.
template <int CIN, int COUT, int MODE>
__device__ __forceinline__ void dense(const float* in, const float* w, const float* b,
                                      float* out, int lane, float s = 1.f) {
#pragma unroll
  for (int o0 = 0; o0 < COUT; o0 += 32) {
    const int o = o0 + lane;
    if (o < COUT) {
      float wc[CIN];
#pragma unroll
      for (int i = 0; i < CIN; ++i) wc[i] = w[i * COUT + o];
      const float bo = b[o];
#pragma unroll 1
      for (int p = 0; p < P; ++p) {
        const float* row = in + p * CIN;
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < CIN; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(row + i);
          acc = fmaf(v.x, wc[i], acc);
          acc = fmaf(v.y, wc[i + 1], acc);
          acc = fmaf(v.z, wc[i + 2], acc);
          acc = fmaf(v.w, wc[i + 3], acc);
        }
        acc += bo;
        if (MODE == 1) acc = gelu(acc);
        if (MODE == 2)
          out[p * COUT + o] += acc * s;  // s = 1 (eval) is exact
        else
          out[p * COUT + o] = acc;
      }
    }
  }
}

// ctx[p, h*D:(h+1)*D] = softmax_k(q_p.k_k * scale) . v; one (p, h) per lane.
template <int C, int D>
__device__ __forceinline__ void attention(const float* q, const float* k, const float* v,
                                          float* ctx, float scale, int lane) {
  constexpr int H = C / D;
#pragma unroll 1
  for (int idx = lane; idx < P * H; idx += 32) {
    const int p = idx / H, h = idx % H;
    float qv[D];
#pragma unroll
    for (int e = 0; e < D; ++e) qv[e] = q[p * C + h * D + e];
    float logit[P];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < D; ++e) s = fmaf(qv[e], k[j * C + h * D + e], s);
      logit[j] = s * scale;
      mx = fmaxf(mx, logit[j]);
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      logit[j] = expf(logit[j] - mx);
      sum += logit[j];
    }
#pragma unroll
    for (int e = 0; e < D; ++e) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) acc = fmaf(logit[j], v[j * C + h * D + e], acc);
      ctx[p * C + h * D + e] = acc / sum;
    }
  }
}

}  // namespace sp
