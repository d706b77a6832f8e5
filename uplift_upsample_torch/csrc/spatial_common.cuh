// Device code shared by the spatial stack's forward (K1, spatial.cu) and
// backward (K4, spatial_bwd.cu): the packed weights' layout, the gelu, and
// the tile of frames both kernels run their dense layers on. A tile is TF = 7
// frames, 119 token rows padded to R = 128: eight m16 tiles of rows, one per
// warp of a group of 8 warps. Every dense product x.W runs on
// mma.sync.m16n8k8 in 3xTF32 with the warp's 16 rows as M (rows_gemm); the
// LayerNorm statistics take two lanes per row of the warp's own rows
// (ln_stats); the 17-token attention takes one thread per (frame, head,
// query) (attention_fwd); a block's six matrices are staged in shared memory
// at padded pitches (BlockWeights).
//
// Packed parameter buffer (float32, this order): emb_w (2, C), emb_b (C),
// pe (17, C); per block: ln1_g, ln1_b, wq (C, C), bq, wk, bk, wv, bv, wp, bp,
// ln2_g, ln2_b, w1 (C, 2C), b1 (2C), w2 (2C, C), b2; then norm_g, norm_b.
// Every matrix is (in, out) row-major, the flax Dense layout. K4 writes its
// parameter gradients in the same layout.
//
// The bf16 mode (rows_gemm's and BlockWeights::store's BF16: K1's and K4's
// bf16 instances): the staged weights are rounded to bf16 instead of split,
// A is rounded as rows_gemm reads it, and each pair of rounded operands
// takes one TF32 product (tf32.cuh), fp32 sums.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32.cuh"

namespace sp {

constexpr int P = 17;                // joint tokens
constexpr int TF = 7;                // frames per tile
constexpr int R = 128;               // the tile's rows: 7 x 17 = 119, padded to 8 x 16
constexpr int WARPS = R / 16;        // a group: one m16 tile of rows per warp
constexpr int THREADS = WARPS * 32;  // the group's threads
constexpr float LOG2E = 1.4426950408889634f;

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

// Pitches (floats) of a tile's activations in shared memory, 4 mod 8, and of
// a block's staged weights, 8 mod 16: the fragment loads of x.W hit 32 banks.
// The staged weights: wq|wk|wv side by side (C x 3C, pitch W3), then wp
// (C x C, WC), w1 (C x 2C, WH), w2 (2C x C, WC); WEIGHTS floats in all.
template <int C>
struct Pitch {
  static constexpr int H = C / 4, HID = 2 * C, C3 = 3 * C;
  static constexpr int PC = C + 4, PH = HID + 4, P3 = C3 + 4;
  static constexpr int WC = C + 8, WH = HID + 8, W3 = C3 + 8;
  static constexpr int OFF_WP = C * W3, OFF_W1 = OFF_WP + C * WC, OFF_W2 = OFF_W1 + C * WH;
  static constexpr int WEIGHTS = OFF_W2 + HID * WC;
};

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// out[r, n] = epi(r, n, sum_k a(r, k) b(k, n)) for the warp's 16 rows (warp w
// of its group: rows 16w..16w+15); epi returns a value summed per row into
// rsum[r] when rsum is given. b_at(k, n) points at a staged weight's big TF32
// half, its small half `small` floats further; SPLIT_B (K4): at the weight
// itself, split into its halves as it is read (the same bits as staged
// halves; `small` unused). FRESH: each 8-deep step's
// three products go into a fresh partial that joins the fp32 accumulators
// with a rounded add (the tensor cores round toward zero as they accumulate);
// else one running sum per output in the tensor cores, which meets the
// float64 criterion for K <= 64 (tests/test_torch_spatial_tc.py). BF16 (the
// running sums only: K1's and K4's bf16 instances): A rounded to bf16, b_at a
// staged weight already rounded (no small half), one TF32 product per pair.
template <int K, int N, bool FRESH = true, bool BF16 = false, bool SPLIT_B = false, class A,
          class B, class Epi>
__device__ __forceinline__ void rows_gemm(A a_at, B b_at, int small, Epi epi, float* rsum) {
  static_assert(!(BF16 && FRESH), "the bf16 mode keeps one running sum per output");
  constexpr int NJ = N / 8;
  const int warp = threadIdx.x / 32 % WARPS, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    if constexpr (BF16) {
      const uint32_t ab[4] = {uu::bf16_round(a_at(r0, 8 * kk + t)),
                              uu::bf16_round(a_at(r1, 8 * kk + t)),
                              uu::bf16_round(a_at(r0, 8 * kk + t + 4)),
                              uu::bf16_round(a_at(r1, 8 * kk + t + 4))};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const uint32_t bb[2] = {__float_as_uint(*b_at(8 * kk + t, 8 * j + g)),
                                __float_as_uint(*b_at(8 * kk + t + 4, 8 * j + g))};
        uu::mma_tf32(acc[j], ab, bb);
      }
      continue;
    }
    uint32_t ab[4], as[4];
    uu::tf32_split(a_at(r0, 8 * kk + t), ab[0], as[0]);
    uu::tf32_split(a_at(r1, 8 * kk + t), ab[1], as[1]);
    uu::tf32_split(a_at(r0, 8 * kk + t + 4), ab[2], as[2]);
    uu::tf32_split(a_at(r1, 8 * kk + t + 4), ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* b0 = b_at(8 * kk + t, 8 * j + g);
      const float* b1 = b_at(8 * kk + t + 4, 8 * j + g);
      uint32_t bb[2], bs[2];
      if constexpr (SPLIT_B) {
        uu::tf32_split(b0[0], bb[0], bs[0]);
        uu::tf32_split(b1[0], bb[1], bs[1]);
      } else {
        bb[0] = __float_as_uint(b0[0]);
        bb[1] = __float_as_uint(b1[0]);
        bs[0] = __float_as_uint(b0[small]);
        bs[1] = __float_as_uint(b1[small]);
      }
      if (FRESH) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        uu::mma_3xtf32(part, ab, as, bb, bs);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
      } else {
        uu::mma_3xtf32(acc[j], ab, as, bb, bs);
      }
    }
  }
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = 8 * j + 2 * t;
    s0 += epi(r0, c, acc[j][0]) + epi(r0, c + 1, acc[j][1]);
    s1 += epi(r1, c, acc[j][2]) + epi(r1, c + 1, acc[j][3]);
  }
  if (rsum) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (t == 0) {
      rsum[r0] = s0;
      rsum[r1] = s1;
    }
  }
}

// The warp's row of the LayerNorm and this lane's channels: lane l takes row
// 16w + l % 16 and the float4s 4(l / 16 + 2i) .. +3 of it, i < C / 8 (a
// quarter warp's float4 loads hit 32 banks; a warp's stores to a row-major
// output fill whole 32-byte sectors).
__device__ __forceinline__ int ln_row() {
  return 16 * (threadIdx.x / 32 % WARPS) + threadIdx.x % 16;
}
__device__ __forceinline__ int ln_col(int i) { return 4 * (threadIdx.x % 32 / 16 + 2 * i); }

// Mean and 1/sqrt(var + eps) of this lane's row of x (pitch PC), from its
// channels v (loaded as ln_col gives them) and its partner lane's (lane ^ 16).
template <int C>
__device__ __forceinline__ void ln_row_stats(const float (&v)[C / 2], float eps, float* mean,
                                             float* rstd) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C / 2; ++c) s += v[c];
  const float m = (s + __shfl_xor_sync(0xffffffffu, s, 16)) / C;
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < C / 2; ++c) q = fmaf(v[c] - m, v[c] - m, q);
  q += __shfl_xor_sync(0xffffffffu, q, 16);
  *mean = m;
  *rstd = 1.f / sqrtf(q / C + eps);
}

template <int C>
__device__ __forceinline__ void ln_load(const float* x, float (&v)[C / 2]) {
  const int r = ln_row();
#pragma unroll
  for (int i = 0; i < C / 8; ++i)
    *reinterpret_cast<float4*>(v + 4 * i) =
        *reinterpret_cast<const float4*>(x + r * Pitch<C>::PC + ln_col(i));
}

// Mean and 1/sqrt(var + eps) of the warp's 16 rows of x (pitch PC) into mu
// and rs, two lanes per row. Warp-local: __syncwarp before the warp reads
// them, a barrier before other warps do.
template <int C>
__device__ __forceinline__ void ln_stats(const float* x, float* mu, float* rs, float eps) {
  static_assert(C % 8 == 0, "two lanes of float4s per row");
  float v[C / 2], m, inv;
  ln_load<C>(x, v);
  ln_row_stats<C>(v, eps, &m, &inv);
  if (threadIdx.x % 32 < 16) {
    mu[ln_row()] = m;
    rs[ln_row()] = inv;
  }
}

// ctx = softmax(q k^T * scale) v per (frame, head, query) of the tile's first
// nf frames; q|k|v rows at pitch P3, the context at pitch `pitch`. A thread
// of the group takes two queries of one (frame, head), p and p + 9 (p = 8
// alone), so each key's and value's float4 is read once for both: 504 items
// per tile, two passes of the group. ctx may be qkv itself (the context over
// q): an item reads no q but its own. The 17 logits of each query stay in
// registers; the softmax runs in base 2.
template <int C>
__device__ __forceinline__ void attention_fwd(const float* qkv, float* ctx, int pitch, int nf,
                                              float scale) {
  using T = Pitch<C>;
  constexpr int S = (P + 1) / 2;  // items per (frame, head)
  const float sl = scale * LOG2E;
  for (int it = threadIdx.x % THREADS; it < nf * T::H * S; it += THREADS) {
    const int f = it / (T::H * S), h = it / S % T::H, pa = it % S, pb = pa + S;
    const bool two = pb < P;
    const int base = f * P * T::P3 + 4 * h;
    const float4 qa = *reinterpret_cast<const float4*>(qkv + base + pa * T::P3);
    const float4 qb = *reinterpret_cast<const float4*>(qkv + base + (two ? pb : pa) * T::P3);
    float ea[P], eb[P], ma = -INFINITY, mb = -INFINITY;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float4 k = *reinterpret_cast<const float4*>(qkv + base + j * T::P3 + C);
      ea[j] = (qa.x * k.x + qa.y * k.y + qa.z * k.z + qa.w * k.w) * sl;
      eb[j] = (qb.x * k.x + qb.y * k.y + qb.z * k.z + qb.w * k.w) * sl;
      ma = fmaxf(ma, ea[j]);
      mb = fmaxf(mb, eb[j]);
    }
    float sa = 0.f, sb = 0.f;
    float4 oa = make_float4(0.f, 0.f, 0.f, 0.f), ob = oa;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      ea[j] = exp2f(ea[j] - ma);
      eb[j] = exp2f(eb[j] - mb);
      sa += ea[j];
      sb += eb[j];
      const float4 v = *reinterpret_cast<const float4*>(qkv + base + j * T::P3 + 2 * C);
      oa.x = fmaf(ea[j], v.x, oa.x);
      oa.y = fmaf(ea[j], v.y, oa.y);
      oa.z = fmaf(ea[j], v.z, oa.z);
      oa.w = fmaf(ea[j], v.w, oa.w);
      ob.x = fmaf(eb[j], v.x, ob.x);
      ob.y = fmaf(eb[j], v.y, ob.y);
      ob.z = fmaf(eb[j], v.z, ob.z);
      ob.w = fmaf(eb[j], v.w, ob.w);
    }
    const float ia = 1.f / sa, ib = 1.f / sb;
    *reinterpret_cast<float4*>(ctx + (f * P + pa) * pitch + 4 * h) =
        make_float4(oa.x * ia, oa.y * ia, oa.z * ia, oa.w * ia);
    if (two)
      *reinterpret_cast<float4*>(ctx + (f * P + pb) * pitch + 4 * h) =
          make_float4(ob.x * ib, ob.y * ib, ob.z * ib, ob.w * ib);
  }
}

// One block's six matrices (wq, wk, wv, wp: C x C; w1: C x 2C; w2: 2C x C;
// 2C^2 float4s) into shared memory at Pitch<C>'s layout, by NT threads:
// load() issues every global load into registers, store() splits them into
// TF32 halves, the big at dst, the small WEIGHTS floats further (BF16: rounds
// them to bf16 at dst, no small half). Between the two a caller may wait at
// a barrier.
template <int C, int NT>
struct BlockWeights {
  using L = Layout<C>;
  using T = Pitch<C>;
  static constexpr int NV = 2 * C * C / NT;
  static_assert(2 * C * C % NT == 0, "the weights' float4s spread evenly");
  float4 v[NV];
  int off[NV];  // each float4's offset in the staged layout

  __device__ __forceinline__ void load(const float* bw, int tid) {
    constexpr int Q = C * C / 4;  // float4s per C x C matrix
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int e = tid + k * NT;
      int src;
      if (e < 4 * Q) {
        const int m = e / Q, i = e % Q / (C / 4), o = 4 * (e % (C / 4));
        static_assert(L::WK - L::WQ == C * C + C && L::WP - L::WV == C * C + C, "w, b pairs");
        off[k] = m < 3 ? i * T::W3 + m * C + o : T::OFF_WP + i * T::WC + o;
        src = L::WQ + m * (C * C + C) + i * C + o;  // wq, wk, wv, wp
      } else if (e < 6 * Q) {
        const int i = (e - 4 * Q) / (T::HID / 4), o = 4 * ((e - 4 * Q) % (T::HID / 4));
        off[k] = T::OFF_W1 + i * T::WH + o;
        src = L::W1 + i * T::HID + o;
      } else {
        const int i = (e - 6 * Q) / (C / 4), o = 4 * ((e - 6 * Q) % (C / 4));
        off[k] = T::OFF_W2 + i * T::WC + o;
        src = L::W2 + i * C + o;
      }
      v[k] = *reinterpret_cast<const float4*>(bw + src);
    }
  }

  template <bool BF16 = false>
  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if constexpr (BF16) {
        *reinterpret_cast<uint4*>(dst + off[k]) =
            make_uint4(uu::bf16_round(v[k].x), uu::bf16_round(v[k].y), uu::bf16_round(v[k].z),
                       uu::bf16_round(v[k].w));
        continue;
      }
      uint32_t b[4], s[4];
      uu::tf32_split(v[k].x, b[0], s[0]);
      uu::tf32_split(v[k].y, b[1], s[1]);
      uu::tf32_split(v[k].z, b[2], s[2]);
      uu::tf32_split(v[k].w, b[3], s[3]);
      *reinterpret_cast<uint4*>(dst + off[k]) = make_uint4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<uint4*>(dst + off[k] + T::WEIGHTS) = make_uint4(s[0], s[1], s[2], s[3]);
    }
  }
};

}  // namespace sp
