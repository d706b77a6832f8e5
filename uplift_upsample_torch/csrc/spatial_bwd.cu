// K4 — the backward of the fused spatial stack (K1), one kernel plus a
// fixed-order sum.
//
// Replaces: uplift_upsample_tpu/ops/pallas_spatial_bwd.py
//   fused_spatial_stack_bwd (:418, pallas_call :491; kernel _make_bwd_kernel
//   :113, its attention backward :234), the VJP of
//   pallas_spatial.fused_spatial_train. Given the frames' input x (F, 17, 2),
//   the packed weights, the stochastic-depth scales (2L, F) and the output
//   gradient g (F, 17*C), it returns the gradients of every weight (packed as
//   the weights are, spatial_common.cuh), dx (F, 17, 2) and dscales (2L, F).
//   The gradients are those of the true parameters (the 1/sqrt(D) logit
//   scale stays explicit); the gelu derivative is exact, Phi(h) + h*phi(h).
//
// What bounds it: operations, ~97 GFLOP at 25,600 frames (the forward
// replay, the block recompute and the backward products), of which the
// dense layers' 86 GFLOP run on the tensor cores in 3xTF32 (three TF32
// products each, tf32.cuh); the 17-token attention (8 heads of 4), the
// LayerNorms and the gelu run on the CUDA cores. In practice it is bound by
// latency, not by either peak: the products' fragment loads and splits, the
// attention's serial chains and ~30 barriers per block and tile with 8
// warps per SM (kernel_probe.py times it without each part).
//
// Design (Hopper; not the TPU's frames-on-lanes tile): one thread block of 8
// warps per SM walks tiles of TF = 7 frames. The tile, the products x.W
// (rows_gemm), the LayerNorm statistics (two lanes per row), the forward
// attention and the staging of a block's weights are spatial_common.cuh's,
// which K1 runs too. A tile's 119 token rows, padded to 128, are 8 m16
// tiles, one per warp, so every dense product has M = 128
// rows on mma.sync.m16n8k8: warp w owns rows 16w..16w+15 of x.W and dY.W^T,
// or pairs of (m16, n8) tiles of dW = X^T.dY, whose K is the tile's rows.
// 16 frames (272 rows, 17 m16 tiles) would need 313 KB of row buffers, more
// than an SM has; 8 frames (9 warps) fit but ptxas held 288 threads to 168
// registers and spilled; 7 frames leave 255 registers to 256 threads.
//  - Per tile: the embedding, then the forward replay block by block, each
//    block's input (a checkpoint) and its attention context written to the
//    thread block's slice of a scratch buffer in device memory ((2L+1) x 128
//    x C floats, 19 MB over 132 blocks, read back with cp.async beside the
//    weights' staging); the tile's output gradient arrives by cp.async
//    during the replay. Then the final LayerNorm's backward and the blocks
//    last to first: from the checkpoint and the context, proj + residual,
//    LN2 and fc1 again, the MLP branch's backward, then the attention
//    branch's with q|k|v recomputed (shared memory does not hold them
//    through the MLP's backward; keeping X2 and fc1's output in the scratch
//    as well was slower: 45 MB no longer stays in L2).
//  - The LayerNorm outputs are not stored: the products normalise x0 as they
//    load it (q|k|v), or read the normalised input kept in place (fc1, dW of
//    fc1 and q|k|v, the LayerNorm backward). The scale gradients use
//    sum(dY . branch) = sum(X . (dY.W^T)) + sum(dY . b), so the backward
//    recomputes no fc2 or proj output.
//  - Each block's weights are staged in shared memory already split into
//    TF32 halves (2 x 38 KB), once per block and pass. Row pitches are 4 mod
//    8 floats and the weights' 8 mod 16, so the fragment loads of x.W hit 32
//    banks; dW takes its K rows permuted inside each 8-row step (A column t
//    <-> row 2t, t+4 <-> 2t+1, the same for dY), which keeps those loads on
//    32 banks too.
//  - Each 8-deep step's three products go into a fresh partial that joins
//    the fp32 accumulators with a rounded add (the tensor cores round
//    toward zero as they accumulate).
//  - Parameter gradients: each tile's dW partial (K = 128 rows) is added into
//    the thread block's own row of a (grid, n_params) buffer, element by
//    element by one thread (the row's slice prefetched into L2, its values
//    loaded before the products); the bias gradients come with dW from the
//    same fragments, the LayerNorm, embedding and PE gradients are column
//    sums over the tile's rows in a fixed order; those small ones are kept
//    in shared memory over the block's tiles and written to the row at the
//    end. sum_rows_f32 adds the 132 rows in a fixed order. No float atomics:
//    repeated runs agree bit for bit. The scale gradients are summed per
//    frame at the end of each tile.
//  - Padded rows (the 9 after 119, and the frames after F in the last tile)
//    carry a row factor of 0 into every gradient sum, and the gradient
//    flowing down the residual stream is kept 0 there.
//
// The bf16 rung (`spatial_bwd_bf16`, TRAIN_MATMUL_PRECISION "default"; the
// JAX kernel's fwd_dot / grad_dot at DEFAULT, pallas_spatial_bwd.py:42-95):
// the same kernel with BF16. The weights are staged rounded to bf16 (no
// small half), and every product takes bf16-rounded operands, one TF32
// product per pair with fp32 sums:
//  - the forward replay and the recompute run as K1's bf16 instance does
//    (one running sum per output, A rounded as it is read, the embedding's
//    operands rounded), so the activations it replays are K1's; the
//    backward's LN2 takes the replay's statistics (ln_stats), so the
//    rounded operands it recomputes are the replay's too;
//  - dX = round(s . dY) . round(W)^T: the droppath factor multiplies dY
//    before the rounding (1/keep is no power of two), where the 3xTF32
//    instance scales the product; dW = round(X)^T . round(s . dY); the
//    embedding's dW and dx round x, dY and emb_w;
//  - the scale gradients need sum(dY . branch) with the branch's product on
//    rounded operands: sum(round(X) . (dY . round(W)^T)), its dY . W^T at
//    fp32 level from the 3xTF32 routine on the rounded plane (a second
//    product of fc2's and proj's backward).
// The 17-token attention, the LayerNorms, the gelu and every sum stay fp32,
// as in K1's bf16 instance (the TPU computes that attention on the VPU).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gemm.cuh"
#include "spatial_common.cuh"
#include "tf32.cuh"

namespace {

using sp::Layout;
using sp::LOG2E;
using sp::P;
using sp::R;
using sp::TF;
using sp::THREADS;
using sp::WARPS;

constexpr float INV_SQRT2 = 0.70710678118654752f;
constexpr float INV_SQRT_2PI = 0.39894228040143268f;

// x as an operand of a tensor-core product: TF32 halves, or rounded to bf16
// with no small half (BF16).
template <bool BF16>
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  if constexpr (BF16) {
    big = uu::bf16_round(x);
    small = 0u;
  } else {
    uu::tf32_split(x, big, small);
  }
}

// gelu(h) = h * Phi(h) and its derivative Phi(h) + h * phi(h), one erff.
__device__ __forceinline__ float gelu_and_grad(float h, float* grad) {
  const float phi = 0.5f * (1.f + erff(h * INV_SQRT2));
  *grad = phi + h * INV_SQRT_2PI * expf(-0.5f * h * h);
  return h * phi;
}

// Shared-memory layout (floats) of one thread block; the pitches are
// spatial_common.cuh's.
template <int C>
struct Tile : sp::Pitch<C> {
  using Base = sp::Pitch<C>;
  using Base::C3, Base::HID, Base::P3, Base::PC, Base::PH, Base::H, Base::WEIGHTS;
  static constexpr int U = R * PC;
  static constexpr int STATS = 2 * TF * H * P;  // attention backward: lse, rowsum(P dP)
  // G: the working region, laid out per phase (see the kernel)
  static constexpr int G_A = U + R * P3, G_B = U + 2 * R * PH, G_C = 2 * U + R * P3 + STATS;
  static constexpr int G = G_A > G_B ? (G_A > G_C ? G_A : G_C) : (G_B > G_C ? G_B : G_C);
  static constexpr int ROWS = 8 * R;  // mu1, rs1, mu2, rs2, rowf, s1r, s2r, rsum
  static constexpr int FLOATS = 2 * U + G + 2 * WEIGHTS + ROWS + 2 * THREADS;
};

// *out(i, o) += sum over the tile's rows r of x(r, i) * dy(r, o) * f[r]
// (dW = X^T . dY, CIN x N): pairs of (m16, n8) output tiles side by side,
// which share X's fragments, spread over the warps. The warps of the first
// m16 tile also add the bias gradient, *bias(o) += sum over r of dy(r, o) *
// f[r], from the same values (per lane in row order, then over the quad).
// BF16: x and dy * f rounded to bf16, one TF32 product a step.
template <int CIN, int N, bool BF16 = false, class X, class Y, class Out, class Bias>
__device__ __forceinline__ void tile_dw(X x_at, Y dy_at, const float* f, Out out, Bias bias) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  constexpr int NP = N / 16, PAIRS = CIN / 16 * NP;  // two n8 tiles beside each other
  for (int pair = warp; pair < PAIRS; pair += WARPS) {
    const int i = 16 * (pair / NP) + g, o0 = 16 * (pair % NP) + g;
    const int o = o0 - g + 2 * t;  // C fragment: rows g, g+8; columns 2t, 2t+1 (+8)
    // the gradient row's values, loaded before the products hide their latency
    float old[2][4], acc[2][4], bsum[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      old[u][0] = *out(i, o + 8 * u);
      old[u][1] = *out(i, o + 8 * u + 1);
      old[u][2] = *out(i + 8, o + 8 * u);
      old[u][3] = *out(i + 8, o + 8 * u + 1);
      acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;  // this tile's partial
    }
#pragma unroll 8
    for (int s = 0; s < R / 8; ++s) {
      const int ra = 8 * s + 2 * t, rb = ra + 1;  // A column t <-> row ra, t+4 <-> rb
      uint32_t ab[4], as[4];
      split<BF16>(x_at(ra, i), ab[0], as[0]);
      split<BF16>(x_at(ra, i + 8), ab[1], as[1]);
      split<BF16>(x_at(rb, i), ab[2], as[2]);
      split<BF16>(x_at(rb, i + 8), ab[3], as[3]);
      const float fa = f[ra], fb = f[rb];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float ya = dy_at(ra, o0 + 8 * u) * fa, yb = dy_at(rb, o0 + 8 * u) * fb;
        bsum[u] += ya + yb;
        uint32_t bb[2], bs[2];
        split<BF16>(ya, bb[0], bs[0]);
        split<BF16>(yb, bb[1], bs[1]);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (BF16)
          uu::mma_tf32(part, ab, bb);
        else
          uu::mma_3xtf32(part, ab, as, bb, bs);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][e] += part[e];
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      *out(i, o + 8 * u) = old[u][0] + acc[u][0];
      *out(i, o + 8 * u + 1) = old[u][1] + acc[u][1];
      *out(i + 8, o + 8 * u) = old[u][2] + acc[u][2];
      *out(i + 8, o + 8 * u + 1) = old[u][3] + acc[u][3];
      bsum[u] += __shfl_xor_sync(0xffffffffu, bsum[u], 1);
      bsum[u] += __shfl_xor_sync(0xffffffffu, bsum[u], 2);
    }
    if (pair < NP && t == 0) {
      *bias(o0) += bsum[0];
      *bias(o0 + 8) += bsum[1];
    }
  }
}

// Column sums over the tile's rows in a fixed order, in two parts: part 1
// sums interleaved chunks of rows (THREADS / ncols of them) of val(r, c)
// and, when given, val2(r, c) into red; after a barrier, part 2 adds the
// chunks in order to *out(c) and *out2(c) (shared memory).
template <class V, class V2 = V>
__device__ __forceinline__ void colsum_part1(int ncols, V val, float* red,
                                             const V2* val2 = nullptr) {
  const int chunks = THREADS / ncols;
  const int c = threadIdx.x % ncols, k = threadIdx.x / ncols;
  if (k < chunks) {
    float s = 0.f, s2 = 0.f;
    for (int r = k; r < R; r += chunks) {
      s += val(r, c);
      if (val2) s2 += (*val2)(r, c);
    }
    red[k * ncols + c] = s;
    red[THREADS + k * ncols + c] = s2;
  }
}

template <class Out, class Out2 = Out>
__device__ __forceinline__ void colsum_part2(int ncols, Out out, const float* red,
                                             const Out2* out2 = nullptr) {
  if (threadIdx.x < ncols) {
    const int chunks = THREADS / ncols;
    float s = 0.f, s2 = 0.f;
    for (int j = 0; j < chunks; ++j) {
      s += red[j * ncols + threadIdx.x];
      s2 += red[THREADS + j * ncols + threadIdx.x];
    }
    *out(threadIdx.x) += s;
    if (out2) *(*out2)(threadIdx.x) += s2;
  }
}

// *out(c) += sum over rows r of val(r, c), c < ncols, both parts.
template <class V, class Out>
__device__ __forceinline__ void colsum_add(int ncols, V val, Out out, float* red) {
  colsum_part1(ncols, val, red);
  __syncthreads();
  colsum_part2(ncols, out, red);
  __syncthreads();
}

// x (pitch PC) normalised in place, row by row (xhat = (x - mean) * rs),
// and each row's rs = 1/sqrt(var + eps), one thread per row.
template <int C>
__device__ __forceinline__ void ln_normalize(float* x, float* rs, float eps) {
  constexpr int PC = Tile<C>::PC;
  for (int r = threadIdx.x; r < R; r += THREADS) {
    float v[C];
#pragma unroll
    for (int c = 0; c < C; c += 4)
      *reinterpret_cast<float4*>(v + c) = *reinterpret_cast<const float4*>(x + r * PC + c);
    float m = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) m += v[c];
    m /= C;
    float var = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) var = fmaf(v[c] - m, v[c] - m, var);
    const float inv = 1.f / sqrtf(var / C + eps);
    rs[r] = inv;
#pragma unroll
    for (int c = 0; c < C; c += 4)
      *reinterpret_cast<float4*>(x + r * PC + c) =
          make_float4((v[c] - m) * inv, (v[c + 1] - m) * inv, (v[c + 2] - m) * inv,
                      (v[c + 3] - m) * inv);
  }
}

// out (pitch PC) = [out +] LN'(dy) at xhat (the normalised input; rs the
// rows' 1/sqrt(var + eps)), 0 on padded rows, one thread per row; the
// LayerNorm's gamma and beta gradients first go to g_gamma, g_beta (one
// column-sum pass).
template <int C>
__device__ __forceinline__ void ln_bwd(const float* xhat, const float* dy, const float* gamma,
                                       const float* rs, const float* rowf, float* out, bool add,
                                       float* g_gamma, float* g_beta, float* red) {
  constexpr int PC = Tile<C>::PC;
  const auto beta_val = [&](int r, int c) { return dy[r * PC + c] * rowf[r]; };
  colsum_part1(
      C, [&](int r, int c) { return dy[r * PC + c] * xhat[r * PC + c] * rowf[r]; }, red,
      &beta_val);
  for (int r = threadIdx.x; r < R; r += THREADS) {
    float xh[C], d[C];
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      *reinterpret_cast<float4*>(xh + c) = *reinterpret_cast<const float4*>(xhat + r * PC + c);
      *reinterpret_cast<float4*>(d + c) = *reinterpret_cast<const float4*>(dy + r * PC + c);
    }
    const float inv = rs[r];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      d[c] *= gamma[c];
      m1 += d[c];
      m2 = fmaf(d[c], xh[c], m2);
    }
    m1 /= C;
    m2 /= C;
    const bool on = rowf[r] > 0.f;
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      float4 o = add ? *reinterpret_cast<const float4*>(out + r * PC + c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      o.x = on ? o.x + (d[c] - m1 - xh[c] * m2) * inv : 0.f;
      o.y = on ? o.y + (d[c + 1] - m1 - xh[c + 1] * m2) * inv : 0.f;
      o.z = on ? o.z + (d[c + 2] - m1 - xh[c + 2] * m2) * inv : 0.f;
      o.w = on ? o.w + (d[c + 3] - m1 - xh[c + 3] * m2) * inv : 0.f;
      *reinterpret_cast<float4*>(out + r * PC + c) = o;
    }
  }
  __syncthreads();
  const auto beta_out = [&](int c) { return g_beta + c; };
  colsum_part2(C, [&](int c) { return g_gamma + c; }, red, &beta_out);
}

// The attention's backward from q|k|v (pitch P3) and dctx (pitch PC): one
// (frame, head, query) per thread for dq (into dq, pitch PC) and each row's
// log-sum-exp and sum(P dP) (into st), then one (frame, head, key) per
// thread for dk and dv, written over that key's k and v (no other item of
// the second pass reads them).
template <int C>
__device__ __forceinline__ void attention_bwd(float* qkv, const float* dctx, float* dq_out,
                                              float* st, int nf, float scale) {
  using T = Tile<C>;
  const float sl = scale * LOG2E;  // the softmax in base 2: st holds log2-sum-exp2
  const int items = nf * T::H * P;
  for (int it = threadIdx.x; it < items; it += THREADS) {
    const int f = it / (T::H * P), h = it / P % T::H, p = it % P;
    const int base = f * P * T::P3 + 4 * h;
    const float4 q = *reinterpret_cast<const float4*>(qkv + base + p * T::P3);
    const float4 g = *reinterpret_cast<const float4*>(dctx + (f * P + p) * T::PC + 4 * h);
    float e[P], dp[P], mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float4 k = *reinterpret_cast<const float4*>(qkv + base + j * T::P3 + C);
      const float4 v = *reinterpret_cast<const float4*>(qkv + base + j * T::P3 + 2 * C);
      e[j] = (q.x * k.x + q.y * k.y + q.z * k.z + q.w * k.w) * sl;
      dp[j] = g.x * v.x + g.y * v.y + g.z * v.z + g.w * v.w;
      mx = fmaxf(mx, e[j]);
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      e[j] = exp2f(e[j] - mx);
      sum += e[j];
    }
    const float inv = 1.f / sum;
    float sd = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      e[j] *= inv;
      sd = fmaf(e[j], dp[j], sd);
    }
    float4 dq = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float4 k = *reinterpret_cast<const float4*>(qkv + base + j * T::P3 + C);
      const float ds = e[j] * (dp[j] - sd);
      dq.x = fmaf(ds, k.x, dq.x);
      dq.y = fmaf(ds, k.y, dq.y);
      dq.z = fmaf(ds, k.z, dq.z);
      dq.w = fmaf(ds, k.w, dq.w);
    }
    *reinterpret_cast<float4*>(dq_out + (f * P + p) * T::PC + 4 * h) =
        make_float4(dq.x * scale, dq.y * scale, dq.z * scale, dq.w * scale);
    st[it] = mx + log2f(sum);
    st[items + it] = sd;
  }
  __syncthreads();
  for (int it = threadIdx.x; it < items; it += THREADS) {
    const int f = it / (T::H * P), h = it / P % T::H, j = it % P;
    const int base = f * P * T::P3 + 4 * h;
    const int row0 = it - j;  // the (frame, head)'s first query item
    const float4 k = *reinterpret_cast<const float4*>(qkv + base + j * T::P3 + C);
    const float4 v = *reinterpret_cast<const float4*>(qkv + base + j * T::P3 + 2 * C);
    float4 dk = make_float4(0.f, 0.f, 0.f, 0.f), dv = dk;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float4 q = *reinterpret_cast<const float4*>(qkv + base + p * T::P3);
      const float4 g = *reinterpret_cast<const float4*>(dctx + (f * P + p) * T::PC + 4 * h);
      const float a = exp2f((q.x * k.x + q.y * k.y + q.z * k.z + q.w * k.w) * sl - st[row0 + p]);
      const float ds = a * ((g.x * v.x + g.y * v.y + g.z * v.z + g.w * v.w) - st[items + row0 + p]);
      dk.x = fmaf(ds, q.x, dk.x);
      dk.y = fmaf(ds, q.y, dk.y);
      dk.z = fmaf(ds, q.z, dk.z);
      dk.w = fmaf(ds, q.w, dk.w);
      dv.x = fmaf(a, g.x, dv.x);
      dv.y = fmaf(a, g.y, dv.y);
      dv.z = fmaf(a, g.z, dv.z);
      dv.w = fmaf(a, g.w, dv.w);
    }
    *reinterpret_cast<float4*>(qkv + base + j * T::P3 + C) =
        make_float4(dk.x * scale, dk.y * scale, dk.z * scale, dk.w * scale);
    *reinterpret_cast<float4*>(qkv + base + j * T::P3 + 2 * C) = dv;
  }
}

// Floats of the small gradients a thread block keeps in shared memory.
template <int C>
__host__ __device__ constexpr int small_floats(int blocks) {
  return Layout<C>::BLOCKS + 2 * C + 11 * C * blocks;
}

template <int C, bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
spatial_bwd_tc_kernel(const float* __restrict__ x, const float* __restrict__ gout,
                      const float* __restrict__ scales, const float* __restrict__ w,
                      float* __restrict__ dx, float* __restrict__ ddp, float* __restrict__ partial,
                      float* __restrict__ scratch, int frames, int blocks, int n_params) {
  using L = Layout<C>;
  using T = Tile<C>;
  constexpr int HID = T::HID, C3 = T::C3, PC = T::PC, PH = T::PH, P3 = T::P3;
  static_assert(C % 16 == 0 && C <= 32, "C = 16 or 32: rows of C lanes, m16 tiles of C");
  extern __shared__ float4 k4_smem[];
  float* sm = reinterpret_cast<float*>(k4_smem);
  float* DD = sm;            // the gradient down the residual stream (then DX2)
  float* XS = DD + T::U;     // the block's input x0: X2 in place, then xhat2; x0, xhat1
  float* G = XS + T::U;      // the working region
  float* WQKV = G + T::G;    // (C, 3C) q|k|v weights' big TF32 halves, pitch W3
  float* WP = WQKV + C * T::W3;
  float* W1 = WP + C * T::WC;
  float* W2 = W1 + C * T::WH;
  float* mu1 = WQKV + 2 * T::WEIGHTS;  // the weights' small halves lie WEIGHTS after the big
  float* rs1 = mu1 + R;
  float* mu2 = rs1 + R;
  float* rs2 = mu2 + R;
  float* rowf = rs2 + R;     // 1 on the tile's real rows, 0 on padded ones
  float* s1r = rowf + R;     // the rows' attention-branch scale (0 on padded rows)
  float* s2r = s1r + R;      // the rows' MLP-branch scale
  float* rsum = s2r + R;     // per-row sums of the scale gradients
  float* red = rsum + R;     // 2 x THREADS: column-sum chunks
  // the small gradients (embedding, PE, LayerNorms, biases), summed here over
  // the block's tiles and written to its gradient row at the end: the
  // packed order of emb_w, emb_b, pe, then norm_g, norm_b, then per block
  // ln1_g, ln1_b, bq, bk, bv, bp, ln2_g, ln2_b, b1, b2 (small_floats)
  float* SG = red + 2 * THREADS;
  float* RSA = SG + small_floats<C>(blocks);  // (2L, R) per-row scale gradients
  float* sg_norm = SG + L::BLOCKS;
  constexpr int SB = 11 * C;  // per block: LN1 0, bq|bk|bv 2C, bp 5C, LN2 6C, b1 8C, b2 10C
  // phase layouts of G: the replay's front CTX | q|k|v, then CTX | H1; the MLP
  // backward CTX | H1 -> gelu(H1) -> dZ | dH1; the attention backward dCTX
  // (over CTX) | q|k|v (then dk, dv over k, v) | dq (then dY) | statistics
  float* CTX = G;
  float* QKV_A = G + T::U;
  float* H1 = G + T::U;
  float* DH1 = H1 + R * PH;
  float* DZ = H1;
  float* QKV_C = G + T::U;  // beside CTX (then dCTX in place); dk, dv over k, v
  float* DQ = QKV_C + R * P3;
  float* ST = DQ + T::U;
  // d(q|k|v)[r, o]: dq from DQ, dk and dv from over k and v
  auto dqkv = [&](int r, int o) { return o < C ? DQ[r * PC + o] : QKV_C[r * P3 + o]; };
  float* DY = DQ;  // dY over dq: rows_gemm reads and writes only the warp's own rows

  for (int i = threadIdx.x; i < T::FLOATS + small_floats<C>(blocks) + 2 * blocks * R;
       i += THREADS)
    sm[i] = 0.f;
  float* gw = partial + (size_t)blockIdx.x * n_params;
  for (int i = threadIdx.x; i < n_params; i += THREADS) gw[i] = 0.f;
  // scratch: each block's input (the checkpoints), then each block's CTX
  float* ck = scratch + (size_t)blockIdx.x * (2 * blocks + 1) * R * C;
  float* ctxg = ck + (size_t)(blocks + 1) * R * C;
  const float scale = 0.5f;  // 1 / sqrt(D), D = 4
  const float* norm = w + L::BLOCKS + blocks * L::BLOCK;
  __syncthreads();

  // an (R, C) slice of the scratch <-> a buffer of pitch PC
  auto save = [&](float* dst, const float* src) {
    for (int e = threadIdx.x; e < R * C / 4; e += THREADS) {
      const int r = e / (C / 4), c = 4 * (e % (C / 4));
      *reinterpret_cast<float4*>(dst + r * C + c) =
          *reinterpret_cast<const float4*>(src + r * PC + c);
    }
  };
  // asynchronous (cp.async): wait_copies() and a barrier before the data is read
  auto restore = [&](float* dst, const float* src) {
    for (int e = threadIdx.x; e < R * C / 4; e += THREADS) {
      const int r = e / (C / 4), c = 4 * (e % (C / 4));
      uu::cp_async16(dst + r * PC + c, src + r * C + c, 16);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto wait_copies = []() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); };
  auto store_ck = [&](int i) { save(ck + (size_t)i * R * C, XS); };
  // block blk's weights into shared memory as TF32 halves (every load issued
  // first, then the splits and stores), its scales per row
  auto stage = [&](int blk, int f0) {
    sp::BlockWeights<C, THREADS> bwts;
    bwts.load(w + L::BLOCKS + blk * L::BLOCK, threadIdx.x);
    bwts.template store<BF16>(WQKV);  // BF16: rounded, the small halves stay 0
    for (int r = threadIdx.x; r < R; r += THREADS) {
      const bool on = rowf[r] > 0.f;
      s1r[r] = on ? scales[(size_t)(2 * blk) * frames + f0 + r / P] : 0.f;
      s2r[r] = on ? scales[(size_t)(2 * blk + 1) * frames + f0 + r / P] : 0.f;
    }
  };
  // LN1(x0)[r, k] and LN2(X2)[r, k] as the products load them
  auto ln1_at = [&](const float* x0, const float* bw) {
    return [=](int r, int k) {
      return (x0[r * PC + k] - mu1[r]) * rs1[r] * bw[L::LN1_G + k] + bw[L::LN1_B + k];
    };
  };
  auto qkv_bias = [](const float* bw, int n) {
    return n < C ? bw[L::BQ + n] : n < 2 * C ? bw[L::BK + n - C] : bw[L::BV + n - 2 * C];
  };
  // XS = (XS - mu) * rs per row: the LayerNorm's xhat in place (no barrier)
  auto normalize = [&](const float* mu, const float* rs) {
    for (int e = threadIdx.x; e < R * C; e += THREADS) {
      const int r = e / C, c = e % C;
      XS[r * PC + c] = (XS[r * PC + c] - mu[r]) * rs[r];
    }
  };
  // the block's front from x0 in XS: (the replay) q|k|v, CTX; then X2 into
  // XS, H1 = LN2(X2) . W1 + b1 (the backward: X2 normalised in place)
  auto front = [&](int blk, int nf, bool replay) {
    const float* bw = w + L::BLOCKS + blk * L::BLOCK;
    sp::ln_stats<C>(XS, mu1, rs1, 1e-5f);
    __syncthreads();
    if (replay) {  // the replay: the attention, its context kept in the scratch
      sp::rows_gemm<C, C3, !BF16, BF16>(ln1_at(XS, bw),
                                        [&](int k, int n) { return WQKV + k * T::W3 + n; },
                                        T::WEIGHTS,
                           [&](int r, int n, float v) {
                             QKV_A[r * P3 + n] = v + qkv_bias(bw, n);
                             return 0.f;
                           },
                           nullptr);
      __syncthreads();
      sp::attention_fwd<C>(QKV_A, CTX, PC, nf, scale);
      __syncthreads();
      save(ctxg + (size_t)blk * R * C, CTX);
    }  // the backward: CTX restored from the replay's context by the caller
    sp::rows_gemm<C, C, !BF16, BF16>([&](int r, int k) { return CTX[r * PC + k]; },
                        [&](int k, int n) { return WP + k * T::WC + n; }, T::WEIGHTS,
                        [&](int r, int n, float v) {
                          XS[r * PC + n] += s1r[r] * (v + bw[L::BP + n]);
                          return 0.f;
                        },
                        nullptr);
    __syncthreads();
    const auto w1_at = [&](int k, int n) { return W1 + k * T::WH + n; };
    if (replay) {  // the replay: X2 stays, the residual of fc2
      sp::ln_stats<C>(XS, mu2, rs2, 1e-5f);
      __syncthreads();
      sp::rows_gemm<C, HID, !BF16, BF16>(
          [&](int r, int k) {
            return (XS[r * PC + k] - mu2[r]) * rs2[r] * bw[L::LN2_G + k] + bw[L::LN2_B + k];
          },
          w1_at, T::WEIGHTS,
          [&](int r, int n, float v) {
            H1[r * PH + n] = sp::gelu(v + bw[L::B1 + n]);
            return 0.f;
          },
          nullptr);
    } else {  // the backward: X2 normalised in place (xhat2), read by fc1, dW1, LN2'
      if constexpr (BF16) {
        // the replay's statistics: LN2's output, rounded for fc1 and dW1, is
        // then the replay's, as the plain version's backward reads its forward's
        sp::ln_stats<C>(XS, mu2, rs2, 1e-5f);
        __syncthreads();
        normalize(mu2, rs2);
      } else {
        ln_normalize<C>(XS, rs2, 1e-5f);
      }
      __syncthreads();
      sp::rows_gemm<C, HID, !BF16, BF16>(
          [&](int r, int k) { return XS[r * PC + k] * bw[L::LN2_G + k] + bw[L::LN2_B + k]; },
          w1_at, T::WEIGHTS,
          [&](int r, int n, float v) {
            H1[r * PH + n] = v + bw[L::B1 + n];
            return 0.f;
          },
          nullptr);
    }
    __syncthreads();
  };
  // the scale gradient ddp[row, f] per row: rsum + sum_c dy[r, c] b[c] into
  // row `row` of RSA; the frames' sums of the tile's 2L rows at its end
  auto frame_rows = [&](const float* dy, const float* b, int row) {
    for (int r = threadIdx.x; r < R; r += THREADS) {
      float s = rsum[r];
      for (int c = 0; c < C; c += 4) {
        const float4 d = *reinterpret_cast<const float4*>(dy + r * PC + c);
        s = fmaf(d.x, b[c], fmaf(d.y, b[c + 1], fmaf(d.z, b[c + 2], fmaf(d.w, b[c + 3], s))));
      }
      RSA[row * R + r] = s;
    }
  };

  const int tiles = (frames + TF - 1) / TF;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int f0 = tile * TF, nf = min(TF, frames - f0), real = nf * P;
    const float* xin = x + (size_t)f0 * P * 2;
    // ---- embedding + PE, the forward replay, checkpoints ---------------------
    for (int r = threadIdx.x; r < R; r += THREADS) rowf[r] = r < real ? 1.f : 0.f;
    // BF16: the embedding's operands rounded, as K1's bf16 instance does
    const auto op = [](float v) { return BF16 ? uu::bf16_roundf(v) : v; };
    for (int e = threadIdx.x; e < R * C; e += THREADS) {
      const int r = e / C, c = e % C;
      XS[r * PC + c] = r < real ? fmaf(op(xin[2 * r]), op(w[L::EMB_W + c]),
                                       fmaf(op(xin[2 * r + 1]), op(w[L::EMB_W + C + c]), 0.f)) +
                                      w[L::EMB_B + c] + w[L::PE + (r % P) * C + c]
                                : 0.f;
    }
    __syncthreads();
    store_ck(0);
    // the tile's output gradient into DD (0 on padded rows) while the replay runs
    for (int e = threadIdx.x; e < R * C / 4; e += THREADS) {
      const int r = e / (C / 4), c = 4 * (e % (C / 4));
      const bool on = r < real;
      uu::cp_async16(DD + r * PC + c, on ? gout + ((size_t)f0 * P + r) * C + c : gout, on ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int blk = 0; blk < blocks; ++blk) {
      const float* bw = w + L::BLOCKS + blk * L::BLOCK;
      stage(blk, f0);
      __syncthreads();
      front(blk, nf, true);
      sp::rows_gemm<HID, C, !BF16, BF16>([&](int r, int k) { return H1[r * PH + k]; },
                            [&](int k, int n) { return W2 + k * T::WC + n; }, T::WEIGHTS,
                            [&](int r, int n, float v) {
                              XS[r * PC + n] += s2r[r] * (v + bw[L::B2 + n]);
                              return 0.f;
                            },
                            nullptr);
      __syncthreads();
      store_ck(blk + 1);
    }

    // ---- final LayerNorm (eps 1e-6): DD = its backward of g ------------------
    ln_normalize<C>(XS, rs2, 1e-6f);
    wait_copies();
    __syncthreads();
    ln_bwd<C>(XS, DD, norm, rs2, rowf, DD, false, sg_norm, sg_norm + C, red);

    // ---- blocks, last to first ----------------------------------------------
    for (int blk = blocks - 1; blk >= 0; --blk) {
      const float* bw = w + L::BLOCKS + blk * L::BLOCK;
      float* gb = gw + L::BLOCKS + blk * L::BLOCK;
      float* sgb = sg_norm + 2 * C + blk * SB;
      // the block's gradient row into L2 ahead of the tile_dw read-modify-writes
      for (int i = 32 * threadIdx.x; i < L::BLOCK; i += 32 * THREADS)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(gb + i));
      restore(XS, ck + (size_t)blk * R * C);
      restore(CTX, ctxg + (size_t)blk * R * C);
      if (blk < blocks - 1) stage(blk, f0);  // the last block's are staged from the replay
      wait_copies();
      __syncthreads();
      front(blk, nf, false);

      // MLP branch: out = X2 + s2 * (gelu(H1) . W2 + b2)
      const auto w2t_at = [&](int k, int n) { return W2 + n * T::WC + k; };
      if constexpr (BF16) {
        // u = dY . round(W2)^T at fp32 level (the plane's small halves are
        // 0) for the scale gradient over fc2's rounded operand, then dH1
        // from round(s2 . dY)
        sp::rows_gemm<C, HID>([&](int r, int k) { return DD[r * PC + k]; }, w2t_at, T::WEIGHTS,
                              [&](int r, int n, float u) {
                                float grad;
                                const float a = gelu_and_grad(H1[r * PH + n], &grad);
                                H1[r * PH + n] = a;  // gelu(H1) from here on
                                DH1[r * PH + n] = grad;
                                return uu::bf16_roundf(a) * u;
                              },
                              rsum);
        sp::rows_gemm<C, HID, false, true>(
            [&](int r, int k) { return DD[r * PC + k] * s2r[r]; }, w2t_at, T::WEIGHTS,
            [&](int r, int n, float v) {
              DH1[r * PH + n] *= v;
              return 0.f;
            },
            nullptr);
      } else {
        sp::rows_gemm<C, HID>([&](int r, int k) { return DD[r * PC + k]; }, w2t_at, T::WEIGHTS,
                              [&](int r, int n, float u) {
                                float grad;
                                const float a = gelu_and_grad(H1[r * PH + n], &grad);
                                H1[r * PH + n] = a;  // gelu(H1) from here on
                                DH1[r * PH + n] = s2r[r] * u * grad;
                                return a * u;
                              },
                              rsum);
      }
      __syncthreads();
      frame_rows(DD, bw + L::B2, 2 * blk + 1);
      tile_dw<HID, C, BF16>([&](int r, int i) { return H1[r * PH + i]; },
                            [&](int r, int o) { return DD[r * PC + o]; }, s2r,
                            [&](int i, int o) { return gb + L::W2 + i * C + o; },
                            [&](int o) { return sgb + 10 * C + o; });
      tile_dw<C, HID, BF16>(
          [&](int r, int i) { return XS[r * PC + i] * bw[L::LN2_G + i] + bw[L::LN2_B + i]; },
          [&](int r, int o) { return DH1[r * PH + o]; }, rowf,
          [&](int i, int o) { return gb + L::W1 + i * HID + o; },
          [&](int o) { return sgb + 8 * C + o; });
      __syncthreads();  // dZ goes over gelu(H1)
      sp::rows_gemm<HID, C, !BF16, BF16>([&](int r, int k) { return DH1[r * PH + k]; },
                            [&](int k, int n) { return W1 + n * T::WH + k; }, T::WEIGHTS,
                            [&](int r, int n, float v) {
                              DZ[r * PC + n] = v;
                              return 0.f;
                            },
                            nullptr);
      __syncthreads();
      ln_bwd<C>(XS, DZ, bw + L::LN2_G, rs2, rowf, DD, true, sgb + 6 * C, sgb + 7 * C,
                red);

      // attention branch: X2 = x0 + s1 * (CTX . Wp + bp); x0 comes back
      // while dWp and dCTX run
      restore(XS, ck + (size_t)blk * R * C);
      tile_dw<C, C, BF16>([&](int r, int i) { return CTX[r * PC + i]; },
                          [&](int r, int o) { return DD[r * PC + o]; }, s1r,
                          [&](int i, int o) { return gb + L::WP + i * C + o; },
                          [&](int o) { return sgb + 5 * C + o; });
      __syncthreads();  // dCTX goes over CTX
      const auto wpt_at = [&](int k, int n) { return WP + n * T::WC + k; };
      if constexpr (BF16) {  // as fc2's: the scale gradient, then round(s1 . dY) . round(Wp)^T
        sp::rows_gemm<C, C>([&](int r, int k) { return DD[r * PC + k]; }, wpt_at, T::WEIGHTS,
                            [&](int r, int n, float u) {
                              return uu::bf16_roundf(CTX[r * PC + n]) * u;
                            },
                            rsum);
        sp::rows_gemm<C, C, false, true>(
            [&](int r, int k) { return DD[r * PC + k] * s1r[r]; }, wpt_at, T::WEIGHTS,
            [&](int r, int n, float v) {
              CTX[r * PC + n] = v;  // dCTX
              return 0.f;
            },
            nullptr);
      } else {
        sp::rows_gemm<C, C>([&](int r, int k) { return DD[r * PC + k]; }, wpt_at, T::WEIGHTS,
                            [&](int r, int n, float u) {
                              const float ctx = CTX[r * PC + n];
                              CTX[r * PC + n] = s1r[r] * u;  // dCTX
                              return ctx * u;
                            },
                            rsum);
      }
      __syncthreads();
      frame_rows(DD, bw + L::BP, 2 * blk);
      wait_copies();
      __syncthreads();
      sp::rows_gemm<C, C3, !BF16, BF16>(ln1_at(XS, bw),
                                        [&](int k, int n) { return WQKV + k * T::W3 + n; },
                           T::WEIGHTS,
                           [&](int r, int n, float v) {
                             QKV_C[r * P3 + n] = v + qkv_bias(bw, n);
                             return 0.f;
                           },
                           nullptr);
      __syncthreads();
      normalize(mu1, rs1);  // xhat1, beside the attention's backward (no barrier)
      attention_bwd<C>(QKV_C, CTX, DQ, ST, nf, scale);
      __syncthreads();
      tile_dw<C, C3, BF16>(
          [&](int r, int i) { return XS[r * PC + i] * bw[L::LN1_G + i] + bw[L::LN1_B + i]; },
          dqkv, rowf,
          [&](int i, int o) {
            const int part = o / C, oo = o % C;
            return gb + (part == 0 ? L::WQ : part == 1 ? L::WK : L::WV) + i * C + oo;
          },
          [&](int o) { return sgb + 2 * C + o; });
      __syncthreads();  // dY goes over dq
      sp::rows_gemm<C3, C, !BF16, BF16>(dqkv, [&](int k, int n) { return WQKV + n * T::W3 + k; },
                                        T::WEIGHTS,
                           [&](int r, int n, float v) {
                             DY[r * PC + n] = v;
                             return 0.f;
                           },
                           nullptr);
      __syncthreads();
      ln_bwd<C>(XS, DY, bw + L::LN1_G, rs1, rowf, DD, true, sgb, sgb + C, red);
    }

    // ---- embedding + PE ------------------------------------------------------
    for (int e = threadIdx.x; e < P * C; e += THREADS) {
      const int p = e / C, c = e % C;
      float s = 0.f;
      for (int f = 0; f < nf; ++f) s += DD[(f * P + p) * PC + c];
      SG[L::PE + e] += s;
    }
    colsum_add(C, [&](int r, int c) { return DD[r * PC + c]; },
               [&](int c) { return SG + L::EMB_B + c; }, red);
    colsum_add(2 * C,
               [&](int r, int c) {
                 return r < real ? op(xin[2 * r + c / C]) * op(DD[r * PC + c % C]) : 0.f;
               },
               [&](int c) { return SG + L::EMB_W + c; }, red);
    for (int r = threadIdx.x; r < real; r += THREADS) {
      float d0 = 0.f, d1 = 0.f;
      for (int c = 0; c < C; ++c) {
        d0 = fmaf(op(DD[r * PC + c]), op(w[L::EMB_W + c]), d0);
        d1 = fmaf(op(DD[r * PC + c]), op(w[L::EMB_W + C + c]), d1);
      }
      __stcs(dx + ((size_t)f0 * P + r) * 2, d0);  // streamed: read by no one here
      __stcs(dx + ((size_t)f0 * P + r) * 2 + 1, d1);
    }
    for (int i = threadIdx.x; i < 2 * blocks * nf; i += THREADS) {
      const int row = i / nf, f = i % nf;
      float sum = 0.f;
      for (int p = 0; p < P; ++p) sum += RSA[row * R + f * P + p];
      __stcs(ddp + (size_t)row * frames + f0 + f, sum);
    }
    __syncthreads();
  }
  // the small gradients into the block's row (the rest of it is dW)
  for (int i = threadIdx.x; i < L::BLOCKS + 2 * C; i += THREADS)
    gw[i < L::BLOCKS ? i : L::BLOCKS + blocks * L::BLOCK + i - L::BLOCKS] = SG[i];
  constexpr int FIELD[10] = {L::LN1_G, L::LN1_B, L::BQ, L::BK, L::BV, L::BP, L::LN2_G,
                             L::LN2_B, L::B1, L::B1 + C};
  for (int i = threadIdx.x; i < blocks * SB; i += THREADS) {
    const int blk = i / SB, j = i % SB;
    const int field = j / C;  // C-wide fields; b1 is two of them, b2 the last
    const int off = field < 10 ? FIELD[field] + j % C : L::B2 + j % C;
    gw[L::BLOCKS + blk * L::BLOCK + off] = sg_norm[2 * C + i];
  }
}

template <int C, bool BF16>
cudaError_t launch(const float* x, const float* g, const float* scales, const float* params,
                   float* dx, float* ddp, float* partial, float* scratch, int frames,
                   int blocks, int workers, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (Tile<C>::FLOATS + small_floats<C>(blocks) + 2 * (size_t)blocks * R);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(spatial_bwd_tc_kernel<C, BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  spatial_bwd_tc_kernel<C, BF16><<<workers, THREADS, smem, stream>>>(
      x, g, scales, params, dx, ddp, partial, scratch, frames, blocks,
      Layout<C>::params(blocks));
  return cudaGetLastError();
}

}  // namespace

// Rows of the per-block gradient buffer spatial_bwd_f32 needs for `frames`
// (one per thread block: min(SMs, tiles of 7 frames)), or a negative CUDA
// error. Launches nothing.
extern "C" int spatial_bwd_workers(int c, int depth, int blocks, int frames) {
  if (depth != 4 || blocks < 0 || frames <= 0 || (c != 32 && c != 16))
    return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  const int tiles = (frames + TF - 1) / TF;
  return tiles < sms ? tiles : sms;
}

// Floats of checkpoint scratch spatial_bwd_f32 needs per gradient row.
extern "C" int spatial_bwd_scratch_floats(int c, int blocks) { return (2 * blocks + 1) * R * c; }

namespace {

template <bool BF16>
int bwd_entry(const float* x, const float* g, const float* scales, const float* params,
              float* dx, float* ddp, float* partial, float* scratch, int frames, int c,
              int depth, int blocks, int workers, void* stream) {
  if (frames <= 0 || blocks < 0 || depth != 4 || workers <= 0) return cudaErrorInvalidValue;
  if (c == 32)
    return launch<32, BF16>(x, g, scales, params, dx, ddp, partial, scratch, frames, blocks,
                            workers, (cudaStream_t)stream);
  if (c == 16)
    return launch<16, BF16>(x, g, scales, params, dx, ddp, partial, scratch, frames, blocks,
                            workers, (cudaStream_t)stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (frames, 17, 2), g (frames, 17*c), scales (2*blocks, frames), params packed;
// out: dx (frames, 17, 2), ddp (2*blocks, frames), partial (workers, n_params);
// scratch (workers, spatial_bwd_scratch_floats) checkpoints.
extern "C" int spatial_bwd_f32(const float* x, const float* g, const float* scales,
                               const float* params, float* dx, float* ddp, float* partial,
                               float* scratch, int frames, int c, int depth, int blocks,
                               int workers, void* stream) {
  return bwd_entry<false>(x, g, scales, params, dx, ddp, partial, scratch, frames, c, depth,
                          blocks, workers, stream);
}

// The bf16 rung (the note at the top): the same operands and outputs.
extern "C" int spatial_bwd_bf16(const float* x, const float* g, const float* scales,
                                const float* params, float* dx, float* ddp, float* partial,
                                float* scratch, int frames, int c, int depth, int blocks,
                                int workers, void* stream) {
  return bwd_entry<true>(x, g, scales, params, dx, ddp, partial, scratch, frames, c, depth,
                         blocks, workers, stream);
}

// out[c] = sum over r (in order) of part[r, c].
extern "C" int sum_rows_f32(const float* part, float* out, int rows, int cols, void* stream) {
  return uu::launch_sum_rows(part, out, rows, cols, (cudaStream_t)stream);
}
