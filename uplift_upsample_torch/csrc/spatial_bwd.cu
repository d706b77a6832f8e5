// K4 — the backward of the fused spatial stack (K1), one kernel plus a
// fixed-order sum.
//
// Replaces: uplift_upsample_tpu/ops/pallas_spatial_bwd.py
//   fused_spatial_stack_bwd (kernel _make_bwd_kernel), the VJP of
//   pallas_spatial.fused_spatial_train. Given the frames' input x (F, 17, 2),
//   the packed weights, the stochastic-depth scales (2L, F) and the output
//   gradient g (F, 17*C), it returns the gradients of every weight (packed as
//   the weights are, spatial_common.cuh), dx (F, 17, 2) and dscales (2L, F).
//   The gradients are those of the true parameters (the 1/sqrt(D) logit
//   scale stays explicit); the gelu derivative is exact, Phi(h) + h*phi(h).
//
// What bounds it here: ~3x K1's FLOPs (forward replay, the block recompute
// and the backward products; ~97 GFLOP at 25,600 frames), so fp32 operations
// again. Design (not the TPU's frames-on-lanes tile): K1's scheme of one warp
// per frame, lane = channel, on a persistent grid. Per frame the warp replays
// the forward from x, keeping each block's input (L+1 checkpoints) in its
// slice of shared memory, then walks the blocks backwards, recomputing one
// block's intermediates at a time (LN outputs, q/k/v, context, projection,
// fc1) into shared memory. The weights (140 KB at C=32) are read through the
// L1 cache instead of being staged, which leaves the shared memory to the
// warps' working sets (~43 KB each at C=32, L=4: 5 warps per SM).
// Attention's backward takes two passes: one (query, head) per lane for dq
// and the softmax row statistics, then one (key, head) per lane for dk and dv.
//
// Parameter gradients: each warp accumulates into its own row of a
// (workers, n_params) buffer in device memory (no atomics), and
// sum_rows_f32 adds the rows in a fixed order, so repeated runs agree bit for
// bit (the TPU kernel's per-tile partials, pallas_spatial_bwd.py:15-17).

#include <cuda_runtime.h>
#include <math.h>

#include "spatial_common.cuh"

namespace {

using sp::Layout;
using sp::P;
using sp::warp_sum;
constexpr int MAX_WARPS = 8;

// g[i, o] += s * sum_p in[p, i] * dy[p, o]; in (P, CIN), dy (P, COUT).
template <int CIN, int COUT>
__device__ __forceinline__ void dense_dw(const float* in, const float* dy, float s, float* g,
                                         int lane) {
#pragma unroll
  for (int o0 = 0; o0 < COUT; o0 += 32) {
    const int o = o0 + lane;
    if (o < COUT) {
      float dyc[P];
#pragma unroll
      for (int p = 0; p < P; ++p) dyc[p] = dy[p * COUT + o];
#pragma unroll 4
      for (int i = 0; i < CIN; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int p = 0; p < P; ++p) acc = fmaf(in[p * CIN + i], dyc[p], acc);
        g[i * COUT + o] += acc * s;
      }
    }
  }
}

// g[o] += s * sum_p dy[p, o]
template <int COUT>
__device__ __forceinline__ void bias_grad(const float* dy, float s, float* g, int lane) {
  for (int o = lane; o < COUT; o += 32) {
    float acc = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) acc += dy[p * COUT + o];
    g[o] += acc * s;
  }
}

// MODE 0: out[p, i] = s * sum_o dy[p, o] * W[i, o]  (dX = dY . W^T); MODE 2: +=.
template <int CIN, int COUT, int MODE>
__device__ __forceinline__ void dense_t(const float* dy, const float* w, float s, float* out,
                                        int lane) {
#pragma unroll
  for (int i0 = 0; i0 < CIN; i0 += 32) {
    const int i = i0 + lane;
    if (i < CIN) {
      float wr[COUT];
#pragma unroll
      for (int o = 0; o < COUT; ++o) wr[o] = w[i * COUT + o];
#pragma unroll 1
      for (int p = 0; p < P; ++p) {
        const float* row = dy + p * COUT;
        float acc = 0.f;
#pragma unroll
        for (int o = 0; o < COUT; o += 4) {
          const float4 v = *reinterpret_cast<const float4*>(row + o);
          acc = fmaf(v.x, wr[o], acc);
          acc = fmaf(v.y, wr[o + 1], acc);
          acc = fmaf(v.z, wr[o + 2], acc);
          acc = fmaf(v.w, wr[o + 3], acc);
        }
        acc *= s;
        if (MODE == 2)
          out[p * CIN + i] += acc;
        else
          out[p * CIN + i] = acc;
      }
    }
  }
}

// Backward of out = LN(src) * gamma + beta per token: dx (MODE 0: =, 2: +=)
// from dy, the statistics recomputed from src; accumulates dgamma, dbeta.
template <int C, int MODE>
__device__ __forceinline__ void ln_bwd(const float* src, const float* dy, const float* gamma,
                                       float eps, float* out, float* g_gamma, float* g_beta,
                                       int lane) {
  const bool on = lane < C;
  const float gm = on ? gamma[lane] : 0.f;
  float acc_g = 0.f, acc_b = 0.f;
#pragma unroll 1
  for (int p = 0; p < P; ++p) {
    const float v = on ? src[p * C + lane] : 0.f;
    const float mu = warp_sum(v) / C;
    const float d = on ? v - mu : 0.f;
    const float inv = 1.f / sqrtf(warp_sum(d * d) / C + eps);
    const float xhat = d * inv;
    const float dyv = on ? dy[p * C + lane] : 0.f;
    acc_g = fmaf(dyv, xhat, acc_g);
    acc_b += dyv;
    const float dxhat = dyv * gm;
    const float m1 = warp_sum(dxhat) / C;
    const float m2 = warp_sum(dxhat * xhat) / C;
    const float dx = (dxhat - m1 - xhat * m2) * inv;
    if (on) {
      if (MODE == 2)
        out[p * C + lane] += dx;
      else
        out[p * C + lane] = dx;
    }
  }
  if (on) {
    g_gamma[lane] += acc_g;
    g_beta[lane] += acc_b;
  }
}

// dq, dk, dv of ctx = softmax(q k^T * scale) v per head, from dctx.
// ast: 3 * P * H floats for the rows' max, sum and sum_k(attn * dattn).
template <int C, int D>
__device__ __forceinline__ void attention_bwd(const float* q, const float* k, const float* v,
                                              const float* dctx, float* dq, float* dk,
                                              float* dv, float* ast, float scale, int lane) {
  constexpr int H = C / D;
  // pass 1: one (query p, head h) per lane -> dq and the row statistics
#pragma unroll 1
  for (int idx = lane; idx < P * H; idx += 32) {
    const int p = idx / H, h = idx % H;
    float qv[D], dc[D];
#pragma unroll
    for (int e = 0; e < D; ++e) {
      qv[e] = q[p * C + h * D + e];
      dc[e] = dctx[p * C + h * D + e];
    }
    float a[P], da[P];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < D; ++e) s = fmaf(qv[e], k[j * C + h * D + e], s);
      a[j] = s * scale;
      mx = fmaxf(mx, a[j]);
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      a[j] = expf(a[j] - mx);
      sum += a[j];
    }
    float sd = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      a[j] = a[j] / sum;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < D; ++e) s = fmaf(dc[e], v[j * C + h * D + e], s);
      da[j] = s;
      sd = fmaf(a[j], s, sd);
    }
    float dqv[D];
#pragma unroll
    for (int e = 0; e < D; ++e) dqv[e] = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float dl = a[j] * (da[j] - sd);
#pragma unroll
      for (int e = 0; e < D; ++e) dqv[e] = fmaf(dl, k[j * C + h * D + e], dqv[e]);
    }
#pragma unroll
    for (int e = 0; e < D; ++e) dq[p * C + h * D + e] = dqv[e] * scale;
    ast[idx] = mx;
    ast[P * H + idx] = sum;
    ast[2 * P * H + idx] = sd;
  }
  __syncwarp();
  // pass 2: one (key j, head h) per lane -> dk, dv
#pragma unroll 1
  for (int idx = lane; idx < P * H; idx += 32) {
    const int j = idx / H, h = idx % H;
    float kv[D], vv[D], dkv[D], dvv[D];
#pragma unroll
    for (int e = 0; e < D; ++e) {
      kv[e] = k[j * C + h * D + e];
      vv[e] = v[j * C + h * D + e];
      dkv[e] = 0.f;
      dvv[e] = 0.f;
    }
#pragma unroll 1
    for (int p = 0; p < P; ++p) {
      const int r = p * H + h;
      float s = 0.f, dd = 0.f;
#pragma unroll
      for (int e = 0; e < D; ++e) {
        s = fmaf(q[p * C + h * D + e], kv[e], s);
        dd = fmaf(dctx[p * C + h * D + e], vv[e], dd);
      }
      const float a = expf(s * scale - ast[r]) / ast[P * H + r];
      const float dl = a * (dd - ast[2 * P * H + r]);
#pragma unroll
      for (int e = 0; e < D; ++e) {
        dkv[e] = fmaf(dl, q[p * C + h * D + e], dkv[e]);
        dvv[e] = fmaf(a, dctx[p * C + h * D + e], dvv[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < D; ++e) {
      dk[j * C + h * D + e] = dkv[e] * scale;
      dv[j * C + h * D + e] = dvv[e];
    }
  }
}

template <int C, int D>
__host__ __device__ constexpr int per_warp_floats(int blocks) {
  // (L+1) checkpoints, 10 buffers of (P, C), 2 of (P, 2C), attention stats
  return ((blocks + 1 + 14) * P * C + 3 * P * (C / D) + 3) & ~3;
}

template <int C, int D>
__global__ void __launch_bounds__(MAX_WARPS * 32)
spatial_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gout,
                   const float* __restrict__ scales, const float* __restrict__ w,
                   float* __restrict__ dx, float* __restrict__ ddp, float* __restrict__ partial,
                   int frames, int blocks, int n_params) {
  using L = Layout<C>;
  constexpr int HID = L::HID;
  constexpr int S = P * C;
  static_assert(C <= 32 && C % 4 == 0 && C % D == 0, "lane = channel needs C <= 32");
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* ck = smem + (size_t)warp * per_warp_floats<C, D>(blocks);  // (L+1) x (P, C)
  float* Y = ck + (blocks + 1) * S;  // LN1 output
  float* Q = Y + S;
  float* K = Q + S;
  float* V = K + S;
  float* CTX = V + S;
  float* PROJ = CTX + S;  // proj branch before its scale
  float* X2 = PROJ + S;   // x + s1 * proj
  float* Z = X2 + S;      // LN2 output
  float* T = Z + S;       // scratch: fc2 branch, dz, dctx, dy
  float* DD = T + S;      // the gradient flowing down the residual stream
  float* H1 = DD + S;     // (P, 2C) fc1 pre-activation; later dv
  float* A = H1 + 2 * S;  // (P, 2C) gelu(h1), then dh1; later dq, dk
  float* AST = A + 2 * S;

  float* gw = partial + (size_t)(blockIdx.x * warps + warp) * n_params;
  for (int i = lane; i < n_params; i += 32) gw[i] = 0.f;
  __syncwarp();
  const float scale = 1.f / sqrtf((float)D);
  const float* norm = w + L::BLOCKS + blocks * L::BLOCK;
  float* gnorm = gw + L::BLOCKS + blocks * L::BLOCK;

  // the block's forward up to gelu(h1), from its input x0
  auto block_front = [&](int blk, const float* x0, float s1) {
    const float* bw = w + L::BLOCKS + blk * L::BLOCK;
    sp::layer_norm<C>(x0, Y, bw + L::LN1_G, bw + L::LN1_B, 1e-5f, lane);
    __syncwarp();
    sp::dense<C, C, 0>(Y, bw + L::WQ, bw + L::BQ, Q, lane);
    sp::dense<C, C, 0>(Y, bw + L::WK, bw + L::BK, K, lane);
    sp::dense<C, C, 0>(Y, bw + L::WV, bw + L::BV, V, lane);
    __syncwarp();
    sp::attention<C, D>(Q, K, V, CTX, scale, lane);
    __syncwarp();
    sp::dense<C, C, 0>(CTX, bw + L::WP, bw + L::BP, PROJ, lane);
    __syncwarp();
    if (lane < C)
      for (int p = 0; p < P; ++p) X2[p * C + lane] = x0[p * C + lane] + PROJ[p * C + lane] * s1;
    __syncwarp();
    sp::layer_norm<C>(X2, Z, bw + L::LN2_G, bw + L::LN2_B, 1e-5f, lane);
    __syncwarp();
    sp::dense<C, HID, 0>(Z, bw + L::W1, bw + L::B1, H1, lane);
    __syncwarp();
    for (int i = lane; i < P * HID; i += 32) A[i] = sp::gelu(H1[i]);
    __syncwarp();
  };

  for (int f = blockIdx.x * warps + warp; f < frames; f += gridDim.x * warps) {
    const float* xin = x + (size_t)f * P * 2;
    // ---- forward replay, checkpointing each block's input ----------------
    if (lane < C) {
      const float we0 = w[L::EMB_W + lane], we1 = w[L::EMB_W + C + lane];
      const float be = w[L::EMB_B + lane];
      for (int p = 0; p < P; ++p)
        ck[p * C + lane] = fmaf(xin[2 * p], we0, fmaf(xin[2 * p + 1], we1, 0.f)) + be
                           + w[L::PE + p * C + lane];
    }
    __syncwarp();
    for (int blk = 0; blk < blocks; ++blk) {
      const float* bw = w + L::BLOCKS + blk * L::BLOCK;
      const float s1 = scales[(size_t)(2 * blk) * frames + f];
      const float s2 = scales[(size_t)(2 * blk + 1) * frames + f];
      block_front(blk, ck + blk * S, s1);
      float* nxt = ck + (blk + 1) * S;
      if (lane < C)
        for (int p = 0; p < P; ++p) nxt[p * C + lane] = X2[p * C + lane];
      __syncwarp();
      sp::dense<HID, C, 2>(A, bw + L::W2, bw + L::B2, nxt, lane, s2);
      __syncwarp();
    }

    // ---- final LayerNorm (eps 1e-6) ---------------------------------------
    ln_bwd<C, 0>(ck + blocks * S, gout + (size_t)f * S, norm, 1e-6f, DD, gnorm, gnorm + C,
                 lane);
    __syncwarp();

    // ---- blocks, last to first --------------------------------------------
    for (int blk = blocks - 1; blk >= 0; --blk) {
      const float* bw = w + L::BLOCKS + blk * L::BLOCK;
      float* gb = gw + L::BLOCKS + blk * L::BLOCK;
      const float s1 = scales[(size_t)(2 * blk) * frames + f];
      const float s2 = scales[(size_t)(2 * blk + 1) * frames + f];
      const float* x0 = ck + blk * S;
      block_front(blk, x0, s1);

      // MLP branch: out = x2 + s2 * (gelu(h1) . W2 + b2)
      sp::dense<HID, C, 0>(A, bw + L::W2, bw + L::B2, T, lane);
      __syncwarp();
      float part = 0.f;
      if (lane < C)
        for (int p = 0; p < P; ++p) part = fmaf(DD[p * C + lane], T[p * C + lane], part);
      part = warp_sum(part);
      if (lane == 0) ddp[(size_t)(2 * blk + 1) * frames + f] = part;
      dense_dw<HID, C>(A, DD, s2, gb + L::W2, lane);
      bias_grad<C>(DD, s2, gb + L::B2, lane);
      __syncwarp();
      dense_t<HID, C, 0>(DD, bw + L::W2, s2, A, lane);  // d gelu(h1)
      __syncwarp();
      for (int i = lane; i < P * HID; i += 32) {
        const float h = H1[i];
        const float phi = 0.5f * (1.f + erff(h * 0.70710678118654752f));
        A[i] *= phi + h * 0.39894228040143268f * expf(-0.5f * h * h);  // dh1
      }
      __syncwarp();
      dense_dw<C, HID>(Z, A, 1.f, gb + L::W1, lane);
      bias_grad<HID>(A, 1.f, gb + L::B1, lane);
      dense_t<C, HID, 0>(A, bw + L::W1, 1.f, T, lane);  // dz
      __syncwarp();
      ln_bwd<C, 2>(X2, T, bw + L::LN2_G, 1e-5f, DD, gb + L::LN2_G, gb + L::LN2_B, lane);
      __syncwarp();

      // attention branch: x2 = x0 + s1 * (ctx . Wp + bp)
      part = 0.f;
      if (lane < C)
        for (int p = 0; p < P; ++p) part = fmaf(DD[p * C + lane], PROJ[p * C + lane], part);
      part = warp_sum(part);
      if (lane == 0) ddp[(size_t)(2 * blk) * frames + f] = part;
      dense_dw<C, C>(CTX, DD, s1, gb + L::WP, lane);
      bias_grad<C>(DD, s1, gb + L::BP, lane);
      dense_t<C, C, 0>(DD, bw + L::WP, s1, T, lane);  // dctx
      __syncwarp();
      float* dQ = A;
      float* dK = A + S;
      float* dV = H1;
      attention_bwd<C, D>(Q, K, V, T, dQ, dK, dV, AST, scale, lane);
      __syncwarp();
      dense_dw<C, C>(Y, dQ, 1.f, gb + L::WQ, lane);
      bias_grad<C>(dQ, 1.f, gb + L::BQ, lane);
      dense_dw<C, C>(Y, dK, 1.f, gb + L::WK, lane);
      bias_grad<C>(dK, 1.f, gb + L::BK, lane);
      dense_dw<C, C>(Y, dV, 1.f, gb + L::WV, lane);
      bias_grad<C>(dV, 1.f, gb + L::BV, lane);
      dense_t<C, C, 0>(dQ, bw + L::WQ, 1.f, T, lane);  // dy
      dense_t<C, C, 2>(dK, bw + L::WK, 1.f, T, lane);
      dense_t<C, C, 2>(dV, bw + L::WV, 1.f, T, lane);
      __syncwarp();
      ln_bwd<C, 2>(x0, T, bw + L::LN1_G, 1e-5f, DD, gb + L::LN1_G, gb + L::LN1_B, lane);
      __syncwarp();
    }

    // ---- embedding + PE ------------------------------------------------------
    if (lane < C) {
      float sb = 0.f, sw0 = 0.f, sw1 = 0.f;
      for (int p = 0; p < P; ++p) {
        const float d = DD[p * C + lane];
        gw[L::PE + p * C + lane] += d;
        sb += d;
        sw0 = fmaf(xin[2 * p], d, sw0);
        sw1 = fmaf(xin[2 * p + 1], d, sw1);
      }
      gw[L::EMB_B + lane] += sb;
      gw[L::EMB_W + lane] += sw0;
      gw[L::EMB_W + C + lane] += sw1;
    }
    const float we0 = lane < C ? w[L::EMB_W + lane] : 0.f;
    const float we1 = lane < C ? w[L::EMB_W + C + lane] : 0.f;
#pragma unroll 1
    for (int p = 0; p < P; ++p) {
      const float d = lane < C ? DD[p * C + lane] : 0.f;
      const float d0 = warp_sum(d * we0), d1 = warp_sum(d * we1);
      if (lane == 0) {
        dx[(size_t)f * P * 2 + 2 * p] = d0;
        dx[(size_t)f * P * 2 + 2 * p + 1] = d1;
      }
    }
    __syncwarp();
  }
}

template <int C, int D>
cudaError_t config(int blocks, int* warps, int* grid, size_t* smem) {
  const size_t per_warp = sizeof(float) * per_warp_floats<C, D>(blocks);
  int dev = 0, optin = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (per_warp > (size_t)optin) return cudaErrorInvalidValue;
  int n = (int)(optin / per_warp);
  *warps = n < MAX_WARPS ? n : MAX_WARPS;
  *grid = sms;
  *smem = *warps * per_warp;
  return cudaSuccess;
}

template <int C, int D>
cudaError_t launch(const float* x, const float* g, const float* scales, const float* params,
                   float* dx, float* ddp, float* partial, int frames, int blocks, int workers,
                   cudaStream_t stream) {
  int warps = 0, grid = 0;
  size_t smem = 0;
  cudaError_t err = config<C, D>(blocks, &warps, &grid, &smem);
  if (err != cudaSuccess) return err;
  if (workers != warps * grid) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(spatial_bwd_kernel<C, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  spatial_bwd_kernel<C, D><<<grid, warps * 32, smem, stream>>>(
      x, g, scales, params, dx, ddp, partial, frames, blocks, Layout<C>::params(blocks));
  return cudaGetLastError();
}

}  // namespace

// Rows of the per-warp gradient buffer spatial_bwd_f32 needs (warps x SMs),
// or a negative CUDA error. Launches nothing.
extern "C" int spatial_bwd_workers(int c, int depth, int blocks) {
  int warps = 0, grid = 0;
  size_t smem = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (depth == 4 && blocks >= 0 && c == 32) err = config<32, 4>(blocks, &warps, &grid, &smem);
  if (depth == 4 && blocks >= 0 && c == 16) err = config<16, 4>(blocks, &warps, &grid, &smem);
  return err == cudaSuccess ? warps * grid : -(int)err;
}

// x (frames, 17, 2), g (frames, 17*c), scales (2*blocks, frames), params packed;
// out: dx (frames, 17, 2), ddp (2*blocks, frames), partial (workers, n_params).
extern "C" int spatial_bwd_f32(const float* x, const float* g, const float* scales,
                               const float* params, float* dx, float* ddp, float* partial,
                               int frames, int c, int depth, int blocks, int workers,
                               void* stream) {
  if (frames <= 0 || blocks < 0 || depth != 4) return cudaErrorInvalidValue;
  if (c == 32)
    return launch<32, 4>(x, g, scales, params, dx, ddp, partial, frames, blocks, workers,
                         (cudaStream_t)stream);
  if (c == 16)
    return launch<16, 4>(x, g, scales, params, dx, ddp, partial, frames, blocks, workers,
                         (cudaStream_t)stream);
  return cudaErrorInvalidValue;
}

// out[c] = sum over r (in order) of part[r, c].
extern "C" int sum_rows_f32(const float* part, float* out, int rows, int cols, void* stream) {
  return uu::launch_sum_rows(part, out, rows, cols, (cudaStream_t)stream);
}
