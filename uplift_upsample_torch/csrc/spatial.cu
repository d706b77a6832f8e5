// K1 — the fused spatial transformer stack, one kernel.
//
// Replaces: uplift_upsample_tpu/ops/pallas_spatial.py fused_spatial_stack
//   (kernel _make_kernel, entry spatial_stack_apply): keypoint embedding
//   2 -> C plus the spatial PE, then `blocks` pre-norm blocks over 17 joint
//   tokens (LN 1e-5, q/k/v C -> C, heads of depth D, proj, residual, LN,
//   fc1 C -> 2C with the exact erf gelu, fc2, residual), then LayerNorm 1e-6.
//   The TPU kernel uses an approximate erf (pallas_spatial.py:35-47); this
//   one uses erff, the model's exact gelu.
//
// What bounds it here: ~90 GFLOP against ~5 MB of input and ~150 MB of
// output at h36m_351's 72,704 frames, so fp32 operations bound it. Design:
// one warp per frame, lane = channel. A frame's activations (17 x 32 floats
// per tensor) live in the warp's slice of shared memory; all weights of the
// stack (~35 K floats, 140 KB at C=32) are staged once per thread block in
// dynamic shared memory, and the grid is one persistent block per SM that
// walks over the frames, so the weights are read from device memory once per
// SM. A dense layer keeps the lane's weight column in registers and reads
// the activations as float4 broadcasts. Attention runs one (query, head)
// pair per lane with the 17 logits in registers.
//
// Output rows are (F, 17*C), p-major: the (B, N, P*C) layout the s2t Dense
// reads, so no transpose follows.
//
// Packed parameter buffer (float32, this order): emb_w (2, C), emb_b (C),
// pe (17, C); per block: ln1_g, ln1_b, wq (C, C), bq, wk, bk, wv, bv, wp, bp,
// ln2_g, ln2_b, w1 (C, 2C), b1 (2C), w2 (2C, C), b2; then norm_g, norm_b.
// Every matrix is (in, out) row-major, the flax Dense layout.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int P = 17;           // joint tokens
constexpr int MAX_WARPS = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int C>
struct Layout {
  static constexpr int HID = 2 * C;
  static constexpr int EMB_W = 0, EMB_B = 2 * C, PE = 3 * C, BLOCKS = PE + P * C;
  static constexpr int LN1_G = 0, LN1_B = C, WQ = 2 * C, BQ = WQ + C * C;
  static constexpr int WK = BQ + C, BK = WK + C * C, WV = BK + C, BV = WV + C * C;
  static constexpr int WP = BV + C, BP = WP + C * C, LN2_G = BP + C, LN2_B = LN2_G + C;
  static constexpr int W1 = LN2_B + C, B1 = W1 + C * HID, W2 = B1 + HID, B2 = W2 + HID * C;
  static constexpr int BLOCK = B2 + C;
  static int params(int blocks) { return BLOCKS + blocks * BLOCK + 2 * C; }
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

// MODE 0: out = in.W + b; 1: out = gelu(in.W + b); 2: out += in.W + b.
template <int CIN, int COUT, int MODE>
__device__ __forceinline__ void dense(const float* in, const float* w, const float* b,
                                      float* out, int lane) {
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
        if (MODE == 1) acc = 0.5f * acc * (1.f + erff(acc * 0.70710678118654752f));
        if (MODE == 2)
          out[p * COUT + o] += acc;
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

template <int C, int D>
__global__ void __launch_bounds__(MAX_WARPS * 32)
spatial_stack_kernel(const float* __restrict__ x, const float* __restrict__ params,
                     float* __restrict__ out, int frames, int blocks, int n_params) {
  using L = Layout<C>;
  constexpr int HID = L::HID;
  static_assert(C <= 32 && C % 4 == 0 && C % D == 0, "lane = channel needs C <= 32");
  extern __shared__ __align__(16) float smem[];
  float* w = smem;
  for (int i = threadIdx.x; i < n_params; i += blockDim.x) w[i] = params[i];
  __syncthreads();

  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* xs = smem + ((n_params + 3) & ~3) + warp * 5 * P * C;
  float* ys = xs + P * C;  // LN output, then attention context
  float* qs = ys + P * C;
  float* ks = qs + P * C;
  float* vs = ks + P * C;
  float* hs = qs;          // (P, 2C) fc1 output, over q/k/v once attention is done
  const float scale = 1.f / sqrtf((float)D);
  const float* norm = w + L::BLOCKS + blocks * L::BLOCK;

  for (int f = blockIdx.x * warps + warp; f < frames; f += gridDim.x * warps) {
    const float* xin = x + (size_t)f * P * 2;
    if (lane < C) {
      const float we0 = w[L::EMB_W + lane], we1 = w[L::EMB_W + C + lane];
      const float be = w[L::EMB_B + lane];
      for (int p = 0; p < P; ++p)
        xs[p * C + lane] = fmaf(xin[2 * p], we0, fmaf(xin[2 * p + 1], we1, 0.f)) + be
                           + w[L::PE + p * C + lane];
    }
    __syncwarp();
    for (int blk = 0; blk < blocks; ++blk) {
      const float* bw = w + L::BLOCKS + blk * L::BLOCK;
      layer_norm<C>(xs, ys, bw + L::LN1_G, bw + L::LN1_B, 1e-5f, lane);
      __syncwarp();
      dense<C, C, 0>(ys, bw + L::WQ, bw + L::BQ, qs, lane);
      dense<C, C, 0>(ys, bw + L::WK, bw + L::BK, ks, lane);
      dense<C, C, 0>(ys, bw + L::WV, bw + L::BV, vs, lane);
      __syncwarp();
      attention<C, D>(qs, ks, vs, ys, scale, lane);
      __syncwarp();
      dense<C, C, 2>(ys, bw + L::WP, bw + L::BP, xs, lane);
      __syncwarp();
      layer_norm<C>(xs, ys, bw + L::LN2_G, bw + L::LN2_B, 1e-5f, lane);
      __syncwarp();
      dense<C, HID, 1>(ys, bw + L::W1, bw + L::B1, hs, lane);
      __syncwarp();
      dense<HID, C, 2>(hs, bw + L::W2, bw + L::B2, xs, lane);
      __syncwarp();
    }
    layer_norm<C>(xs, ys, norm, norm + C, 1e-6f, lane);
    __syncwarp();
    if (lane < C) {
      float* o = out + (size_t)f * P * C;
      for (int p = 0; p < P; ++p) o[p * C + lane] = ys[p * C + lane];
    }
    __syncwarp();
  }
}

template <int C, int D>
cudaError_t launch(const float* x, const float* params, float* out, int frames,
                   int blocks, cudaStream_t stream) {
  const int n_params = Layout<C>::params(blocks);
  const size_t weights = sizeof(float) * ((n_params + 3) & ~3);
  const size_t per_warp = sizeof(float) * 5 * P * C;
  int dev = 0, optin = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (weights + per_warp > (size_t)optin) return cudaErrorInvalidValue;
  int warps = (int)((optin - weights) / per_warp);
  warps = warps < MAX_WARPS ? warps : MAX_WARPS;
  const size_t smem = weights + warps * per_warp;
  const cudaError_t err = cudaFuncSetAttribute(
      spatial_stack_kernel<C, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int wanted = (frames + warps - 1) / warps;
  const int grid = wanted < sms ? wanted : sms;
  spatial_stack_kernel<C, D><<<grid, warps * 32, smem, stream>>>(x, params, out, frames,
                                                                 blocks, n_params);
  return cudaGetLastError();
}

}  // namespace

// x: (frames, 17, 2); out: (frames, 17 * c). c = 32 or 16, head depth 4.
extern "C" int spatial_stack_f32(const float* x, const float* params, float* out,
                                 int frames, int c, int depth, int blocks, void* stream) {
  if (frames <= 0 || blocks < 0 || depth != 4) return cudaErrorInvalidValue;
  if (c == 32) return launch<32, 4>(x, params, out, frames, blocks, (cudaStream_t)stream);
  if (c == 16) return launch<16, 4>(x, params, out, frames, blocks, (cudaStream_t)stream);
  return cudaErrorInvalidValue;
}
