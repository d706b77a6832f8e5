// K1 — the fused spatial transformer stack, one kernel.
//
// Replaces: uplift_upsample_tpu/ops/pallas_spatial.py fused_spatial_stack
//   (kernel _make_kernel, entry spatial_stack_apply, and with droppath
//   scales the training forward fused_spatial_train): keypoint embedding
//   2 -> C plus the spatial PE, then `blocks` pre-norm blocks over 17 joint
//   tokens (LN 1e-5, q/k/v C -> C, heads of depth D, proj, residual, LN,
//   fc1 C -> 2C with the exact erf gelu, fc2, residual), then LayerNorm 1e-6.
//   The TPU kernel uses an approximate erf (pallas_spatial.py:35-47); this
//   one uses erff, the model's exact gelu. In training, block l's two
//   residual branches are multiplied per frame by the stochastic-depth scales
//   scales[2l, f] and scales[2l+1, f] (pallas_spatial.py:571-579); without
//   scales (eval) the factor is exactly 1.
//
// What bounds it here: ~90 GFLOP against ~5 MB of input and ~150 MB of
// output at h36m_351's 72,704 frames, so fp32 operations bound it. Design:
// one warp per frame, lane = channel (spatial_common.cuh). A frame's
// activations (17 x 32 floats per tensor) live in the warp's slice of shared
// memory; all weights of the stack (~35 K floats, 140 KB at C=32) are staged
// once per thread block in dynamic shared memory, and the grid is one
// persistent block per SM that walks over the frames, so the weights are read
// from device memory once per SM. A dense layer keeps the lane's weight
// column in registers and reads the activations as float4 broadcasts.
// Attention runs one (query, head) pair per lane with the 17 logits in
// registers.
//
// Output rows are (F, 17*C), p-major: the (B, N, P*C) layout the s2t Dense
// reads, so no transpose follows.

#include <cuda_runtime.h>
#include <math.h>

#include "spatial_common.cuh"

namespace {

using sp::P;
using sp::Layout;
constexpr int MAX_WARPS = 8;

template <int C, int D>
__global__ void __launch_bounds__(MAX_WARPS * 32)
spatial_stack_kernel(const float* __restrict__ x, const float* __restrict__ params,
                     const float* __restrict__ scales, float* __restrict__ out,
                     int frames, int blocks, int n_params) {
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
      const float s1 = scales ? scales[(size_t)(2 * blk) * frames + f] : 1.f;
      const float s2 = scales ? scales[(size_t)(2 * blk + 1) * frames + f] : 1.f;
      sp::layer_norm<C>(xs, ys, bw + L::LN1_G, bw + L::LN1_B, 1e-5f, lane);
      __syncwarp();
      sp::dense<C, C, 0>(ys, bw + L::WQ, bw + L::BQ, qs, lane);
      sp::dense<C, C, 0>(ys, bw + L::WK, bw + L::BK, ks, lane);
      sp::dense<C, C, 0>(ys, bw + L::WV, bw + L::BV, vs, lane);
      __syncwarp();
      sp::attention<C, D>(qs, ks, vs, ys, scale, lane);
      __syncwarp();
      sp::dense<C, C, 2>(ys, bw + L::WP, bw + L::BP, xs, lane, s1);
      __syncwarp();
      sp::layer_norm<C>(xs, ys, bw + L::LN2_G, bw + L::LN2_B, 1e-5f, lane);
      __syncwarp();
      sp::dense<C, HID, 1>(ys, bw + L::W1, bw + L::B1, hs, lane);
      __syncwarp();
      sp::dense<HID, C, 2>(hs, bw + L::W2, bw + L::B2, xs, lane, s2);
      __syncwarp();
    }
    sp::layer_norm<C>(xs, ys, norm, norm + C, 1e-6f, lane);
    __syncwarp();
    if (lane < C) {
      float* o = out + (size_t)f * P * C;
      for (int p = 0; p < P; ++p) o[p * C + lane] = ys[p * C + lane];
    }
    __syncwarp();
  }
}

template <int C, int D>
cudaError_t launch(const float* x, const float* params, const float* scales, float* out,
                   int frames, int blocks, cudaStream_t stream) {
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
  spatial_stack_kernel<C, D><<<grid, warps * 32, smem, stream>>>(x, params, scales, out,
                                                                 frames, blocks, n_params);
  return cudaGetLastError();
}

}  // namespace

// x: (frames, 17, 2); out: (frames, 17 * c). c = 32 or 16, head depth 4.
// scales: (2 * blocks, frames) stochastic-depth factors, or null (eval).
extern "C" int spatial_stack_f32(const float* x, const float* params, const float* scales,
                                 float* out, int frames, int c, int depth, int blocks,
                                 void* stream) {
  if (frames <= 0 || blocks < 0 || depth != 4) return cudaErrorInvalidValue;
  if (c == 32)
    return launch<32, 4>(x, params, scales, out, frames, blocks, (cudaStream_t)stream);
  if (c == 16)
    return launch<16, 4>(x, params, scales, out, frames, blocks, (cudaStream_t)stream);
  return cudaErrorInvalidValue;
}
