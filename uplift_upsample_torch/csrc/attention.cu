// Row 11 — packed multi-head attention on (F, S, H·D) q, k and v.
//
// Replaces: uplift_upsample_tpu/ops/pallas_attention.py
//   packed_multihead_attention (:75, pallas_call at :113):
//   softmax(q kᵀ / sqrt(D) + mask · -1e9) v per head, on the packed
//   (F, S, H·D) tensors the q/k/v projections produce (no head-split
//   transpose), with an optional (F, S) key mask (1 = blocked), S <= 128. The
//   model calls it in every attention layer when USE_PALLAS_ATTENTION is set.
//
// What bounds it here: bytes. A call reads q, k, v (and the mask) once and
// writes the context once; its 4·S²·C FLOPs per sequence take less time than
// those bytes at every h36m_351 shape (17 joints x 32 channels in the spatial
// blocks, 71, 23 and 3 frames x 384 in the temporal and strided blocks).
//
// Design, two regimes:
//  - Short sequences (S·C <= 1,536 floats: the spatial blocks' 17 x 32, the
//    last strided block's 3 x 384). A call holds up to ~580 k tiny (frame,
//    head) problems, so one thread block per problem would spend its time
//    starting warps. Here a warp owns a whole sequence: it stages the keys and
//    values in its slice of shared memory with coalesced loads, and each lane
//    takes (query, head) tasks, consecutive lanes on consecutive D-wide
//    slices of q and of the output (coalesced). A task runs a max pass and an
//    exp-sum pass over the staged keys (the plain softmax, without an online
//    rescale) and keeps its D-wide context in registers (D a template
//    parameter, <= 64). Eight warps per block, grid-stride over sequences.
//  - Longer sequences (71 and 23 frames x 384): K2's window-attention kernel
//    (attention.cuh), one block per (sequence, head) on the tensor cores in
//    3xTF32, reading the three tensors with row stride C.

#include <cuda_runtime.h>
#include <math.h>

#include "attention.cuh"

namespace {

constexpr int FRAME_WARPS = 8;
constexpr int FRAME_MAX_FLOATS = 1536;  // S·C of the short-sequence regime

template <int D>
__global__ void __launch_bounds__(FRAME_WARPS * 32)
frame_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ key_mask,
                       float* __restrict__ out, int frames, int s, int c, float scale) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int heads = c / D;
  const int sc = s * c;
  float* ks = sm + (size_t)warp * (2 * sc + s);  // s x c keys
  float* vs = ks + sc;                           // s x c values
  float* mk = vs + sc;                           // s additive key mask
  const int tasks = s * heads;
  for (int f = blockIdx.x * FRAME_WARPS + warp; f < frames; f += gridDim.x * FRAME_WARPS) {
    const size_t base = (size_t)f * sc;
    for (int e = lane; e < sc; e += 32) {
      ks[e] = k[base + e];
      vs[e] = v[base + e];
    }
    for (int j = lane; j < s; j += 32)
      mk[j] = key_mask ? key_mask[(size_t)f * s + j] * -1e9f : 0.f;
    __syncwarp();
    // task t = (query i, head h) reads q and writes out at base + t·D
    for (int t = lane; t < tasks; t += 32) {
      const int h = t % heads;
      const float* qp = q + base + (size_t)t * D;
      float qr[D];
#pragma unroll
      for (int e = 0; e < D; ++e) qr[e] = qp[e];
      const float* kh = ks + h * D;
      const float* vh = vs + h * D;
      float mx = -INFINITY;
      for (int j = 0; j < s; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < D; ++e) dot = fmaf(qr[e], kh[j * c + e], dot);
        mx = fmaxf(mx, dot * scale + mk[j]);
      }
      float acc[D];
#pragma unroll
      for (int e = 0; e < D; ++e) acc[e] = 0.f;
      float sum = 0.f;
      for (int j = 0; j < s; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < D; ++e) dot = fmaf(qr[e], kh[j * c + e], dot);
        const float p = expf(dot * scale + mk[j] - mx);
        sum += p;
#pragma unroll
        for (int e = 0; e < D; ++e) acc[e] = fmaf(p, vh[j * c + e], acc[e]);
      }
      float* op = out + base + (size_t)t * D;
#pragma unroll
      for (int e = 0; e < D; ++e) op[e] = acc[e] / sum;
    }
    __syncwarp();
  }
}

template <int D>
cudaError_t launch_frame_attention(const float* q, const float* k, const float* v,
                                   const float* key_mask, float* out, int frames, int s, int c,
                                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * FRAME_WARPS * (2 * (size_t)s * c + s);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        frame_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (frames + FRAME_WARPS - 1) / FRAME_WARPS;
  frame_attention_kernel<D><<<blocks, FRAME_WARPS * 32, smem, stream>>>(
      q, k, v, key_mask, out, frames, s, c, 1.f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

extern "C" int packed_attention_f32(const float* q, const float* k, const float* v,
                                    const float* key_mask, float* out, int frames, int s,
                                    int c, int heads, void* stream) {
  if (frames <= 0 || s <= 0 || s > 128 || heads <= 0 || c % heads != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (s * c <= FRAME_MAX_FLOATS) {
    switch (c / heads) {
      case 4: return launch_frame_attention<4>(q, k, v, key_mask, out, frames, s, c, st);
      case 8: return launch_frame_attention<8>(q, k, v, key_mask, out, frames, s, c, st);
      case 16: return launch_frame_attention<16>(q, k, v, key_mask, out, frames, s, c, st);
      case 32: return launch_frame_attention<32>(q, k, v, key_mask, out, frames, s, c, st);
      case 48: return launch_frame_attention<48>(q, k, v, key_mask, out, frames, s, c, st);
      case 64: return launch_frame_attention<64>(q, k, v, key_mask, out, frames, s, c, st);
      default: break;  // other head depths take the per-(sequence, head) kernel
    }
  }
  return uu::launch_head_attention(q, k, v, c, key_mask, out, frames, s, c, heads, st);
}
