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
// What bounds it: operations. Per frame at C = 32 the dense layers take
// 1.11 MFLOP, run in 3xTF32 on the tensor cores (three TF32 products each);
// the attention and the embedding 0.15 MFLOP in fp32 on the CUDA cores; the
// input is 136 bytes and the output 2,176. At h36m_351's 72,704 frames:
// 0.49 ms of products at 495 TFLOP/s, 0.16 ms at 67 TFLOP/s, 0.05 ms of bytes.
//
// Design (Hopper; spatial_common.cuh holds the routines K4 runs too): tiles
// of TF = 7 frames, 119 token rows padded to 128, one m16 tile of rows per
// warp; a group of 8 warps takes a tile through the whole stack.
//  - Every dense product runs on mma.sync.m16n8k8 in 3xTF32 with M = the
//    warp's 16 rows (rows_gemm); with K = 32 or 64 each output keeps one
//    running sum in the tensor cores (tests/test_torch_spatial_tc.py holds
//    its emulation to the float64 criterion).
//  - No checkpoints: a tile is x (128 x C, pitch C+4) and q|k|v (128 x 3C,
//    pitch 3C+4), 68 KB at C = 32. LN1 and LN2 are normalised as the
//    products load A (each row's mean and 1/std in shared memory, two lanes
//    per row); the context is written over q, fc1's gelu over q|k|v.
//  - Only the attention crosses warps (a frame's 17 rows span two m16
//    tiles): two barriers of the group per block. The LayerNorms, products,
//    epilogues, the embedding and the output touch only the warp's own rows.
//  - The attention takes one thread per (frame, head, query), 952 items per
//    tile: q, k and v of a head one float4 per token, the 17 logits in
//    registers, the softmax in base 2.
//  - Weights: two tiles per thread block of 16 warps, one per group, share
//    one block's weights staged as TF32 halves (2 x 38 KB at C = 32),
//    restaged per block: the next block's loads are issued before the
//    barrier that waits for both groups (issued before the MLP instead, they
//    spill at the register cap); its LayerNorm affines and biases (11 C
//    floats) come along. 215 KB of shared memory, one block per SM, at most
//    128 registers a thread: ptxas reports 128 at C = 32 and 126 at C = 16,
//    no spills (they spilled while the LN affines and biases were read from
//    device memory). Keeping every block's fp32 weights resident instead
//    (4 x 38 KB, the B fragments split in registers) leaves room for one
//    tile, 8 warps per SM, and was slower on every shape (PERF.md).
//  - Padded rows (the 9 after 119, and the frames after F in the last tile)
//    start at 0 and carry a branch factor of 0, so they stay 0 and finite;
//    they are never stored. The branch factors are per row: the frame's
//    scale, or 1 without scales.
//  - A tile's input (7 x 34 floats) and output (7 x 17 x C floats) are
//    contiguous: a warp's loads cover 128 bytes, its float4 stores fill
//    whole 32-byte sectors.
//  - No atomics: a second call gives the same bits.
//
// Output rows are (F, 17*C), p-major: the (B, N, P*C) layout the s2t Dense
// reads, so no transpose follows.
//
// The bf16 rung (`spatial_stack_bf16`, the TPU's one-pass DEFAULT dots): the
// same kernel with BF16, the staged weights rounded to bf16 instead of split,
// every dense product's A rounded as it is read, one TF32 product per pair
// (spatial_common.cuh); the embedding's two operands rounded on the CUDA
// cores; the 17-token attention, the LayerNorms and the gelu stay fp32, as
// the TPU computes its attention on the vector unit. Bound at 72,704 frames:
// the dense products at the 989 TFLOP/s dense bf16 peak, 0.033 ms, under
// the CUDA cores' 0.16 ms.

#include <cuda_runtime.h>
#include <math.h>

#include "spatial_common.cuh"

namespace {

using sp::Layout;
using sp::P;
using sp::R;
using sp::TF;
using sp::THREADS;

constexpr int GROUPS = 2;  // tiles, each an 8-warp group, per thread block

template <int C>
struct Smem {
  using T = sp::Pitch<C>;
  // a block's vectors: ln1_g, ln1_b, bq|bk|bv, bp, ln2_g, ln2_b, b1, b2
  static constexpr int LN1_G = 0, LN1_B = C, BQKV = 2 * C, BP = 5 * C, LN2_G = 6 * C,
                       LN2_B = 7 * C, B1 = 8 * C, B2 = 10 * C, VEC = 11 * C;
  // per group: x, q|k|v, then per row mu, rs and the two branch factors
  static constexpr int GROUP = R * T::PC + R * T::P3 + 4 * R;
  static constexpr size_t BYTES = sizeof(float) * (2 * T::WEIGHTS + VEC + GROUPS * GROUP);
};

// Where element i of Smem's vectors sits in a block's packed parameters.
template <int C>
__device__ __forceinline__ int vec_src(int i) {
  using L = Layout<C>;
  const int field = i / C, c = i % C;
  return c + (field == 0   ? L::LN1_G
              : field == 1 ? L::LN1_B
              : field == 2 ? L::BQ
              : field == 3 ? L::BK
              : field == 4 ? L::BV
              : field == 5 ? L::BP
              : field == 6 ? L::LN2_G
              : field == 7 ? L::LN2_B
              : field < 10 ? L::B1 + (field - 8) * C
                           : L::B2);
}

template <int C, bool BF16>
__global__ void __launch_bounds__(GROUPS * THREADS, 1)
spatial_stack_tc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ scales, float* __restrict__ out, int frames,
                        int blocks) {
  using L = Layout<C>;
  using T = sp::Pitch<C>;
  using S = Smem<C>;
  constexpr int PC = T::PC, P3 = T::P3, NT = GROUPS * THREADS;
  static_assert(S::VEC <= NT, "one vector element a thread");
  static_assert(C % 16 == 0 && C <= 32, "C = 16 or 32: m16 tiles of C, two lanes a row");
  extern __shared__ float4 k1_smem[];
  float* W = reinterpret_cast<float*>(k1_smem);  // the staged weights
  float* V = W + 2 * T::WEIGHTS;  // the staged vectors
  const int group = threadIdx.x / THREADS;
  float* X = V + S::VEC + group * S::GROUP;
  float* QKV = X + R * PC;  // q|k|v; the context over q; fc1's gelu over q|k|v
  float* mu = QKV + R * P3;
  float* rs = mu + R;
  float* fac = rs + R;  // the branch factors: s1 at fac[r], s2 at fac[R + r]
  const int lane = threadIdx.x % 32;
  const float scale = 0.5f;  // 1 / sqrt(D), D = 4
  const float* norm = w + L::BLOCKS + blocks * L::BLOCK;
  auto group_sync = [&]() {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(THREADS) : "memory");
  };

  const int tiles = (frames + TF - 1) / TF;
  for (int base = blockIdx.x * GROUPS; base < tiles; base += gridDim.x * GROUPS) {
    const int tile = base + group, f0 = tile * TF;
    const int nf = tile < tiles ? min(TF, frames - f0) : 0, real = nf * P;
    const int r = sp::ln_row();  // this lane's row of the LayerNorms and the embedding
    if (nf > 0) {  // embedding + PE (0 on padded rows)
      const float* xr = x + ((size_t)f0 * P + r) * 2;  // any float offset: two loads
      // BF16: the embedding's operands rounded (its products exact, one rounding)
      const auto op = [](float v) { return BF16 ? uu::bf16_roundf(v) : v; };
      const float x0 = r < real ? op(xr[0]) : 0.f, x1 = r < real ? op(xr[1]) : 0.f;
      const float* pe = w + L::PE + (r % P) * C;
#pragma unroll
      for (int i = 0; i < C / 8; ++i) {
        const int c = sp::ln_col(i);
        float e[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          e[u] = r < real ? fmaf(x0, op(w[L::EMB_W + c + u]),
                                 fmaf(x1, op(w[L::EMB_W + C + c + u]), 0.f))
                                + w[L::EMB_B + c + u] + pe[c + u]
                          : 0.f;
        *reinterpret_cast<float4*>(X + r * PC + c) = make_float4(e[0], e[1], e[2], e[3]);
      }
    }
    for (int blk = 0; blk < blocks; ++blk) {
      const float* bw = w + L::BLOCKS + blk * L::BLOCK;
      {  // stage this block's weights and vectors for both groups
        sp::BlockWeights<C, NT> bwts;
        bwts.load(bw, threadIdx.x);  // in flight while the barrier waits
        const float vec = threadIdx.x < S::VEC ? bw[vec_src<C>(threadIdx.x)] : 0.f;
        __syncthreads();             // both groups done with the last block's weights
        bwts.template store<BF16>(W);
        if (threadIdx.x < S::VEC) V[threadIdx.x] = vec;
        __syncthreads();
      }
      if (nf == 0) continue;
      {  // the branch factors of the warp's rows: lanes 0-15 s1, 16-31 s2
        const int branch = lane / 16;
        float s = 0.f;
        if (r < real)
          s = scales ? scales[(size_t)(2 * blk + branch) * frames + f0 + r / P] : 1.f;
        fac[branch * R + r] = s;
      }
      const auto b_at = [&](int off, int pitch) {
        return [=](int k, int n) { return W + off + k * pitch + n; };
      };
      const auto ln_at = [&](int gamma, int beta) {
        return [=](int row, int k) {
          return (X[row * PC + k] - mu[row]) * rs[row] * V[gamma + k] + V[beta + k];
        };
      };
      const auto qkv_at = [&](int row, int k) { return QKV[row * P3 + k]; };
      sp::ln_stats<C>(X, mu, rs, 1e-5f);
      __syncwarp();
      // rows_gemm<K, N, false>: one running sum per output (K <= 64)
      sp::rows_gemm<C, 3 * C, false, BF16>(
          ln_at(S::LN1_G, S::LN1_B), b_at(0, T::W3), T::WEIGHTS,
          [&](int row, int n, float v) {
            QKV[row * P3 + n] = v + V[S::BQKV + n];
            return 0.f;
          },
          nullptr);
      group_sync();
      sp::attention_fwd<C>(QKV, QKV, P3, nf, scale);
      group_sync();
      sp::rows_gemm<C, C, false, BF16>(qkv_at, b_at(T::OFF_WP, T::WC), T::WEIGHTS,
                                 [&](int row, int n, float v) {
                                   X[row * PC + n] += fac[row] * (v + V[S::BP + n]);
                                   return 0.f;
                                 },
                                 nullptr);
      __syncwarp();
      sp::ln_stats<C>(X, mu, rs, 1e-5f);
      __syncwarp();
      sp::rows_gemm<C, 2 * C, false, BF16>(ln_at(S::LN2_G, S::LN2_B), b_at(T::OFF_W1, T::WH),
                                     T::WEIGHTS,
                                     [&](int row, int n, float v) {
                                       QKV[row * P3 + n] = sp::gelu(v + V[S::B1 + n]);
                                       return 0.f;
                                     },
                                     nullptr);
      __syncwarp();
      sp::rows_gemm<2 * C, C, false, BF16>(qkv_at, b_at(T::OFF_W2, T::WC), T::WEIGHTS,
                                     [&](int row, int n, float v) {
                                       X[row * PC + n] += fac[R + row] * (v + V[S::B2 + n]);
                                       return 0.f;
                                     },
                                     nullptr);
      __syncwarp();
    }
    if (nf > 0) {  // the final LayerNorm (eps 1e-6), stored from registers
      float v[C / 2], m, inv;
      sp::ln_load<C>(X, v);
      sp::ln_row_stats<C>(v, 1e-6f, &m, &inv);
      if (r < real) {
        float* o = out + ((size_t)f0 * P + r) * C;
#pragma unroll
        for (int i = 0; i < C / 8; ++i) {
          const int c = sp::ln_col(i);
          float e[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            e[u] = (v[4 * i + u] - m) * inv * norm[c + u] + norm[C + c + u];
          *reinterpret_cast<float4*>(o + c) = make_float4(e[0], e[1], e[2], e[3]);
        }
      }
    }
  }
}

template <int C, bool BF16>
cudaError_t launch(const float* x, const float* params, const float* scales, float* out,
                   int frames, int blocks, cudaStream_t stream) {
  const size_t smem = Smem<C>::BYTES;
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(spatial_stack_tc_kernel<C, BF16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (frames + TF - 1) / TF;
  const int units = (tiles + GROUPS - 1) / GROUPS;  // a thread block's tiles at a time
  const int grid = units < sms ? units : sms;
  spatial_stack_tc_kernel<C, BF16><<<grid, GROUPS * THREADS, smem, stream>>>(
      x, params, scales, out, frames, blocks);
  return cudaGetLastError();
}

template <bool BF16>
int stack(const float* x, const float* params, const float* scales, float* out, int frames,
          int c, int depth, int blocks, void* stream) {
  if (frames <= 0 || blocks < 0 || depth != 4) return cudaErrorInvalidValue;
  if (c == 32)
    return launch<32, BF16>(x, params, scales, out, frames, blocks, (cudaStream_t)stream);
  if (c == 16)
    return launch<16, BF16>(x, params, scales, out, frames, blocks, (cudaStream_t)stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (frames, 17, 2); out: (frames, 17 * c). c = 32 or 16, head depth 4.
// scales: (2 * blocks, frames) stochastic-depth factors, or null (eval).
extern "C" int spatial_stack_f32(const float* x, const float* params, const float* scales,
                                 float* out, int frames, int c, int depth, int blocks,
                                 void* stream) {
  return stack<false>(x, params, scales, out, frames, c, depth, blocks, stream);
}

// The bf16 rung: the same operands, the products on bf16-rounded operands.
extern "C" int spatial_stack_bf16(const float* x, const float* params, const float* scales,
                                  float* out, int frames, int c, int depth, int blocks,
                                  void* stream) {
  return stack<true>(x, params, scales, out, frames, c, depth, blocks, stream);
}
