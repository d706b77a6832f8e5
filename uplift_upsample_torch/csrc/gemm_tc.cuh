// Tensor-core GEMMs at fp32-level error for Hopper: 3xTF32 (tf32.cuh), in
// two kernels. They carry every product of K2, K3, K5 and K6 outside the
// attention: the dense layers (forward, and the backward's dX and dW), the
// strided conv's three products (strided.cu, strided_bwd.cu: its taps
// gathered from h1 by the loaders, conv_taps.cuh) and the s2t prologue.
//
// 1. gemm_tc_kernel: out = epilogue(A · B), A (m, k) fp32 row-major, B the
//    two TF32 halves of an (n, k) K-major matrix in one (2, n, k) buffer
//    (`launch_tf32_halves`): for x·W with W (k, n) the halves of Wᵀ, for the
//    backward's dX = dY·Wᵀ the halves of W as it is stored. The epilogue is
//    a functor `epi(r, c, v)` called once per output element. A comes by
//    TMA (`launch_gemm_tc`) or, for the conv's taps, gathered row by row
//    (`launch_gemm_tc_gather`).
//
//    Bound: operations. 3xTF32 takes three TF32 products per fp32 one; K2's
//    qkv product (72,704 x 384 -> 1,152) is 3 x 64.3 GFLOP, 0.390 ms at the
//    495 TFLOP/s dense TF32 peak, against 0.133 ms for its 447 MB.
//
//    The bf16 mode (kBf16, the one-pass bf16 rung; `launch_gemm_tc<true>`):
//    B is W's bf16-rounded plane (n, k) in place of the halves, A is rounded
//    to bf16 (tf32.cuh bf16_round) as it leaves shared memory, and each
//    8-deep step is one wgmma on the plane instead of three; the producer
//    loads no small half. A simple instance: one TF32 pass on operands that
//    bf16 holds exactly, so the stages keep fp32 tiles at TF32's rate. With
//    A read as TmaAScaled (the backward's dX in training) each row of A is
//    multiplied by its factor before the rounding, as the TPU rounds the
//    droppath-scaled gradient (`launch_gemm_tc_scaled`).
//
//    Design: persistent, one block per SM walking 128 x 128 output tiles in
//    order, n fastest (the blocks running together share A tiles, so A
//    comes from device memory about once), 384 threads:
//     - warpgroup 0 is the producer: one thread keeps a ring of 4
//       shared-memory stages filled with TMA loads (A 128 x 32, W_big and
//       W_small 128 x 32, 128-byte swizzle), each stage guarded by a full
//       and an empty mbarrier. It runs on into the next tile's loads while
//       the consumers finish the current one: with K = 384-1,152 a tile is
//       only 12-36 stages deep, and a block per tile would refill the ring
//       and leave TMA idle through every epilogue. A gathered A (TMA takes
//       no row list) is fetched by all 128 producer threads instead, with
//       cp.async in 16-byte pieces written where the swizzle puts them,
//       zero-filled where the gather says so; each thread's copies arrive
//       on the stage's full mbarrier as they land (cp.async.mbarrier.arrive),
//       beside the TMA bytes of W;
//     - warpgroups 1 and 2 are consumers, 64 rows each: per 32-deep stage a
//       thread loads its A fragments from shared memory and splits them into
//       TF32 halves in registers; per 64-column half of the tile it issues
//       wgmma.m64n64k8 three times per 8-deep step (A_small·W_big,
//       A_big·W_small, A_big·W_big, B read from shared memory through
//       descriptors) into a fresh partial, then adds the partial to its fp32
//       accumulators. The tensor cores round toward zero as they accumulate:
//       with every product of K = 768 added into one sum that came to ~10x
//       the fp32 plain version's error on the card, and a partial per stage
//       brings it back to fp32's level;
//     - the epilogue runs from the accumulator registers: only rows < m and
//       columns < n are written. TMA fills rows and columns past the ends
//       of A with zeros. Each output element is read (a residual may alias
//       out) and written by one thread; A must not alias out. It does not
//       overlap the tensor cores' work (~0.3 of the qkv product's 0.86 ms,
//       kernel_probe.py); passing it through shared memory for 128-byte
//       stores was tried and was slower with a residual (spills).
//
// 2. gemm_atb_kernel: part[z] = Xᵀ · (s ⊙ dY) over chunk z of the rows, X
//    (rows, m) and dY (rows, n) row-major: the backward's dW, split over the
//    rows (36,352 at the train step) into partials that launch_sum_rows
//    (gemm.cuh) adds in a fixed order, so repeated runs agree bit for bit.
//
//    Bound: operations, as above (3 x 85.8 GFLOP per temporal block at the
//    train step, 0.52 ms at the TF32 peak, against 0.20 ms for its 670 MB).
//
//    Design: both operands are MN-major here, and TF32 wgmma reads 32-bit
//    operands from shared memory only K-major, so this kernel runs
//    mma.sync.m16n8k8 (as attention.cuh does) with both fragments read from
//    shared memory by the threads: 128 x 128 x 32 tiles in a 3-stage
//    cp.async ring, 8 warps of 64 x 32, rows padded by 8 floats so each
//    fragment read hits 32 banks; dY's row scale is applied as its values
//    leave shared memory, before the split. Each 8-deep step's three
//    products go into a fresh partial that joins the accumulators with a
//    rounded add (over 36,352 rows the toward-zero rounding of one running
//    sum cost ~15x the plain version's error). Two blocks per SM; the caller
//    picks the split count for about one wave (ops/temporal_train.py). X is
//    read through a functor, so the conv's dWc = Tᵀ·g gathers its taps
//    (conv_taps.cuh) the way the dense dW reads a matrix. The bf16 mode
//    (kBf16): X and s ⊙ dY rounded to bf16 as they leave shared memory, one
//    TF32 product per 8-deep step into the fresh partial.
#pragma once


#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "tf32.cuh"

namespace uu {

constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 32, TC_STAGES = 4;
constexpr int TC_THREADS = 384;                               // producer + 2 consumers
constexpr int TC_TILE_BYTES = TC_BM * TC_BK * 4;              // 16 KB, = TC_BN x TC_BK
constexpr int TC_STAGE_BYTES = 3 * TC_TILE_BYTES;             // A, W_big, W_small
constexpr int TC_SMEM_BYTES = TC_STAGES * TC_STAGE_BYTES + 1024 + 2 * TC_STAGES * 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// One arrival on `bar` once every cp.async this thread issued so far has
// landed; counted in the barrier's expected arrivals (.noinc).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One 2D TMA box (inner coordinate first) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile with 128-byte rows, 128-byte swizzle:
// 8-row groups 1,024 bytes apart. The tile starts 1,024-byte aligned; a
// step of 8 along K adds 32 bytes (2 in the address field).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 64 per warpgroup) += a (64 x 8, registers) · b (8 x 64, shared memory)
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// out[r, c] = act(v + bias[c]) + residual[r, c]; bias and residual optional.
// residual may alias out: each element is read and written by one thread.
struct BiasActResidual {
  const float* bias;
  const float* residual;
  float* out;
  int n;
  int relu;
  __device__ __forceinline__ void operator()(int r, int c, float v) const {
    if (bias) v += bias[c];
    if (relu) v = fmaxf(v, 0.f);
    const size_t o = (size_t)r * n + c;
    if (residual) v += residual[o];
    out[o] = v;
  }
};

// A read by TMA through map_a.
struct TmaA {
  static constexpr bool kGather = false;
};

// A read by TMA through map_a, each row r multiplied by scale[r /
// rows_per_scale] (1 without a scale) as it leaves shared memory; the bf16
// mode only.
struct TmaAScaled {
  static constexpr bool kGather = false;
  const float* scale;
  int rows_per_scale;
  __device__ __forceinline__ float factor(int row, int m) const {
    return scale && row < m ? scale[row / rows_per_scale] : 1.f;
  }
};

template <class ASrc>
struct RowScaled {
  static constexpr bool value = false;
};
template <>
struct RowScaled<TmaAScaled> {
  static constexpr bool value = true;
};

// map_w holds W's big half in rows [0, n) and its small half in rows
// [w_small, w_small + n) (kBf16: the bf16 plane in rows [0, n), no small
// half); A comes through map_a (ASrc = TmaA) or through the gather `a_at`
// (ASrc::kGather: `row(r)` once per tile row, `at(row, k)` a pointer to
// A[r, k..k+3] or nullptr for zeros).
template <class Epilogue, class ASrc, bool kBf16>
__global__ void __launch_bounds__(TC_THREADS, 1)
gemm_tc_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_w, int m, int n, int k, int w_small,
               ASrc a_at, Epilogue epi) {
  extern __shared__ float4 tc_smem[];
  unsigned char* smem_raw = reinterpret_cast<unsigned char*>(tc_smem);
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // 128-byte swizzle wants 1,024 alignment
  float* tiles = reinterpret_cast<float*>(smem_raw + (base - raw));
  const uint32_t full = base + TC_STAGES * TC_STAGE_BYTES;  // TC_STAGES mbarriers
  const uint32_t empty = full + TC_STAGES * 8;              // TC_STAGES mbarriers
  const int ktiles = (k + TC_BK - 1) / TC_BK;
  const int tiles_n = (n + TC_BN - 1) / TC_BN;
  const int tile_count = tiles_n * ((m + TC_BM - 1) / TC_BM);

  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(full + 8 * s, ASrc::kGather ? 1 + 128 : 1);  // + each gathering thread
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Both sides count the stages they have used, `it`, across tiles: stage
  // it % TC_STAGES, in its (it / TC_STAGES)-th round.
  if (threadIdx.x < 128) {  // producer warpgroup
    if constexpr (!ASrc::kGather) {  // one thread issues every load
      if (threadIdx.x == 0) {
        uint32_t it = 0;
        for (int tile = blockIdx.x; tile < tile_count; tile += gridDim.x) {
          const int n0 = (tile % tiles_n) * TC_BN, m0 = (tile / tiles_n) * TC_BM;
          for (int kt = 0; kt < ktiles; ++kt, ++it) {
            const int s = it % TC_STAGES;
            const uint32_t round = it / TC_STAGES;
            if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
            const uint32_t st = base + s * TC_STAGE_BYTES;
            mbar_expect_tx(full + 8 * s, kBf16 ? 2 * TC_TILE_BYTES : TC_STAGE_BYTES);
            tma_load_2d(st, &map_a, kt * TC_BK, m0, full + 8 * s);
            tma_load_2d(st + TC_TILE_BYTES, &map_w, kt * TC_BK, n0, full + 8 * s);
            if constexpr (!kBf16)
              tma_load_2d(st + 2 * TC_TILE_BYTES, &map_w, kt * TC_BK, w_small + n0,
                          full + 8 * s);
          }
        }
      }
    } else {
      // Thread p copies 16-byte piece q = p % 8 of the tile rows p / 8 + 16i;
      // in the 128-byte swizzle piece q of row r sits at piece q ^ (r % 8).
      const int p = threadIdx.x, q = p % 8, r0 = p / 8;
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < tile_count; tile += gridDim.x) {
        const int n0 = (tile % tiles_n) * TC_BN, m0 = (tile / tiles_n) * TC_BM;
        typename ASrc::Row rows[TC_BM / 16];
#pragma unroll
        for (int i = 0; i < TC_BM / 16; ++i) rows[i] = a_at.row(m0 + r0 + 16 * i);
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % TC_STAGES;
          const uint32_t round = it / TC_STAGES;
          if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
          const uint32_t st = base + s * TC_STAGE_BYTES;
          if (p == 0) {
            mbar_expect_tx(full + 8 * s, kBf16 ? TC_TILE_BYTES : 2 * TC_TILE_BYTES);
            tma_load_2d(st + TC_TILE_BYTES, &map_w, kt * TC_BK, n0, full + 8 * s);
            if constexpr (!kBf16)
              tma_load_2d(st + 2 * TC_TILE_BYTES, &map_w, kt * TC_BK, w_small + n0,
                          full + 8 * s);
          }
          float* at = tiles + s * (TC_STAGE_BYTES / 4);
          const int kk = kt * TC_BK + 4 * q;
#pragma unroll
          for (int i = 0; i < TC_BM / 16; ++i) {
            const int r = r0 + 16 * i;
            const float* src = kk < k ? a_at.at(rows[i], kk) : nullptr;
            cp_async16(at + r * 32 + (q ^ (r % 8)) * 4, src ? src : a_at.h1, src ? 16 : 0);
          }
          cp_async_mbar_arrive(full + 8 * s);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows 64cw..64cw+63 of each tile
  static_assert(kBf16 || !RowScaled<ASrc>::value, "A's row factors are a bf16-mode input");
  const int cw = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int r = cw * 64 + warp * 16 + g;  // this thread's rows r and r + 8 (r % 8 == g)
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < tile_count; tile += gridDim.x) {
    const int n0 = (tile % tiles_n) * TC_BN, m0 = (tile / tiles_n) * TC_BM;
    float fr0 = 1.f, fr1 = 1.f;  // the rows' factors (TmaAScaled)
    if constexpr (RowScaled<ASrc>::value) {
      fr0 = a_at.factor(m0 + r, m);
      fr1 = a_at.factor(m0 + r + 8, m);
    }
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = it % TC_STAGES;
      mbar_wait(full + 8 * s, (it / TC_STAGES) & 1);
      const float* at = tiles + s * (TC_STAGE_BYTES / 4);
      const uint32_t wb = base + s * TC_STAGE_BYTES + TC_TILE_BYTES;
      const uint64_t desc_big = sw128_desc(wb), desc_small = sw128_desc(wb + TC_TILE_BYTES);
      // A fragment of step j: (r, 8j+t), (r+8, 8j+t), (r, 8j+t+4), (r+8, 8j+t+4);
      // element (row, col) of the swizzled tile sits at
      // row*32 + ((col/4) ^ (row%8))*4 + col%4
      uint32_t a_big[4][4], a_small[kBf16 ? 1 : 4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int lo = ((2 * j) ^ g) * 4 + t, hi = ((2 * j + 1) ^ g) * 4 + t;
        if constexpr (kBf16 && RowScaled<ASrc>::value) {
          a_big[j][0] = bf16_round(at[r * 32 + lo] * fr0);
          a_big[j][1] = bf16_round(at[(r + 8) * 32 + lo] * fr1);
          a_big[j][2] = bf16_round(at[r * 32 + hi] * fr0);
          a_big[j][3] = bf16_round(at[(r + 8) * 32 + hi] * fr1);
        } else if constexpr (kBf16) {
          a_big[j][0] = bf16_round(at[r * 32 + lo]);
          a_big[j][1] = bf16_round(at[(r + 8) * 32 + lo]);
          a_big[j][2] = bf16_round(at[r * 32 + hi]);
          a_big[j][3] = bf16_round(at[(r + 8) * 32 + hi]);
        } else {
          tf32_split(at[r * 32 + lo], a_big[j][0], a_small[j][0]);
          tf32_split(at[(r + 8) * 32 + lo], a_big[j][1], a_small[j][1]);
          tf32_split(at[r * 32 + hi], a_big[j][2], a_small[j][2]);
          tf32_split(at[(r + 8) * 32 + hi], a_big[j][3], a_small[j][3]);
        }
      }
      // The tensor cores add each product into their accumulator rounding
      // toward zero, an error that grows with the number of adds into one
      // sum (~1e-5 relative over K = 768 where the fp32 plain version keeps
      // ~1e-6). So each 32-deep stage sums into a fresh partial, per 64-column
      // half (32 registers), which then joins acc with a rounded fp32 add.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float part[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) part[i] = 0.f;
        const uint64_t half = h * (64 * TC_BK * 4 >> 4);  // W's rows 64h.. of the tile
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (!kBf16) {
            wgmma_m64n64k8_tf32(part, a_small[j], desc_big + half + 2 * j);
            wgmma_m64n64k8_tf32(part, a_big[j], desc_small + half + 2 * j);
          }
          wgmma_m64n64k8_tf32(part, a_big[j], desc_big + half + 2 * j);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[32 * h + i] += part[i];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // accumulator i: column 8(i/4) + 2t + (i%2), row r + 8((i/2)%2)
    const int row0 = m0 + r, row1 = row0 + 8;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (row0 < m) {
        if (col < n) epi(row0, col, acc[4 * j]);
        if (col + 1 < n) epi(row0, col + 1, acc[4 * j + 1]);
      }
      if (row1 < m) {
        if (col < n) epi(row1, col, acc[4 * j + 2]);
        if (col + 1 < n) epi(row1, col + 1, acc[4 * j + 3]);
      }
    }
  }
}

// W (batch, k, n) row-major -> halves (batch, 2, n, k) with `transpose`, else
// (batch, 2, k, n): [0] = tf32(W), [1] = W - tf32(W).
static __global__ void tf32_halves_kernel(const float* __restrict__ w,
                                          float* __restrict__ halves, int k, int n,
                                          int transpose) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;  // along n: coalesced reads
  const int kk = blockIdx.y;
  if (col >= n) return;
  const size_t plane = (size_t)k * n;
  const size_t b = blockIdx.z;
  uint32_t big, small;
  tf32_split(w[b * plane + (size_t)kk * n + col], big, small);
  float* out = halves + 2 * b * plane;
  const size_t at = transpose ? (size_t)col * k + kk : (size_t)kk * n + col;
  out[at] = __uint_as_float(big);
  out[plane + at] = __uint_as_float(small);
}

inline cudaError_t launch_tf32_halves(const float* w, float* halves, int batch, int k, int n,
                                      int transpose, cudaStream_t stream) {
  if (batch <= 0 || k <= 0 || n <= 0 || k > 65535 || batch > 65535)
    return cudaErrorInvalidValue;
  tf32_halves_kernel<<<dim3((n + 127) / 128, k, batch), 128, 0, stream>>>(w, halves, k, n,
                                                                         transpose);
  return cudaGetLastError();
}

typedef CUresult (*TensorMapEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                         const cuuint64_t*, const cuuint64_t*,
                                         const cuuint32_t*, const cuuint32_t*,
                                         CUtensorMapInterleave, CUtensorMapSwizzle,
                                         CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime (no -lcuda).
inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TensorMapEncodeTiled>(p);
  }
  return fn;
}

// A (rows, cols) fp32 row-major tensor map, boxes of box_rows x 32 with the
// 128-byte swizzle; out-of-range elements read as zero.
inline bool make_tile_map(CUtensorMap* map, const float* ptr, int rows, int cols, int box_rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)TC_BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int sm_count() {
  static int count = 0;
  if (!count) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 0;
  }
  return count;
}

template <bool kBf16, class Epilogue, class ASrc>
inline cudaError_t launch_tc(const CUtensorMap& map_a, ASrc a_at, const float* halves,
                             int w_small, int m, int n, int k, Epilogue epi,
                             cudaStream_t stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 4 != 0 || w_small < n) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(halves) % 16) return cudaErrorInvalidValue;
  const long long tiles =
      (long long)((m + TC_BM - 1) / TC_BM) * ((n + TC_BN - 1) / TC_BN);
  const int sms = sm_count();
  if (tiles > (1LL << 30) || sms <= 0) return cudaErrorInvalidValue;
  CUtensorMap map_w;
  if (!make_tile_map(&map_w, halves, kBf16 ? n : w_small + n, k, TC_BN))
    return cudaErrorInvalidValue;
  auto kernel = gemm_tc_kernel<Epilogue, ASrc, kBf16>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int grid = tiles < sms ? (int)tiles : sms;
  kernel<<<grid, TC_THREADS, TC_SMEM_BYTES, stream>>>(map_a, map_w, m, n, k, w_small, a_at,
                                                      epi);
  return cudaGetLastError();
}

// out = epi(A · B) with A (m, k) row-major and halves (2, n, k) from
// launch_tf32_halves; or, with w_small > 0, a slice of n rows of larger
// halves whose small half starts w_small rows after `halves`. kBf16: the
// bf16 mode, `halves` W's bf16-rounded plane (n, k). TMA needs 16-byte
// aligned rows: k % 4 == 0 and 16-byte aligned pointers.
template <bool kBf16 = false, class Epilogue>
inline cudaError_t launch_gemm_tc(const float* a, const float* halves, int m, int n, int k,
                                  Epilogue epi, cudaStream_t stream, int w_small = 0) {
  if (m <= 0 || k <= 0 || k % 4 != 0 || reinterpret_cast<uintptr_t>(a) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap map_a;
  if (!make_tile_map(&map_a, a, m, k, TC_BM)) return cudaErrorInvalidValue;
  return launch_tc<kBf16>(map_a, TmaA{}, halves, w_small > 0 ? w_small : n, m, n, k, epi,
                          stream);
}

// launch_gemm_tc<true> with row r of A multiplied by scale[r / rows_per_scale]
// (scale may be null: 1) before its rounding to bf16.
template <class Epilogue>
inline cudaError_t launch_gemm_tc_scaled(const float* a, const float* plane, int m, int n,
                                         int k, const float* scale, int rows_per_scale,
                                         Epilogue epi, cudaStream_t stream) {
  if (m <= 0 || k <= 0 || k % 4 != 0 || reinterpret_cast<uintptr_t>(a) % 16 ||
      (scale && rows_per_scale <= 0))
    return cudaErrorInvalidValue;
  CUtensorMap map_a;
  if (!make_tile_map(&map_a, a, m, k, TC_BM)) return cudaErrorInvalidValue;
  return launch_tc<true>(map_a, TmaAScaled{scale, rows_per_scale}, plane, n, m, n, k, epi,
                         stream);
}

// out = epi(A · B) with A (m, k) read through the gather `a_at` (a ConvTaps,
// conv_taps.cuh) and halves (2, n, k) (kBf16: the bf16 plane (n, k)).
template <bool kBf16 = false, class Epilogue, class Gather>
inline cudaError_t launch_gemm_tc_gather(Gather a_at, const float* halves, int m, int n, int k,
                                         Epilogue epi, cudaStream_t stream) {
  CUtensorMap unused;
  memset(&unused, 0, sizeof(unused));
  return launch_tc<kBf16>(unused, a_at, halves, n, m, n, k, epi, stream);
}

constexpr int AB_BM = 128, AB_BN = 128, AB_BK = 32, AB_STAGES = 3;
constexpr int AB_THREADS = 256;                       // 8 warps of 64 x 32
constexpr int AB_LD = AB_BM + 8;                      // floats per staged row (= AB_BN + 8)
constexpr int AB_TILE = AB_BK * AB_LD;                // floats per operand per stage
constexpr int AB_STAGE = 2 * AB_TILE + AB_BK;         // X, dY, the rows' scales
constexpr int AB_SMEM_BYTES = AB_STAGES * AB_STAGE * 4;

// X (rows, m) row-major, read as x_at(row, col): a pointer to X[row, col..col+3].
struct DenseRows {
  const float* x;
  int m;
  __device__ __forceinline__ const float* operator()(int r, int c) const {
    return x + (size_t)r * m + c;
  }
};

// x_at(row, col): a pointer to X[row, col..col+3], or nullptr where X is
// zero (DenseRows, or the conv's taps: ConvTaps, conv_taps.cuh).
template <class XSrc, bool kBf16>
__global__ void __launch_bounds__(AB_THREADS, 2)
gemm_atb_kernel(XSrc x_at, const float* __restrict__ dy,
                const float* __restrict__ scale, int rows_per_scale, float* __restrict__ part,
                int m, int n, int rows, int k_split) {
  extern __shared__ float4 ab_smem[];
  float* sm = reinterpret_cast<float*>(ab_smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int wm = warp / 4, wn = warp % 4;  // the warp's rows wm*64.., columns wn*32..
  const int m0 = blockIdx.y * AB_BM, n0 = blockIdx.x * AB_BN;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(rows, k_begin + k_split);
  const int ktiles = k_end > k_begin ? (k_end - k_begin + AB_BK - 1) / AB_BK : 0;

  // stage kt: 32 rows of X's and dY's column slices, 16 bytes a copy;
  // rows past the chunk and columns past m or n are zero-filled
  auto load = [&](int kt) {
    float* xs = sm + (kt % AB_STAGES) * AB_STAGE;
    float* ys = xs + AB_TILE;
    const int k0 = k_begin + kt * AB_BK;
#pragma unroll
    for (int i = 0; i < (AB_BK * AB_BM / 4) / AB_THREADS; ++i) {
      const int idx = tid + i * AB_THREADS;
      const int kk = idx / (AB_BM / 4), c4 = (idx % (AB_BM / 4)) * 4;
      const int gk = k0 + kk;
      const bool vy = gk < k_end && n0 + c4 < n;
      const float* xp = gk < k_end && m0 + c4 < m ? x_at(gk, m0 + c4) : nullptr;
      cp_async16(xs + kk * AB_LD + c4, xp ? xp : dy, xp ? 16 : 0);
      cp_async16(ys + kk * AB_LD + c4, vy ? dy + (size_t)gk * n + n0 + c4 : dy, vy ? 16 : 0);
    }
    if (tid < AB_BK) {
      const int gk = k0 + tid;
      ys[AB_TILE + tid] = gk >= k_end ? 0.f : scale ? scale[gk / rows_per_scale] : 1.f;
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < AB_STAGES - 1; ++s) {
    if (s < ktiles) load(s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(AB_STAGES - 2) : "memory");
    __syncthreads();  // stage kt landed; every warp is done with stage kt - 1
    if (kt + AB_STAGES - 1 < ktiles) load(kt + AB_STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* xs = sm + (kt % AB_STAGES) * AB_STAGE;
    const float* ys = xs + AB_TILE;
    const float* sc = ys + AB_TILE;
#pragma unroll
    for (int k8 = 0; k8 < AB_BK / 8; ++k8) {
      const int lo = k8 * 8 + t, hi = lo + 4;  // the fragments' rows of X and dY
      const float s_lo = sc[lo], s_hi = sc[hi];
      if constexpr (kBf16) {  // one product of the rounded operands a step
        uint32_t b_r[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = wn * 32 + j * 8 + g;
          b_r[j][0] = bf16_round(ys[lo * AB_LD + col] * s_lo);
          b_r[j][1] = bf16_round(ys[hi * AB_LD + col] * s_hi);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = wm * 64 + i * 16 + g;
          const uint32_t a_r[4] = {bf16_round(xs[lo * AB_LD + row]),
                                   bf16_round(xs[lo * AB_LD + row + 8]),
                                   bf16_round(xs[hi * AB_LD + row]),
                                   bf16_round(xs[hi * AB_LD + row + 8])};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(part, a_r, b_r[j]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
          }
        }
        continue;
      }
      uint32_t b_big[4][2], b_small[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn * 32 + j * 8 + g;
        tf32_split(ys[lo * AB_LD + col] * s_lo, b_big[j][0], b_small[j][0]);
        tf32_split(ys[hi * AB_LD + col] * s_hi, b_big[j][1], b_small[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm * 64 + i * 16 + g;
        uint32_t a_big[4], a_small[4];
        tf32_split(xs[lo * AB_LD + row], a_big[0], a_small[0]);
        tf32_split(xs[lo * AB_LD + row + 8], a_big[1], a_small[1]);
        tf32_split(xs[hi * AB_LD + row], a_big[2], a_small[2]);
        tf32_split(xs[hi * AB_LD + row + 8], a_big[3], a_small[3]);
        // each 8-deep step's three products into a fresh partial, added to
        // acc rounded (the tensor cores round toward zero: see gemm_tc_kernel)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_3xtf32(part, a_big, a_small, b_big[j], b_small[j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // accumulator e of (i, j): row wm*64 + 16i + g + 8(e/2), column wn*32 + 8j + 2t + e%2
  float* out = part + (size_t)blockIdx.z * m * n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + wm * 64 + i * 16 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + 2 * t;
      if (col >= n) continue;  // n is even: col + 1 < n with it
      if (row < m)
        *reinterpret_cast<float2*>(out + (size_t)row * n + col) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (row + 8 < m)
        *reinterpret_cast<float2*>(out + (size_t)(row + 8) * n + col) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

// part (splits, m, n): chunk z of Xᵀ · (dY * scale[row / rows_per_scale])
// over rows [z·k_split, (z+1)·k_split), k_split a multiple of 32; X (rows,
// m) through x_at (DenseRows, 16-byte aligned, or the conv's ConvTaps), dY
// (rows, n) row-major, 16-byte aligned; m and n multiples of 4. kBf16: the
// bf16 mode (X and the scaled dY rounded to bf16).
template <bool kBf16 = false, class XSrc>
inline cudaError_t launch_gemm_atb(XSrc x_at, const float* dy, const float* scale,
                                   int rows_per_scale, float* part, int m, int n, int rows,
                                   int splits, cudaStream_t stream) {
  if (m <= 0 || n <= 0 || rows <= 0 || splits <= 0 || splits > 65535 || m % 4 || n % 4 ||
      (scale && rows_per_scale <= 0) || reinterpret_cast<uintptr_t>(dy) % 16)
    return cudaErrorInvalidValue;
  if ((m + AB_BM - 1) / AB_BM > 65535) return cudaErrorInvalidValue;
  int k_split = (rows + splits - 1) / splits;
  k_split = (k_split + AB_BK - 1) / AB_BK * AB_BK;
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_atb_kernel<XSrc, kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      AB_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + AB_BN - 1) / AB_BN, (m + AB_BM - 1) / AB_BM, splits);
  gemm_atb_kernel<XSrc, kBf16><<<grid, AB_THREADS, AB_SMEM_BYTES, stream>>>(
      x_at, dy, scale, rows_per_scale, part, m, n, rows, k_split);
  return cudaGetLastError();
}

}  // namespace uu
