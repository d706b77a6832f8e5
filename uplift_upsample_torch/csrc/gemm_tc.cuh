// Tensor-core GEMMs at fp32-level error for Hopper: 3xTF32 (tf32.cuh), in
// two kernels. They carry every product of K2, K3, K5 and K6 outside the
// attention: the dense layers (forward, and the backward's dX and dW), the
// strided conv's three products (strided.cu, strided_bwd.cu: its operands
// as conv_taps.cuh reads them) and the s2t prologue.
//
// 1. gemm_tc_kernel: out = epilogue(A · B), A fp32, B the two TF32 halves
//    of an (n, k) K-major matrix in one (2, n, k) buffer
//    (`launch_tf32_halves`): for x·W with W (k, n) the halves of Wᵀ, for the
//    backward's dX = dY·Wᵀ the halves of W as it is stored. The epilogue is
//    a functor (`BiasActResidual` below says what it provides) that writes
//    each output element from its sum. A comes by TMA as its source says:
//    TmaA, (m, k) row-major (`launch_gemm_tc`); the strided conv's taps of
//    h1, a box of whole windows a stage (ConvTapsTma), or dH1's shifted rows
//    of g (Dh1Rows), whose tiles also leave by TMA (an epilogue with
//    kTmaStore).
//
//    Bound: operations. 3xTF32 takes three TF32 products per fp32 one; K2's
//    qkv product (72,704 x 384 -> 1,152) is 3 x 64.3 GFLOP, 0.390 ms at the
//    495 TFLOP/s dense TF32 peak, against 0.133 ms for its 447 MB.
//
//    The bf16 rung (TC_BF16, `launch_gemm_bf16`: K2's and K3's dense layers,
//    K5's forward and dX, s2t; the strided conv and its dH1 through their A
//    sources) runs native bf16: W's plane in bf16 (torch.bfloat16) by TMA
//    into 64-byte rows with the 64-byte swizzle, A's fp32 tile rounded by the
//    consumers to bf16 pairs (cvt.rn.bf16x2) as wgmma's register operand,
//    two wgmma.m64n64k16 per 32-deep stage and half; a stage is 24 KB, so
//    the ring holds 6 (a ring of 4 beside two staging tiles ran the dense
//    products 1.04-1.27x slower). With A read as TmaAScaled (the backward's
//    dX in training) each row of A is multiplied by its factor before the
//    rounding, as the TPU rounds the droppath-scaled gradient. Its own
//    mainloop (`mainloop_native`) staggers the two halves' wgmma groups by
//    half a stage, so one half's products run while the other's partial is
//    added. Bound: bytes at serving (qkv's 447 MB, 0.134 ms; its products
//    0.065 ms at the 989 TFLOP/s dense bf16 peak).
//
//    Design: persistent, one block per SM walking output tiles of up to 128
//    rows x 128 columns in order, n fastest (the blocks running together
//    share A tiles, so A comes from device memory about once), 384 threads;
//    warpgroup 0 gives registers to the two consumer warpgroups
//    (setmaxnreg: 56 and 224 a thread, the launch's 168 on average):
//     - the loader: one thread keeps a ring of shared-memory stages (3 of
//       A 128 x 32, W_big and W_small 128 x 32, 128-byte swizzle) filled
//       with TMA loads, each stage guarded by a full and an empty mbarrier.
//       It runs on into the next tile's loads while the consumers finish the
//       current one: with K = 384-1,152 a tile is only 12-36 stages deep.
//       Before A came by TMA for the conv, its taps were gathered by all 128
//       threads of warpgroup 0 with cp.async (72 / 216 registers, a ring of
//       4, no epilogue warps): 0.73 ms at serving where the same products
//       from a dense A took 0.41 (kernel_probe.py, NVIDIA H100 80GB HBM3,
//       700 W);
//     - the consumers, 64 rows each: per 32-deep stage a thread loads its A
//       fragments from shared memory and splits them into TF32 halves in
//       registers; per 64-column half of the tile it issues wgmma.m64n64k8
//       three times per 8-deep step (A_small·W_big, A_big·W_small,
//       A_big·W_big, B read from shared memory through descriptors) into a
//       fresh partial, then adds the partial to its fp32 accumulators. The
//       tensor cores round toward zero as they accumulate: with every
//       product of K = 768 added into one sum that came to ~10x the fp32
//       plain version's error on the card, and a partial per stage brings it
//       back to fp32's level. Both halves' products are in flight together
//       (wgmma.wait_group 1, then 0), the next stage's A is read under them,
//       and a stage is released as soon as its second half retires
//       (`mainloop`). The consumers then write their sums to a staging tile
//       in shared memory and go on to the next tile;
//     - the epilogue (warps 1-3 of warpgroup 0): it reads a staged tile and
//       passes it through the epilogue functor, 4 columns a thread (16-byte
//       loads and stores, a few rows' loads in flight), while the consumers
//       run the next tile's products. Run from the consumers' registers
//       after the last stage, as the kernel did before this pipeline, it
//       took ~0.34 of qkv's 0.87 ms (kernel_probe.py, NVIDIA H100 80GB HBM3,
//       700 W). With kTmaStore one of its threads brings the tile's mask or
//       residual by TMA into the staging tile (TMA's layout) once the last
//       tile's store has read it, the consumers write their outputs there,
//       and the thread stores the tile by TMA (dH1; the bf16 rung's products
//       with a residual or a relu mask). With kDirect the consumers write
//       their outputs themselves from their registers (the bf16 rung's
//       branch and s2t prologue).
//    Only rows < m (the source's rows of a tile) and columns < n are
//    written; TMA fills rows and columns past the ends of A with zeros. Each
//    output element is read (a residual may alias out) and written by one
//    thread; A must not alias out. Every output's sum is the one the kernel
//    took before the pipeline (the same partials, added in stage order), so
//    its outputs are the same bits (uplift_upsample_torch/tools/
//    gemm_digests.py, GEMM_DIGESTS); so are the conv's in 3xTF32, whose
//    stages are T's 32-column slices in order.
//
// 2. gemm_atb_kernel: part[z] = Xᵀ · (s ⊙ dY) over chunk z of the rows, X
//    (rows, m) and dY (rows, n) row-major: the backward's dW (K5: qkv, proj,
//    fc1, fc2; K6's dWc = Tᵀ·g with X the conv's taps, gathered from h1:
//    conv_taps.cuh), split over the rows (36,352 at the train step) into
//    partials that launch_sum_rows (gemm.cuh) adds in a fixed order, so
//    repeated runs agree bit for bit.
//
//    Bound: operations in 3xTF32 (3 x 85.8 GFLOP per temporal block at the
//    train step, 0.52 ms at the TF32 peak, against 0.20 ms for its 670 MB);
//    bytes in the bf16 mode (the fp32 operands read once: fc2 0.050 ms, its
//    products 0.017 ms at the bf16 peak).
//
//    Design: both operands are MN-major (m or n contiguous, k = the rows
//    strided). One 128 x 128 output tile and one row chunk per block, 384
//    threads, one block per SM, 32 rows a stage:
//     - the loader (thread 0) fills a ring of 5 stages of rows: dY's, and X's
//       for the dense dW, by TMA in boxes of 32 rows x 32 columns (128-byte
//       swizzle; rows and columns past the ends read as zeros); the taps of
//       dWc gathered from h1 by warpgroup 0's 128 threads, eight to a
//       128-byte row, with cp.async 16 bytes at a time into the same layout
//       (zeros where a tap reads none);
//     - the consumers (two warpgroups, 64 rows of the tile each, in two
//       64-column halves) run stage it's products while they write stage
//       it + 1's operand buffer (of two) from its rows, each warpgroup its
//       share, and release the rows at once; a barrier of the two ends each
//       stage. bf16 mode: X and s ⊙ dY rounded to bf16 (bf16_round's
//       rounding, two at a time) into two MN-major tiles with the 128-byte
//       swizzle, which bf16 wgmma reads through its transpose bits; per
//       stage and half two wgmma.m64n64k16 into a fresh partial. 3xTF32:
//       TF32 wgmma reads a 32-bit operand from shared memory only K-major,
//       so s ⊙ dY is transposed, split and written as big and small halves
//       K-major (128-byte swizzle) as gemm_tc_kernel's W tiles; Xᵀ is the
//       register operand, read from the rows and split in registers; per
//       stage and half wgmma.m64n64k8 three times per 8-deep step
//       (small·big, big·small, big·big: mma_3xtf32's order) into a fresh
//       partial. Both halves are in flight together; a partial joins the
//       fp32 accumulators with a rounded add once it retires. Rows past the
//       chunk reach the products as zeros. The tensor cores round toward
//       zero as they accumulate: over 36,352 rows one running sum cost ~15x
//       the plain version's error (tests/test_torch_gemm_tc.py emulates both
//       modes' sums against float64).
//    What was tried first (kernel_probe.py, NVIDIA H100 80GB HBM3, 700 W):
//    rows by bulk copies (cp.async.bulk, a 512-byte row a lane): without
//    products the kernel took 0.67 ms at qkv, as long as the mma.sync
//    kernel it replaces; a partial per 8-deep step, as that kernel took,
//    kept its bits but left the products waiting on one another (0.52 ms at
//    qkv without the copies); three converter warps writing the operand
//    tiles bound the kernel (3xTF32 qkv 0.67 ms, 0.32 without them).
//    The caller picks the split count (ops/temporal_train.py dw_splits).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "mma_bf16.cuh"
#include "tf32.cuh"

namespace uu {

constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 32;
constexpr int TC_THREADS = 384;                    // warpgroup 0, then two consumers
constexpr int TC_TILE_BYTES = TC_BM * TC_BK * 4;   // 16 KB, = TC_BN x TC_BK
constexpr int TC_STAGE_BYTES = 3 * TC_TILE_BYTES;  // A, W_big, W_small
constexpr int TC_LDS = TC_BN + 8;                  // floats per staged output row
constexpr int TC_OUT_BYTES = TC_BM * TC_LDS * 4;   // one tile's sums, 68 KB
// Registers per thread after setmaxnreg: warpgroup 0's and the consumers',
// 128 x 56 + 256 x 224 = 384 x 168, the launch's own (__launch_bounds__).
constexpr int TC_LOADER_REGS = 56, TC_CONSUMER_REGS = 224;
constexpr int TC_EPILOGUE = 96;  // warps 1-3 of warpgroup 0
constexpr uint64_t kHalf = 64 * TC_BK * 4 >> 4;  // rows 64.. of a K-major fp32 tile of 32

// The products' modes: 3xTF32, and the bf16 rung's native bf16 (W's plane in
// bf16, A rounded into registers, wgmma k16 on bf16 operands).
constexpr int TC_3XTF32 = 0, TC_BF16 = 1;

// A ring stage by mode: A's 128 x 32 fp32 tile (128-byte rows, 128-byte
// swizzle), then W's: its two TF32 halves, fp32 tiles of 128 rows x 32, or in
// native bf16 one tile of 128 rows of 32 bf16 (64-byte rows, 64-byte
// swizzle), which leaves room for twice the stages.
template <int kMode>
struct TcStage {
  static constexpr bool kNative = kMode == TC_BF16;
  static constexpr int kBytes = kNative ? TC_TILE_BYTES + TC_BN * TC_BK * 2 : TC_STAGE_BYTES;
  static constexpr int kStages = kNative ? 6 : 3;
  static constexpr int kWLoad = kNative ? TC_BN * TC_BK * 2 : 2 * TC_TILE_BYTES;  // W a stage
  static constexpr uint64_t kWHalf =  // W's rows 64.. of a stage tile, in descriptor units
      kNative ? 64 * TC_BK * 2 >> 4 : kHalf;
  static constexpr int kSmem = kStages * kBytes + TC_OUT_BYTES + (2 * kStages + 2) * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

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

// Wait until the phase of parity `parity` has completed; trap instead of
// spinning forever if it never does.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins == (1u << 24)) __trap();
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

// One 3D TMA box into shared memory, completing on `bar`; coordinates may
// be negative (what lies outside the tensor reads as zeros).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One 3D TMA box from shared memory to the tensor (what lies outside it is
// not written), in this thread's bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The bulk groups' stores have read their shared memory (kRead) or are done.
template <bool kRead>
__device__ __forceinline__ void bulk_wait_all() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// wgmma descriptor of a K-major tile with 128-byte rows, 128-byte swizzle:
// 8-row groups 1,024 bytes apart. The tile starts 1,024-byte aligned; a
// step of 8 along K adds 32 bytes (2 in the address field).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The same for a K-major bf16 tile with 64-byte rows, 64-byte swizzle
// (16-byte chunk c of row r at chunk c ^ ((r / 2) % 4)): 8-row groups 512
// bytes apart. The tile starts 512-byte aligned; a step of 16 along K adds
// 32 bytes.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
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

// d (64 x 64 per warpgroup) += a (64 x 16 bf16, registers: four pairs a
// thread) · b (16 x 64 bf16, K-major in shared memory)
__device__ __forceinline__ void wgmma_m64n64k16_bf16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                        uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 64) = a (64 x 16 bf16, registers) · b (16 x 64 bf16), d's old
// values unread: a partial's first product, so nothing zeroes d first
__device__ __forceinline__ void wgmma_m64n64k16_bf16_rs_first(float (&d)[32],
                                                              const uint32_t (&a)[4],
                                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),
        "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(0));
}

// Keeps the compiler from moving reads or writes of x across the wgmma
// issues and waits around it (the tensor cores write x asynchronously).
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// An epilogue functor E writes one output tile's elements from their sums v:
//   operator()(r, c, v)              one element;
//   quads() (host)                   whether 4 columns at a time may be taken
//                                    (n % 4 == 0, 16-byte aligned pointers);
//   Ld load4(r, c), store4(r, c, v4, ld)
//                                    columns c..c+3 (c % 4 == 0) of row r: what
//                                    they read, then what they write, each
//                                    element exactly as operator() computes it.
// The epilogue threads load a few rows' Ld before storing any, so their reads
// are in flight together. An epilogue with `kTmaStore` (DenseTmaStore
// below, strided_bwd.cu's dH1) instead comes with two arrays of tensor maps
// (its Maps: `in`, `out`) of the output's row sets that its A source's
// `out_at` names, and provides
//   tile_in()                        whether a tile of values (a residual, a
//                                    relu mask) comes in first;
//   value(c, v, in)                  what column c's sum v becomes, `in` the
//                                    value that came in at its place;
// the tile's incoming values come by TMA through in[·] into the staging
// tile, the consumers write value(·) of their sums in their place, and the
// tile leaves by TMA through out[·]. An epilogue with `kDirect` (K5's
// branch, the s2t prologue) is written by the consumers from their
// registers, with no staging and no epilogue warps; it comes with Maps
// (`in`) and provides
//   tile_in()                        whether a tile of values (a residual, a
//                                    relu mask) comes in first, by TMA
//                                    through in[·] into the staging tile;
//   Row row(r)                       what row r's outputs need (a factor, a
//                                    mask), read once a tile;
//   put(r, c, v0, v1, in, row)       columns c, c + 1 of row r (r < m,
//                                    c + 1 < n) from their sums and the
//                                    values that came in at their place.
// Written from the staging tile by the warps, a residual's loads (four rows
// in flight a warp) bound proj's product: 0.1884 ms, 0.1327 with the
// residual by TMA and the tile stored by TMA (kernel_probe.py, NVIDIA H100
// 80GB HBM3, 700 W).
//
// out[r, c] = act(v + bias[c]) + residual[r, c]; bias and residual optional.
// residual may alias out: each element is read and written by one thread.
struct BiasActResidual {
  const float* bias;
  const float* residual;
  float* out;
  int n;
  int relu;
  __device__ __forceinline__ float value(int c, float v, float res) const {
    if (bias) v += bias[c];
    if (relu) v = fmaxf(v, 0.f);
    if (residual) v += res;
    return v;
  }
  __device__ __forceinline__ void operator()(int r, int c, float v) const {
    const size_t o = (size_t)r * n + c;
    out[o] = value(c, v, residual ? residual[o] : 0.f);
  }
  bool quads() const { return n % 4 == 0 && aligned16(residual) && aligned16(out); }
  struct Ld {
    float4 res;
  };
  __device__ __forceinline__ Ld load4(int r, int c) const {
    return {residual ? ld4(residual + (size_t)r * n + c) : make_float4(0.f, 0.f, 0.f, 0.f)};
  }
  __device__ __forceinline__ void store4(int r, int c, float4 v, const Ld& l) const {
    st4(out + (size_t)r * n + c,
        make_float4(value(c, v.x, l.res.x), value(c + 1, v.y, l.res.y),
                    value(c + 2, v.z, l.res.z), value(c + 3, v.w, l.res.w)));
  }
};

// A dense (m, n) output stored by TMA (kTmaStore), n % 4 == 0: out[r, c] =
// act(v + bias[c]) + in[r, c] (`in_kind` 1: the residual; 0: no `in`), as
// BiasActResidual computes it, or the sum where in[r, c] > 0, else 0
// (`in_kind` 2: the backward's dX, `in` its relu mask). `in` comes through
// in[0], the tile leaves through out[0] (make_rows_map); the residual may
// alias out.
struct DenseTmaStore {
  static constexpr bool kTmaStore = true;
  struct Maps {
    CUtensorMap in[1], out[1];
  };
  const float* bias;
  int n, relu, in_kind;
  bool quads() const { return false; }
  __device__ __forceinline__ bool tile_in() const { return in_kind != 0; }
  __device__ __forceinline__ float value(int c, float v, float in) const {
    if (in_kind == 2) return in > 0.f ? v : 0.f;
    if (bias) v += c < n ? bias[c] : 0.f;
    if (relu) v = fmaxf(v, 0.f);
    return in_kind == 1 ? v + in : v;
  }
};

// The tensor maps of an epilogue with kTmaStore (its type Maps), passed to
// the kernel as a __grid_constant__ parameter of their own: the TMA needs
// their address. The epilogue itself stays an ordinary parameter (marked
// __grid_constant__ too, K2's GEMMs ran 0-18 % slower, in turn, NVIDIA H100
// 80GB HBM3, 700 W).
struct NoMaps {};
template <class E, class = void>
struct TmaStored {
  static constexpr bool value = false;
  typedef NoMaps Maps;
};
template <class E>
struct TmaStored<E, decltype(void(E::kTmaStore))> {
  static constexpr bool value = E::kTmaStore;
  typedef typename E::Maps Maps;
};
template <class E, class = void>
struct Direct {
  static constexpr bool value = false;
};
template <class E>
struct Direct<E, decltype(void(E::kDirect))> {
  static constexpr bool value = E::kDirect;
};

// A's source: for m-tile tm, m0(tm) the tile's first output row and
// rows(tm, m) its output rows (the row-major epilogues'); ktiles(tm, k) its
// 32-deep stages; a_bytes() the bytes of A a stage brings; load(dst, map,
// tm, kt, bar) issues stage kt's A by TMA and returns W's coordinates for
// it (k, then a row offset added to the tile's first column n0); tiles_m(m)
// (host and device) the m-tiles.
//
// A (m, k) row-major by TMA through map_a, tiles of 128 rows.
struct TmaA {
  __host__ __device__ int tiles_m(int m) const { return (m + TC_BM - 1) / TC_BM; }
  __host__ __device__ int a_bytes() const { return TC_TILE_BYTES; }
  __device__ __forceinline__ int m0(int tm) const { return tm * TC_BM; }
  __device__ __forceinline__ int rows(int tm, int m) const { return min(TC_BM, m - tm * TC_BM); }
  __device__ __forceinline__ int ktiles(int, int k) const { return (k + TC_BK - 1) / TC_BK; }
  __device__ __forceinline__ int2 load(uint32_t dst, const CUtensorMap* map, int tm, int kt,
                                       uint32_t bar) const {
    tma_load_2d(dst, map, kt * TC_BK, tm * TC_BM, bar);
    return make_int2(kt * TC_BK, 0);
  }
  // (map, row, 0) of m-tile tm's output rows in an epilogue's maps (kTmaStore)
  __device__ __forceinline__ int3 out_at(int tm) const { return make_int3(0, tm * TC_BM, 0); }
};

// TmaA with each row r multiplied by scale[r / rows_per_scale] (1 without a
// scale) before its rounding to bf16; the bf16 mode only.
struct TmaAScaled : TmaA {
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

// A consumer thread's A fragments of one 32-deep stage: TF32 halves, step j's
// fragment (r, 8j+t), (r+8, 8j+t), (r, 8j+t+4), (r+8, 8j+t+4); native bf16,
// two k16 steps of four bf16 pairs, step s's (r, 16s+2t..), (r+8, 16s+2t..),
// (r, 16s+8+2t..), (r+8, 16s+8+2t..).
template <int kMode>
struct AFrag {
  uint32_t big[kMode == TC_BF16 ? 2 : 4][4], small[kMode == TC_BF16 ? 1 : 4][4];
};

// The thread's 16 values of A in stage tile `at`, in fragment order;
// element (row, col) of the swizzled tile sits at
// row*32 + ((col/4) ^ (row%8))*4 + col%4.
template <int kMode>
__device__ __forceinline__ void load_a(float (&x)[16], const float* at, int r, int g, int t) {
  if constexpr (kMode == TC_BF16) {
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at_col = (((4 * s + 2 * h + t / 2) ^ g) * 4) + 2 * (t % 2);
        const float2 lo = *reinterpret_cast<const float2*>(at + r * 32 + at_col);
        const float2 hi = *reinterpret_cast<const float2*>(at + (r + 8) * 32 + at_col);
        x[8 * s + 4 * h] = lo.x;
        x[8 * s + 4 * h + 1] = lo.y;
        x[8 * s + 4 * h + 2] = hi.x;
        x[8 * s + 4 * h + 3] = hi.y;
      }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lo = ((2 * j) ^ g) * 4 + t, hi = ((2 * j + 1) ^ g) * 4 + t;
      x[4 * j] = at[r * 32 + lo];
      x[4 * j + 1] = at[(r + 8) * 32 + lo];
      x[4 * j + 2] = at[r * 32 + hi];
      x[4 * j + 3] = at[(r + 8) * 32 + hi];
    }
  }
}

// The fragments of x: its TF32 halves, or x rounded to bf16 two to a register
// (cvt.rn.bf16x2; with kScaled rows r and r + 8 first times their factors
// fr0, fr1, as the TPU rounds the droppath-scaled gradient).
template <int kMode, bool kScaled>
__device__ __forceinline__ void make_frag(AFrag<kMode>& f, const float (&x)[16], float fr0,
                                          float fr1) {
  if constexpr (kMode == TC_BF16) {
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // pairs e = 0, 2 of row r, e = 1, 3 of row r + 8
        const float fr = e % 2 ? fr1 : fr0;
        f.big[s][e] = kScaled ? pack_bf16(x[8 * s + 2 * e] * fr, x[8 * s + 2 * e + 1] * fr)
                              : pack_bf16(x[8 * s + 2 * e], x[8 * s + 2 * e + 1]);
      }
  } else {
    static_assert(!kScaled, "A's row factors are an input of the bf16 mode");
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32_split(x[4 * j + e], f.big[j][e], f.small[j][e]);
  }
}

// One 64-column half's products of a stage into the partial d: per 8-deep
// step A_small·W_big, A_big·W_small, A_big·W_big; issued as a wgmma group
// and not waited for.
__device__ __forceinline__ void issue_half(float (&d)[32], const AFrag<TC_3XTF32>& f,
                                           uint64_t desc_big, uint64_t desc_small) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  fence_regs(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wgmma_m64n64k8_tf32(d, f.small[j], desc_big + 2 * j);
    wgmma_m64n64k8_tf32(d, f.big[j], desc_small + 2 * j);
    wgmma_m64n64k8_tf32(d, f.big[j], desc_big + 2 * j);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// The same in native bf16: the partial d = the stage's first k16 product
// (d unread) + its second, one wgmma group.
__device__ __forceinline__ void issue_half(float (&d)[32], const AFrag<TC_BF16>& f,
                                           uint64_t desc) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  wgmma_m64n64k16_bf16_rs_first(d, f.big[0], desc);
  wgmma_m64n64k16_bf16_rs(d, f.big[1], desc + 2);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keeps a fragment's registers live up to here, past the wait for the wgmma
// that read them, so nothing else is written there while they are read (a
// use that only reads them: a write would be a hazard against the wgmma that
// ptxas resolves by serializing every wgmma of the kernel).
__device__ __forceinline__ void hold(const AFrag<TC_BF16>& f) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(f.big[s][e]) : "memory");
}

// Waits until at most `kLeft` wgmma groups are in flight, then adds the
// retired partial d into acc[kOff..kOff+31] with rounded fp32 adds.
template <int kLeft, int kOff>
__device__ __forceinline__ void retire_into(float (&acc)[64], float (&d)[32]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kLeft) : "memory");
  fence_regs(d);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[kOff + i] += d[i];
}

template <int kMode>
__device__ __forceinline__ const float* stage_at(const float* tiles, uint32_t i) {
  typedef TcStage<kMode> L;
  return tiles + (i % L::kStages) * (L::kBytes / 4);
}

// The descriptor of stage i's W_big tile (which = 0) or W_small tile (1);
// + TcStage::kWHalf: its second 64 columns.
template <int kMode>
__device__ __forceinline__ uint64_t w_desc(uint32_t base, uint32_t i, int which) {
  typedef TcStage<kMode> L;
  const uint32_t at = base + (i % L::kStages) * L::kBytes + TC_TILE_BYTES;
  if constexpr (L::kNative) return sw64_desc(at);
  return sw128_desc(at + which * TC_TILE_BYTES);
}

// Stage i's shared memory may be refilled: one arrival per consumer warp.
template <int kStages>
__device__ __forceinline__ void release(uint32_t empty, uint32_t i) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(empty + 8 * (i % kStages));
}

// A consumer's products of one tile into acc, over the ring from stage `it`
// on. The tensor cores add each product into their accumulator rounding
// toward zero, an error that grows with the number of adds into one sum
// (~1e-5 relative over K = 768 where the fp32 plain version keeps ~1e-6).
// So each 32-deep stage sums into a fresh partial per 64-column half (32
// registers), which then joins acc with a rounded fp32 add, stage by stage.
// The two halves' groups are in flight together, the next stage's A is read
// from shared memory under them and split (or rounded) once they retire, and
// a stage is released once its second half retires. A second buffer of
// fragments, to issue stage kt+1 before stage kt retires, does not fit in
// 224 registers beside the partials (3xTF32 spilled; the TF32 pass ran 1.3x
// slower, ptxas serializing its wgmma; NVIDIA H100 80GB HBM3, 700 W).
template <int kMode, bool kScaled>
__device__ __forceinline__ void mainloop(float (&acc)[64], int ktiles, uint32_t it,
                                         uint32_t base, const float* tiles, uint32_t full,
                                         uint32_t empty, int r, int g, int t, float fr0,
                                         float fr1) {
  constexpr int S = TcStage<kMode>::kStages;
  constexpr uint64_t kWHalf = TcStage<kMode>::kWHalf;
  float p0[32], p1[32], x[16];
  mbar_wait(full + 8 * (it % S), (it / S) & 1);
  load_a<kMode>(x, stage_at<kMode>(tiles, it), r, g, t);
  for (int kt = 0; kt < ktiles; ++kt) {
    AFrag<kMode> f;
    make_frag<kMode, kScaled>(f, x, fr0, fr1);
    const uint64_t db = w_desc<kMode>(base, it + kt, 0);
    const uint64_t ds = w_desc<kMode>(base, it + kt, 1);
    issue_half(p0, f, db, ds);
    issue_half(p1, f, db + kWHalf, ds + kWHalf);
    const uint32_t next = it + kt + 1;
    if (kt + 1 < ktiles) {
      mbar_wait(full + 8 * (next % S), (next / S) & 1);
      load_a<kMode>(x, stage_at<kMode>(tiles, next), r, g, t);
    }
    retire_into<1, 0>(acc, p0);
    retire_into<0, 32>(acc, p1);
    release<S>(empty, it + kt);
  }
}

// A consumer thread's place in the native mainloop: the ring, its rows.
struct NativeRing {
  uint32_t base, full, empty;
  const float* tiles;
  int r, g, t;
  float fr0, fr1;  // the rows' factors (TmaAScaled)
};

// Waits for stage i and rounds its A into f.
template <bool kScaled>
__device__ __forceinline__ void native_read(const NativeRing& q, AFrag<TC_BF16>& f,
                                            float (&x)[16], uint32_t i) {
  constexpr int S = TcStage<TC_BF16>::kStages;
  mbar_wait(q.full + 8 * (i % S), (i / S) & 1);
  load_a<TC_BF16>(x, stage_at<TC_BF16>(q.tiles, i), q.r, q.g, q.t);
  make_frag<TC_BF16, kScaled>(f, x, q.fr0, q.fr1);
}

// Stage i's halves are in flight from `cur`; issues stage i + 1's from `nxt`
// as stage i's retire. No wgmma is issued or waited for under a branch.
template <bool kScaled>
__device__ __forceinline__ void native_step(const NativeRing& q, float (&acc)[64],
                                            float (&p0)[32], float (&p1)[32], float (&x)[16],
                                            const AFrag<TC_BF16>& cur, AFrag<TC_BF16>& nxt,
                                            uint32_t i) {
  constexpr int S = TcStage<TC_BF16>::kStages;
  constexpr uint64_t kWHalf = TcStage<TC_BF16>::kWHalf;
  native_read<kScaled>(q, nxt, x, i + 1);
  retire_into<1, 0>(acc, p0);
  issue_half(p0, nxt, w_desc<TC_BF16>(q.base, i + 1, 0));
  retire_into<1, 32>(acc, p1);
  hold(cur);
  release<S>(q.empty, i);
  issue_half(p1, nxt, w_desc<TC_BF16>(q.base, i + 1, 0) + kWHalf);
}

// The native bf16 mainloop: the same partials added in the same order, with
// the halves' groups staggered by half a stage: half 0 of stage kt + 1 is
// issued as soon as half 0 of stage kt retired, while half 1 of stage kt
// still runs, so the tensor cores are not left idle while a partial is
// added. Stage kt + 1's A is read and rounded into the second fragment
// buffer under stage kt's products (8 registers a buffer, where 3xTF32's
// 32 did not fit beside the partials).
template <bool kScaled>
__device__ __forceinline__ void mainloop_native(float (&acc)[64], int ktiles, uint32_t it,
                                                const NativeRing& q) {
  constexpr int S = TcStage<TC_BF16>::kStages;
  constexpr uint64_t kWHalf = TcStage<TC_BF16>::kWHalf;
  float p0[32], p1[32], x[16];
  AFrag<TC_BF16> f0, f1;
  native_read<kScaled>(q, f0, x, it);
  issue_half(p0, f0, w_desc<TC_BF16>(q.base, it, 0));
  issue_half(p1, f0, w_desc<TC_BF16>(q.base, it, 0) + kWHalf);
  const uint32_t last = it + ktiles - 1;
  for (uint32_t i = it; i < last;) {  // the buffers alternate: two stages a turn
    native_step<kScaled>(q, acc, p0, p1, x, f0, f1, i++);
    if (i == last) break;
    native_step<kScaled>(q, acc, p0, p1, x, f1, f0, i++);
  }
  retire_into<1, 0>(acc, p0);
  retire_into<0, 32>(acc, p1);
  hold(f0);
  hold(f1);
  release<S>(q.empty, last);
}

// map_w holds W's big half in rows [0, w_small) and its small half in rows
// [w_small, 2·w_small) (native bf16: the bf16 plane, no small half); A comes
// through map_a as the source `a_src` says (TmaA: A row-major; conv_taps.cuh:
// the strided conv's taps of h1 and its dH1's rows of g). `quads`:
// epi.quads() on the host.
template <class Epilogue, class ASrc, int kMode>
__global__ void __launch_bounds__(TC_THREADS, 1)
gemm_tc_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_w, int m, int n, int k, int w_small,
               ASrc a_src, Epilogue epi,
               const __grid_constant__ typename TmaStored<Epilogue>::Maps maps, int quads) {
  typedef TcStage<kMode> L;
  constexpr int S = L::kStages;
  constexpr bool kTmaStore = TmaStored<Epilogue>::value, kDirect = Direct<Epilogue>::value;
  extern __shared__ float4 tc_smem[];
  unsigned char* smem_raw = reinterpret_cast<unsigned char*>(tc_smem);
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // 128-byte swizzle wants 1,024 alignment
  float* tiles = reinterpret_cast<float*>(smem_raw + (base - raw));
  float* outs = tiles + S * L::kBytes / 4;  // the staged sums
  const uint32_t outs_at = base + S * L::kBytes;
  const uint32_t full = outs_at + TC_OUT_BYTES;
  const uint32_t empty = full + S * 8;    // S mbarriers each
  // a tile's sums are in `outs` (kDirect: the consumers have read the tile's
  // incoming values there)
  const uint32_t staged = empty + S * 8;
  // the epilogue is done with them (kTmaStore, kDirect: the tile's incoming
  // values are in `outs`)
  const uint32_t drained = staged + 8;
  const int tiles_n = (n + TC_BN - 1) / TC_BN;
  const int tile_count = tiles_n * a_src.tiles_m(m);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_init(staged, 256);                                      // every consumer thread
    mbar_init(drained, kTmaStore || kDirect ? 1 : TC_EPILOGUE);  // every epilogue thread
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The loader and consumers count the stages they have used, `it`, across
  // tiles: stage it % S, in its (it / S)-th round. Consumers and epilogue
  // count tiles, `lt`: the sums of the block's lt-th tile pass through
  // `outs` in phase lt of `staged` and `drained`.
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(TC_LOADER_REGS));
    if (threadIdx.x == 0) {  // one thread issues every load
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < tile_count; tile += gridDim.x) {
        const int n0 = (tile % tiles_n) * TC_BN, tm = tile / tiles_n;
        const int kts = a_src.ktiles(tm, k);
        for (int kt = 0; kt < kts; ++kt, ++it) {
          const int s = it % S;
          const uint32_t round = it / S;
          if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
          const uint32_t st = base + s * L::kBytes;
          mbar_expect_tx(full + 8 * s, a_src.a_bytes() + L::kWLoad);
          const int2 wk = a_src.load(st, &map_a, tm, kt, full + 8 * s);
          tma_load_2d(st + TC_TILE_BYTES, &map_w, wk.x, wk.y + n0, full + 8 * s);
          if constexpr (kMode == TC_3XTF32)
            tma_load_2d(st + 2 * TC_TILE_BYTES, &map_w, wk.x, w_small + wk.y + n0,
                        full + 8 * s);
        }
      }
    } else if (threadIdx.x < 32) {
      // warp 0's other lanes: nothing
    } else if constexpr (kTmaStore) {
      // thread 32: each tile's incoming values (epi.tile_in()) into `outs`
      // through maps.in[·] once the last tile's store has read it; the tile
      // out through maps.out[·] once the consumers staged it (the maps and
      // coordinates a_src.out_at gives). Column boxes of 32 past n are
      // skipped.
      if (threadIdx.x == 32) {
        uint32_t lt = 0;
        for (int tile = blockIdx.x; tile < tile_count; tile += gridDim.x, ++lt) {
          const int n0 = (tile % tiles_n) * TC_BN, tm = tile / tiles_n;
          const int3 at = a_src.out_at(tm);  // (map, row, window)
          const int boxes = min(TC_BN / 32, (n - n0 + 31) / 32);
          if (lt > 0) bulk_wait_all<true>();
          if (epi.tile_in()) {
            mbar_expect_tx(drained, boxes * a_src.a_bytes());
            for (int q = 0; q < boxes; ++q)
              tma_load_3d(outs_at + q * TC_TILE_BYTES, &maps.in[at.x], n0 + 32 * q, at.y, at.z,
                          drained);
          } else {
            mbar_arrive(drained);
          }
          mbar_wait(staged, lt & 1);
          for (int q = 0; q < boxes; ++q)
            tma_store_3d(&maps.out[at.x], outs_at + q * TC_TILE_BYTES, n0 + 32 * q, at.y,
                         at.z);
          bulk_commit();
        }
        bulk_wait_all<false>();
      }
    } else if constexpr (kDirect) {
      // thread 32: each tile's incoming values (epi.tile_in()) into `outs`
      // through maps.in[·] once the consumers have read the last tile's.
      // Column boxes of 32 past n are skipped.
      if (threadIdx.x == 32 && epi.tile_in()) {
        uint32_t lt = 0;
        for (int tile = blockIdx.x; tile < tile_count; tile += gridDim.x, ++lt) {
          const int n0 = (tile % tiles_n) * TC_BN, tm = tile / tiles_n;
          const int3 at = a_src.out_at(tm);  // (map, row, window)
          const int boxes = min(TC_BN / 32, (n - n0 + 31) / 32);
          if (lt > 0) mbar_wait(staged, (lt - 1) & 1);
          mbar_expect_tx(drained, boxes * a_src.a_bytes());
          for (int q = 0; q < boxes; ++q)
            tma_load_3d(outs_at + q * TC_TILE_BYTES, &maps.in[at.x], n0 + 32 * q, at.y, at.z,
                        drained);
        }
      }
    } else {
      // The epilogue: each tile's sums from `outs` through epi, while the
      // consumers run the next tile's products. Warp e2 takes rows e2,
      // e2 + kWarps, ...; a lane 4 columns (or every 32nd column without quads).
      constexpr int kWarps = TC_EPILOGUE / 32;
      constexpr int kRows = sizeof(typename Epilogue::Ld) <= 16 ? 4 : 2;  // loads in flight
      const int e = threadIdx.x - 32, e2 = e / 32, lane = e % 32;
      uint32_t lt = 0;
      for (int tile = blockIdx.x; tile < tile_count; tile += gridDim.x, ++lt) {
        const int n0 = (tile % tiles_n) * TC_BN, tm = tile / tiles_n;
        const int m0 = a_src.m0(tm);
        const int rows = a_src.rows(tm, m);
        mbar_wait(staged, lt & 1);
        if (quads) {
          const int c = n0 + 4 * lane;  // n % 4 == 0: c + 3 < n with it
          if (c < n) {
            for (int i0 = e2; i0 < rows; i0 += kWarps * kRows) {
              typename Epilogue::Ld ld[kRows];
#pragma unroll
              for (int u = 0; u < kRows; ++u)
                if (i0 + kWarps * u < rows) ld[u] = epi.load4(m0 + i0 + kWarps * u, c);
#pragma unroll
              for (int u = 0; u < kRows; ++u) {
                const int i = i0 + kWarps * u;
                if (i < rows) epi.store4(m0 + i, c, ld4(outs + i * TC_LDS + 4 * lane), ld[u]);
              }
            }
          }
        } else {
          for (int i = e2; i < rows; i += kWarps)
            for (int j = lane; j < TC_BN && n0 + j < n; j += 32)
              epi(m0 + i, n0 + j, outs[i * TC_LDS + j]);
        }
        mbar_arrive(drained);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows 64cw..64cw+63 of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(TC_CONSUMER_REGS));
  const int cw = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int r = cw * 64 + warp * 16 + g;  // this thread's rows r and r + 8 (r % 8 == g)
  uint32_t it = 0, lt = 0;
  for (int tile = blockIdx.x; tile < tile_count; tile += gridDim.x, ++lt) {
    const int tm = tile / tiles_n;
    float fr0 = 1.f, fr1 = 1.f;  // the rows' factors (TmaAScaled)
    if constexpr (RowScaled<ASrc>::value) {
      fr0 = a_src.factor(a_src.m0(tm) + r, m);
      fr1 = a_src.factor(a_src.m0(tm) + r + 8, m);
    }
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    const int kts = a_src.ktiles(tm, k);
    if (kts > 0) {
      if constexpr (kMode == TC_BF16)
        mainloop_native<RowScaled<ASrc>::value>(
            acc, kts, it, NativeRing{base, full, empty, tiles, r, g, t, fr0, fr1});
      else
        mainloop<kMode, RowScaled<ASrc>::value>(acc, kts, it, base, tiles, full, empty, r, g,
                                                 t, fr0, fr1);
    }
    it += kts;

    // accumulator i: column 8(i/4) + 2t + (i%2), row r + 8((i/2)%2); a box
    // of 32 columns in TMA's layout holds row i at 128 i bytes, 16-byte chunk
    // c at c ^ (i % 8)
    auto boxed = [&](int j) {  // float offset of (row r, columns 8j + 2t..) in `outs`
      return (j / 4) * (TC_TILE_BYTES / 4) + (((2 * (j % 4) + t / 2) ^ g) * 4) + 2 * (t % 2) +
             r * 32;
    };
    if constexpr (kTmaStore) {
      // the tile's incoming values are in `outs`, four boxes of 32 columns:
      // each sum's epi.value in its place
      mbar_wait(drained, lt & 1);
      const int c0 = (tile % tiles_n) * TC_BN + 2 * t;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = c0 + 8 * j;
        float2* p0 = reinterpret_cast<float2*>(outs + boxed(j));
        float2* p1 = reinterpret_cast<float2*>(outs + boxed(j) + 8 * 32);  // row r + 8
        const float2 m0 = *p0, m1 = *p1;
        *p0 = make_float2(epi.value(c, acc[4 * j], m0.x), epi.value(c + 1, acc[4 * j + 1], m0.y));
        *p1 = make_float2(epi.value(c, acc[4 * j + 2], m1.x),
                          epi.value(c + 1, acc[4 * j + 3], m1.y));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(staged);
    } else if constexpr (kDirect) {
      // each pair of sums written through epi.put from the registers, beside
      // the tile's incoming values (four boxes of 32 columns in `outs`)
      const bool in = epi.tile_in();
      if (in) mbar_wait(drained, lt & 1);
      const int m0 = a_src.m0(tm), rows = a_src.rows(tm, m);
      const int c0 = (tile % tiles_n) * TC_BN + 2 * t;
      const typename Epilogue::Row row0 = epi.row(m0 + min(r, rows - 1));
      const typename Epilogue::Row row1 = epi.row(m0 + min(r + 8, rows - 1));
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = c0 + 8 * j;  // n even: c + 1 < n with it
        if (c < n) {
          float2 i0 = make_float2(0.f, 0.f), i1 = i0;
          if (in) {
            i0 = *reinterpret_cast<const float2*>(outs + boxed(j));
            i1 = *reinterpret_cast<const float2*>(outs + boxed(j) + 8 * 32);
          }
          if (r < rows) epi.put(m0 + r, c, acc[4 * j], acc[4 * j + 1], i0, row0);
          if (r + 8 < rows) epi.put(m0 + r + 8, c, acc[4 * j + 2], acc[4 * j + 3], i1, row1);
        }
      }
      if (in) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(staged);
      }
    } else {
      // stage the sums for the epilogue warps once they are done with the
      // last tile's, and go on to the next tile
      if (lt > 0) mbar_wait(drained, (lt - 1) & 1);
      float* so = outs + r * TC_LDS + 2 * t;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<float2*>(so + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(so + 8 * TC_LDS + 8 * j) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      mbar_arrive(staged);
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

// A (rows, cols) bf16 row-major tensor map, boxes of 128 rows x 32 with the
// 64-byte swizzle (native bf16's W tiles); out-of-range elements read as zero.
inline bool make_bf16_tile_map(CUtensorMap* map, const void* ptr, int rows, int cols) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (!encode || cols % 8) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)TC_BK, (cuuint32_t)TC_BN};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A (rows, cols) fp32 row-major output as a 3D tensor map (cols, rows, 1),
// boxes of 32 x 128 x 1 with the 128-byte swizzle: an epilogue's maps
// (DenseTmaStore, out_at (0, row, 0)); cols % 4 == 0, 16-byte aligned.
inline bool make_rows_map(CUtensorMap* map, const float* ptr, int rows, int cols) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (!encode || cols % 4 || !aligned16(ptr)) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4, (cuuint64_t)rows * cols * 4};
  const cuuint32_t box[3] = {(cuuint32_t)TC_BK, (cuuint32_t)TC_BM, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
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

// gemm_tc_kernel<kMode> over A's source a_src (through map_a) and W (map_w,
// its small half w_small rows on in 3xTF32) into epi (with kTmaStore, its
// maps); one block per SM.
template <int kMode, class Epilogue, class ASrc>
inline cudaError_t launch_tc(const CUtensorMap& map_a, ASrc a_src, const CUtensorMap& map_w,
                             int w_small, int m, int n, int k, const Epilogue& epi,
                             cudaStream_t stream,
                             const typename TmaStored<Epilogue>::Maps& maps = {}) {
  if (m <= 0 || n <= 0 || k <= 0) return cudaErrorInvalidValue;
  const long long tiles = (long long)a_src.tiles_m(m) * ((n + TC_BN - 1) / TC_BN);
  const int sms = sm_count();
  if (tiles > (1LL << 30) || sms <= 0) return cudaErrorInvalidValue;
  auto kernel = gemm_tc_kernel<Epilogue, ASrc, kMode>;
  constexpr int smem = TcStage<kMode>::kSmem;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = tiles < sms ? (int)tiles : sms;
  kernel<<<grid, TC_THREADS, smem, stream>>>(map_a, map_w, m, n, k, w_small, a_src, epi, maps,
                                             epi.quads() ? 1 : 0);
  return cudaGetLastError();
}

// The map of W's TF32 halves with n of its rows used, the small half w_small
// rows after the big.
inline bool make_w_map(CUtensorMap* map, const float* halves, int n, int k, int w_small) {
  if (k % 4 != 0 || w_small < n || !aligned16(halves)) return false;
  return make_tile_map(map, halves, w_small + n, k, TC_BN);
}

// out = epi(A · B) in 3xTF32 with A (m, k) row-major and halves (2, n, k)
// from launch_tf32_halves; or, with w_small > 0, a slice of n rows of larger
// halves whose small half starts w_small rows after `halves`. TMA needs
// 16-byte aligned rows: k % 4 == 0 and 16-byte aligned pointers.
template <class Epilogue>
inline cudaError_t launch_gemm_tc(const float* a, const float* halves, int m, int n, int k,
                                  Epilogue epi, cudaStream_t stream, int w_small = 0) {
  if (m <= 0 || k <= 0 || k % 4 != 0 || reinterpret_cast<uintptr_t>(a) % 16)
    return cudaErrorInvalidValue;
  w_small = w_small > 0 ? w_small : n;
  CUtensorMap map_a, map_w;
  if (!make_tile_map(&map_a, a, m, k, TC_BM) || !make_w_map(&map_w, halves, n, k, w_small))
    return cudaErrorInvalidValue;
  return launch_tc<TC_3XTF32>(map_a, TmaA{}, map_w, w_small, m, n, k, epi, stream);
}

// The bf16 rung in native bf16: out = epi(bf16(A) · plane) with A (m, k)
// fp32 row-major and plane (n, k) W's bf16 plane (torch.bfloat16), fp32
// sums. With a_src a TmaAScaled, row r of A is multiplied by its factor
// before its rounding. TMA needs 16-byte aligned rows: k % 8 == 0 and
// 16-byte aligned pointers.
template <class Epilogue, class ASrc = TmaA>
inline cudaError_t launch_gemm_bf16(const float* a, const void* plane, int m, int n, int k,
                                    Epilogue epi, cudaStream_t stream, ASrc a_src = {},
                                    const typename TmaStored<Epilogue>::Maps& maps = {}) {
  if (m <= 0 || k <= 0 || k % 8 != 0 || !aligned16(a) || !aligned16(plane))
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_w;
  if (!make_tile_map(&map_a, a, m, k, TC_BM) || !make_bf16_tile_map(&map_w, plane, n, k))
    return cudaErrorInvalidValue;
  return launch_tc<TC_BF16>(map_a, a_src, map_w, n, m, n, k, epi, stream, maps);
}

// launch_gemm_bf16 into out (m, n) through DenseTmaStore: `in` (the residual
// with in_kind 1, the mask with 2; else null) comes in by TMA.
template <class ASrc = TmaA>
inline cudaError_t launch_gemm_bf16_tma(const float* a, const void* plane, int m, int n, int k,
                                        DenseTmaStore epi, const float* in, float* out,
                                        cudaStream_t stream, ASrc a_src = {}) {
  DenseTmaStore::Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (m <= 0 || (epi.in_kind != 0) != (in != nullptr) ||
      !make_rows_map(&maps.out[0], out, m, n) || (in && !make_rows_map(&maps.in[0], in, m, n)))
    return cudaErrorInvalidValue;
  return launch_gemm_bf16(a, plane, m, n, k, epi, stream, a_src, maps);
}

// ---- gemm_atb_kernel -------------------------------------------------------

constexpr int AB_BM = 128, AB_BN = 128, AB_BK = 32;
constexpr int AB_THREADS = 384;  // warpgroup 0 (thread 0 loads, all 128 gather), two consumers
// 128 x 40 + 256 x 232 = 384 x 168, the launch's own: setmaxnreg.inc waits for
// registers that warpgroup 0 gives back, so the split cannot exceed it
constexpr int AB_LOADER_REGS = 40, AB_CONSUMER_REGS = 232;
constexpr int AB_ROWS_BYTES = AB_BK * AB_BM * 4;  // a stage's 32 rows of X's (or dY's) 128 columns
constexpr int AB_STAGES = 5;                       // the ring of rows

// Shared memory: two operand buffers that the wgmma read, then a ring of
// AB_STAGES stages of the 32 rows of X and of dY as they came from device
// memory. The rows: four boxes of 32 columns, 4,096 bytes apart, each 32
// rows (k) of 128 bytes with the 128-byte swizzle (float (k, c) of a box at
// k·32 + ((c/4) ^ (k%8))·4 + c%4), as TMA writes them. An operand buffer:
//   3xTF32: (s ⊙ dY)ᵀ's TF32 halves, big then small, each 128 n-rows x 32 k
//           K-major with the 128-byte swizzle (element (n, k) at float
//           n·32 + ((k/4) ^ (n%8))·4 + k%4), as gemm_tc_kernel's W tiles;
//   bf16:   Xᵀ then s ⊙ dY rounded to bf16, each 128 (m or n) x 32 k
//           MN-major with the 128-byte swizzle: two atoms of 64 columns, an
//           atom 32 rows (k) of 128 bytes, 16-byte chunk c of row k at
//           chunk c ^ (k%8).
template <bool kBf16>
struct AbLayout {
  static constexpr int kOps = kBf16 ? 2 * AB_BK * AB_BM * 2 : 2 * AB_BK * AB_BN * 4;
  static constexpr int kRows = 2 * AB_ROWS_BYTES;  // a stage: X's rows, then dY's
  static constexpr int kSmem = 2 * kOps + AB_STAGES * kRows + 2 * AB_STAGES * 8 + 1024;
};

// Float (k, c) of a stage's rows: box c/32, row k, swizzled 16-byte chunk.
__device__ __forceinline__ int ab_at(int k, int c) {
  return (c / 32) * 1024 + k * 32 + ((c % 32) ^ ((k % 8) * 4));  // chunk ^ (k % 8), in floats
}

// X (rows, m) row-major, loaded by TMA (gemm_atb_kernel's map_x).
struct DenseRows {
  static constexpr bool kGather = false;
};

// wgmma descriptor of one 64-column atom of an MN-major bf16 tile with the
// 128-byte swizzle: 8-row (k) groups 1,024 bytes apart (the stride byte
// offset). The leading byte offset, the atom stride, is never read: the
// operand spans one atom along m or n. A step of 16 along k adds 2,048
// bytes (128 in the address field).
__device__ __forceinline__ uint64_t mn_sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 64) = a (64 x 8, registers) · b (8 x 64, shared memory), d's old
// values unread: a partial's first product, with d write-only, so its
// registers are free between the partial's add and the next partial
__device__ __forceinline__ void wgmma_m64n64k8_tf32_first(float (&d)[32], const uint32_t (&a)[4],
                                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),
        "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(0));
}

// d (64 x 64) = a (64 x 16) · b (16 x 64), both bf16 MN-major in shared
// memory (the transpose bits), plus d when `acc`
__device__ __forceinline__ void wgmma_m64n64k16_bf16_mn(float (&d)[32], uint64_t desc_a,
                                                        uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(acc));
}

// Warpgroup 0's share of a stage's gathered X rows (ConvTaps): thread p
// copies 16-byte piece p % 8 of box b of rows p / 8 and p / 8 + 16 (eight
// threads a 128-byte box row: coalesced reads, conflict-free writes) with
// cp.async, zeros where a tap reads none, past m or past the chunk; `taps`
// holds the tap of its column in each box. One arrival on `full` once they
// land.
template <class XSrc>
__device__ __forceinline__ void ab_gather_rows(const XSrc& x_at, int k0, int k_end, int m0,
                                               int m, const int (&taps)[4], float* xs,
                                               uint32_t full) {
  const int p = threadIdx.x, qb = p % 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = p / 8 + 16 * i, gk = k0 + k;
    const typename XSrc::Row row = x_at.row(gk);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = m0 + 32 * b + 4 * qb;
      const float* src = gk < k_end && c < m ? x_at.at(row, c, taps[b]) : nullptr;
      cp_async16(xs + ab_at(k, 32 * b + 4 * qb), src ? src : x_at.h1, src ? 16 : 0);
    }
  }
  cp_async_mbar_arrive(full);
}

// The two consumer warpgroups' barrier (named barrier 1): a stage's operand
// buffer is whole, and the products that read the other buffer retired.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// part[z] (m, n) = Xᵀ · (s ⊙ dY) over rows [z·k_split, (z+1)·k_split): one
// 128 x 128 output tile and one row chunk per block. X by TMA through map_x
// (DenseRows) or gathered from h1 (ConvTaps, conv_taps.cuh: zero where a tap
// reads none); dY by TMA through map_y. Rows past the chunk reach the
// products as zeros; columns past m or n are never written.
template <class XSrc, bool kBf16>
__global__ void __launch_bounds__(AB_THREADS, 1)
gemm_atb_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_y, XSrc x_at,
                const float* __restrict__ scale, int rows_per_scale, float* __restrict__ part,
                int m, int n, int rows, int k_split) {
  typedef AbLayout<kBf16> L;
  constexpr int S = AB_STAGES;
  extern __shared__ float4 ab_smem[];
  unsigned char* smem_raw = reinterpret_cast<unsigned char*>(ab_smem);
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzled tiles want 1,024 alignment
  unsigned char* ops_smem = smem_raw + (base - raw);  // the two operand buffers
  unsigned char* rows_smem = ops_smem + 2 * L::kOps;  // the ring of rows
  const uint32_t full = base + 2 * L::kOps + S * L::kRows;  // S mbarriers each: rows landed,
  const uint32_t empty = full + S * 8;                      // rows read
  const int m0 = blockIdx.y * AB_BM, n0 = blockIdx.x * AB_BN;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(rows, k_begin + k_split);
  const int ktiles = k_end > k_begin ? (k_end - k_begin + AB_BK - 1) / AB_BK : 0;
  auto xs_of = [&](int s) { return reinterpret_cast<float*>(rows_smem + s * L::kRows); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, XSrc::kGather ? 129 : 1);  // + each gathering thread
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(AB_LOADER_REGS));
    if (!XSrc::kGather && threadIdx.x > 0) return;
    // the loader: thread 0 issues TMA boxes of 32 rows x 32 columns; with a
    // gathered X all 128 threads copy its rows
    int taps[4] = {0, 0, 0, 0};  // the tap of each box's column (ConvTaps)
    if constexpr (XSrc::kGather)
      for (int b = 0; b < 4; ++b) taps[b] = (m0 + 32 * b + 4 * (threadIdx.x % 8)) / x_at.hidden;
    for (int it = 0; it < ktiles; ++it) {
      const int s = it % S;
      if (it >= S) mbar_wait(empty + 8 * s, (it / S - 1) & 1);
      const int k0 = k_begin + it * AB_BK;
      const uint32_t xs = smem_addr(xs_of(s)), ys = xs + AB_ROWS_BYTES;
      if (threadIdx.x == 0) {
        mbar_expect_tx(full + 8 * s, XSrc::kGather ? AB_ROWS_BYTES : 2 * AB_ROWS_BYTES);
        for (int b = 0; b < AB_BN / 32; ++b)
          tma_load_2d(ys + b * 4096, &map_y, n0 + 32 * b, k0, full + 8 * s);
        if constexpr (!XSrc::kGather)
          for (int b = 0; b < AB_BM / 32; ++b)
            tma_load_2d(xs + b * 4096, &map_x, m0 + 32 * b, k0, full + 8 * s);
      }
      if constexpr (XSrc::kGather)
        ab_gather_rows(x_at, k0, k_end, m0, m, taps, xs_of(s), full + 8 * s);
    }
    return;
  }

  // consumers: warpgroup cw owns rows 64cw..64cw+63 of the tile (X's columns),
  // as two 64-column halves. Stage it's products (into fresh partials, which
  // join the fp32 accumulators with a rounded add once they retire) run while
  // both warpgroups write stage it + 1's operand buffer from its rows, each
  // its share, and release the rows; a barrier of the two ends each stage.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(AB_CONSUMER_REGS));
  const int cw = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int r = cw * 64 + warp * 16 + g;  // this thread's rows r and r + 8 of the tile
  float acc[64], p[2][32];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // Stage it's rows into operand buffer it % 2, rows past the chunk as zeros,
  // dY's rows times their factors; bf16: then the rows are released (3xTF32:
  // once this thread's Xᵀ fragments are read from them).
  auto convert = [&](int it) {
    const int s = it % S, k0 = k_begin + it * AB_BK, valid = k_end - k0;
    const float f_lane = scale && lane < valid ? scale[(k0 + lane) / rows_per_scale] : 1.f;
    mbar_wait(full + 8 * s, (it / S) & 1);
    const float* xs = xs_of(s);
    const float* ys = xs + AB_ROWS_BYTES / 4;
    unsigned char* ops = ops_smem + (it % 2) * L::kOps;
    if constexpr (kBf16) {
      // this warpgroup's 64 columns of X (into Xᵀ's atom cw) and of dY (into
      // s ⊙ dY's atom cw): thread tid takes columns 64cw + 4(tid % 16).. of
      // rows tid / 16 + 8i
      const int q = tid % 16, col = 64 * cw + 4 * q;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = tid / 16 + 8 * i;
        const float f = __shfl_sync(0xffffffffu, f_lane, k);
        float4 vx = ld4(xs + ab_at(k, col)), vy = ld4(ys + ab_at(k, col));
        if (scale) vy = make_float4(vy.x * f, vy.y * f, vy.z * f, vy.w * f);
        if (k >= valid) vx = vy = make_float4(0.f, 0.f, 0.f, 0.f);
        const int off = cw * (AB_BK * 128) + k * 128 + (((q / 2) ^ (k % 8)) * 16) + (q % 2) * 8;
        *reinterpret_cast<uint2*>(ops + off) = make_uint2(pack_bf16(vx.x, vx.y),
                                                          pack_bf16(vx.z, vx.w));
        *reinterpret_cast<uint2*>(ops + AB_BK * AB_BM * 2 + off) =
            make_uint2(pack_bf16(vy.x, vy.y), pack_bf16(vy.z, vy.w));
      }
    } else {
      // lane k transposes dY's row k, times its factor, into the K-major
      // halves: this warp's n-quads 16cw + 4warp + u of the row to rows
      // 4q..4q+3 of both tiles
      const int k = lane;
      uint32_t* big = reinterpret_cast<uint32_t*>(ops);
      uint32_t* small = big + AB_BN * AB_BK;
#pragma unroll 2  // fully unrolled it spilled
      for (int u = 0; u < 4; ++u) {
        const int q = 16 * cw + 4 * warp + u;
        const float4 v = ld4(ys + ab_at(k, 4 * q));
        const float e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int nn = 4 * q + e;
          const int at = nn * AB_BK + (k ^ ((nn % 8) * 4));  // chunk k/4 ^ (nn % 8)
          tf32_split(k < valid ? e4[e] * f_lane : 0.f, big[at], small[at]);
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if constexpr (kBf16) release<S>(empty, s);  // 3xTF32: X's rows are read next
  };

  if (ktiles > 0) {
    convert(0);
    consumers_sync();
  }
  for (int it = 0; it < ktiles; ++it) {
    const uint32_t ops = base + (it % 2) * L::kOps;
    if constexpr (kBf16) {
      const uint64_t da = mn_sw128_desc(ops + cw * (AB_BK * 128));
      const uint64_t db = mn_sw128_desc(ops + AB_BK * AB_BM * 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        const uint64_t dbh = db + h * (AB_BK * 128 >> 4);
        wgmma_m64n64k16_bf16_mn(p[h], da, dbh, 0);
        wgmma_m64n64k16_bf16_mn(p[h], da + (2048 >> 4), dbh + (2048 >> 4), 1);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      }
    } else {
      // Xᵀ's fragments of steps j0, j0 + 1 (step j: (r, 8j+t), (r+8, 8j+t),
      // (r, 8j+t+4), (r+8, 8j+t+4)) split into TF32 halves, then their
      // products for both halves; the stage in two such passes, the second
      // once the first's retired (two steps' fragments in registers, not four)
      const float* xs = xs_of(it % S);
      const int valid = k_end - k_begin - it * AB_BK;
      const uint64_t db = sw128_desc(ops);
      const uint64_t ds = db + (AB_BN * AB_BK * 4 >> 4);
      uint32_t fb[2][4], fsm[2][4];
#pragma unroll
      for (int j0 = 0; j0 < 4; j0 += 2) {
        if (j0 > 0) asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int k_lo = 8 * (j0 + jj) + t, k_hi = k_lo + 4;
          const float x4[4] = {k_lo < valid ? xs[ab_at(k_lo, r)] : 0.f,
                               k_lo < valid ? xs[ab_at(k_lo, r + 8)] : 0.f,
                               k_hi < valid ? xs[ab_at(k_hi, r)] : 0.f,
                               k_hi < valid ? xs[ab_at(k_hi, r + 8)] : 0.f};
#pragma unroll
          for (int e = 0; e < 4; ++e) tf32_split(x4[e], fb[jj][e], fsm[jj][e]);
        }
        if (j0 > 0) release<S>(empty, it % S);  // X's rows read
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = j0 + jj;
            const uint64_t off = 2 * j + h * kHalf;  // 8 deep: 32 bytes; 64 rows of n: kHalf
            if (j == 0)
              wgmma_m64n64k8_tf32_first(p[h], fsm[jj], db + off);
            else
              wgmma_m64n64k8_tf32(p[h], fsm[jj], db + off);
            wgmma_m64n64k8_tf32(p[h], fb[jj], ds + off);
            wgmma_m64n64k8_tf32(p[h], fb[jj], db + off);
          }
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        }
      }
    }
    // the next stage's operands under the products: bf16 under both halves;
    // 3xTF32 under the second, once the first's partial has joined acc
    // (under both, its transposition spilled at 232 registers)
    if (kBf16 && it + 1 < ktiles) convert(it + 1);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_regs(p[0]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += p[0][i];
    if (!kBf16 && it + 1 < ktiles) convert(it + 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(p[1]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[32 + i] += p[1][i];
    consumers_sync();
  }

  // accumulator 32h + i: column 64h + 8(i/4) + 2t + (i%2), row r + 8((i/2)%2)
  float* out = part + (size_t)blockIdx.z * m * n;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + 64 * h + 8 * j + 2 * t, row = m0 + r;
      if (col >= n) continue;  // n % 4 == 0: col + 1 < n with it
      const float* a = acc + 32 * h + 4 * j;
      if (row < m)
        *reinterpret_cast<float2*>(out + (size_t)row * n + col) = make_float2(a[0], a[1]);
      if (row + 8 < m)
        *reinterpret_cast<float2*>(out + (size_t)(row + 8) * n + col) = make_float2(a[2], a[3]);
    }
}

// part (splits, m, n): chunk z of Xᵀ · (dY * scale[row / rows_per_scale])
// over rows [z·k_split, (z+1)·k_split), k_split a multiple of 32; X (rows,
// m) row-major (x, DenseRows) or the conv's taps (ConvTaps, x_at), dY (rows,
// n) row-major; both 16-byte aligned with m and n multiples of 4 (TMA's
// 16-byte rows). kBf16: the bf16 mode (X and the scaled dY rounded to bf16).
template <bool kBf16, class XSrc>
inline cudaError_t launch_atb(const float* x, XSrc x_at, const float* dy, const float* scale,
                              int rows_per_scale, float* part, int m, int n, int rows,
                              int splits, cudaStream_t stream) {
  if (m <= 0 || n <= 0 || rows <= 0 || splits <= 0 || splits > 65535 || m % 4 || n % 4 ||
      (scale && rows_per_scale <= 0) || !aligned16(dy) || !aligned16(x))
    return cudaErrorInvalidValue;
  if ((m + AB_BM - 1) / AB_BM > 65535) return cudaErrorInvalidValue;
  int k_split = (rows + splits - 1) / splits;
  k_split = (k_split + AB_BK - 1) / AB_BK * AB_BK;
  CUtensorMap map_x, map_y;
  memset(&map_x, 0, sizeof(map_x));
  if (!make_tile_map(&map_y, dy, rows, n, AB_BK) ||
      (!XSrc::kGather && !make_tile_map(&map_x, x, rows, m, AB_BK)))
    return cudaErrorInvalidValue;
  auto kernel = gemm_atb_kernel<XSrc, kBf16>;
  constexpr int smem = AbLayout<kBf16>::kSmem;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + AB_BN - 1) / AB_BN, (m + AB_BM - 1) / AB_BM, splits);
  kernel<<<grid, AB_THREADS, smem, stream>>>(map_x, map_y, x_at, scale, rows_per_scale, part, m,
                                             n, rows, k_split);
  return cudaGetLastError();
}

// X (rows, m) row-major.
template <bool kBf16 = false>
inline cudaError_t launch_gemm_atb(const float* x, const float* dy, const float* scale,
                                   int rows_per_scale, float* part, int m, int n, int rows,
                                   int splits, cudaStream_t stream) {
  return launch_atb<kBf16>(x, DenseRows{}, dy, scale, rows_per_scale, part, m, n, rows, splits,
                           stream);
}

// X the conv's taps gathered from h1 (ConvTaps).
template <bool kBf16 = false, class Gather>
inline cudaError_t launch_gemm_atb_gather(Gather x_at, const float* dy, const float* scale,
                                          int rows_per_scale, float* part, int m, int n,
                                          int rows, int splits, cudaStream_t stream) {
  return launch_atb<kBf16>(x_at.h1, x_at, dy, scale, rows_per_scale, part, m, n, rows, splits,
                           stream);
}

}  // namespace uu
