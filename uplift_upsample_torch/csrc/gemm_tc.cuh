// A tensor-core GEMM at fp32-level error for Hopper: 3xTF32 on wgmma, fed by
// TMA. Used by the s2t prologue (s2t.cu); gemm.cuh's SIMT tile loop serves
// the other kernels.
//
// out = epilogue(A · B) with A (m, k) fp32 row-major and B given as the two
// TF32 halves of W (k, n): `launch_tf32_split` writes W_big = tf32(W) and
// W_small = tf32(W - W_big), each transposed to (n, k) (K-major, as TF32
// wgmma needs both operands), into one (2, n, k) buffer. The epilogue is a
// functor `epi(r, c, v)` called once per output element, gemm.cuh's
// interface, so a product of gemm.cuh's row-major A and W moves here by
// changing its launch call (and splitting its W once).
//
// Bound: operations. 3xTF32 takes three TF32 products per fp32 one; at the
// s2t prologue's 72,704 x 544 x 384 that is 3 x 30.4 GFLOP, 0.184 ms at the
// 495 TFLOP/s dense TF32 peak, against 0.081 ms for its 271 MB.
//
// Design: one block per 128 x 128 output tile (n fastest, so the blocks that
// share an A tile run together and A comes from device memory about once),
// 384 threads:
//  - warpgroup 0 is the producer: one thread keeps a ring of 4 shared-memory
//    stages filled with TMA loads (A 128 x 32, W_big and W_small 128 x 32,
//    128-byte swizzle), each stage guarded by a full and an empty mbarrier;
//  - warpgroups 1 and 2 are consumers, 64 rows each: per 32-deep stage a
//    thread loads its A fragments from shared memory, splits them into TF32
//    halves in registers, and issues wgmma.m64n128k8 three times per 8-deep
//    step (A_small·W_big, A_big·W_small, A_big·W_big) with B read from
//    shared memory through descriptors; fp32 accumulators stay in registers;
//  - the epilogue runs from the accumulator registers: only rows < m and
//    columns < n are written. TMA fills rows and columns past the ends of A
//    with zeros.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// d (64 x 128 per warpgroup) += a (64 x 8, registers) · b (8 x 128, shared memory)
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <class Epilogue>
__global__ void __launch_bounds__(TC_THREADS, 1)
gemm_tc_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_w, int m, int n, int k,
               Epilogue epi) {
  extern __shared__ float4 tc_smem[];
  unsigned char* smem_raw = reinterpret_cast<unsigned char*>(tc_smem);
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // 128-byte swizzle wants 1,024 alignment
  float* tiles = reinterpret_cast<float*>(smem_raw + (base - raw));
  const uint32_t full = base + TC_STAGES * TC_STAGE_BYTES;  // TC_STAGES mbarriers
  const uint32_t empty = full + TC_STAGES * 8;              // TC_STAGES mbarriers
  const int ktiles = (k + TC_BK - 1) / TC_BK;
  const int n0 = blockIdx.x * TC_BN, m0 = blockIdx.y * TC_BM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues every load
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % TC_STAGES;
        const uint32_t round = kt / TC_STAGES;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        const uint32_t st = base + s * TC_STAGE_BYTES;
        mbar_expect_tx(full + 8 * s, TC_STAGE_BYTES);
        tma_load_2d(st, &map_a, kt * TC_BK, m0, full + 8 * s);
        tma_load_2d(st + TC_TILE_BYTES, &map_w, kt * TC_BK, n0, full + 8 * s);
        tma_load_2d(st + 2 * TC_TILE_BYTES, &map_w, kt * TC_BK, n + n0, full + 8 * s);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows 64cw..64cw+63 of the tile
  const int cw = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int r = cw * 64 + warp * 16 + g;  // this thread's rows r and r + 8 (r % 8 == g)
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % TC_STAGES;
    mbar_wait(full + 8 * s, (kt / TC_STAGES) & 1);
    const float* at = tiles + s * (TC_STAGE_BYTES / 4);
    const uint32_t wb = base + s * TC_STAGE_BYTES + TC_TILE_BYTES;
    const uint64_t desc_big = sw128_desc(wb), desc_small = sw128_desc(wb + TC_TILE_BYTES);
    // A fragment of step j: (r, 8j+t), (r+8, 8j+t), (r, 8j+t+4), (r+8, 8j+t+4);
    // element (row, col) of the swizzled tile sits at
    // row*32 + ((col/4) ^ (row%8))*4 + col%4
    uint32_t a_big[4][4], a_small[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lo = ((2 * j) ^ g) * 4 + t, hi = ((2 * j + 1) ^ g) * 4 + t;
      tf32_split(at[r * 32 + lo], a_big[j][0], a_small[j][0]);
      tf32_split(at[(r + 8) * 32 + lo], a_big[j][1], a_small[j][1]);
      tf32_split(at[r * 32 + hi], a_big[j][2], a_small[j][2]);
      tf32_split(at[(r + 8) * 32 + hi], a_big[j][3], a_small[j][3]);
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_m64n128k8_tf32(acc, a_small[j], desc_big + 2 * j);
      wgmma_m64n128k8_tf32(acc, a_big[j], desc_small + 2 * j);
      wgmma_m64n128k8_tf32(acc, a_big[j], desc_big + 2 * j);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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

// W (k, n) row-major -> split (2, n, k): [0] = tf32(W)ᵀ, [1] = tf32(W - tf32(W))ᵀ.
static __global__ void tf32_split_kernel(const float* __restrict__ w, float* __restrict__ split,
                                         int k, int n) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;  // along n: coalesced reads
  const int kk = blockIdx.y;
  if (col >= n) return;
  uint32_t big, small;
  tf32_split(w[(size_t)kk * n + col], big, small);
  split[(size_t)col * k + kk] = __uint_as_float(big);
  split[((size_t)n + col) * k + kk] = __uint_as_float(small);
}

inline cudaError_t launch_tf32_split(const float* w, float* split, int k, int n,
                                     cudaStream_t stream) {
  if (k <= 0 || n <= 0 || k > 65535) return cudaErrorInvalidValue;
  tf32_split_kernel<<<dim3((n + 127) / 128, k), 128, 0, stream>>>(w, split, k, n);
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

// out = epi(A · W) with A (m, k) row-major and w_split from launch_tf32_split.
// TMA needs 16-byte aligned rows: k % 4 == 0 and 16-byte aligned pointers.
template <class Epilogue>
inline cudaError_t launch_gemm_tc(const float* a, const float* w_split, int m, int n, int k,
                                  Epilogue epi, cudaStream_t stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 4 != 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(w_split) % 16)
    return cudaErrorInvalidValue;
  const long long tiles_m = (m + TC_BM - 1) / TC_BM;
  if (tiles_m > 65535) return cudaErrorInvalidValue;
  CUtensorMap map_a, map_w;
  if (!make_tile_map(&map_a, a, m, k, TC_BM) || !make_tile_map(&map_w, w_split, 2 * n, k, TC_BN))
    return cudaErrorInvalidValue;
  auto kernel = gemm_tc_kernel<Epilogue>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + TC_BN - 1) / TC_BN, (unsigned)tiles_m);
  kernel<<<grid, TC_THREADS, TC_SMEM_BYTES, stream>>>(map_a, map_w, m, n, k, epi);
  return cudaGetLastError();
}

}  // namespace uu
