// Row 11's kernels (packed multi-head attention on (F, S, H·D) q, k and v),
// shared by attention.cu (fp32 tensors, fp32-level products) and
// attention_bf16.cu (the bf16 rung, and bf16 tensors). The design notes are
// attention.cu's; `packed_attention` at the end is the rule that picks a
// kernel by shape.
//
// Two compile-time choices of every kernel, so the fp32 instances keep
// their code:
//  - BF16, the one-pass bf16 rung (EVAL_MATMUL_PRECISION "default"), the
//    function `pallas_attention._head_attention` computes under
//    `default_matmul_precision("default")`: at head depth D <= 8 the logits
//    are fp32 FMAs with no rounding (pallas_attention.py:36-41: the VPU
//    path), beyond 8 one bf16 pass on q and k with fp32 sums (:43-44); the
//    logits scaled after the product, the softmax fp32; P·V one bf16 pass
//    on the normalised probabilities and on v, fp32 sums (:49-50). The
//    short kernels normalise P before the product (the fp32 ones after it),
//    so the thread per task takes its keys twice: once for the row's max
//    and sum, once for P·V.
//  - T, the tensors' element type: float, or __nv_bfloat16 for the bf16
//    operands of COMPUTE_DTYPE bfloat16 (pallas_attention.py:63-66: the
//    kernel widens them to fp32, computes at the ambient rung, and writes
//    q's dtype, :118). The kernels load bf16 (8 bytes where fp32 loads 16),
//    widen in registers, and round the context to bf16 as they store it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention.cuh"

namespace uu {
namespace packed {

constexpr int SHORT_MAX_FLOATS = 1536;  // S·C of the two short-sequence kernels
constexpr int GROUP_FLOATS = 2176;      // K (or V) values a stage holds: 4 frames of 17 x 32
constexpr int STAGES = 3;               // the ring: two groups staged ahead of the one computed
constexpr int CHUNK = 17;               // logits a task holds at once: a pose's 17 joints
constexpr int LANE_WARPS = 4;           // warps (frames) of a lane_attention_kernel block
constexpr int TASK_BLOCKS = 2;          // blocks per SM the 17 x 32 instance's registers allow
constexpr int SMALL_DEPTH = 8;          // D at or below which the logits are fp32 FMAs
constexpr float MASK_LOG2 = -1e9f * ATTN_LOG2E;  // a blocked key's logit, in base 2

__device__ __forceinline__ float4 widen4(uint2 raw) {
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}

// four values from device memory (read-only path)
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  return widen4(__ldg(reinterpret_cast<const uint2*>(p)));
}

// four values from shared memory
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  return widen4(*reinterpret_cast<const uint2*>(p));
}

// four context values to device memory, streaming; bf16: rounded to nearest even
__device__ __forceinline__ void store4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  uint2 raw;
  raw.x = (bf16_round(v.x) >> 16) | bf16_round(v.y);
  raw.y = (bf16_round(v.z) >> 16) | bf16_round(v.w);
  __stcs(reinterpret_cast<uint2*>(p), raw);
}

__device__ __forceinline__ float4 round4(float4 a) {
  return make_float4(bf16_roundf(a.x), bf16_roundf(a.y), bf16_roundf(a.z), bf16_roundf(a.w));
}

__device__ __forceinline__ float4 fma4(float a, float4 b, float4 c) {
  return make_float4(fmaf(a, b.x, c.x), fmaf(a, b.y, c.y), fmaf(a, b.z, c.z), fmaf(a, b.w, c.w));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// 2^x by the SFU alone (ex2.approx.ftz: relative error ~2^-22; results
// below 2^-126 flush to 0, as a softmax weight that small adds nothing).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The mbarrier forms gemm_tc.cuh uses, with a wait that traps instead of
// spinning forever if a phase never completes.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

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

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory by the TMA unit, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// ---- the 3-token regime: a warp per frame, lanes owning channels -----------

// Query row `qr` (the lane's NV float4) against the frame's S keys: the
// context slice of the lane, normalised. `lph` lanes make a head. BF16: the
// caller rounded q, k and v; the probabilities are normalised, then rounded.
template <int NV, int SMAX, bool BF16>
__device__ __forceinline__ void lane_attend(const float4 (&qr)[NV], const float4 (&kr)[SMAX][NV],
                                            const float4 (&vr)[SMAX][NV],
                                            const float (&mk)[SMAX], int s, int lph,
                                            float scale2, float4 (&o)[NV]) {
  float lg[SMAX];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < SMAX; ++j) {
    if (j < s) {
      float dot = 0.f;
#pragma unroll
      for (int u = 0; u < NV; ++u) dot = dot4(qr[u], kr[j][u], dot);
      for (int w = 1; w < lph; w <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, w);
      lg[j] = fmaf(dot, scale2, mk[j]);
      m = fmaxf(m, lg[j]);
    }
  }
  float l = 0.f;
#pragma unroll
  for (int u = 0; u < NV; ++u) o[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (BF16) {
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      if (j < s) {
        lg[j] = fast_exp2(lg[j] - m);
        l += lg[j];
      }
    }
    const float inv = 1.f / l;
#pragma unroll
    for (int j = 0; j < SMAX; ++j) {
      if (j < s) {
        const float p = bf16_roundf(lg[j] * inv);
#pragma unroll
        for (int u = 0; u < NV; ++u) o[u] = fma4(p, vr[j][u], o[u]);
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < SMAX; ++j) {
    if (j < s) {
      const float p = fast_exp2(lg[j] - m);
      l += p;
#pragma unroll
      for (int u = 0; u < NV; ++u) o[u] = fma4(p, vr[j][u], o[u]);
    }
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int u = 0; u < NV; ++u)
    o[u] = make_float4(o[u].x * inv, o[u].y * inv, o[u].z * inv, o[u].w * inv);
}

// C = 128·NV channels, so a lane owns NV float4 of every token; S·C <= 1,536
// bounds the tokens a frame holds in registers. BF16 rounds v, and q and k
// where `round_qk` (packed_attention's rule), as they are loaded.
template <int NV, bool BF16, typename T>
__global__ void __launch_bounds__(LANE_WARPS * 32)
lane_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ key_mask,
                      T* __restrict__ out, int frames, int s, int lph, float scale2,
                      bool round_qk) {
  constexpr int C = 128 * NV;
  constexpr int SMAX = SHORT_MAX_FLOATS / C;
  const int f = blockIdx.x * LANE_WARPS + threadIdx.x / 32;
  if (f >= frames) return;  // a whole warp: the shuffles below see every lane
  const size_t base = (size_t)f * s * C + (threadIdx.x % 32) * 4 * NV;
  float4 kr[SMAX][NV], vr[SMAX][NV];
  float mk[SMAX];
#pragma unroll
  for (int j = 0; j < SMAX; ++j) {
    mk[j] = 0.f;
    if (j < s) {
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        kr[j][u] = load4(k + base + (size_t)j * C + 4 * u);
        vr[j][u] = load4(v + base + (size_t)j * C + 4 * u);
        if constexpr (BF16) {
          if (round_qk) kr[j][u] = round4(kr[j][u]);
          vr[j][u] = round4(vr[j][u]);
        }
      }
      if (key_mask) mk[j] = key_mask[(size_t)f * s + j] * MASK_LOG2;
    }
  }
#pragma unroll
  for (int i = 0; i < SMAX; ++i) {
    if (i < s) {
      float4 qr[NV], o[NV];
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        qr[u] = load4(q + base + (size_t)i * C + 4 * u);
        if constexpr (BF16) {
          if (round_qk) qr[u] = round4(qr[u]);
        }
      }
      lane_attend<NV, SMAX, BF16>(qr, kr, vr, mk, s, lph, scale2, o);
#pragma unroll
      for (int u = 0; u < NV; ++u) store4(out + base + (size_t)i * C + 4 * u, o[u]);
    }
  }
}

template <int NV, bool BF16, typename T>
cudaError_t launch_lane_attention(const T* q, const T* k, const T* v, const float* key_mask,
                                  T* out, int frames, int s, int heads, bool round_qk,
                                  cudaStream_t stream) {
  const int blocks = (frames + LANE_WARPS - 1) / LANE_WARPS;
  lane_attention_kernel<NV, BF16, T><<<blocks, LANE_WARPS * 32, 0, stream>>>(
      q, k, v, key_mask, out, frames, s, 32 / heads, attn_scale2(128 * NV / heads), round_qk);
  return cudaGetLastError();
}

// ---- the spatial regime: a thread per (frame, query, head) task ------------

// Threads of a block: one per task of a group, whose K holds at most
// GROUP_FLOATS values, so at most GROUP_FLOATS / D tasks.
template <int D>
constexpr int task_threads() {
  return (GROUP_FLOATS / D + 31) / 32 * 32;
}

// The logits of one task's query (`qv`: D/4 float4 in registers, the base-2
// scale folded in) against keys j0.. of a chunk (`kh`: key 0 of the head,
// rows c values apart); `mk` the frame's key mask in device memory, or null.
// RQK rounds each key to bf16 (the bf16 rung beyond SMALL_DEPTH).
template <int D, bool RQK, typename T>
__device__ __forceinline__ float task_logits(const float4 (&qv)[D / 4], const T* kh,
                                             const float* mk, int s, int c, int j0,
                                             float (&lg)[CHUNK]) {
  float cm = -INFINITY;
#pragma unroll
  for (int jj = 0; jj < CHUNK; ++jj) {
    if (j0 + jj < s) {
      const T* kj = kh + (j0 + jj) * c;
      float dot = 0.f;
#pragma unroll
      for (int u = 0; u < D / 4; ++u) {
        const float4 kv = lds4(kj + 4 * u);
        dot = dot4(qv[u], RQK ? round4(kv) : kv, dot);
      }
      lg[jj] = mk ? fmaf(__ldg(mk + j0 + jj), MASK_LOG2, dot) : dot;
      cm = fmaxf(cm, lg[jj]);
    }
  }
  return cm;
}

// One task against the S staged keys of its frame and head (`kh`, `vh`:
// key 0 of the head; rows c values apart). BF16: two passes over the keys,
// the row's max and sum, then the normalised, rounded probabilities against
// rounded v.
template <int D, bool BF16, typename T>
__device__ __forceinline__ void task_attend(const float4 (&qv)[D / 4], const T* kh,
                                            const T* vh, const float* mk, int s, int c,
                                            float4 (&o)[D / 4]) {
  constexpr bool RQK = BF16 && D > SMALL_DEPTH;
  float m = -INFINITY, l = 0.f;
#pragma unroll
  for (int u = 0; u < D / 4; ++u) o[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = 0; j0 < s; j0 += CHUNK) {
    float lg[CHUNK];
    const float cm = task_logits<D, RQK>(qv, kh, mk, s, c, j0, lg);
    // a running max across chunks: the first chunk's correction is exp2(-inf) = 0
    const float mn = fmaxf(m, cm), corr = fast_exp2(m - mn);
    m = mn;
    l *= corr;
    if constexpr (!BF16) {
#pragma unroll
      for (int u = 0; u < D / 4; ++u)
        o[u] = make_float4(o[u].x * corr, o[u].y * corr, o[u].z * corr, o[u].w * corr);
    }
#pragma unroll
    for (int jj = 0; jj < CHUNK; ++jj) {
      if (j0 + jj < s) {
        const float p = fast_exp2(lg[jj] - m);
        l += p;
        if constexpr (!BF16) {
          const T* vj = vh + (j0 + jj) * c;
#pragma unroll
          for (int u = 0; u < D / 4; ++u) o[u] = fma4(p, lds4(vj + 4 * u), o[u]);
        }
      }
    }
  }
  const float inv = 1.f / l;
  if constexpr (BF16) {
    for (int j0 = 0; j0 < s; j0 += CHUNK) {
      float lg[CHUNK];
      task_logits<D, RQK>(qv, kh, mk, s, c, j0, lg);
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        if (j0 + jj < s) {
          const float p = bf16_roundf(fast_exp2(lg[jj] - m) * inv);
          const T* vj = vh + (j0 + jj) * c;
#pragma unroll
          for (int u = 0; u < D / 4; ++u) o[u] = fma4(p, round4(lds4(vj + 4 * u)), o[u]);
        }
      }
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < D / 4; ++u)
    o[u] = make_float4(o[u].x * inv, o[u].y * inv, o[u].z * inv, o[u].w * inv);
}

// Groups of g consecutive frames; block b takes groups b, b + grid, ... Task
// x of a group is (frame x / tasks, query (x % tasks) / heads, head x % heads);
// its q and context lie at x·D values from the group's start. S_ and C_ fix
// S and C at compile time (the spatial blocks' 17 x 32: no bounds checks, key
// offsets as constants, registers for TASK_BLOCKS blocks per SM); 0 reads
// them at run time.
template <int D, int S_, int C_, bool BF16, typename T>
__global__ void __launch_bounds__(task_threads<D>(), S_ ? TASK_BLOCKS : 1)
task_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ key_mask,
                      T* __restrict__ out, int frames, int s_arg, int c_arg, int g,
                      float scale2) {
  extern __shared__ float4 ring4[];  // STAGES x (K, V) of a group
  __shared__ uint64_t full[STAGES];
  T* ring = reinterpret_cast<T*>(ring4);
  const int s = S_ ? S_ : s_arg, c = C_ ? C_ : c_arg;
  const int heads = c / D, tasks = s * heads, sc = s * c;
  const int gf = g * sc;  // values of one tensor in a group (<= GROUP_FLOATS)
  const int groups = (frames + g - 1) / g;
  const int x = threadIdx.x, fl = x / tasks, h = x % heads;
  const auto group_tasks = [&](int grp) { return min(g, frames - grp * g) * tasks; };

  if (x == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(smem_u32(&full[st]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // thread 0: K and V of the block's it-th group into stage it % STAGES
  const auto stage_group = [&](int it) {
    const int grp = blockIdx.x + it * gridDim.x;
    if (grp >= groups) return;
    const uint32_t bytes = (uint32_t)(group_tasks(grp) * D) * sizeof(T);
    const uint32_t bar = smem_u32(&full[it % STAGES]);
    T* dst = ring + (it % STAGES) * 2 * gf;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, 2 * bytes);
    bulk_load(dst, k + (size_t)grp * gf, bytes, bar);
    bulk_load(dst + gf, v + (size_t)grp * gf, bytes, bar);
  };
  if (x == 0)
    for (int it = 0; it < STAGES - 1; ++it) stage_group(it);

  // q of this thread's task in group grp, scaled (zeros past the last task);
  // the bf16 rung beyond SMALL_DEPTH rounds it first
  const auto load_q = [&](int grp, float4 (&qv)[D / 4]) {
    const bool in = grp < groups && x < group_tasks(grp);
    const T* qp = q + (size_t)grp * gf + x * D;
#pragma unroll
    for (int u = 0; u < D / 4; ++u) {
      float4 a = in ? load4(qp + 4 * u) : make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (BF16 && D > SMALL_DEPTH) a = round4(a);
      qv[u] = make_float4(a.x * scale2, a.y * scale2, a.z * scale2, a.w * scale2);
    }
  };
  float4 qn[D / 4];
  load_q(blockIdx.x, qn);
  for (int it = 0;; ++it) {
    const int grp = blockIdx.x + it * gridDim.x;
    if (grp >= groups) break;
    // the stage group it - 1 used is free: every thread passed the barrier below
    if (x == 0) stage_group(it + STAGES - 1);
    float4 qc[D / 4];
#pragma unroll
    for (int u = 0; u < D / 4; ++u) qc[u] = qn[u];
    load_q(grp + gridDim.x, qn);  // the next group's, in flight during this one
    mbar_wait(smem_u32(&full[it % STAGES]), (it / STAGES) & 1);
    if (x < group_tasks(grp)) {
      const T* kh = ring + (it % STAGES) * 2 * gf + fl * sc + h * D;
      const float* mk = key_mask ? key_mask + ((size_t)grp * g + fl) * s : nullptr;
      float4 o[D / 4];
      task_attend<D, BF16>(qc, kh, kh + gf, mk, s, c, o);
      T* op = out + (size_t)grp * gf + x * D;
#pragma unroll
      for (int u = 0; u < D / 4; ++u) store4(op + 4 * u, o[u]);
    }
    __syncthreads();
  }
}

template <int D, bool BF16, typename T, int S_ = 0, int C_ = 0>
cudaError_t launch_task_attention(const T* q, const T* k, const T* v, const float* key_mask,
                                  T* out, int frames, int s, int c, cudaStream_t stream) {
  const int g = GROUP_FLOATS / (s * c) > 1 ? GROUP_FLOATS / (s * c) : 1;
  const int threads = (g * s * (c / D) + 31) / 32 * 32;
  const size_t smem = sizeof(T) * STAGES * 2 * (size_t)g * s * c;
  const auto kernel = task_attention_kernel<D, S_, C_, BF16, T>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // the persistent grid: as many blocks as fit on the card at once
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int groups = (frames + g - 1) / g;
  const int blocks = groups < per_sm * sms ? groups : per_sm * sms;
  kernel<<<blocks, threads, smem, stream>>>(q, k, v, key_mask, out, frames, s, c, g,
                                            ATTN_LOG2E / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace packed

// The rule: S·C <= 1,536 takes a short kernel. Of those, C of 128, 256 or
// 384 with a power-of-two head count <= 32 takes the warp per frame
// (lane_attention_kernel: 3 x 384), and D in {4, 8, 16, 32, 48, 64} the
// thread per task (task_attention_kernel: 17 x 32; with bf16 tensors only
// where a frame's S·C is a multiple of 8, the bulk copies' 16 bytes).
// Everything else takes attention.cuh's tensor-core kernel. The short
// kernels read 16 (fp32) or 8 (bf16) bytes at a time: q, k, v and out must
// be 16-byte aligned.
template <bool BF16, typename T>
cudaError_t packed_attention(const T* q, const T* k, const T* v, const float* key_mask, T* out,
                             int frames, int s, int c, int heads, cudaStream_t st) {
  using namespace packed;
  if (frames <= 0 || s <= 0 || s > 128 || heads <= 0 || c % heads != 0)
    return cudaErrorInvalidValue;
  // the TPU kernel's rule (`_SMALL_DEPTH`): on the bf16 rung q and k are
  // rounded beyond head depth SMALL_DEPTH; at or below it their logits are
  // fp32-level (the thread per task derives it from its compile-time D)
  const bool rqk = BF16 && c / heads > SMALL_DEPTH;
  if (s * c <= SHORT_MAX_FLOATS) {
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
      return cudaErrorMisalignedAddress;
    if (c % 128 == 0 && 32 % heads == 0) {
      switch (c / 128) {
        case 1:
          return launch_lane_attention<1, BF16>(q, k, v, key_mask, out, frames, s, heads,
                                                rqk, st);
        case 2:
          return launch_lane_attention<2, BF16>(q, k, v, key_mask, out, frames, s, heads,
                                                rqk, st);
        case 3:
          return launch_lane_attention<3, BF16>(q, k, v, key_mask, out, frames, s, heads,
                                                rqk, st);
        default: break;  // wider rows: a thread per task
      }
    }
    if (sizeof(T) == 4 || (s * c) % 8 == 0) {
      if (s == 17 && c == 32 && heads == 8)  // the spatial blocks: 17 joints x 32, 8 heads
        return launch_task_attention<4, BF16, T, 17, 32>(q, k, v, key_mask, out, frames, s, c,
                                                         st);
      switch (c / heads) {
        case 4: return launch_task_attention<4, BF16>(q, k, v, key_mask, out, frames, s, c, st);
        case 8: return launch_task_attention<8, BF16>(q, k, v, key_mask, out, frames, s, c, st);
        case 16: return launch_task_attention<16, BF16>(q, k, v, key_mask, out, frames, s, c, st);
        case 32: return launch_task_attention<32, BF16>(q, k, v, key_mask, out, frames, s, c, st);
        case 48: return launch_task_attention<48, BF16>(q, k, v, key_mask, out, frames, s, c, st);
        case 64: return launch_task_attention<64, BF16>(q, k, v, key_mask, out, frames, s, c, st);
        default: break;  // other head depths take the per-(sequence, head) kernel
      }
    }
  }
  if constexpr (BF16) {
    if (!rqk)
      return launch_head_attention<BF16, false, T, false>(q, k, v, c, key_mask, out, frames, s,
                                                          c, heads, attn_scale2(c / heads), st);
  }
  return launch_head_attention<BF16, false, T>(q, k, v, c, key_mask, out, frames, s, c, heads,
                                               attn_scale2(c / heads), st);
}

}  // namespace uu
