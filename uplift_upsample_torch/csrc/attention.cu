// Row 11 — packed multi-head attention on (F, S, H·D) q, k and v.
//
// Replaces: uplift_upsample_tpu/ops/pallas_attention.py
//   packed_multihead_attention (:75, pallas_call at :113):
//   softmax(q kᵀ / sqrt(D) + mask · -1e9) v per head, on the packed
//   (F, S, H·D) tensors the q/k/v projections produce (no head-split
//   transpose), with an optional (F, S) key mask (1 = blocked), S <= 128. The
//   model calls it in every attention layer when USE_PALLAS_ATTENTION is set.
//   Each of the three kernels below replaces it on its own shapes.
//
// What bounds it here: bytes, in both short regimes and beyond. A call reads
// q, k and v once and writes the context once: 4·F·S·C·4 bytes, plus F·S·4
// of key mask. At the spatial blocks' 72,704 frames x 17 joints x 32 channels
// that is 632.8 MB (0.189 ms at 3.35 TB/s); at the last strided block's 1,024
// windows x 3 tokens x 384 channels 18.9 MB (0.006 ms). Its 4·S²·C FLOPs per
// sequence take a fraction of that time on the CUDA cores (0.04 ms spatial),
// and with D = 4 or S = 3 a tensor-core tile would be mostly padding. So
// both short kernels work on how the bytes move, not on the arithmetic.
//
// The kernels, by shape (the rule is packed_attention_f32's, at the end):
//  - lane_attention_kernel, the 3-token regime (strided block 3's 3 x 384,
//    D = 48; any S·C <= 1,536 with C of 128, 256 or 384 and a power-of-two
//    head count <= 32). A warp owns a frame and each lane 4·C/128 adjacent
//    channels of every token (12, three float4, at C = 384), so every load
//    and store is a float4, straight between device memory and registers: no
//    shared memory, no barrier. A head is 32/H adjacent lanes (4 at 8 heads):
//    each (query, key) dot is the lanes' partial dots summed by xor shuffles
//    inside the head's lanes, so every lane of a head holds the same S
//    logits. The softmax and the weighted sum of V run in registers, in one
//    pass. Blocks of 4 warps, one frame each: at 1,024 frames that is 256
//    small blocks, spread over every SM, each warp's loads all in flight at
//    once.
//  - task_attention_kernel, the spatial regime (17 x 32, D = 4, and every
//    other S·C <= 1,536 with D in {4, 8, 16, 32, 48, 64}). One thread per
//    (frame, query, head) task. A block takes groups of consecutive frames
//    (4 frames of 17 x 32: 544 tasks for 544 threads) in a persistent grid.
//    A group's K and V are each one contiguous run of device memory, so one
//    thread stages them with two bulk copies (cp.async.bulk, TMA's 1-D copy)
//    completing on an mbarrier, into a ring of 3 stages: the copies of the
//    next two groups are in flight while the threads compute this one. q is
//    read and the context written as float4 straight from and to device
//    memory (consecutive tasks on consecutive 16 bytes; q of the next group
//    is loaded before this group's compute). Each task keeps its logits in
//    registers, in one pass: logits and their max, exp and sum, then the
//    weighted sum of V; nothing is computed twice (more than 17 keys go in
//    chunks with a running max). The lanes of a warp that share a head read
//    the same K/V float4 (a broadcast) and the 8 heads span 128 contiguous
//    bytes, so the reads of the staged rows hit distinct banks. The
//    arithmetic, not the copies, is what the ring has to hide here: with S
//    and C read at run time the kernel without its loads took as long as
//    the whole kernel (kernel_probe.py --only short). So the spatial blocks'
//    17 x 32 instance is compiled with S and C fixed (no bounds checks,
//    constant key offsets) and its registers capped for 2 blocks of 544
//    threads per SM; both kernels take exp2 from the SFU alone.
//  - Longer sequences (71 and 23 frames x 384): K2's window-attention kernel
//    (attention.cuh), one block per (sequence, head) on the tensor cores in
//    3xTF32, reading the three tensors with row stride C.
//
// Both short kernels sum in a fixed order with no atomics: a second call
// gives the same bits. Their softmax runs in base 2 (attention.cuh's
// ATTN_LOG2E folded into the scale and the mask).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention.cuh"

namespace {

constexpr int SHORT_MAX_FLOATS = 1536;  // S·C of the two short-sequence kernels
constexpr int GROUP_FLOATS = 2176;      // K (or V) floats a stage holds: 4 frames of 17 x 32
constexpr int STAGES = 3;               // the ring: two groups staged ahead of the one computed
constexpr int CHUNK = 17;               // logits a task holds at once: a pose's 17 joints
constexpr int LANE_WARPS = 4;           // warps (frames) of a lane_attention_kernel block
constexpr int TASK_BLOCKS = 2;          // blocks per SM the 17 x 32 instance's registers allow
constexpr float MASK_LOG2 = -1e9f * uu::ATTN_LOG2E;  // a blocked key's logit, in base 2

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
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
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// ---- the 3-token regime: a warp per frame, lanes owning channels -----------

// Query row `qr` (the lane's NV float4) against the frame's S keys: the
// context slice of the lane, normalised. `lph` lanes make a head.
template <int NV, int SMAX>
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
// bounds the tokens a frame holds in registers.
template <int NV>
__global__ void __launch_bounds__(LANE_WARPS * 32)
lane_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ key_mask,
                      float* __restrict__ out, int frames, int s, int lph, float scale2) {
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
      }
      if (key_mask) mk[j] = key_mask[(size_t)f * s + j] * MASK_LOG2;
    }
  }
#pragma unroll
  for (int i = 0; i < SMAX; ++i) {
    if (i < s) {
      float4 qr[NV], o[NV];
#pragma unroll
      for (int u = 0; u < NV; ++u) qr[u] = load4(q + base + (size_t)i * C + 4 * u);
      lane_attend<NV, SMAX>(qr, kr, vr, mk, s, lph, scale2, o);
#pragma unroll
      for (int u = 0; u < NV; ++u) store4(out + base + (size_t)i * C + 4 * u, o[u]);
    }
  }
}

template <int NV>
cudaError_t launch_lane_attention(const float* q, const float* k, const float* v,
                                  const float* key_mask, float* out, int frames, int s,
                                  int heads, cudaStream_t stream) {
  const int blocks = (frames + LANE_WARPS - 1) / LANE_WARPS;
  lane_attention_kernel<NV><<<blocks, LANE_WARPS * 32, 0, stream>>>(
      q, k, v, key_mask, out, frames, s, 32 / heads,
      uu::ATTN_LOG2E / sqrtf((float)(128 * NV / heads)));
  return cudaGetLastError();
}

// ---- the spatial regime: a thread per (frame, query, head) task ------------

// Threads of a block: one per task of a group, whose K holds at most
// GROUP_FLOATS floats, so at most GROUP_FLOATS / D tasks.
template <int D>
constexpr int task_threads() {
  return (GROUP_FLOATS / D + 31) / 32 * 32;
}

// One task: its query (D/4 float4 in registers, the base-2 scale folded in)
// against the S staged keys of its frame and head (`kh`, `vh`: key 0 of the
// head; rows c floats apart). `mk`: the frame's key mask in device memory,
// or null.
template <int D>
__device__ __forceinline__ void task_attend(const float4 (&qv)[D / 4], const float* kh,
                                            const float* vh, const float* mk, int s, int c,
                                            float4 (&o)[D / 4]) {
  float m = -INFINITY, l = 0.f;
#pragma unroll
  for (int u = 0; u < D / 4; ++u) o[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = 0; j0 < s; j0 += CHUNK) {
    float lg[CHUNK];
    float cm = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < CHUNK; ++jj) {
      if (j0 + jj < s) {
        const float* kj = kh + (j0 + jj) * c;
        float dot = 0.f;
#pragma unroll
        for (int u = 0; u < D / 4; ++u)
          dot = dot4(qv[u], *reinterpret_cast<const float4*>(kj + 4 * u), dot);
        lg[jj] = mk ? fmaf(__ldg(mk + j0 + jj), MASK_LOG2, dot) : dot;
        cm = fmaxf(cm, lg[jj]);
      }
    }
    // a running max across chunks: the first chunk's correction is exp2(-inf) = 0
    const float mn = fmaxf(m, cm), corr = fast_exp2(m - mn);
    m = mn;
    l *= corr;
#pragma unroll
    for (int u = 0; u < D / 4; ++u)
      o[u] = make_float4(o[u].x * corr, o[u].y * corr, o[u].z * corr, o[u].w * corr);
#pragma unroll
    for (int jj = 0; jj < CHUNK; ++jj) {
      if (j0 + jj < s) {
        const float p = fast_exp2(lg[jj] - m);
        l += p;
        const float* vj = vh + (j0 + jj) * c;
#pragma unroll
        for (int u = 0; u < D / 4; ++u)
          o[u] = fma4(p, *reinterpret_cast<const float4*>(vj + 4 * u), o[u]);
      }
    }
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int u = 0; u < D / 4; ++u)
    o[u] = make_float4(o[u].x * inv, o[u].y * inv, o[u].z * inv, o[u].w * inv);
}

// Groups of g consecutive frames; block b takes groups b, b + grid, ... Task
// x of a group is (frame x / tasks, query (x % tasks) / heads, head x % heads);
// its q and context lie at x·D floats from the group's start. S_ and C_ fix
// S and C at compile time (the spatial blocks' 17 x 32: no bounds checks, key
// offsets as constants, registers for TASK_BLOCKS blocks per SM); 0 reads
// them at run time.
template <int D, int S_, int C_>
__global__ void __launch_bounds__(task_threads<D>(), S_ ? TASK_BLOCKS : 1)
task_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ key_mask,
                      float* __restrict__ out, int frames, int s_arg, int c_arg, int g,
                      float scale2) {
  extern __shared__ float4 ring4[];  // STAGES x (K, V) of a group
  __shared__ uint64_t full[STAGES];
  float* ring = reinterpret_cast<float*>(ring4);
  const int s = S_ ? S_ : s_arg, c = C_ ? C_ : c_arg;
  const int heads = c / D, tasks = s * heads, sc = s * c;
  const int gf = g * sc;  // floats of one tensor in a group (<= GROUP_FLOATS)
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
    const uint32_t bytes = (uint32_t)(group_tasks(grp) * D) * 4;
    const uint32_t bar = smem_u32(&full[it % STAGES]);
    float* dst = ring + (it % STAGES) * 2 * gf;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, 2 * bytes);
    bulk_load(dst, k + (size_t)grp * gf, bytes, bar);
    bulk_load(dst + gf, v + (size_t)grp * gf, bytes, bar);
  };
  if (x == 0)
    for (int it = 0; it < STAGES - 1; ++it) stage_group(it);

  // q of this thread's task in group grp, scaled (zeros past the last task)
  const auto load_q = [&](int grp, float4 (&qv)[D / 4]) {
    const bool in = grp < groups && x < group_tasks(grp);
    const float* qp = q + (size_t)grp * gf + x * D;
#pragma unroll
    for (int u = 0; u < D / 4; ++u) {
      const float4 a = in ? load4(qp + 4 * u) : make_float4(0.f, 0.f, 0.f, 0.f);
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
      const float* kh = ring + (it % STAGES) * 2 * gf + fl * sc + h * D;
      const float* mk = key_mask ? key_mask + ((size_t)grp * g + fl) * s : nullptr;
      float4 o[D / 4];
      task_attend<D>(qc, kh, kh + gf, mk, s, c, o);
      float* op = out + (size_t)grp * gf + x * D;
#pragma unroll
      for (int u = 0; u < D / 4; ++u) store4(op + 4 * u, o[u]);
    }
    __syncthreads();
  }
}

template <int D, int S_ = 0, int C_ = 0>
cudaError_t launch_task_attention(const float* q, const float* k, const float* v,
                                  const float* key_mask, float* out, int frames, int s, int c,
                                  cudaStream_t stream) {
  const int g = GROUP_FLOATS / (s * c) > 1 ? GROUP_FLOATS / (s * c) : 1;
  const int threads = (g * s * (c / D) + 31) / 32 * 32;
  const size_t smem = sizeof(float) * STAGES * 2 * (size_t)g * s * c;
  const auto kernel = task_attention_kernel<D, S_, C_>;
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
                                            uu::ATTN_LOG2E / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// The rule: S·C <= 1,536 takes a short kernel. Of those, C of 128, 256 or
// 384 with a power-of-two head count <= 32 takes the warp per frame
// (lane_attention_kernel: 3 x 384), and D in {4, 8, 16, 32, 48, 64} the
// thread per task (task_attention_kernel: 17 x 32). Everything else
// takes attention.cuh's tensor-core kernel. The short kernels read float4:
// q, k, v and out must be 16-byte aligned.
extern "C" int packed_attention_f32(const float* q, const float* k, const float* v,
                                    const float* key_mask, float* out, int frames, int s,
                                    int c, int heads, void* stream) {
  if (frames <= 0 || s <= 0 || s > 128 || heads <= 0 || c % heads != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (s * c <= SHORT_MAX_FLOATS) {
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
      return cudaErrorMisalignedAddress;
    if (c % 128 == 0 && 32 % heads == 0) {
      switch (c / 128) {
        case 1: return launch_lane_attention<1>(q, k, v, key_mask, out, frames, s, heads, st);
        case 2: return launch_lane_attention<2>(q, k, v, key_mask, out, frames, s, heads, st);
        case 3: return launch_lane_attention<3>(q, k, v, key_mask, out, frames, s, heads, st);
        default: break;  // wider rows: a thread per task
      }
    }
    if (s == 17 && c == 32 && heads == 8)  // the spatial blocks: 17 joints x 32, 8 heads
      return launch_task_attention<4, 17, 32>(q, k, v, key_mask, out, frames, s, c, st);
    switch (c / heads) {
      case 4: return launch_task_attention<4>(q, k, v, key_mask, out, frames, s, c, st);
      case 8: return launch_task_attention<8>(q, k, v, key_mask, out, frames, s, c, st);
      case 16: return launch_task_attention<16>(q, k, v, key_mask, out, frames, s, c, st);
      case 32: return launch_task_attention<32>(q, k, v, key_mask, out, frames, s, c, st);
      case 48: return launch_task_attention<48>(q, k, v, key_mask, out, frames, s, c, st);
      case 64: return launch_task_attention<64>(q, k, v, key_mask, out, frames, s, c, st);
      default: break;  // other head depths take the per-(sequence, head) kernel
    }
  }
  return uu::launch_head_attention(q, k, v, c, key_mask, out, frames, s, c, heads, st);
}
