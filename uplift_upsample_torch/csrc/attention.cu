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
//
// The kernels live in packed_attention.cuh, each with two compile-time
// choices: the bf16 rung and bf16 tensors, whose entries attention_bf16.cu
// builds (a library of their own, compiled beside this one). This file
// builds the fp32 instances.

#include <cuda_runtime.h>

#include "packed_attention.cuh"

// q, k, v, out (frames, s, c) fp32; key_mask (frames, s), 1 = blocked, or null.
extern "C" int packed_attention_f32(const float* q, const float* k, const float* v,
                                    const float* key_mask, float* out, int frames, int s,
                                    int c, int heads, void* stream) {
  return uu::packed_attention<false>(q, k, v, key_mask, out, frames, s, c, heads,
                                     (cudaStream_t)stream);
}
