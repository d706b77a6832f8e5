#!/usr/bin/env python3
"""What bounds the hand-written kernels on the card (csrc/).

    python3 kernel_probe.py [--seed 0]
        [--only dense,dense_bf16,dw,conv,attn_bwd,attn_bf16io,k4,k1,short,e2e]
                            [--parent DIR]

Builds patched copies of `csrc/` under `uplift_upsample_torch/_build/probe/`
(one nvcc per copy, all started together) and times each with CUDA events:

- the window attention (`attention.cu`, row 11's 71-token shapes, 1,024
  sequences x 8 heads of 48, with and without a key mask, and 23 tokens,
  beside SDPA): the kernel as it is; "products only" (no copies into shared
  memory: the products run on whatever shared memory holds); "copies only"
  (no products: the block stages q, k and v and writes the context); "no
  splits" (every operand passed to the three mma.sync unsplit: the splits'
  cost); "one pass, no splits" (one mma.sync per product: the cost of the
  other two);
- the dense-layer GEMM (`temporal.cu`'s gemm_f32 at K2's qkv product,
  72,704 x 384 -> 1,152, beside addmm): the kernel; "products only" (no TMA
  loads: the loader only signals the stages); "copies only" (no wgmma);
  "no epilogue" (the epilogue warps read and write nothing; the consumers
  still stage their sums); "no splits", "one pass, no splits" as above;
  "no register split" (no setmaxnreg: every warpgroup at the launch's 168);
- the bf16 rung of that GEMM at its dense callers ("dense_bf16"):
  `temporal.cu`'s gemm_bf16 at K2's four serving products (72,704 rows:
  qkv, proj + residual, fc1 + relu, fc2 + the residual aliasing the
  output), `temporal_bwd.cu`'s gemm_branch_bf16 and gemm_dx_bf16 (row
  scale, relu mask) at fc2 on the train step's 36,352 rows, and `s2t.cu`'s
  s2t_prologue_bf16 (72,704 x 544 -> 384): the kernel, "copies only",
  "products only", "no epilogue" (no tile brought in by TMA, nothing
  written by the consumers or the epilogue warps) and "no register split"
  as above,
  "copies only, no epilogue" and "products only, no epilogue", and for
  gemm_bf16 "warps' epilogue" (with a residual, the sums through the
  staging tile and the epilogue warps, BiasActResidual, in place of the
  TMA-stored tiles, DenseTmaStore), alone and with "copies only", beside
  torch.matmul on operands rounded to bf16 beforehand and the same function
  from the same fp32 inputs (the fastest PyTorch sequence tried: casts,
  fp32 out, bias, relu, residual, row scale, mask, token, PE);
- the dW product (`gemm_tc.cuh`'s gemm_atb_kernel) as `temporal_bwd.cu`'s
  gemm_dw_f32 at the qkv weight's 384 x 1,152 over 36,352 rows and
  gemm_dw_bf16 at fc2's 768 x 384 with the per-window row scale, and as
  `strided_bwd.cu`'s strided_dwc_bf16 and strided_dwc_f32 (K6's dWc, the
  taps gathered from h1) at 512 windows x 23 rows, (3 x 768) x 384, each
  split as ops/temporal_train.dw_splits cuts it, beside torch.mm on the
  same fp32 operands: the kernel; "products only" (no TMA loads or
  gathers: the loader only arrives); "copies only" (no wgmma); "no
  converter" (the consumers write no operand buffer: no transpose and TF32
  split of dY, or no bf16 rounding); 3xTF32 also "no splits" and "one
  pass, no splits";
- the conv forward (`strided.cu`'s strided_conv_f32 and strided_conv_bf16 at
  serving, 1,024 windows x 23 selected rows, K = 3 x 768 -> 384, T read
  from h1 by TMA's im2col mode, conv_taps.cuh ConvTapsTma) and its dH1
  (`strided_bwd.cu`'s strided_dh1_f32 and strided_dh1_bf16 at the train
  step, 512 windows, s0 3: 11,776 rows x 384 -> 3 x 768, Dh1Rows), each in
  3xTF32 and on the bf16 rung
  (native bf16, Wc's torch.bfloat16 plane; one build holds both), beside
  F.conv1d + the residual add / convolution_backward's input gradient on
  operands prepared beforehand (bf16: pre-rounded) and on the same inputs as
  the kernel (layouts, casts, the residual or the relu mask timed): the
  kernel; "dense A" (the conv only: gemm_f32 / gemm_bf16, native bf16, on
  the taps matrix written out, read by TMA: the same products without the
  taps' boxes); "no A copies" (the loader issues W's boxes only: no box of
  h1 or g); "no products" (no wgmma); "no epilogue" (the conv: the epilogue
  warps read and write nothing; dH1: no mask brought into the staging tile,
  no tile stored); "no splits" (3xTF32 only); "no register split";
- with `--parent DIR` (a copy of an earlier `csrc/`) every caller of
  gemm_tc_kernel and gemm_atb_kernel, 3xTF32 and bf16 (`uplift_upsample_
  torch/tools/gemm_digests.py`), from this checkout's build and DIR's,
  timed in turn (parent, kernel, kernel, parent) with both builds' output
  digests: the A/B of a redesign of either kernel.
- K5's window-attention backward (`temporal_bwd.cu`'s
  window_attention_bwd_f32, 3xTF32, and window_attention_bwd_bf16, the bf16
  rung on native bf16 mma.sync, at the train step: 512 windows x 71 tokens
  x 384, 8 heads, a key mask; beside SDPA's backward on fp32 and on bf16):
  the kernel; "copies only" (no products, no softmax: the staging and the
  stores); "no products" (no mma.sync); "no splits" (no TF32 splits, bf16
  pairs packed by truncation: no rounding conversions); "no gradient writes"
  (dq, dk, dv computed, not stored); "bf16 3 blocks, 3xTF32 2 blocks per
  SM" (the register caps of the launch bounds at 71 tokens: the bf16
  kernel at 3 blocks an SM, not 4; the 3xTF32 one at 2, not 3); with
  `--parent DIR` also DIR's build,
  timed in turn (parent, kernel, kernel, parent) with and without the key
  mask, both builds' output digests;
- row 11 on bf16 tensors ("attn_bf16io": `attention_bf16.cu`'s
  packed_attention_bf16io, "high", and packed_attention_bf16io_bf16,
  "default", at 1,024 sequences x 71 tokens x 384 with a key mask and 1,024
  x 23 x 384, 8 heads, beside SDPA on bf16): the kernel; "copies only" (no
  logits, softmax or products: q, k and v staged, the context stored);
  "no products"; "no splits" ("high": P in one bf16 term, not three); "no
  stores" (the context computed, not written); "3 blocks per SM" (at 71
  tokens a 136-register cap, not 4 blocks at 96); with `--parent DIR` DIR's
  build in turn (parent, kernel, kernel, parent, SDPA) and both builds'
  digests; ptxas's registers and spills of each build's instances at D = 48;
- K4 (`spatial_bwd.cu`'s spatial_bwd_f32 and spatial_bwd_bf16 at the train
  step's 25,600 keyframes, C = 32, 4 blocks, random weights from the seed;
  3 rounds of 20 launches per variant, taken in turn): the kernel; "no
  products"; "no splits"; "no gradient writes" (no read-modify-write of dW
  in the gradient rows, or in shared memory on the bf16 rung); "no
  attention backward"; "staged once" (block 0's weights only: the cost of
  staging); "no checkpoints" (the scratch's slices neither saved nor
  restored); with `--parent DIR` also "parent", DIR's K4 timed in turn
  (parent, kernel, ..., kernel, parent) with both builds' digests, and K1
  from both builds (digests, equal or not);
- K1 (`spatial.cu`'s spatial_stack_f32, C = 32, 4 blocks, random weights
  from the seed) at serving (72,704 frames), the train step (25,600
  keyframes, droppath scales) and the eval shared step (3,072 frames): the
  kernel beside "fresh partials" (a fresh partial per 8-deep step, K4's
  accumulation), each against the plain version and float64; at serving
  also "no products", "no attention", "no LayerNorm statistics", "no gelu"
  (fc1's output as it is), "no splits", "one pass, no splits" and "staged
  once" (block 0's weights only: the cost of restaging). 3 rounds of 20
  launches per variant, taken in turn; ptxas's registers and spills of
  both accumulations are printed first.

- row 11's two short-sequence kernels (`attention.cu`) at their h36m_351
  shapes, 8 heads: task_attention_kernel at the spatial blocks' 72,704
  frames x 17 x 32 and lane_attention_kernel at strided block 3's 1,024
  windows x 3 x 384, each beside SDPA: the kernel; "copies only" (every
  load and store, no logits, softmax or weighted sum); "compute only" (no
  loads from device memory: q, k and v made up in registers, no bulk
  copies; the context still stored); "1 block per SM" and "3 blocks per
  SM" (TASK_BLOCKS, the register cap of the 17 x 32 instance: 80 and 32
  registers against 56); with `--parent DIR` also "parent",
  `packed_attention_f32` built from DIR, a copy of an earlier `csrc/` (an
  A/B against an earlier design). Times from CUDA graphs of 20 launches
  (`chip_smoke.graph_ms`: the card's time without the host's per call), 3
  rounds taken in turn, "cold" on copies of the inputs that stream 4x the
  L2 between two reads of one copy and "warm" on one copy (at 1,024 x 3 x
  384 it stays in L2); the kernel's and parent's back-to-back time with the
  host in it; ptxas's registers and spills of every variant first.

- end to end ("e2e", with `--parent DIR`, DIR the `uplift_upsample_torch/csrc`
  of another checkout): the serving call (`bench_forward` on 1,024 h36m_351
  windows, "high" and "default") and the B=512 training step at "default"
  (`tools/profile_train.py` full, fwd, temporal), in that checkout and in
  this one in turn (parent, this, this, parent), each in its own process.

`--only` runs a subset: "dense" is the attention, GEMM, bf16 GEMM, dW, conv
and dH1 groups (and the A/B of every GEMM caller with `--parent`),
"dense_bf16" the bf16 GEMM group alone (and, with `--parent`, the A/B of
its seven cases), "dw" the dW
groups alone (and the A/B), "conv" the conv and dH1 groups (and, with
`--parent`, the A/B of the strided conv's cases: conv, dH1, dWc; an
earlier build that reads the bf16 plane in fp32 is handed one).

Each prints one line. The patched versions compute nothing meaningful; only
each kernel as it is is checked against its plain version. Needs a CUDA card
and the repository checkout around it.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# (file in csrc/, text, replacement)
NO_SPLITS = [("tf32.cuh", "  big = tf32_round(x);\n  small = __float_as_uint(x - __uint_as_float(big));",
              "  big = __float_as_uint(x);\n  small = big;")]
ONE_MMA = [("tf32.cuh", "  mma_tf32(d, a_small, b_big);\n  mma_tf32(d, a_big, b_small);\n", "")]
ATTENTION = {
    "kernel": [],
    "products only": [("attention.cuh", f"  stage_head({t}s", f"  if (n < 0) stage_head({t}s")
                      for t in "qkv"],
    "copies only": [("attention.cuh", "nk = (n + 7) & ~7, nt = nk / 8;",
                     "nk = (n + 7) & ~7, nt = nk / 8 - 100;")],
    "no splits": NO_SPLITS,
    "one pass, no splits": NO_SPLITS + ONE_MMA,
}
_TMA = ("          mbar_expect_tx(full + 8 * s, a_src.a_bytes() + L::kWLoad);\n"
        "          const int2 wk = a_src.load(st, &map_a, tm, kt, full + 8 * s);\n"
        "          tma_load_2d(st + TC_TILE_BYTES, &map_w, wk.x, wk.y + n0, full + 8 * s);\n"
        "          if constexpr (kMode == TC_3XTF32)\n"
        "            tma_load_2d(st + 2 * TC_TILE_BYTES, &map_w, wk.x, w_small + wk.y + n0,\n"
        "                        full + 8 * s);\n")
_SMALL_WGMMA = ("    wgmma_m64n64k8_tf32(d, f.small[j], desc_big + 2 * j);\n"
                "    wgmma_m64n64k8_tf32(d, f.big[j], desc_small + 2 * j);\n")
_BIG_WGMMA = "    wgmma_m64n64k8_tf32(d, f.big[j], desc_big + 2 * j);\n"
_NATIVE_WGMMA = ("  wgmma_m64n64k16_bf16_rs_first(d, f.big[0], desc);\n"
                 "  wgmma_m64n64k16_bf16_rs(d, f.big[1], desc + 2);\n")
_ROWS = "        const int rows = a_src.rows(tm, m);\n"
# the register split (setmaxnreg) of the loader / epilogue and consumer warpgroups
_SETMAXNREG = '    asm volatile("setmaxnreg.{}.sync.aligned.u32 %0;\\n" :: "n"(TC_{}_REGS));\n'
NO_PRODUCTS = [("gemm_tc.cuh", _SMALL_WGMMA, ""), ("gemm_tc.cuh", _BIG_WGMMA, ""),
               ("gemm_tc.cuh", _NATIVE_WGMMA, "")]
REGS = [("gemm_tc.cuh", _SETMAXNREG.format("dec", "LOADER"), ""),
        ("gemm_tc.cuh", "  " + _SETMAXNREG.format("inc", "CONSUMER")[4:], "")]
GEMM = {
    "kernel": [],
    "products only": [("gemm_tc.cuh", _TMA, "          mbar_arrive(full + 8 * s);\n")],
    "copies only": NO_PRODUCTS,
    "no epilogue": [],  # below: the epilogue warps' and the TMA epilogue's
    "no splits": NO_SPLITS,
    "one pass, no splits": NO_SPLITS + [("gemm_tc.cuh", _SMALL_WGMMA, "")],
    "no register split": REGS,
}
NO_EPILOGUE = [("gemm_tc.cuh", _ROWS, "        const int rows = k > 0 ? 0 : a_src.rows(tm, m);\n")]
# gemm_tc_kernel's bf16 rung at its dense callers, without its parts (the
# "gemm" group's builds serve temporal.cu's gemm_bf16)
BF16_DENSE = {name: GEMM[name] for name in ("kernel", "copies only", "products only",
                                            "no epilogue", "no register split")}
# the conv's A boxes (ConvTapsTma) and dH1's (Dh1Rows): the loader issues W's
# boxes only and expects their bytes
_A_BYTES = ("gemm_tc.cuh", "          mbar_expect_tx(full + 8 * s, a_src.a_bytes() + L::kWLoad);\n",
            "          mbar_expect_tx(full + 8 * s, L::kWLoad);\n")
_CONV_BOX = "    tma_load_im2col_3d(dst, map, c0, stride * t - p0, b, (uint16_t)j, bar);\n"
_DH1_BOX = "    tma_load_3d(dst, map, c0, (at.x + p0 - j) / stride + at.y, at.z, bar);\n"
CONV = {
    "kernel": [],
    "no A copies": [_A_BYTES, ("conv_taps.cuh", _CONV_BOX, "    if (kt < 0)\n" + _CONV_BOX)],
    "no products": NO_PRODUCTS,
    "no epilogue": NO_EPILOGUE,
    "no splits": NO_SPLITS,
    "no register split": REGS,
}
# dH1's epilogue (kTmaStore): no mask loaded into the staging tile, no tile
# stored; the consumers' epilogue (kDirect): no tile brought in, nothing written
_BOXES = "          const int boxes = min(TC_BN / 32, (n - n0 + 31) / 32);\n"
_NO_BOXES = "          const int boxes = k > 0 ? 0 : min(TC_BN / 32, (n - n0 + 31) / 32);\n"
_STORE_WAIT = "          if (lt > 0) bulk_wait_all<true>();\n"
_IN_WAIT = "          if (lt > 0) mbar_wait(staged, (lt - 1) & 1);\n"
NO_TMA_EPILOGUE = [("gemm_tc.cuh", _BOXES + _STORE_WAIT, _NO_BOXES + _STORE_WAIT)]
NO_DIRECT_EPILOGUE = [("gemm_tc.cuh", _BOXES + _IN_WAIT, _NO_BOXES + _IN_WAIT),
                      ("gemm_tc.cuh",
                       "        const int c = c0 + 8 * j;  // n even: c + 1 < n with it\n"
                       "        if (c < n) {\n",
                       "        const int c = c0 + 8 * j;  // n even: c + 1 < n with it\n"
                       "        if (c < n && k < 0) {\n")]
# every epilogue: the warps', the TMA-stored one's and the consumers'
GEMM["no epilogue"] += NO_EPILOGUE + NO_TMA_EPILOGUE + NO_DIRECT_EPILOGUE
BF16_DENSE["copies only, no epilogue"] = NO_PRODUCTS + GEMM["no epilogue"]
BF16_DENSE["products only, no epilogue"] = GEMM["products only"] + GEMM["no epilogue"]
# K2's products with a residual (`temporal.cu`'s gemm_bf16) through the
# epilogue warps (BiasActResidual) in place of the TMA-stored tiles
# (DenseTmaStore)
_WARPS_EPI = [("temporal.cu",
               "  if (residual)\n"
               "    return uu::launch_gemm_bf16_tma(a, plane, m, n, k, "
               "uu::DenseTmaStore{bias, n, relu, 1},\n"
               "                                    residual, out, (cudaStream_t)stream);\n",
               "  if (residual)\n"
               "    return uu::launch_gemm_bf16(a, plane, m, n, k,\n"
               "                                uu::BiasActResidual{bias, residual, out, n, "
               "relu},\n"
               "                                (cudaStream_t)stream);\n")]
BF16_GEMM = {**BF16_DENSE, "warps' epilogue": _WARPS_EPI,
             "copies only, warps' epilogue": NO_PRODUCTS + _WARPS_EPI}
DH1 = {"kernel": [],
       "no A copies": [_A_BYTES, ("conv_taps.cuh", _DH1_BOX, "    if (kt < 0)\n" + _DH1_BOX)],
       "no products": NO_PRODUCTS,
       "no epilogue": NO_TMA_EPILOGUE,
       "no register split": REGS}
NOT_BF16 = ("no splits",)  # variants the bf16 instances skip: they split nothing
_SINK = "if ({} == 1.2345e-30f) "  # a store the compiler cannot drop, never taken
# the attention backward's two kernels (temporal_bwd.cu: the 3xTF32 one, the
# bf16 rung's on native bf16) without their parts
_BWD_PRODUCTS = [
    ("temporal_bwd.cu", "  uu::mma_3xtf32(part, ab, as, bb, bs);\n", ""),
    ("temporal_bwd.cu", "            uu::mma_bf16(part, a, bb[2 * u], bb[2 * u + 1]);\n", ""),
    ("temporal_bwd.cu", "              uu::mma_bf16(part, a, b[2 * u], b[2 * u + 1]);\n", ""),
    ("temporal_bwd.cu", "            uu::mma_bf16(pk, as, bq[2 * u], bq[2 * u + 1]);\n"
                        "            uu::mma_bf16(pv, ap, bg[2 * u], bg[2 * u + 1]);\n", "")]
_BWD_NT = [("temporal_bwd.cu", "nq = 16 * warps, nt = (n + 7) / 8;\n",
            "nq = 16 * warps, nt = (n + 7) / 8 - 100;\n"),
           ("temporal_bwd.cu", "nk = (n + 7) & ~7, nt = nk / 8;\n",
            "nk = (n + 7) & ~7, nt = nk / 8 - 100;\n")]
# bf16 pairs packed by truncation: no rounding conversions
_NO_ROUNDING = [("mma_bf16.cuh",
                 '  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\\n" : "=r"(r) : "f"(hi), "f"(lo));\n',
                 "  r = (__float_as_uint(hi) & 0xffff0000u) | (__float_as_uint(lo) >> 16);\n")]
ATTN_BWD = {
    "kernel": [],
    "copies only": _BWD_PRODUCTS + _BWD_NT,
    "no products": _BWD_PRODUCTS,
    "no splits": NO_SPLITS + _NO_ROUNDING,
    "no gradient writes": [("temporal_bwd.cu", "    if (row < n && col < d)\n      *reinterpret_cast",
                            "    if (row < n - 4096 && col < d)\n      *reinterpret_cast")],
    # the blocks an SM holds at 71 tokens (launch bounds: the register cap)
    "bf16 3 blocks, 3xTF32 2 blocks per SM": [
        ("temporal_bwd.cu", "NT <= 10 ? 4 : 1)\nwindow_attention_bwd_bf16_kernel",
         "NT <= 10 ? 3 : 1)\nwindow_attention_bwd_bf16_kernel"),
        ("temporal_bwd.cu", "NT <= 9 ? 3 : 1)\nwindow_attention_bwd_tc_kernel",
         "NT <= 9 ? 2 : 1)\nwindow_attention_bwd_tc_kernel")],
}
# the entries the attention backward's probe times: 3xTF32 ("high") and the bf16 rung
ATTN_BWD_ENTRIES = (("window_attention_bwd_f32", "high"), ("window_attention_bwd_bf16", "default"))
# row 11 on bf16 tensors (attention.cuh's head_attention_bf16_kernel) without its parts
ATTN_BF16IO = {
    "kernel": [],
    "copies only": [("attention.cuh", "nk = (n + 15) & ~15, nt = nk / 8;",
                     "nk = (n + 15) & ~15, nt = nk / 8 - 100;")],
    "no products": [("attention.cuh", text, "") for text in (
        "          mma_bf16(p0, a, b[0], b[1]);\n          mma_bf16(p1, a, b[2], b[3]);\n",
        "          mma_bf16(s[j], a, b[0], b[1]);\n          mma_bf16(s[j + 1], a, b[2], b[3]);\n",
        "              mma_bf16(o[cc], a1, b[0], b[1]);\n"
        "              mma_bf16(o[cc + 1], a1, b[2], b[3]);\n",
        "                mma_bf16(p, a3, b[2 * u], b[2 * u + 1]);\n"
        "                mma_bf16(p, a2, b[2 * u], b[2 * u + 1]);\n"
        "                mma_bf16(p, a1, b[2 * u], b[2 * u + 1]);\n")],
    # "high": P in one bf16 term, not three
    "no splits": [("attention.cuh", "            a2[e] = pack_bf16(r0, r1);\n"
                   "            a3[e] = pack_bf16(r0 - bf16_lo(a2[e]), r1 - bf16_hi(a2[e]));\n",
                   "            a2[e] = a3[e] = a1[e] + (r0 == r1 + 1.2345e30f);\n")],
    "no stores": [("attention.cuh", "      if (row0 + r < n)\n        *reinterpret_cast<uint4*>",
                   "      if (row0 + r < n - 4096)\n        *reinterpret_cast<uint4*>")],
    # 3 blocks of 5 warps an SM at 71 tokens (a 136-register cap), not 4 (96)
    "3 blocks per SM": [("attention.cuh", "attn_min_blocks(NT / 2))\nhead_attention_bf16_kernel",
                         "NT == 10 ? 3 : attn_min_blocks(NT / 2))\nhead_attention_bf16_kernel")],
}
ATTN_BF16IO_ENTRIES = (("packed_attention_bf16io", "high"),
                       ("packed_attention_bf16io_bf16", "default"))
_MMA = "      uu::mma_3xtf32(part, ab, as, bb, bs);\n"
# rows_gemm's products (spatial_common.cuh): a running sum, fresh partials
_RUNNING = "        uu::mma_3xtf32(acc[j], ab, as, bb, bs);\n"
_FRESH = "        uu::mma_3xtf32(part, ab, as, bb, bs);\n"
_RUNNING1 = "        uu::mma_tf32(acc[j], ab, bb);\n"  # the bf16 mode's
_MMA1 = "        uu::mma_tf32(part, ab, bb);\n"
_DW = [("*out(i, o + 8 * u)", 0), ("*out(i, o + 8 * u + 1)", 1), ("*out(i + 8, o + 8 * u)", 2),
       ("*out(i + 8, o + 8 * u + 1)", 3)]
_DW_STORES = "".join(f"    {ref} = old[u][{e}] + acc[u][{e}];\n" for ref, e in _DW)
_DW_LOADS = "".join(f"    old[u][{e}] = {ref};\n" for ref, e in _DW)
K4 = {
    "kernel": [],
    "no products": [("spatial_bwd.cu", _MMA, ";\n"), ("spatial_bwd.cu", _MMA1, ";\n"),
                    ("spatial_common.cuh", _FRESH, ""), ("spatial_common.cuh", _RUNNING, ""),
                    ("spatial_common.cuh", _RUNNING1, "")],
    "no splits": NO_SPLITS,
    "no gradient writes": [  # dW's read-modify-writes of the gradient row
        ("spatial_bwd.cu", _DW_STORES,
         "    " + _SINK.format("acc[u][0] + acc[u][1] + acc[u][2] + acc[u][3]")
         + "*out(i, o) = 0.f;\n"),
        ("spatial_bwd.cu", _DW_LOADS,
         "    old[u][0] = old[u][1] = old[u][2] = old[u][3] = 0.f;\n")],
    "no attention backward": [
        ("spatial_bwd.cu", "      attention_bwd<C>(QKV_C, CTX, DQ, ST, nf, scale);\n", "")],
    # block 0's weights only, staged at its passes: the cost of staging
    "staged once": [("spatial_bwd.cu", "    sp::BlockWeights<C, THREADS> bwts;\n",
                     "    if (blk == 0) {\n    sp::BlockWeights<C, THREADS> bwts;\n"),
                    ("spatial_bwd.cu", "    bwts.template store<BF16>(WQKV);",
                     "    bwts.template store<BF16>(WQKV);\n    }")],
    # the checkpoints' and contexts' saves and restores through the scratch
    "no checkpoints": [("spatial_bwd.cu", "auto save = [&](float* dst, const float* src) {\n"
                        "    for (int e = threadIdx.x; e < R * C / 4;",
                        "auto save = [&](float* dst, const float* src) {\n"
                        "    for (int e = threadIdx.x; e < 0;"),
                       ("spatial_bwd.cu", "auto restore = [&](float* dst, const float* src) {\n"
                        "    for (int e = threadIdx.x; e < R * C / 4;",
                        "auto restore = [&](float* dst, const float* src) {\n"
                        "    for (int e = threadIdx.x; e < 0;")],
}
# the entries K4's probe times: the 3xTF32 instance ("high") and the bf16 rung
K4_ENTRIES = (("spatial_bwd_f32", "high"), ("spatial_bwd_bf16", "default"))
# K1: its accumulation against K4's (A/B), then without its parts
K1_AB = {
    "kernel": [],
    "fresh partials": [("spatial_common.cuh", "      if (FRESH) {\n", "      if (true) {\n")],
}
K1 = {
    **K1_AB,
    "no products": [("spatial_common.cuh", _RUNNING, ""), ("spatial_common.cuh", _FRESH, "")],
    "no attention": [("spatial.cu", "      sp::attention_fwd<C>(QKV, QKV, P3, nf, scale);\n", "")],
    "no LayerNorm statistics": [
        ("spatial.cu", "P3 + k]; };\n      sp::ln_stats<C>(X, mu, rs, 1e-5f);\n", "P3 + k]; };\n"),
        ("spatial.cu", "nullptr);\n      __syncwarp();\n      sp::ln_stats<C>(X, mu, rs, 1e-5f);\n",
         "nullptr);\n      __syncwarp();\n")],
    "no gelu": [("spatial.cu", "sp::gelu(v + V[S::B1 + n])", "(v + V[S::B1 + n])")],
    "no splits": NO_SPLITS,
    "one pass, no splits": NO_SPLITS + ONE_MMA,
    "staged once": [("spatial.cu", "      {  // stage this block's weights",
                     "      if (blk == 0) {  // stage this block's weights")],
}
# row 11's short kernels without their arithmetic, and without their loads
_TASK_CALL = "      task_attend<D, BF16>(qc, kh, kh + gf, mk, s, c, o);\n"
_LANE_CALL = "      lane_attend<NV, SMAX, BF16>(qr, kr, vr, mk, s, lph, scale2, o);\n"
_ADD3 = "make_float4({a}.x + {b}.x + {c}.x, {a}.y + {b}.y + {c}.y, {a}.z + {b}.z + {c}.z, " \
        "{a}.w + {b}.w + {c}.w)"
_BULK = ("    mbar_expect_tx(bar, 2 * bytes);\n"
         "    bulk_load(dst, k + (size_t)grp * gf, bytes, bar);\n"
         "    bulk_load(dst + gf, v + (size_t)grp * gf, bytes, bar);\n")
SHORT = {
    "kernel": [],
    "copies only": [
        ("packed_attention.cuh", _TASK_CALL,
         "      for (int u = 0; u < D / 4; ++u) o[u] = "
         + _ADD3.format(a="qc[u]", b="(*reinterpret_cast<const float4*>(kh + 4 * u))",
                        c="(*reinterpret_cast<const float4*>(kh + gf + 4 * u))") + ";\n"),
        ("packed_attention.cuh", _LANE_CALL,
         "      for (int u = 0; u < NV; ++u) {\n        o[u] = qr[u];\n"
         "        for (int j = 0; j < SMAX; ++j)\n          if (j < s) o[u] = "
         + _ADD3.format(a="o[u]", b="kr[j][u]", c="vr[j][u]") + ";\n      }\n")],
    "compute only": [
        ("packed_attention.cuh", "  return __ldg(reinterpret_cast<const float4*>(p));\n",
         "  const float a = (float)((size_t)p % 4096) * 1e-4f;\n"
         "  return make_float4(a, a, a, a);\n"),
        ("packed_attention.cuh", _BULK,
         '    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\\n" :: "r"(bar) : '
         '"memory");\n')],
    "3 blocks per SM": [("packed_attention.cuh", "constexpr int TASK_BLOCKS = 2;",
                         "constexpr int TASK_BLOCKS = 3;")],
    "1 block per SM": [("packed_attention.cuh", "constexpr int TASK_BLOCKS = 2;",
                        "constexpr int TASK_BLOCKS = 1;")],
}
# the probes --only selects; "dense" is the attention, GEMM, dW and conv
# groups, "dw" the dW groups alone
PROBES = ("dense", "dense_bf16", "dw", "conv", "attn_bwd", "attn_bf16io", "k4", "k1", "short",
          "e2e")
DW_GROUPS = ("dw", "dw_bf16", "dwc")
CONV_GROUPS = ("conv", "dh1", "gemm")  # "dense A" reads the GEMM
# "dense_bf16"'s builds: gemm_bf16 from "gemm"; the library each group builds
BF16_LIBS = {"gemm": "temporal", "bf16 bwd": "temporal_bwd", "bf16 s2t": "s2t"}
BF16_GROUPS = tuple(BF16_LIBS)
# gemm_atb_kernel (the dW product) without its parts: the loader's TMA
# loads and gathers, the products, the consumers' operand buffers, the splits
_DW_TMA = "      if (threadIdx.x == 0) {\n        mbar_expect_tx("
_DW_GATHER = "        ab_gather_rows(x_at, k0, k_end, m0, m, taps, xs_of(s), full + 8 * s);\n"
_DW_COPIES = [("gemm_tc.cuh", _DW_TMA, "      if (threadIdx.x == 0) mbar_arrive(full + 8 * s);\n"
               "      if (threadIdx.x == 0 && n < 0) {\n        mbar_expect_tx("),
              ("gemm_tc.cuh", _DW_GATHER, "        cp_async_mbar_arrive(full + 8 * s);\n")]
_DW_3X = ("            if (j == 0)\n"
          "              wgmma_m64n64k8_tf32_first(p[h], fsm[jj], db + off);\n"
          "            else\n"
          "              wgmma_m64n64k8_tf32(p[h], fsm[jj], db + off);\n"
          "            wgmma_m64n64k8_tf32(p[h], fb[jj], ds + off);\n"
          "            wgmma_m64n64k8_tf32(p[h], fb[jj], db + off);\n")
_DW_BF16 = ("        wgmma_m64n64k16_bf16_mn(p[h], da, dbh, 0);\n"
            "        wgmma_m64n64k16_bf16_mn(p[h], da + (2048 >> 4), dbh + (2048 >> 4), 1);\n")
_DW_SPLIT = "          tf32_split(k < valid ? e4[e] * f_lane : 0.f, big[at], small[at]);"
_DW_ROUND = ["        *reinterpret_cast<uint2*>(ops + off) =",
             "        *reinterpret_cast<uint2*>(ops + AB_BK * AB_BM * 2 + off) ="]
DW = {
    "kernel": [],
    "products only": _DW_COPIES,
    "copies only": [("gemm_tc.cuh", _DW_3X, "")],
    "no converter": [("gemm_tc.cuh", _DW_SPLIT, "if (n < 0) " + _DW_SPLIT.strip())],
    "no splits": NO_SPLITS,
    "one pass, no splits": NO_SPLITS + [
        ("gemm_tc.cuh", _DW_3X,
         "            if (j == 0)\n"
         "              wgmma_m64n64k8_tf32_first(p[h], fb[jj], db + off);\n"
         "            else\n"
         "              wgmma_m64n64k8_tf32(p[h], fb[jj], db + off);\n")],
}
# the bf16 mode: the same parts (no splits there: the converters round)
DW_BF16 = {
    "kernel": [],
    "products only": _DW_COPIES,
    "copies only": [("gemm_tc.cuh", _DW_BF16, "")],
    "no converter": [("gemm_tc.cuh", a, "if (n < 0) " + a.strip()) for a in _DW_ROUND],
}
# strided_bwd.cu's dWc, both modes' parts taken out together
DWC = {"kernel": [], "products only": _DW_COPIES,
       "copies only": DW["copies only"] + DW_BF16["copies only"],
       "no converter": DW["no converter"] + DW_BF16["no converter"]}


def start_build(cuda_lib, tag, source, reps, csrc=None):
    """csrc/ (or `csrc`) copied to _build/probe/<tag>, `reps` applied, nvcc
    started on <source>.cu with ptxas's report on stderr; returns (process,
    library path)."""
    out = cuda_lib.BUILD_DIR / "probe" / tag.replace(" ", "_").replace(",", "")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc or cuda_lib.CSRC_DIR, out)
    for fname, old, new in reps:
        path = out / fname
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"probe patch {old!r} does not match {fname} exactly once")
        path.write_text(text.replace(old, new))
    lib = out / f"lib{source}.so"
    proc = subprocess.Popen([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                             str(lib), str(out / f"{source}.cu")],
                            stderr=subprocess.PIPE, text=True)
    return proc, lib


def bind(lib, fn_name, nptr, nint):
    """fn_name of the built library with `nptr` pointers, `nint` ints and the stream."""
    fn = getattr(ctypes.CDLL(str(lib)), fn_name)
    fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * nint + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", default="",
                        help=f"a comma-separated subset of {','.join(PROBES)}")
    parser.add_argument("--parent", default=None,
                        help="a copy of an earlier csrc/: 'short' times its "
                             "packed_attention_f32 beside the kernels, 'attn_bwd' and "
                             "'attn_bf16io' its attention backward and row 11 on bf16 "
                             "tensors in turn with this build's, 'dense' every "
                             "caller of gemm_tc_kernel, 'k4' its K4 in turn with this "
                             "build's (and K1's digests from both)")
    args = parser.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device; this run needs a card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import card_line, ptxas_report
    from uplift_upsample_torch.ops import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card_line()}", flush=True)
    only = set(args.only.split(",")) if args.only else set(PROBES)
    if only - set(PROBES):
        raise SystemExit(f"--only takes {','.join(PROBES)}")
    builds = {}
    for group, source, variants in (("attention", "attention", ATTENTION),
                                    ("gemm", "temporal", {**GEMM, **BF16_GEMM}),
                                    ("dw", "temporal_bwd", DW),
                                    ("dw_bf16", "temporal_bwd", DW_BF16),
                                    ("dwc", "strided_bwd", DWC),
                                    ("bf16 bwd", "temporal_bwd", BF16_DENSE),
                                    ("bf16 s2t", "s2t", BF16_DENSE),
                                    ("conv", "strided", CONV), ("dh1", "strided_bwd", DH1),
                                    ("attn_bwd", "temporal_bwd", ATTN_BWD),
                                    ("attn_bf16io", "attention_bf16", ATTN_BF16IO),
                                    ("k4", "spatial_bwd", K4), ("k1", "spatial", K1),
                                    ("short", "attention", SHORT)):
        probes = ({group} if group in PROBES and group != "conv" else
                  {"dense", "dw"} if group in DW_GROUPS else
                  {"dense", "conv", "dense_bf16"} if group == "gemm" else
                  {"dense", "conv"} if group in CONV_GROUPS else
                  {"dense", "dense_bf16"} if group in BF16_GROUPS else {"dense"})
        for name, reps in variants.items() if probes & only else ():
            if group == "gemm" and "dense" not in only and not (
                    name == "kernel" or ("dense_bf16" in only and name in BF16_GEMM)):
                continue  # "conv" reads only the GEMM as it is ("dense A")
            builds[group, name] = start_build(cuda_lib, f"{group} {name}", source, reps)
    if "short" in only and args.parent:
        builds["short", "parent"] = start_build(cuda_lib, "short parent", "attention", [],
                                                csrc=os.path.abspath(args.parent))
    for group, source in (("attn_bwd", "temporal_bwd"), ("attn_bf16io", "attention_bf16")):
        if group in only and args.parent:
            builds[group, "parent"] = start_build(cuda_lib, f"{group} parent", source, [],
                                                  csrc=os.path.abspath(args.parent))
    if "k4" in only and args.parent:
        builds["k4", "parent"] = start_build(cuda_lib, "k4 parent", "spatial_bwd", [],
                                             csrc=os.path.abspath(args.parent))
        builds["k4", "k1 kernel"] = start_build(cuda_lib, "k4 k1 kernel", "spatial", [])
        builds["k4", "k1 parent"] = start_build(cuda_lib, "k4 k1 parent", "spatial", [],
                                                csrc=os.path.abspath(args.parent))
    for key, (proc, _) in builds.items():
        _, report = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"probe build {key} failed:\n{report}")
        # registers and spills of each K1 accumulation, each short variant and
        # each dW kernel as it is
        if ((key[0] == "k1" and key[1] in K1_AB) or key[0] == "short"
                or (key[0] in DW_GROUPS + ("conv", "dh1") + BF16_GROUPS
                    and key[1] == "kernel")
                or (key[0] == "k4" and key[1] in ("kernel", "parent"))):
            for kernel, line in ptxas_report(report):
                print(f"ptxas {key[0]} {key[1]}, {kernel}: {line}", flush=True)
        elif key[0] in ("attn_bwd", "attn_bf16io"):
            for kernel, line in attention_ptxas(report, key[0]):
                print(f"ptxas {key[0]} {key[1]}, {kernel}: {line}", flush=True)

    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(args.seed)
    rand = lambda *shape, scale=0.5: torch.from_numpy(
        (rng.normal(size=shape) * scale).astype(np.float32)).to(dev)

    if "dense" in only:
        probe_dense(torch, F, builds, rand, rng, dev, stream)
    else:
        if "dense_bf16" in only:
            probe_dense_bf16(torch, builds, rand, rng, dev, stream)
        if "dw" in only:
            probe_dw(torch, builds, rand, rng, dev, stream)
        if "conv" in only:
            probe_conv(torch, F, builds, rand, dev, stream)
    if args.parent and only & {"dense", "dense_bf16", "dw", "conv"}:
        probe_gemm_parent(args.parent, args.seed,
                          None if only & {"dense", "dw"} else
                          "conv" if "conv" in only else "dense_bf16")
    if "attn_bwd" in only:
        probe_attention_bwd(torch, F, builds, rand, rng, dev, stream)
    if "attn_bf16io" in only:
        probe_attention_bf16io(torch, F, builds, rand, rng, dev, stream)
    if "k4" in only:
        probe_spatial_bwd(torch, builds, rand, args.seed, dev, stream)
    if "k1" in only:
        probe_spatial(torch, builds, rand, args.seed, dev, stream)
    if "short" in only:
        probe_short(torch, F, builds, rand, dev, stream)
    if "e2e" in only:
        probe_end_to_end(args.parent, args.seed)
    return 0


def probe_dense(torch, F, builds, rand, rng, dev, stream):
    """The attention (row 11's shapes), the dense-layer GEMM, dW and dWc, the
    conv forward and its dH1, each beside its PyTorch call."""
    from chip_smoke import time_ms
    from uplift_upsample_torch.ops.packed_attention import packed_attention_plain
    from uplift_upsample_torch.ops.temporal import tf32_halves

    heads, c = 8, 384
    cases = []
    for s, masked in ((71, True), (71, False), (23, False)):
        q, k, v = (rand(1024, s, c, scale=1.0) for _ in range(3))
        km = (torch.from_numpy((rng.uniform(size=(1024, s)) < 0.5).astype(np.float32)).to(dev)
              if masked else None)
        split = lambda t: t.reshape(1024, s, heads, c // heads).transpose(1, 2)
        add_mask = None if km is None else (km * -1e9)[:, None, None, :]
        sdpa = time_ms(torch, lambda: F.scaled_dot_product_attention(
            split(q), split(k), split(v), attn_mask=add_mask), 10)
        cases.append((s, masked, q, k, v, km, sdpa))
    for name in ATTENTION:
        fn = bind(builds["attention", name][1], "packed_attention_f32", 5, 4)
        for s, masked, q, k, v, km, sdpa in cases:
            out = torch.empty_like(q)
            call = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              None if km is None else km.data_ptr(), out.data_ptr(),
                              1024, s, c, heads, stream())
            if call() != 0:
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            err = ""
            if name == "kernel":
                ref = packed_attention_plain(q, k, v, km, num_heads=heads)
                err = f" max_abs_err {float((out - ref).abs().max()):.3e};"
            print(f"probe {name}: 1024 x {s} x {c}, key mask {masked}:{err} "
                  f"ms {time_ms(torch, call, 20):.4f} (SDPA {sdpa:.4f})", flush=True)
    del cases

    m, n = 1024 * 71, 3 * c
    a, w, bias = rand(m, c), rand(c, n, scale=0.05), rand(n, scale=0.1)
    halves = tf32_halves(w)
    out = torch.empty((m, n), device=dev)
    addmm = time_ms(torch, lambda: torch.addmm(bias, a, w), 20)
    for name in GEMM:
        fn = bind(builds["gemm", name][1], "gemm_f32", 5, 4)
        call = lambda: fn(a.data_ptr(), halves.data_ptr(), bias.data_ptr(), None,
                          out.data_ptr(), m, n, c, 0, stream())
        if call() != 0:
            raise RuntimeError(f"gemm {name}: launch failed")
        torch.cuda.synchronize()
        err = ""
        if name == "kernel":
            err = f" max_abs_err {float((out - (a @ w + bias)).abs().max()):.3e};"
        print(f"probe gemm {name}: {m} x {c} -> {n}:{err} ms {time_ms(torch, call, 20):.4f} "
              f"(addmm {addmm:.4f})", flush=True)
    del a, out

    probe_dense_bf16(torch, builds, rand, rng, dev, stream)

    probe_dw(torch, builds, rand, rng, dev, stream)

    probe_conv(torch, F, builds, rand, dev, stream)


# The serving call's card time in the checkout at the working directory:
# bench_forward on 1,024 h36m_351 windows (seeded weights, MASK_STRIDE 5),
# "high" and "default", 3 rounds of 10 calls after 3, CUDA events; one line
# "E2E_FORWARD {json}".
FORWARD_TIMER = """
import json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
from uplift_upsample_torch.configs import get_config
from uplift_upsample_torch.models import build_uplift_upsample_transformer
from uplift_upsample_torch.models.bench_forward import bench_forward, prepare_fused_params
torch.backends.cuda.matmul.allow_tf32 = False
cfg = get_config("h36m_351")
model = build_uplift_upsample_transformer(cfg, device="cuda", seed=SEED)
rng = np.random.default_rng(SEED)
b, n = 1024, cfg.SEQUENCE_LENGTH
x = torch.from_numpy(rng.standard_normal((b, n, 17, 2)).astype(np.float32)).cuda()
mask = torch.from_numpy((np.arange(n)[None] + rng.integers(0, 5, size=(b, 1))) % 5 == 0).cuda()
x = x * mask[..., None, None]
out = {}
for rung in ("high", "default"):
    fp = prepare_fused_params(model, rung)
    call = lambda: bench_forward(model, x, mask, fp, precision=rung)
    for _ in range(3):
        call()
    best = []
    for _ in range(3):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(10):
            call()
        e.record()
        e.synchronize()
        best.append(s.elapsed_time(e) / 10)
    out[rung] = min(best)
print("E2E_FORWARD " + json.dumps(out), flush=True)
"""


def probe_end_to_end(parent, seed):
    """The serving call (FORWARD_TIMER) and the B=512 training step at
    "default" (`tools/profile_train.py`: the full step, its forward and K5
    alone, slopes of 4 and 16 chained calls) in the checkout whose
    `uplift_upsample_torch/csrc` is `parent` and in this one, in turn
    (parent, this, this, parent), each in a process of its own started in
    that checkout (which builds its own kernels)."""
    from pathlib import Path

    if parent is None:
        raise SystemExit("--only e2e needs --parent <checkout>/uplift_upsample_torch/csrc")
    trees = {"parent": Path(parent).resolve().parents[1], "this": Path(ROOT)}
    for label in ("parent", "this", "this", "parent"):
        tree = trees[label]
        fwd = subprocess.run([sys.executable, "-c", FORWARD_TIMER.replace("SEED", str(seed))],
                             cwd=tree, capture_output=True, text=True, timeout=900)
        lines = [ln for ln in fwd.stdout.splitlines() if ln.startswith("E2E_FORWARD")]
        print(f"probe e2e {label} forward: {lines[-1][12:] if lines else fwd.stderr[-2000:]}",
              flush=True)
        train = subprocess.run([sys.executable, "-m", "uplift_upsample_torch.tools.profile_train",
                                "--variants", "full,fwd,temporal", "--precision", "default"],
                               cwd=tree, capture_output=True, text=True, timeout=900)
        for ln in train.stdout.splitlines() or [train.stderr[-2000:]]:
            print(f"probe e2e {label} train: {ln}", flush=True)


def probe_dense_bf16(torch, builds, rand, rng, dev, stream):
    """gemm_tc_kernel's bf16 rung at its dense callers, with every variant of
    BF16_DENSE: gemm_bf16 at K2's four serving products (72,704 rows: qkv,
    proj + residual, fc1 + relu, fc2 + the residual aliasing the output),
    gemm_branch_bf16 and gemm_dx_bf16 (row scale, relu mask) at fc2 on the
    train step's 36,352 rows, s2t_prologue_bf16 (72,704 x 544 -> 384, the
    stride mask). Beside each: torch.matmul on operands rounded to bf16
    beforehand (bf16 out), and the same function from the same fp32 inputs as
    the fastest PyTorch sequence tried (A cast to bf16, W's bf16 plane, fp32
    out with `out_dtype`, then bias, relu, residual, row scale, mask, token
    and PE; every cast timed)."""
    from chip_smoke import time_ms
    from uplift_upsample_torch.ops import cuda_lib
    from uplift_upsample_torch.ops.temporal import bf16_plane
    from uplift_upsample_torch.precision import mm

    bf, f32 = torch.bfloat16, torch.float32

    def fastest(seqs):
        """(label, ms) of the fastest sequence that runs on this torch."""
        best = None
        for label, fn in seqs:
            try:
                fn()
            except (RuntimeError, TypeError):
                continue
            ms = time_ms(torch, fn, 20)
            if best is None or ms < best[1]:
                best = (label, ms)
        return best or ("none ran", float("nan"))

    def addmm_f32(bias, a, w):  # bf16 operands, fp32 sums and output
        return torch.addmm(bias, a, w, out_dtype=f32)

    def mm_f32(a, w):
        return torch.mm(a, w, out_dtype=f32)

    def run(case, entry, group, args, got, ref, pre, seqs):
        """Each variant of `entry` from `group`'s builds (BF16_GEMM for
        gemm_bf16, else BF16_DENSE) on `args` (the kernel's outputs `got()`
        against `ref`), beside the library."""
        same = fastest(seqs)
        lib_pre = time_ms(torch, pre, 20)
        sig = cuda_lib._SIGNATURES[BF16_LIBS[group]][entry]
        for name in BF16_GEMM if group == "gemm" else BF16_DENSE:
            fn = getattr(ctypes.CDLL(str(builds[group, name][1])), entry)
            fn.argtypes = [cuda_lib._CTYPES[ch] for ch in sig]
            fn.restype = ctypes.c_int
            cargs = [None if a is None else a.data_ptr() if torch.is_tensor(a) else a
                     for a in args]
            call = lambda: fn(*cargs, stream())
            if call() != 0:
                raise RuntimeError(f"{case} {name}: launch failed")
            torch.cuda.synchronize()
            err = (f" max_abs_err {float((got() - ref).abs().max()):.3e};"
                   if name == "kernel" else "")
            print(f"probe bf16 {case} {name}: {entry}:{err} ms {time_ms(torch, call, 20):.4f} "
                  f"(torch.matmul on pre-rounded bf16 {lib_pre:.4f}; same inputs "
                  f"{same[1]:.4f}, {same[0]})", flush=True)

    c, hid = 384, 768
    m = 1024 * 71
    for label, k, n, relu, residual in (("qkv", c, 3 * c, 0, None), ("proj", c, c, 0, "res"),
                                        ("fc1", c, hid, 1, None), ("fc2", hid, c, 0, "alias")):
        a, w, bias = rand(m, k), rand(k, n, scale=0.05), rand(n, scale=0.1)
        plane, w_bf, a_bf = bf16_plane(w), w.to(bf), a.to(bf)
        res = rand(m, n) if residual else None
        out = torch.empty((m, n), device=dev)
        act = torch.relu if relu else (lambda t: t)
        ref = act(mm(a, w, "default") + bias) + (0 if res is None else res)
        if residual == "alias":  # out = h + (a·w + b), written over h
            h0 = res.clone()
            out = res
        seqs = [("addmm out_dtype", lambda: act(addmm_f32(bias, a.to(bf), w_bf))),
                ("mm out_dtype + bias", lambda: act(mm_f32(a.to(bf), w_bf) + bias))]
        if residual:
            seqs = [("addmm out_dtype + residual",
                     lambda: addmm_f32(bias, a.to(bf), w_bf).add_(h0 if residual == "alias"
                                                                  else res)),
                    ("addmm(residual) out_dtype + bias",
                     lambda: addmm_f32(h0 if residual == "alias" else res, a.to(bf),
                                       w_bf).add_(bias))]
        if residual == "alias":
            res.copy_(h0)
            ref = mm(a, w, "default") + bias + h0
        run(label, "gemm_bf16", "gemm", [a, plane, bias, res, out, m, n, k, relu],
            lambda: out, ref, lambda: torch.matmul(a_bf, w_bf), seqs)
        if residual == "alias":
            res.copy_(h0)
        del a, w, plane, w_bf, a_bf, res, out, ref

    m, per = 512 * 71, 71
    scale = torch.from_numpy(np.where(rng.uniform(size=512) < 0.9, 1 / 0.9, 0.0)
                             .astype(np.float32)).to(dev)
    srow = lambda: scale.repeat_interleave(per)[:, None]
    a, w, bias, res = rand(m, hid), rand(hid, c, scale=0.05), rand(c, scale=0.1), rand(m, c)
    plane, w_bf, a_bf = bf16_plane(w), w.to(bf), a.to(bf)
    branch, out = torch.empty((m, c), device=dev), torch.empty((m, c), device=dev)
    z = mm(a, w, "default") + bias
    ref = torch.cat([res + z * srow(), z], 1)

    def branch_seq():
        z_ = addmm_f32(bias, a.to(bf), w_bf)
        return torch.addcmul(res, z_, srow()), z_
    run("branch fc2", "gemm_branch_bf16", "bf16 bwd",
        [a, plane, bias, scale, per, res, branch, out, m, c, hid, 0],
        lambda: torch.cat([out, branch], 1), ref, lambda: torch.matmul(a_bf, w_bf),
        [("addmm out_dtype + addcmul", branch_seq)])
    del a, plane, a_bf, branch, out, z, ref

    g, mask = rand(m, c, scale=1.0), torch.relu(rand(m, hid))
    w2 = w  # (hid, c) as stored: dX = (s·g)·w2ᵀ
    plane, w2_bf, g_bf = bf16_plane(w2, transpose=False), w2.to(bf), (g * srow()).to(bf)
    out = torch.empty((m, hid), device=dev)
    ref = torch.where(mask > 0, mm(g * srow(), w2.t(), "default"), 0.0)
    run("dx fc2", "gemm_dx_bf16", "bf16 bwd", [g, scale, per, plane, mask, out, m, hid, c],
        lambda: out, ref, lambda: torch.matmul(g_bf, w2_bf.t()),
        [("mm out_dtype + where", lambda: torch.where(
            mask > 0, mm_f32((g * srow()).to(bf), w2_bf.t()), 0.0))])
    del g, mask, w, w2, plane, w2_bf, g_bf, out, ref, res

    m, k, n_t = 1024 * 71, 17 * 32, 71
    sp, w, bias = rand(m, k, scale=1.0), rand(k, c, scale=0.05), rand(c, scale=0.1)
    smask = torch.from_numpy((rng.uniform(size=m) < 0.3).astype(np.float32)).to(dev)
    token, pe = rand(c), rand(n_t, c)
    plane, w_bf, sp_bf = bf16_plane(w), w.to(bf), sp.to(bf)
    out = torch.empty((m, c), device=dev)
    y = mm(sp, w, "default") + bias
    ref = (smask[:, None] * y + (1 - smask[:, None]) * token).reshape(-1, n_t, c) + pe
    run("s2t", "s2t_prologue_bf16", "bf16 s2t",
        [sp, plane, bias, smask, token, pe, out, m, c, k, n_t], lambda: out, ref.reshape(m, c),
        lambda: torch.matmul(sp_bf, w_bf),
        [("addmm out_dtype + where + pe", lambda: (torch.where(
            smask[:, None] > 0, addmm_f32(bias, sp.to(bf), w_bf), token).reshape(-1, n_t, c)
            + pe))])
    del sp, w, plane, w_bf, sp_bf, out, ref, y
    torch.cuda.empty_cache()


def probe_conv(torch, F, builds, rand, dev, stream):
    """The conv forward at serving (1,024 windows x 23 selected rows, K = 3 x
    768 -> 384) and its dH1 at the train step (512 windows), each in 3xTF32
    ("high") and on the bf16 rung ("default"), with every variant of CONV and
    DH1 (one build holds both instances), beside the PyTorch call on
    operands prepared beforehand and on the same inputs as the kernel (h1 or
    g as the kernel takes them: layouts, casts and the relu mask timed)."""
    from chip_smoke import time_ms
    from uplift_upsample_torch.ops.strided import conv_taps_plain, strided_conv_plain
    from uplift_upsample_torch.ops.strided_train import conv_dh1_plain
    from uplift_upsample_torch.ops.temporal import bf16_plane, tf32_halves

    c = 384
    bf = torch.bfloat16
    b, n, hid, s0 = 1024, 71, 2 * c, 3
    n_out = (n - 3) // s0 + 1
    h1, x = torch.relu(rand(b, n, hid)), rand(b, n, c)
    wc, bc = rand(3 * hid, c, scale=0.03), rand(c, scale=0.1)
    operands = {"f32": tf32_halves(wc), "bf16": bf16_plane(wc)}
    res = x[:, 1: 1 + s0 * (n_out - 1) + 1: s0]
    h1t, wt = h1.transpose(1, 2).contiguous(), wc.reshape(3, hid, c).permute(2, 1, 0).contiguous()
    wt_bf, h1t_bf, bc_bf = wt.to(bf), h1t.to(bf), bc.to(bf)
    library = {
        "f32": time_ms(torch, lambda: res + F.conv1d(h1t, wt, bc, stride=s0).transpose(1, 2), 20),
        "bf16": time_ms(torch, lambda: res + F.conv1d(h1t_bf, wt_bf, bc_bf, stride=s0)
                        .transpose(1, 2).float(), 20)}
    same = {
        "f32": time_ms(torch, lambda: res + (F.conv1d(h1.transpose(1, 2), wt, None, stride=s0)
                                             .transpose(1, 2) + bc), 20),
        "bf16": time_ms(torch, lambda: res + (F.conv1d(h1.to(bf).transpose(1, 2), wt_bf, None,
                                                       stride=s0).float().transpose(1, 2) + bc),
                        20)}
    out = torch.empty((b * n_out, c), device=dev)
    taps = conv_taps_plain(h1, s0, (0, 0)).reshape(-1, 3 * hid)
    res2 = res.reshape(-1, c)
    dense = bind(builds["gemm", "kernel"][1], "gemm_f32", 5, 4)
    dense_bf = bind(builds["gemm", "kernel"][1], "gemm_bf16", 5, 4)
    plane_dense = bf16_plane(wc)  # gemm_bf16's plane (c, 3 x hidden)
    for mode, entry, rung in (("f32", "strided_conv_f32", "high"),
                              ("bf16", "strided_conv_bf16", "default")):
        w = operands[mode]
        ref = strided_conv_plain(h1, x, wc, bc, stride=s0, paddings=(0, 0), precision=rung)
        wd, fd = (plane_dense, dense_bf) if mode == "bf16" else (w, dense)
        variants = {"dense A": lambda wd=wd, fd=fd: fd(taps.data_ptr(), wd.data_ptr(),
                                                       bc.data_ptr(), res2.data_ptr(),
                                                       out.data_ptr(), b * n_out, c, 3 * hid,
                                                       0, stream())}
        for name in CONV:
            fn = bind(builds["conv", name][1], entry, 5, 7)
            variants[name] = lambda fn=fn, w=w: fn(h1.data_ptr(), x.data_ptr(), w.data_ptr(),
                                                   bc.data_ptr(), out.data_ptr(), b, n, hid, c,
                                                   s0, 0, n_out, stream())
        for name in ["kernel", "dense A", *list(CONV)[1:]]:
            if mode == "bf16" and name in NOT_BF16:
                continue
            call = variants[name]
            if call() != 0:
                raise RuntimeError(f"conv {mode} {name}: launch failed")
            torch.cuda.synchronize()
            err = ""
            if name in ("kernel", "dense A"):
                err = f" max_abs_err {float((out.reshape(ref.shape) - ref).abs().max()):.3e};"
            print(f"probe conv {mode} {name}: {entry} {b * n_out} x {3 * hid} -> {c}:{err} ms "
                  f"{time_ms(torch, call, 20):.4f} (F.conv1d + add {library[mode]:.4f}, same "
                  f"inputs {same[mode]:.4f})", flush=True)
    del h1, x, taps, res, res2, out, h1t, h1t_bf

    b = 512
    h1, g = torch.relu(rand(b, n, hid)), rand(b, n_out, c, scale=1.0)
    operands = {"f32": tf32_halves(wc, transpose=False),
                "bf16": bf16_plane(wc, transpose=False)}
    dh1 = torch.empty_like(h1)
    g_t = g.transpose(1, 2).contiguous()
    h1t = h1.transpose(1, 2).contiguous()
    h1t_bf, g_t_bf = h1t.to(bf), g_t.to(bf)
    mask = [True, False, False]  # the input's gradient only
    bwd = torch.ops.aten.convolution_backward
    library = {
        "f32": time_ms(torch, lambda: bwd(g_t, h1t, wt, None, [s0], [0], [1], False, [0], 1,
                                          mask), 20),
        "bf16": time_ms(torch, lambda: bwd(g_t_bf, h1t_bf, wt_bf, None, [s0], [0], [1], False,
                                           [0], 1, mask), 20)}
    same = {
        "f32": time_ms(torch, lambda: torch.where(
            h1 > 0, bwd(g.transpose(1, 2), h1t, wt, None, [s0], [0], [1], False, [0], 1,
                        mask)[0].transpose(1, 2), 0.0), 20),
        "bf16": time_ms(torch, lambda: torch.where(
            h1 > 0, bwd(g.to(bf).transpose(1, 2), h1t_bf, wt_bf, None, [s0], [0], [1], False,
                        [0], 1, mask)[0].float().transpose(1, 2), 0.0), 20)}
    for mode, entry, rung in (("f32", "strided_dh1_f32", "high"),
                              ("bf16", "strided_dh1_bf16", "default")):
        w = operands[mode]
        ref = conv_dh1_plain(g, wc, h1, stride=s0, paddings=(0, 0), precision=rung)
        for name in DH1:
            if mode == "bf16" and name in NOT_BF16:
                continue
            fn = bind(builds["dh1", name][1], entry, 4, 7)
            call = lambda: fn(g.data_ptr(), w.data_ptr(), h1.data_ptr(), dh1.data_ptr(), b, n,
                              hid, c, s0, 0, n_out, stream())
            if call() != 0:
                raise RuntimeError(f"dh1 {mode} {name}: launch failed")
            torch.cuda.synchronize()
            err = (f" max_abs_err {float((dh1 - ref).abs().max()):.3e};" if name == "kernel"
                   else "")
            print(f"probe dh1 {mode} {name}: {entry} {b * n_out} x {c} -> {3 * hid}:{err} ms "
                  f"{time_ms(torch, call, 20):.4f} (convolution_backward, input "
                  f"{library[mode]:.4f}, same inputs {same[mode]:.4f})", flush=True)
    del h1, g, dh1, g_t, h1t, h1t_bf, g_t_bf
    torch.cuda.empty_cache()


def probe_dw(torch, builds, rand, rng, dev, stream):
    """gemm_atb_kernel's variants: dW in 3xTF32 at qkv (384 x 1,152 over
    36,352 rows), in bf16 at fc2 (768 x 384, the per-window row scale), and
    dWc (strided_bwd.cu, the taps gathered from h1) at the train step's 512
    windows x 23 rows, K6's (3 x 768) x 384, in both modes; each beside
    torch.mm on the same fp32 operands (the scale applied, the taps written
    out) and, as it is, against float64 on the operands it reads."""
    from chip_smoke import time_ms
    from uplift_upsample_torch.ops.strided import conv_taps_plain
    from uplift_upsample_torch.ops.temporal_train import dw_splits

    c = 384
    rows, per = 512 * 71, 71
    scale = torch.from_numpy(np.where(rng.uniform(size=512) < 0.9, 1 / 0.9, 0.0)
                             .astype(np.float32)).to(dev)
    sig = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    for group, entry, mw, nw, scaled in (("dw", "gemm_dw_f32", c, 3 * c, False),
                                         ("dw_bf16", "gemm_dw_bf16", 2 * c, c, True)):
        x, dy = rand(rows, mw), rand(rows, nw, scale=1.0)
        sc = scale if scaled else None
        dys = dy * scale.repeat_interleave(per)[:, None] if scaled else dy
        if group == "dw_bf16":
            ref = x.bfloat16().double().t() @ dys.bfloat16().double()
        else:
            ref = x.double().t() @ dys.double()
        splits = dw_splits(rows, mw, nw)
        part = torch.empty((splits, mw, nw), device=dev)
        mm = time_ms(torch, lambda: torch.mm(x.t(), dys), 20)
        for name in DW if group == "dw" else DW_BF16:
            fn = bind(builds[group, name][1], entry, 3, 1)
            fn.argtypes = sig
            call = lambda: fn(x.data_ptr(), dy.data_ptr(), None if sc is None else sc.data_ptr(),
                              per, part.data_ptr(), mw, nw, rows, splits, stream())
            if call() != 0:
                raise RuntimeError(f"{group} {name}: launch failed")
            torch.cuda.synchronize()
            err = ""
            if name == "kernel":
                gap = float((part.sum(0).double() - ref).abs().max())
                err = f" max_abs_err vs float64 {gap:.3e};"
            print(f"probe {group} {name}: {entry} {mw} x {nw} over {rows} rows in {splits} chunks"
                  f" (partials only), row scale {scaled}:{err} ms "
                  f"{time_ms(torch, call, 20):.4f} (torch.mm, scaled dY {mm:.4f})", flush=True)
        del x, dy, dys, part, ref

    b, n_t, hid, s0 = 512, 71, 2 * c, 3
    n_out = (n_t - 3) // s0 + 1
    h1, g = torch.relu(rand(b, n_t, hid)), rand(b * n_out, c, scale=1.0)
    taps = conv_taps_plain(h1, s0, (0, 0)).reshape(-1, 3 * hid)
    splits = dw_splits(b * n_out, 3 * hid, c)
    part = torch.empty((splits, 3 * hid, c), device=dev)
    mm = time_ms(torch, lambda: torch.mm(taps.t(), g), 20)
    for entry in ("strided_dwc_bf16", "strided_dwc_f32"):
        ref = (taps.bfloat16().double().t() @ g.bfloat16().double() if entry.endswith("bf16")
               else taps.double().t() @ g.double())
        for name in DWC:
            fn = bind(builds["dwc", name][1], entry, 3, 8)
            call = lambda: fn(h1.data_ptr(), g.data_ptr(), part.data_ptr(), b, n_t, hid, c, s0,
                              0, n_out, splits, stream())
            if call() != 0:
                raise RuntimeError(f"dwc {name}: launch failed")
            torch.cuda.synchronize()
            err = ""
            if name == "kernel":
                gap = float((part.sum(0).double() - ref).abs().max())
                err = f" max_abs_err vs float64 {gap:.3e};"
            print(f"probe dwc {name}: {entry} {3 * hid} x {c} over {b * n_out} gathered rows in "
                  f"{splits} chunks (partials only):{err} ms {time_ms(torch, call, 20):.4f} "
                  f"(torch.mm on the taps {mm:.4f})", flush=True)
    del h1, g, taps, part
    torch.cuda.empty_cache()


# the seven cases of gemm_digests the bf16 rung's dense callers run
BF16_DENSE_CASES = ("gemm qkv_bf16", "gemm proj_bf16", "gemm fc1_bf16", "gemm fc2_bf16",
                    "branch fc2_bf16", "dx fc2_bf16", "s2t_bf16")


def probe_gemm_parent(parent, seed, only):
    """Every caller of gemm_tc_kernel and gemm_atb_kernel
    (tools/gemm_digests.py: K2's four products, the scaled branch, dX, the
    conv at two geometries, dH1 at two strides, s2t, dW, dWc; 3xTF32 and
    bf16), or with `only` "conv" the strided conv's (conv, dH1, dWc), with
    "dense_bf16" the bf16 rung's seven dense cases, from this checkout's
    build and from `parent`'s, timed in turn (parent, kernel, kernel,
    parent; 3 rounds of 10 launches), with both builds' digests."""
    from pathlib import Path

    from uplift_upsample_torch.ops import cuda_lib
    from uplift_upsample_torch.tools import gemm_digests

    select = {"conv": lambda case: case.lib in ("strided", "strided_bwd"),
              "dense_bf16": lambda case: case.name in BF16_DENSE_CASES}.get(only)
    libs = gemm_digests.build_libs(Path(parent).resolve(), cuda_lib.BUILD_DIR / "probe" /
                                   "gemm_parent")
    failed = gemm_digests.check(gemm_digests.port_libs(), libs, seed, rounds=3,
                                log=lambda s: print(f"probe {s}", flush=True),
                                parent_fp32_libs=gemm_digests.fp32_plane_libs(parent),
                                select=select)
    if failed:
        raise RuntimeError(f"gemm callers differ from the parent's bits: {failed}")


def attention_ptxas(report, group):
    """(kernel, line) of ptxas's report for the attention kernels a probe
    times: the backward's instances, and row 11's tensor-core instances on
    bf16 tensors (a kernel of their own, or the fp32 kernel's T =
    __nv_bfloat16 before it; ptxas_report names a kernel with a type among
    its template arguments by its mangled symbol)."""
    from chip_smoke import ptxas_report

    for kernel, line in ptxas_report(report):
        if group == "attn_bwd" and "window_attention_bwd" in kernel:
            yield kernel, line
        elif group == "attn_bf16io" and ("head_attention_bf16" in kernel or (
                "head_attention" in kernel and "nv_bfloat16" in kernel)):
            yield kernel, line


def digest(t) -> str:
    import hashlib

    import torch

    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def in_turn(torch, calls, rounds=3, iters=20):
    """{label: [ms per round]}: each label's call timed (CUDA events, `iters`
    launches) in the order given, `rounds` times."""
    from chip_smoke import time_ms

    times = {label: [] for label in calls}
    for _ in range(rounds):
        for label, call in calls.items():
            times[label].append(time_ms(torch, call, iters))
    return times


def probe_attention_bwd(torch, F, builds, rand, rng, dev, stream):
    """K5's window-attention backward at the train step (512 windows x 71
    tokens x 384, 8 heads) at both rungs (window_attention_bwd_f32 "high",
    window_attention_bwd_bf16 "default"), with a key mask, every variant,
    beside SDPA's backward on fp32 and on bf16; with a parent build, both
    builds in turn (parent, kernel, kernel, parent; with and without the key
    mask) with their outputs' digests."""
    from chip_smoke import time_ms
    from uplift_upsample_torch.ops.temporal_train import window_attention_bwd_plain

    b, n, c, heads = 512, 71, 384, 8
    qkv, dctx = rand(b * n, 3 * c), rand(b * n, c, scale=1.0)
    km = torch.from_numpy((rng.uniform(size=(b, n)) < 0.5).astype(np.float32)).to(dev)
    kw = dict(windows=b, n=n, num_heads=heads)
    sdpa = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (t.reshape(b, n, heads, c // heads).transpose(1, 2).to(dt).detach()
                   .requires_grad_(True) for t in qkv.split(c, dim=-1))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=(km * -1e9)[:, None, None, :].to(dt))
        g = dctx.reshape(b, n, heads, c // heads).transpose(1, 2).to(dt)
        sdpa[dt] = time_ms(torch, lambda: torch.autograd.grad(out, (q, k, v), g,
                                                              retain_graph=True), 10)
        del q, k, v, out, g
    names = [name for name in (*ATTN_BWD, "parent") if ("attn_bwd", name) in builds]
    for entry, rung in ATTN_BWD_ENTRIES:
        ref = window_attention_bwd_plain(qkv, dctx, km, precision=rung, **kw)
        lib = sdpa[torch.float32 if rung == "high" else torch.bfloat16]
        fns = {name: bind(builds["attn_bwd", name][1], entry, 4, 4) for name in names}
        outs = {name: torch.empty_like(qkv) for name in names}

        def call(name, mask=km):
            return fns[name](qkv.data_ptr(), dctx.data_ptr(),
                             None if mask is None else mask.data_ptr(),
                             outs[name].data_ptr(), b, n, c, heads, stream())

        for name in names:
            if call(name) != 0:
                raise RuntimeError(f"attention backward {name} ({entry}): launch failed")
            torch.cuda.synchronize()
            err = ""
            if name in ("kernel", "parent"):
                got = outs[name].clone()
                call(name)
                err = (f" max_abs_err {float((got - ref).abs().max()):.3e}, repeat "
                       f"bit-identical {'yes' if torch.equal(got, outs[name]) else 'NO'}, "
                       f"digest {digest(got)};")
            print(f"probe attn_bwd {entry} {name}: {b} x {n} x {c}, key mask True:{err} ms "
                  f"{time_ms(torch, lambda: call(name), 20):.4f} (SDPA backward "
                  f"{'fp32' if rung == 'high' else 'bf16'} {lib:.4f})", flush=True)
        if "parent" in names:
            for mask in (km, None):
                times = in_turn(torch, {"parent": lambda: call("parent", mask),
                                        "kernel": lambda: call("kernel", mask),
                                        "kernel ": lambda: call("kernel", mask),
                                        "parent ": lambda: call("parent", mask)})
                digests = []
                for name in ("parent", "kernel"):
                    call(name, mask)
                    torch.cuda.synchronize()
                    digests.append(digest(outs[name]))
                print(f"probe attn_bwd {entry} in turn, key mask {mask is not None}: "
                      + "; ".join(f"{label.strip()} {min(t):.4f} ({', '.join(f'{x:.4f}' for x in t)})"
                                  for label, t in times.items())
                      + f"; digests parent {digests[0]}, kernel {digests[1]}", flush=True)
        del ref, outs
        torch.cuda.empty_cache()


def probe_attention_bf16io(torch, F, builds, rand, rng, dev, stream):
    """Row 11 on bf16 tensors (attention_bf16.cu's packed_attention_bf16io,
    "high", and packed_attention_bf16io_bf16, "default") at 1,024 x 71 x 384
    with the key mask and 1,024 x 23 x 384, 8 heads, every variant, beside
    SDPA on bf16; with a parent build, both builds in turn (parent, kernel,
    kernel, parent) with their outputs' digests."""
    from chip_smoke import time_ms
    from uplift_upsample_torch.ops.packed_attention import packed_attention_plain

    heads, c, f = 8, 384, 1024
    bf = torch.bfloat16
    names = [name for name in (*ATTN_BF16IO, "parent") if ("attn_bf16io", name) in builds]
    for s, masked in ((71, True), (23, False)):
        q, k, v = (rand(f, s, c, scale=1.0).to(bf) for _ in range(3))
        km = (torch.from_numpy((rng.uniform(size=(f, s)) < 0.5).astype(np.float32)).to(dev)
              if masked else None)
        split = lambda t: t.reshape(f, s, heads, c // heads).transpose(1, 2)
        add_mask = None if km is None else (km * -1e9)[:, None, None, :].to(bf)
        sdpa = time_ms(torch, lambda: F.scaled_dot_product_attention(
            split(q), split(k), split(v), attn_mask=add_mask), 20)
        for entry, rung in ATTN_BF16IO_ENTRIES:
            ref = packed_attention_plain(q, k, v, km, num_heads=heads, precision=rung)
            ref64 = packed_attention_plain(q.double(), k.double(), v.double(), km,
                                           num_heads=heads, precision=rung)
            fns = {name: bind(builds["attn_bf16io", name][1], entry, 5, 4) for name in names}
            outs = {name: torch.empty_like(q) for name in names}

            def call(name):
                return fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 None if km is None else km.data_ptr(), outs[name].data_ptr(),
                                 f, s, c, heads, stream())

            for name in names:
                if call(name) != 0:
                    raise RuntimeError(f"row 11 {name} ({entry}): launch failed")
                torch.cuda.synchronize()
                err = ""
                if name in ("kernel", "parent"):
                    got = outs[name].clone()
                    call(name)
                    err = (f" max_abs_err {float((got.float() - ref.float()).abs().max()):.3e}, "
                           f"vs float64 {float((got.double() - ref64).abs().max()):.3e} (plain "
                           f"{float((ref.double() - ref64).abs().max()):.3e}), repeat "
                           f"bit-identical {'yes' if torch.equal(got, outs[name]) else 'NO'}, "
                           f"digest {digest(got)};")
                print(f"probe attn_bf16io {entry} {name}: {f} x {s} x {c}, key mask {masked}:"
                      f"{err} ms {time_ms(torch, lambda: call(name), 20):.4f} (SDPA on bf16 "
                      f"{sdpa:.4f})", flush=True)
            if "parent" in names:
                times = in_turn(torch, {"parent": lambda: call("parent"),
                                        "kernel": lambda: call("kernel"),
                                        "kernel ": lambda: call("kernel"),
                                        "parent ": lambda: call("parent"),
                                        "SDPA": lambda: F.scaled_dot_product_attention(
                                            split(q), split(k), split(v), attn_mask=add_mask)})
                print(f"probe attn_bf16io {entry} in turn, {f} x {s}: "
                      + "; ".join(f"{label.strip()} {min(t):.4f} ({', '.join(f'{x:.4f}' for x in t)})"
                                  for label, t in times.items()), flush=True)
            del ref, ref64, outs
        del q, k, v, km
        torch.cuda.empty_cache()


def probe_spatial_bwd(torch, builds, rand, seed, dev, stream):
    """K4 at the train step's keyframe budget (25,600 frames, C = 32, 4 blocks,
    8 heads of 4), random weights from the seed, at both rungs (the 3xTF32
    instance and the bf16 rung): every variant, 3 rounds taken in turn; with
    a parent build (`--parent`) the rounds run parent, kernel, the variants,
    kernel, parent, and both builds' output digests are printed (differing
    bits are reported, not raised); then K1's outputs from both builds."""
    import hashlib

    from chip_smoke import time_ms
    from uplift_upsample_torch.configs import get_config
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.models.bench_forward import prepare_fused_params
    from uplift_upsample_torch.ops.spatial import make_droppath_scales
    from uplift_upsample_torch.ops.spatial_bwd import spatial_stack_bwd_plain

    config = get_config("h36m_351")
    model = build_uplift_upsample_transformer(config, device="cuda", seed=seed)
    fp = prepare_fused_params(model)
    ops, packed = fp["spatial"], fp["spatial_packed"]
    f, c, heads, blocks = 25600, config.SPATIAL_EMBED_DIM, model.num_heads, model.spatial_depth
    x, g = rand(f, 17, 2), rand(f, 17 * c, scale=1.0)
    gen = torch.Generator().manual_seed(seed)
    rates = [config.DROP_PATH_RATE[0] * i / (blocks - 1) for i in range(blocks)]
    sc = make_droppath_scales(gen, rates, f).to(dev)
    names = [name for name in (*K4, "parent") if ("k4", name) in builds]
    order = ["parent", "kernel", *list(K4)[1:], "kernel", "parent"] if "parent" in names else names
    digest = lambda ts: hashlib.sha256(b"".join(
        t.detach().cpu().contiguous().numpy().tobytes() for t in ts)).hexdigest()[:16]
    for entry, rung in K4_ENTRIES:
        _, ref_dx, _ = spatial_stack_bwd_plain(x, ops, sc, g, num_heads=heads, precision=rung)
        calls, outs = {}, {}
        for name in names:
            path = builds["k4", name][1]
            workers = bind(path, "spatial_bwd_workers", 0, 0)
            workers.argtypes = [ctypes.c_int] * 4
            rows = workers(c, c // heads, blocks, f)
            scratch_floats = bind(path, "spatial_bwd_scratch_floats", 0, 0)
            scratch_floats.argtypes = [ctypes.c_int] * 4  # (c, blocks, frames, workers);
            # a build before the block-major walk reads the first two
            if rows <= 0:
                raise RuntimeError(f"k4 {name}: spatial_bwd_workers returned {rows}")
            fn = bind(path, entry, 8, 5)
            total = bind(path, "sum_rows_f32", 2, 2)
            dx, flat = torch.empty_like(x), torch.empty_like(packed)
            ddp = torch.empty((2 * blocks, f), device=dev)
            partial = torch.empty((rows, packed.numel()), device=dev)
            scratch = torch.empty((rows, max(1, scratch_floats(c, blocks, f, rows))), device=dev)
            calls[name] = lambda fn=fn, dx=dx, ddp=ddp, partial=partial, scratch=scratch, rows=rows: (
                fn(x.data_ptr(), g.data_ptr(), sc.data_ptr(), packed.data_ptr(), dx.data_ptr(),
                   ddp.data_ptr(), partial.data_ptr(), scratch.data_ptr(), f, c, c // heads,
                   blocks, rows, stream()))
            if calls[name]() != 0:
                raise RuntimeError(f"k4 {name} {entry}: launch failed")
            if total(partial.data_ptr(), flat.data_ptr(), rows, packed.numel(), stream()) != 0:
                raise RuntimeError(f"k4 {name}: sum_rows_f32 failed")
            outs[name] = (rows, flat, dx, ddp)
        torch.cuda.synchronize()
        times = {name: [] for name in names}
        for _ in range(3):
            for name in order:
                times[name].append(time_ms(torch, calls[name], 20))
        for name in names:
            rows, flat, dx, ddp = outs[name]
            err = ""
            if name in ("kernel", "parent"):
                err = (f" dx max_abs_err {float((dx - ref_dx).abs().max()):.3e}, digest "
                       f"{digest((flat, dx, ddp))};")
            rounds = ", ".join(f"{t:.4f}" for t in times[name])
            print(f"probe k4 {name}: {entry} ({rung}), {f} frames, C {c}, {blocks} blocks, "
                  f"{rows} gradient rows:{err} ms {min(times[name]):.4f} (rounds {rounds})",
                  flush=True)
        if "parent" in names:
            same = all(torch.equal(a, b) for a, b in zip(outs["kernel"][1:], outs["parent"][1:]))
            print(f"probe k4 {entry}: outputs {'EQUAL' if same else 'differ from'} the parent "
                  f"build's bits", flush=True)
        del calls, outs
        torch.cuda.empty_cache()
    if ("k4", "k1 parent") in builds:
        probe_k1_parent(torch, builds, ops, packed, x, sc, c, heads, blocks, dev, stream, digest)


def probe_k1_parent(torch, builds, ops, packed, x, sc, c, heads, blocks, dev, stream, digest):
    """K1 (spatial_stack_f32 / _bf16) from this checkout's build and the
    parent's on the same inputs, with and without droppath scales: both
    builds' digests, equal or not (K1 shares spatial_common.cuh with K4)."""
    for entry in ("spatial_stack_f32", "spatial_stack_bf16"):
        for scales in (sc, None):
            got = {}
            for name in ("k1 kernel", "k1 parent"):
                fn = bind(builds["k4", name][1], entry, 4, 4)
                out = torch.empty((x.shape[0], 17 * c), device=dev)
                if fn(x.data_ptr(), packed.data_ptr(), None if scales is None else
                      scales.data_ptr(), out.data_ptr(), x.shape[0], c, c // heads, blocks,
                      stream()) != 0:
                    raise RuntimeError(f"{name} {entry}: launch failed")
                got[name] = out
            torch.cuda.synchronize()
            same = torch.equal(got["k1 kernel"], got["k1 parent"])
            print(f"probe k4 K1 {entry}, scales {scales is not None}: digest "
                  f"{digest([got['k1 kernel']])}, parent {digest([got['k1 parent']])}: "
                  f"{'EQUAL' if same else 'DIFFER'}", flush=True)


def probe_spatial(torch, builds, rand, seed, dev, stream):
    """K1 at serving (72,704 frames), the train step (25,600 keyframes with
    droppath scales) and the eval shared step (3,072 frames), C = 32, 4
    blocks, random weights from the seed: the A/B variants at each shape,
    every variant at serving; 3 rounds of 20 launches per variant, taken in
    turn, and each A/B variant against the plain version and float64."""
    from chip_smoke import time_ms
    from uplift_upsample_torch.configs import get_config
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.models.bench_forward import prepare_fused_params
    from uplift_upsample_torch.ops.spatial import make_droppath_scales, spatial_stack_plain

    config = get_config("h36m_351")
    model = build_uplift_upsample_transformer(config, device="cuda", seed=seed)
    fp = prepare_fused_params(model)
    ops, packed = fp["spatial"], fp["spatial_packed"]
    c, heads, blocks = config.SPATIAL_EMBED_DIM, model.num_heads, model.spatial_depth
    gen = torch.Generator().manual_seed(seed)
    rates = [config.DROP_PATH_RATE[0] * i / (blocks - 1) for i in range(blocks)]
    fns = {name: bind(builds["k1", name][1], "spatial_stack_f32", 4, 4) for name in K1}
    for label, f, scaled in (("serving", 72704, False), ("train", 25600, True),
                             ("eval", 3072, False)):
        x = rand(f, 17, 2)
        sc = make_droppath_scales(gen, rates, f).to(dev) if scaled else None
        ref = spatial_stack_plain(x, ops, num_heads=heads, droppath_scales=sc)
        ref64 = spatial_stack_plain(x.double(), {k: v.double() for k, v in ops.items()},
                                    num_heads=heads,
                                    droppath_scales=None if sc is None else sc.double())
        err_plain = float((ref.double() - ref64).abs().max())
        names = list(K1) if label == "serving" else list(K1_AB)
        outs = {name: torch.empty((f, 17 * c), device=dev) for name in names}
        calls = {}
        for name in names:
            calls[name] = lambda fn=fns[name], out=outs[name]: fn(
                x.data_ptr(), packed.data_ptr(), None if sc is None else sc.data_ptr(),
                out.data_ptr(), f, c, c // heads, blocks, stream())
            if calls[name]() != 0:
                raise RuntimeError(f"k1 {name}: launch failed")
        torch.cuda.synchronize()
        times = {name: [] for name in names}
        for _ in range(3):
            for name in names:
                times[name].append(time_ms(torch, calls[name], 20))
        for name in names:
            err = ""
            if name in K1_AB:
                got = outs[name]
                err = (f" max_abs_err {float((got - ref).abs().max()):.3e}, vs float64 "
                       f"{float((got.double() - ref64).abs().max()):.3e} (plain "
                       f"{err_plain:.3e});")
            rounds = ", ".join(f"{t:.4f}" for t in times[name])
            print(f"probe k1 {name}: {label}, {f} frames, C {c}, {blocks} blocks, scales "
                  f"{scaled}:{err} ms {min(times[name]):.4f} (rounds {rounds})", flush=True)
        del x, sc, ref, ref64, outs
        torch.cuda.empty_cache()


def probe_short(torch, F, builds, rand, dev, stream):
    """Row 11's two short kernels at their h36m_351 shapes, 8 heads, beside
    SDPA on the head-split view: each variant's card time from CUDA graphs
    of 20 launches, 3 rounds taken in turn (the A/B against --parent
    included), on copies of the inputs that keep them out of L2 (`cold`,
    what the bytes bound assumes) and on one copy (`warm`: at 1,024 x 3 x
    384 its 18.9 MB stay in L2); the kernel's and the parent's error against
    the plain version and float64."""
    from chip_smoke import graph_ms, l2_copies, time_ms
    from uplift_upsample_torch.ops.packed_attention import packed_attention_plain

    heads = 8
    names = [name for name in (*SHORT, "parent") if ("short", name) in builds]
    fns = {name: bind(builds["short", name][1], "packed_attention_f32", 5, 4)
           for name in names}
    for label, f, s, c in (("spatial", 72704, 17, 32), ("strided 3", 1024, 3, 384)):
        sets = [tuple(rand(f, s, c, scale=1.0) for _ in range(3))
                for _ in range(l2_copies(4 * 4 * f * s * c))]
        q, k, v = sets[0]
        ref = packed_attention_plain(q, k, v, None, num_heads=heads)
        ref64 = packed_attention_plain(q.double(), k.double(), v.double(), None,
                                       num_heads=heads)
        err_plain = float((ref.double() - ref64).abs().max())
        outs = {name: [torch.empty_like(q) for _ in sets] for name in names}
        split = lambda t: t.reshape(f, s, heads, c // heads).transpose(1, 2)
        calls = {"SDPA": [lambda x=x: F.scaled_dot_product_attention(*map(split, x))
                          for x in sets]}
        for name in names:
            calls[name] = [lambda fn=fns[name], x=x, out=out: fn(
                x[0].data_ptr(), x[1].data_ptr(), x[2].data_ptr(), None, out.data_ptr(), f, s,
                c, heads, stream()) for x, out in zip(sets, outs[name])]
            if calls[name][0]() != 0:
                raise RuntimeError(f"short {name}: launch failed")
        torch.cuda.synchronize()
        cold = {name: [] for name in calls}
        warm = {name: [] for name in calls}
        for _ in range(3):
            for name, call in calls.items():
                cold[name].append(graph_ms(torch, call, 20))
                warm[name].append(graph_ms(torch, call[0], 20))
        for name in names:
            err = ""
            if name in ("kernel", "parent"):
                got = outs[name][0]
                again = torch.empty_like(q)
                fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(), None, again.data_ptr(), f,
                          s, c, heads, stream())
                err = (f" max_abs_err {float((got - ref).abs().max()):.3e}, vs float64 "
                       f"{float((got.double() - ref64).abs().max()):.3e} (plain "
                       f"{err_plain:.3e}), repeat bit-identical "
                       f"{'yes' if torch.equal(got, again) else 'NO'}, back-to-back with "
                       f"the host {time_ms(torch, calls[name][0], 20):.4f} ms;")
            rounds = ", ".join(f"{t:.4f}" for t in cold[name])
            print(f"probe short {name}: {label} {f} x {s} x {c}, {heads} heads, "
                  f"{len(sets)} input copies:{err} ms cold {min(cold[name]):.4f} (rounds "
                  f"{rounds}), warm {min(warm[name]):.4f}; SDPA cold "
                  f"{min(cold['SDPA']):.4f}, warm {min(warm['SDPA']):.4f}", flush=True)
        del q, k, v, sets, ref, ref64, outs, calls
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
