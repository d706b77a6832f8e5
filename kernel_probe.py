#!/usr/bin/env python3
"""What bounds the hand-written kernels on the card (csrc/).

    python3 kernel_probe.py [--seed 0] [--only dense,attn_bwd,k4,k1,short]
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
  loads: the producer only signals the stages); "copies only" (no wgmma);
  "no epilogue" (nothing read or written in device memory); "no splits"
  and "one pass, no splits" as above;
- the dW product (`temporal_bwd.cu`'s gemm_dw_f32 at the qkv weight's
  384 x 1,152 over 36,352 rows, split as ops/temporal_train.dw_splits cuts
  it, beside torch.mm): the kernel; "products only" (no cp.async copies);
  "copies only" (no mma.sync); "no splits"; "one pass, no splits";
- the conv forward (`strided.cu`'s strided_conv_f32 at serving, 1,024
  windows x 23 selected rows, K = 3 x 768 -> 384, its taps gathered from h1,
  beside F.conv1d + the residual add): the kernel; "dense A" (gemm_f32 on
  the taps matrix written out, read by TMA: the same products without the
  gather); "no gathered copies" (the producer threads issue no cp.async);
  "no products" (no wgmma); "no epilogue"; "no splits"; "registers 56/224"
  (setmaxnreg: the producer warpgroup gives registers to the consumers);
- the conv's dH1 (`strided_bwd.cu`'s strided_dh1_f32 at the train step,
  11,776 rows x 384 -> 3 x 768, beside convolution_backward's input
  gradient): the kernel; "no epilogue"; "registers 56/224".
- K5's window-attention backward (`temporal_bwd.cu`'s
  window_attention_bwd_f32 at the train step, 512 windows x 71 tokens x
  384, 8 heads, a key mask, beside SDPA's backward): the kernel; "no
  products" (no mma.sync, so no splits either); "no splits"; "no gradient
  writes" (dq, dk, dv computed, not stored);
- K4 (`spatial_bwd.cu`'s spatial_bwd_f32 at the train step's 25,600
  keyframes, C = 32, 4 blocks, random weights from the seed): the kernel;
  "no products"; "no splits"; "no gradient writes" (no read-modify-write
  of dW in the gradient rows); "no attention backward";
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

`--only` runs a subset: "dense" is the attention, GEMM, dW, conv and dH1
groups.

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
    "copies only": [("attention.cuh", "nt = nk / 8;", "nt = nk / 8 - 100;")],
    "no splits": NO_SPLITS,
    "one pass, no splits": NO_SPLITS + ONE_MMA,
}
_TMA = ("            mbar_expect_tx(full + 8 * s, TC_STAGE_BYTES);\n"
        "            tma_load_2d(st, &map_a, kt * TC_BK, m0, full + 8 * s);\n"
        "            tma_load_2d(st + TC_TILE_BYTES, &map_w, kt * TC_BK, n0, full + 8 * s);\n"
        "            tma_load_2d(st + 2 * TC_TILE_BYTES, &map_w, kt * TC_BK, w_small + n0,"
        " full + 8 * s);\n")
_SMALL_WGMMA = ("          wgmma_m64n64k8_tf32(part, a_small[j], desc_big + half + 2 * j);\n"
                "          wgmma_m64n64k8_tf32(part, a_big[j], desc_small + half + 2 * j);\n")
_BIG_WGMMA = "          wgmma_m64n64k8_tf32(part, a_big[j], desc_big + half + 2 * j);\n"
GEMM = {
    "kernel": [],
    "products only": [("gemm_tc.cuh", _TMA, "            mbar_arrive(full + 8 * s);\n")],
    "copies only": [("gemm_tc.cuh", _SMALL_WGMMA + _BIG_WGMMA, "")],
    "no epilogue": [("gemm_tc.cuh", "    const int row0 = m0 + r, row1 = row0 + 8;",
                     "    const int row0 = m0 + r + (k > 0 ? m : 0), row1 = row0 + 8;")],
    "no splits": NO_SPLITS,
    "one pass, no splits": NO_SPLITS + [("gemm_tc.cuh", _SMALL_WGMMA, "")],
}
_CP = "      cp_async16({t}s + kk * AB_LD + c4,"
_GATHER = "            cp_async16(at + r * 32 + (q ^ (r % 8)) * 4,"
_PROD = "  if (threadIdx.x < 128) {  // producer warpgroup\n"
_CONS = "  // consumers: warpgroup cw owns rows 64cw..64cw+63 of each tile\n"
# registers moved from the producer warpgroup to the consumers (setmaxnreg)
_SETMAXNREG = '{}asm volatile("setmaxnreg.{}.sync.aligned.u32 {};\\n");\n'
REGS = [("gemm_tc.cuh", _PROD, _PROD + _SETMAXNREG.format("    ", "dec", 56)),
        ("gemm_tc.cuh", _CONS, _CONS + _SETMAXNREG.format("  ", "inc", 224))]
NO_EPILOGUE = GEMM["no epilogue"]
CONV = {
    "kernel": [],
    "no gathered copies": [("gemm_tc.cuh", _GATHER, "            if (k < 0) " + _GATHER[12:])],
    "no products": [("gemm_tc.cuh", _SMALL_WGMMA + _BIG_WGMMA, "")],
    "no epilogue": NO_EPILOGUE,
    "no splits": NO_SPLITS,
    "registers 56/224": REGS,
}
DH1 = {"kernel": [], "no epilogue": NO_EPILOGUE, "registers 56/224": REGS}
_SINK = "if ({} == 1.2345e-30f) "  # a store the compiler cannot drop, never taken
ATTN_BWD = {
    "kernel": [],
    "no products": [("temporal_bwd.cu", "  uu::mma_3xtf32(part, ab, as, bb, bs);\n", "")],
    "no splits": NO_SPLITS,
    "no gradient writes": [("temporal_bwd.cu", f"({r} < n)", f"({r} < n - 4096)")
                           for r in ("row0", "row1")]
                          + [("temporal_bwd.cu", f"{r} < n &&", f"{r} < n - 4096 &&")
                             for r in ("key0", "key1")],
}
_MMA = "      uu::mma_3xtf32(part, ab, as, bb, bs);\n"
# rows_gemm's products (spatial_common.cuh): a running sum, fresh partials
_RUNNING = "        uu::mma_3xtf32(acc[j], ab, as, bb, bs);\n"
_FRESH = "        uu::mma_3xtf32(part, ab, as, bb, bs);\n"
_DW = [("*out(i, o + 8 * u)", 0), ("*out(i, o + 8 * u + 1)", 1), ("*out(i + 8, o + 8 * u)", 2),
       ("*out(i + 8, o + 8 * u + 1)", 3)]
_DW_STORES = "".join(f"      {ref} = old[u][{e}] + acc[u][{e}];\n" for ref, e in _DW)
_DW_LOADS = "".join(f"      old[u][{e}] = {ref};\n" for ref, e in _DW)
K4 = {
    "kernel": [],
    "no products": [("spatial_bwd.cu", _MMA, ""), ("spatial_common.cuh", _FRESH, "")],
    "no splits": NO_SPLITS,
    "no gradient writes": [  # dW's read-modify-writes of the gradient row
        ("spatial_bwd.cu", _DW_STORES,
         "      " + _SINK.format("acc[u][0] + acc[u][1] + acc[u][2] + acc[u][3]")
         + "*out(i, o) = 0.f;\n"),
        ("spatial_bwd.cu", _DW_LOADS,
         "      old[u][0] = old[u][1] = old[u][2] = old[u][3] = 0.f;\n")],
    "no attention backward": [
        ("spatial_bwd.cu", "      attention_bwd<C>(QKV_C, CTX, DQ, ST, nf, scale);\n", "")],
}
# K1: its accumulation against K4's (A/B), then without its parts
K1_AB = {
    "kernel": [],
    "fresh partials": [("spatial_common.cuh", "      if (FRESH) {\n", "      if (true) {\n")],
}
K1 = {
    **K1_AB,
    "no products": [("spatial_common.cuh", _RUNNING, ""), ("spatial_common.cuh", _FRESH, "")],
    "no attention": [("spatial.cu", "      sp::attention_fwd<C>(QKV, QKV, P3, nf, scale);\n", "")],
    "no LayerNorm statistics": [("spatial.cu", "      sp::ln_stats<C>(X, mu, rs, 1e-5f);\n", "")],
    "no gelu": [("spatial.cu", "sp::gelu(v + V[S::B1 + n])", "(v + V[S::B1 + n])")],
    "no splits": NO_SPLITS,
    "one pass, no splits": NO_SPLITS + ONE_MMA,
    "staged once": [("spatial.cu", "      {  // stage this block's weights",
                     "      if (blk == 0) {  // stage this block's weights")],
}
# row 11's short kernels without their arithmetic, and without their loads
_TASK_CALL = "      task_attend<D>(qc, kh, kh + gf, mk, s, c, o);\n"
_LANE_CALL = "      lane_attend<NV, SMAX>(qr, kr, vr, mk, s, lph, scale2, o);\n"
_ADD3 = "make_float4({a}.x + {b}.x + {c}.x, {a}.y + {b}.y + {c}.y, {a}.z + {b}.z + {c}.z, " \
        "{a}.w + {b}.w + {c}.w)"
_BULK = ("    mbar_expect_tx(bar, 2 * bytes);\n"
         "    bulk_load(dst, k + (size_t)grp * gf, bytes, bar);\n"
         "    bulk_load(dst + gf, v + (size_t)grp * gf, bytes, bar);\n")
SHORT = {
    "kernel": [],
    "copies only": [
        ("attention.cu", _TASK_CALL,
         "      for (int u = 0; u < D / 4; ++u) o[u] = "
         + _ADD3.format(a="qc[u]", b="(*reinterpret_cast<const float4*>(kh + 4 * u))",
                        c="(*reinterpret_cast<const float4*>(kh + gf + 4 * u))") + ";\n"),
        ("attention.cu", _LANE_CALL,
         "      for (int u = 0; u < NV; ++u) {\n        o[u] = qr[u];\n"
         "        for (int j = 0; j < SMAX; ++j)\n          if (j < s) o[u] = "
         + _ADD3.format(a="o[u]", b="kr[j][u]", c="vr[j][u]") + ";\n      }\n")],
    "compute only": [
        ("attention.cu", "  return __ldg(reinterpret_cast<const float4*>(p));\n",
         "  const float a = (float)((size_t)p % 4096) * 1e-4f;\n"
         "  return make_float4(a, a, a, a);\n"),
        ("attention.cu", _BULK,
         '    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\\n" :: "r"(bar) : '
         '"memory");\n')],
    "3 blocks per SM": [("attention.cu", "constexpr int TASK_BLOCKS = 2;",
                         "constexpr int TASK_BLOCKS = 3;")],
    "1 block per SM": [("attention.cu", "constexpr int TASK_BLOCKS = 2;",
                        "constexpr int TASK_BLOCKS = 1;")],
}
# the probes --only selects; "dense" is the attention, GEMM, dW and conv groups
PROBES = ("dense", "attn_bwd", "k4", "k1", "short")
DW = {
    "kernel": [],
    "products only": [("gemm_tc.cuh", _CP.format(t=t), "      if (m < 0) " + _CP.format(t=t)[6:])
                      for t in "xy"],
    "copies only": [("gemm_tc.cuh", "          mma_3xtf32(part, a_big, a_small, b_big[j], "
                     "b_small[j]);\n", "")],
    "no splits": NO_SPLITS,
    "one pass, no splits": NO_SPLITS + ONE_MMA,
}


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
        if old not in text:
            raise RuntimeError(f"probe patch {old!r} no longer matches {fname}")
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
                             "packed_attention_f32 beside the kernels")
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
                                    ("gemm", "temporal", GEMM), ("dw", "temporal_bwd", DW),
                                    ("conv", "strided", CONV), ("dh1", "strided_bwd", DH1),
                                    ("attn_bwd", "temporal_bwd", ATTN_BWD),
                                    ("k4", "spatial_bwd", K4), ("k1", "spatial", K1),
                                    ("short", "attention", SHORT)):
        probe = group if group in PROBES else "dense"
        for name, reps in variants.items() if probe in only else ():
            builds[group, name] = start_build(cuda_lib, f"{group} {name}", source, reps)
    if "short" in only and args.parent:
        builds["short", "parent"] = start_build(cuda_lib, "short parent", "attention", [],
                                                csrc=os.path.abspath(args.parent))
    for key, (proc, _) in builds.items():
        _, report = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"probe build {key} failed:\n{report}")
        # registers and spills of each K1 accumulation and each short variant
        if (key[0] == "k1" and key[1] in K1_AB) or key[0] == "short":
            for kernel, line in ptxas_report(report):
                print(f"ptxas {key[0]} {key[1]}, {kernel}: {line}", flush=True)

    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(args.seed)
    rand = lambda *shape, scale=0.5: torch.from_numpy(
        (rng.normal(size=shape) * scale).astype(np.float32)).to(dev)

    if "dense" in only:
        probe_dense(torch, F, builds, rand, rng, dev, stream)
    if "attn_bwd" in only:
        probe_attention_bwd(torch, F, builds, rand, rng, dev, stream)
    if "k4" in only:
        probe_spatial_bwd(torch, builds, rand, args.seed, dev, stream)
    if "k1" in only:
        probe_spatial(torch, builds, rand, args.seed, dev, stream)
    if "short" in only:
        probe_short(torch, F, builds, rand, dev, stream)
    return 0


def probe_dense(torch, F, builds, rand, rng, dev, stream):
    """The attention (row 11's shapes), the dense-layer GEMM, dW, the conv
    forward and its dH1, each beside its PyTorch call."""
    from chip_smoke import time_ms
    from uplift_upsample_torch.ops.packed_attention import packed_attention_plain
    from uplift_upsample_torch.ops.strided import conv_taps_plain, strided_conv_plain
    from uplift_upsample_torch.ops.strided_train import conv_dh1_plain
    from uplift_upsample_torch.ops.temporal import tf32_halves
    from uplift_upsample_torch.ops.temporal_train import dw_splits

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

    rows, mw = 512 * 71, c
    x, dy = rand(rows, mw), rand(rows, n, scale=1.0)
    splits = dw_splits(rows, mw, n)
    part = torch.empty((splits, mw, n), device=dev)
    mm = time_ms(torch, lambda: torch.mm(x.t(), dy), 20)
    for name in DW:
        fn = bind(builds["dw", name][1], "gemm_dw_f32", 3, 1)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p] + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        call = lambda: fn(x.data_ptr(), dy.data_ptr(), None, 1, part.data_ptr(), mw, n, rows,
                          splits, stream())
        if call() != 0:
            raise RuntimeError(f"dw {name}: launch failed")
        torch.cuda.synchronize()
        err = ""
        if name == "kernel":
            err = f" max_abs_err {float((part.sum(0) - x.t() @ dy).abs().max()):.3e};"
        print(f"probe dw {name}: {mw} x {n} over {rows} rows in {splits} chunks (partials "
              f"only):{err} ms {time_ms(torch, call, 20):.4f} (torch.mm {mm:.4f})", flush=True)
    del x, dy, part

    b, n, hid, s0 = 1024, 71, 2 * c, 3
    n_out = (n - 3) // s0 + 1
    h1, x = torch.relu(rand(b, n, hid)), rand(b, n, c)
    wc, bc = rand(3 * hid, c, scale=0.03), rand(c, scale=0.1)
    halves = tf32_halves(wc)
    res = x[:, 1: 1 + s0 * (n_out - 1) + 1: s0]
    h1t, wt = h1.transpose(1, 2).contiguous(), wc.reshape(3, hid, c).permute(2, 1, 0).contiguous()
    conv1d = time_ms(torch, lambda: res + F.conv1d(h1t, wt, bc, stride=s0).transpose(1, 2), 20)
    ref = strided_conv_plain(h1, x, wc, bc, stride=s0, paddings=(0, 0))
    out = torch.empty((b * n_out, c), device=dev)
    taps, res = conv_taps_plain(h1, s0, (0, 0)).reshape(-1, 3 * hid), res.reshape(-1, c)
    dense = bind(builds["gemm", "kernel"][1], "gemm_f32", 5, 4)
    variants = {"dense A": lambda: dense(taps.data_ptr(), halves.data_ptr(), bc.data_ptr(),
                                         res.data_ptr(), out.data_ptr(), b * n_out, c,
                                         3 * hid, 0, stream())}
    for name in CONV:
        fn = bind(builds["conv", name][1], "strided_conv_f32", 5, 7)
        variants[name] = lambda fn=fn: fn(h1.data_ptr(), x.data_ptr(), halves.data_ptr(),
                                          bc.data_ptr(), out.data_ptr(), b, n, hid, c, s0, 0,
                                          n_out, stream())
    for name in ["kernel", "dense A", *list(CONV)[1:]]:
        call = variants[name]
        if call() != 0:
            raise RuntimeError(f"conv {name}: launch failed")
        torch.cuda.synchronize()
        err = ""
        if name in ("kernel", "dense A"):
            err = f" max_abs_err {float((out.reshape(ref.shape) - ref).abs().max()):.3e};"
        print(f"probe conv {name}: {b * n_out} x {3 * hid} -> {c}:{err} ms "
              f"{time_ms(torch, call, 20):.4f} (F.conv1d + add {conv1d:.4f})", flush=True)
    del h1, x, taps, res, out

    b = 512
    h1, g = torch.relu(rand(b, n, hid)), rand(b, n_out, c, scale=1.0)
    halves_dx = tf32_halves(wc, transpose=False)
    ref = conv_dh1_plain(g, wc, h1, stride=s0, paddings=(0, 0))
    dh1 = torch.empty_like(h1)
    g_t = g.transpose(1, 2).contiguous()
    h1t = h1.transpose(1, 2).contiguous()
    lib = time_ms(torch, lambda: torch.ops.aten.convolution_backward(
        g_t, h1t, wt, None, [s0], [0], [1], False, [0], 1, [True, False, False]), 20)
    for name in DH1:
        fn = bind(builds["dh1", name][1], "strided_dh1_f32", 4, 7)
        call = lambda: fn(g.data_ptr(), halves_dx.data_ptr(), h1.data_ptr(), dh1.data_ptr(), b,
                          n, hid, c, s0, 0, n_out, stream())
        if call() != 0:
            raise RuntimeError(f"dh1 {name}: launch failed")
        torch.cuda.synchronize()
        err = f" max_abs_err {float((dh1 - ref).abs().max()):.3e};" if name == "kernel" else ""
        print(f"probe dh1 {name}: {b * n_out} x {c} -> {3 * hid}:{err} ms "
              f"{time_ms(torch, call, 20):.4f} (convolution_backward, input {lib:.4f})",
              flush=True)
    del h1, g, dh1, g_t, h1t
    torch.cuda.empty_cache()


def probe_attention_bwd(torch, F, builds, rand, rng, dev, stream):
    """K5's window-attention backward at the train step (512 windows x 71
    tokens x 384, 8 heads, a key mask), beside SDPA's backward."""
    from chip_smoke import time_ms
    from uplift_upsample_torch.ops.temporal import window_attention_plain

    b, n, c, heads = 512, 71, 384, 8
    qkv, dctx = rand(b * n, 3 * c), rand(b * n, c, scale=1.0)
    km = torch.from_numpy((rng.uniform(size=(b, n)) < 0.5).astype(np.float32)).to(dev)
    qkv_req = qkv.reshape(b, n, 3 * c).clone().requires_grad_(True)
    ref = torch.autograd.grad(window_attention_plain(qkv_req, km, heads), qkv_req,
                              dctx.reshape(b, n, c))[0].reshape(b * n, 3 * c)
    q, k, v = (t.reshape(b, n, heads, c // heads).transpose(1, 2).detach().requires_grad_(True)
               for t in qkv.split(c, dim=-1))
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=(km * -1e9)[:, None, None, :])
    g = dctx.reshape(b, n, heads, c // heads).transpose(1, 2)
    sdpa = time_ms(torch, lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True), 10)
    dqkv = torch.empty_like(qkv)
    for name in ATTN_BWD:
        fn = bind(builds["attn_bwd", name][1], "window_attention_bwd_f32", 4, 4)
        call = lambda: fn(qkv.data_ptr(), dctx.data_ptr(), km.data_ptr(), dqkv.data_ptr(), b, n,
                          c, heads, stream())
        if call() != 0:
            raise RuntimeError(f"attention backward {name}: launch failed")
        torch.cuda.synchronize()
        err = f" max_abs_err {float((dqkv - ref).abs().max()):.3e};" if name == "kernel" else ""
        print(f"probe attn_bwd {name}: {b} x {n} x {c}, key mask True:{err} ms "
              f"{time_ms(torch, call, 20):.4f} (SDPA backward {sdpa:.4f})", flush=True)


def probe_spatial_bwd(torch, builds, rand, seed, dev, stream):
    """K4 at the train step's keyframe budget (25,600 frames, C = 32, 4 blocks,
    8 heads of 4), random weights from the seed."""
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
    _, ref_dx, _ = spatial_stack_bwd_plain(x, ops, sc, g, num_heads=heads)
    for name in K4:
        path = builds["k4", name][1]
        workers = bind(path, "spatial_bwd_workers", 0, 0)
        workers.argtypes = [ctypes.c_int] * 4
        rows = workers(c, c // heads, blocks, f)
        scratch_floats = bind(path, "spatial_bwd_scratch_floats", 0, 0)
        scratch_floats.argtypes = [ctypes.c_int] * 2
        if rows <= 0:
            raise RuntimeError(f"k4 {name}: spatial_bwd_workers returned {rows}")
        fn = bind(path, "spatial_bwd_f32", 8, 5)
        dx = torch.empty_like(x)
        ddp = torch.empty((2 * blocks, f), device=dev)
        partial = torch.empty((rows, packed.numel()), device=dev)
        scratch = torch.empty((rows, scratch_floats(c, blocks)), device=dev)
        call = lambda: fn(x.data_ptr(), g.data_ptr(), sc.data_ptr(), packed.data_ptr(),
                          dx.data_ptr(), ddp.data_ptr(), partial.data_ptr(), scratch.data_ptr(),
                          f, c, c // heads, blocks, rows, stream())
        if call() != 0:
            raise RuntimeError(f"k4 {name}: launch failed")
        torch.cuda.synchronize()
        err = f" dx max_abs_err {float((dx - ref_dx).abs().max()):.3e};" if name == "kernel" else ""
        print(f"probe k4 {name}: {f} frames, C {c}, {blocks} blocks, {rows} gradient rows:{err} "
              f"ms {time_ms(torch, call, 5):.4f}", flush=True)


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
