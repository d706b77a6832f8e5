#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving, training, eval, CLI, data- and tensor-parallel paths, the bf16 eval rung and the training rungs on one card.

    python3 chip_smoke.py [--seed 0]

Phases (one line each; any failure ends the run with a non-zero exit):
  1. the card's name and power limit; build the CUDA kernels of
     uplift_upsample_torch/csrc with nvcc for sm_90a, one nvcc per source,
     all started together, and print ptxas's registers and spills of each
     kernel;
  2. each kernel against its plain PyTorch version on the card at h36m_351
     width (K1 on 72,704 frames, K2 and K3 on 1,024 windows of 71 tokens,
     K3 also at the h36m_81 geometry; the training kernels at the train
     step's shapes: K1 with stochastic-depth scales and K4 on the 25,600
     frames of the keyframe budget, K5 forward and backward on 512 windows,
     K5 also over one block and at the h36m_81 geometry, K6 (strided block 1
     in training) forward and backward on 512 windows; the eval step's K1 on
     the shared step's 3,072 unique frames and K2 without a key mask; row 11,
     the packed attention, at the five shapes --pallas gives it, each also
     against float64 and repeated bit for bit, and timed in a CUDA graph
     too: `graph_ms`), with its
     time from CUDA events, the plain version's time, a PyTorch library
     call's time where one computes the same function, and the least time
     the card could take (bound); the dense layers' products on the tensor
     cores (gemm_tc.cuh) at every main-path shape: K2's qkv, proj, fc1 and
     fc2 at 72,704 rows, K5's forward products (gemm_f32, the scaled-branch
     gemm_branch_f32), dX and dW at the train step's 36,352 rows, each beside
     addmm / torch.mm; the strided conv's products, its taps gathered from
     h1 (strided_conv_f32 at 1,024 and 512 windows beside F.conv1d + the
     residual add; dH1 and dWc at 512 windows beside convolution_backward);
     every 3xTF32 kernel (those, the window attention of attention.cuh, the
     s2t prologue) is also held against a float64 reference beside its
     plain version;
  3. the serving path end to end: a seeded full-width h36m_351 model, flip-TTA
     on, seeded synthetic 2D sequences through `predict_sequence` on the
     kernel path, the launch counts of that run, and the same sequences
     through the plain model on the card for comparison;
  4. the training step end to end: a seeded full-width h36m_351 model with
     the shipped training config (B=512, mask strides [5, 10, 20], stochastic
     depth, AdamW), synthetic H36M-shaped sequences through the train-mode
     generator and FastH36mBatcher into `make_train_step`: ms per step split
     into host batch time and card step time, windows/s, launches per step;
     then the kernel path against `kernels=False` (the plain versions on the
     card): one batch's loss and every parameter gradient, and a 5-step loss
     curve; then the same with TRAIN_FUSED_STRIDED=True (K6): step time,
     windows/s, K6 calls per step, the loss and every gradient;
  5. the eval protocol end to end: a synthetic Human3.6M pair (S9 and S11,
     3 actions x 2 variants, 2,000-2,500 frames each, ~108 k eval samples)
     written to a temporary directory, then `run_eval_multi_mask_stride` with
     a seeded full-width h36m_351 model at MASK_STRIDE 5, 10 and 20 (B=512,
     flip-TTA, window-sparse, shared spatial stage): per stride the protocol
     frames/s (eval samples over run_eval's wall time, host included), the
     wall attribution line, the six frame metrics and the launches; then at
     MASK_STRIDE 10 (a) --pallas on the fused path, (b) EVAL_FUSED "none"
     with --pallas and (c) the plain model on the card: every metric of the
     default run, (a) and (b) within 0.1 mm of (c)'s;
  6. the training CLI end to end: a synthetic Human3.6M pair (S1, S5, S6, S7
     for training, S8 for validation) written to a temporary directory, then
     `train.train_and_validate` with a seeded full-width h36m_351 model, the
     shipped training config at B=512, TRAIN_FUSED_STRIDED=True and the
     device feed ("auto": on, on the card), 2 epochs x 8 steps with
     validation on 2,048 windows and a checkpoint every epoch, then a resume
     to epoch 3: s/step and windows/s per epoch (the CLI's own
     train/step_duration), the feed's host wait per step, validation wall and
     metrics, checkpoint MB and save/restore seconds, the restored state
     against the saved one bit for bit, K6 calls per step; then 1 epoch x 4
     steps of `--dataset amass` on a synthetic AMASS tree (world-space poses,
     camera projection inside the step) with validation on its val split.
     `export_h5=False`: the card's machine has no h5py, so no .h5 is written;
  7. the bench slice: the s2t prologue kernel (the tiled route's Dense,
     token and PE) against its plain version on 1,024 windows x 71 frames
     at full width, beside addmm + where + add and addmm alone; K2 over one block (row 9)
     and strided block 1 as its own pass (row 8) against their plain
     versions, and `temporal_stack_apply` and the pass as paths of their
     own; then every route of `bench_forward` on 1,024 windows at h36m_351
     (the default, temporal_attn "banded", temporal_impl "v2", the tiled
     route fuse_s2t + "banded", strided_sel, and strided_sel through
     `shared_spatial_forward` on deduplicated windows) and at h36m_81
     ("banded", "v2") against the plain model on the card, each with its
     launches counted from 0 (the tiled route: one s2t launch; v2 and
     h36m_81 banded: no K3); one train step each with TRAIN_FUSED_TEMPORAL
     off and with TRAIN_FUSED_SPATIAL off (no K5 launch in either, K1/K4
     only with spatial on); then the bench CLI (`python -m
     uplift_upsample_torch.bench --iters 8`) as a subprocess: the default
     eval invocation, --strided-sel and --train, each JSON line echoed;
  8. data parallel (`parallel/mesh.py`), h36m_351 full width, the shipped
     training config, each sub-phase with its wall time: (a) NCCL at world
     size 1 in this process, TRAIN_FUSED_STRIDED on: 3 dp steps against 3
     1-process steps from the same seed (loss rtol 1e-5, params and EMA atol
     2e-4), beside the gap between two 1-process runs; (b) two gloo ranks
     spawned on the one card, local batch 256: 3 steps against the
     1-process step on the same global batches (loss rtol 2e-5, params and
     EMA atol 2e-4), the ranks bit-identical, each rank launching K1, K4 and
     K5; (c) in the same ranks, run_eval at MASK_STRIDE 10 on a synthetic
     S9/S11 pair, every metric within 0.1 mm of the 1-process run; (d) the
     training CLI under torchrun (`python -m torch.distributed.run
     --standalone --nproc-per-node 1 -m uplift_upsample_torch.train`, NCCL):
     one epoch of phase 6's size, exit 0, one checkpoint. The card has no
     second H100: the speed on many cards is not measured here;
  9. the host tools, each sub-phase with its wall time: (a) the C++ window
     gather (data/native.py, built with g++) against the numpy one at the
     train batch's shapes with flip and zero-fill on (equal in value; only
     the zeros of zero-filled flipped rows may differ in sign), both timed,
     the native one also on 1-8 threads, and phase 5's eval batcher per
     stride with each gather, every batch compared; (b) npz weights: a seeded h36m_351 through save_npz and
     load_npz into a fresh model (bit for bit), then `python -m
     uplift_upsample_torch.predict --weights w.npz` and the eval CLI's main
     (`--weights w.npz --forced_mask_stride 10` on phase 5's data, its
     returned metrics printed) as subprocesses against the same model in
     process (metrics within 1e-6 mm); (c) utils/profiling.device_timer on
     K2 at 1,024 windows beside time_ms (the gap printed; 10 % expected);
     (d) utils/profiling.trace around one serving call in a fresh process:
     the Chrome trace is written, every launch in it has its kernel's
     record, and it names K1's, K2's and K3's CUDA kernels; then, in this
     process, the kernel records of a plain profiler session and of
     `trace` around the same call (printed: a plain session here loses its
     first launches' records);
 10. tensor parallel (`parallel/sharding.py`, `init_mesh`), h36m_351 full
     width, two gloo ranks sharing the card (dp 1 x mp 2), each sub-phase
     with its wall time: (a) K2 (4 blocks, key mask in block 1) and K3 split
     over the ranks on 64 windows against the unsplit kernels (out_check's
     tolerance), the split launches counted on each rank, each launch at
     mp rank 0's widths timed beside the same launch at full width, the
     split passes and one all-reduce timed on the ranks; (b) the TP serving
     forward (fused full, shared spatial, flip-TTA, 64 windows) against one
     process (1e-4) and 3 TP train steps at B=64 with TRAIN_FUSED_STRIDED
     on against one process (loss rtol 2e-5, params and EMA atol 2e-4),
     the replicated parameters bit-identical over the ranks and K1 and
     K4-K6 launched on each (on gathered weights); (c) `python -m
     uplift_upsample_torch.tools.dryrun_multichip --devices 4` (dp 2 x mp 2,
     4 gloo ranks on the card): exit 0 with MULTICHIP_CORE_OK, each stage's
     wall time or its budget skip; (d) the phase's wall time;
 11. the bf16 eval rung (EVAL_MATMUL_PRECISION "default"), h36m_351 full
     width: (a) each bf16 instance (K1 at 72,704 frames; K2 over four blocks
     and over one, its attention core and its four GEMM pieces at 1,024
     windows; K3 at (0, 0) and at h36m_81's (1, 1); the strided conv; the
     s2t kernel) against its plain version at the same rung: its mean and
     largest distance to the rung with exact sums (the plain version in
     float64) at most 2x the fp32 plain version's, and its mean gap to the
     plain version at most 0.25 x the rung's mean drift from "high" (over
     K2's four blocks reported, not held: the bf16 rounding flips that
     different sum orders cause cascade there), each timed beside its
     "high" instance, the plain version and one PyTorch call on bf16
     tensors; (b) predict (3 x 3,000 frames, flip-TTA) at "default" against
     "high" with its launches (bf16 instances only), the tiled route's s2t
     launch, and run_eval per mask stride on phase 5's data against phase
     5's metrics (every metric within 1 %); (c) `python -m
     uplift_upsample_torch.tools.check_parity --assert-bounds` exits 0;
     (d) the bench CLI at `--precision default` exits 0; (e) K4's output
     bit for bit against its build before the bf16 mode;
 12. the training rungs (TRAIN_MATMUL_PRECISION), h36m_351 full width at
     B=512: (a) each bf16 training instance against its plain version at
     the rung (every output within 2x the fp32 plain version's distance to
     the rung with float64 sums): K1's training launch and K4 on the 25,600
     keyframes, K5 forward and backward over four blocks and over one (row
     14), its attention backward (beside SDPA's backward on bf16), its
     forward attention, scaled branch, dX and dW pieces (beside torch.matmul
     on bf16 tensors), K6 forward and backward and its conv's dH1 and dWc,
     each timed beside its "high" instance; (b) `make_train_step` at
     "high", "highest", "mixed" and "default" (and "default" with K6), 8
     steps after 2 on the same batches: card ms, windows/s, the bf16 or
     3xTF32 entries each rung launches, and the loss curves ("default" and
     "mixed" end within 2 % of "high"; "high" and "highest" the same); (c)
     one epoch of the training CLI at the class default rung (K6 on) and
     `bench --train --train-precision default`. Phases 2 and 4-10 pin
     "high", the training they checked before the rung was read;
 13. one JSON line of per-kernel numbers, the card line again, and the last
     line `{"ok": true, "device": {...}}`.

It needs a CUDA card and the repository checkout around it; without either it
exits non-zero before printing any result. Weights are random (from --seed);
phase 9 carries them through the npz the card's machine reads without h5py.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import io
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

SEQUENCES, FRAMES = 3, 3000  # synthetic 2D sequences of the predict phase
TRAIN_SEQUENCES = 8          # synthetic 3D+2D sequences of the train phase
WARMUP_STEPS, TIMED_STEPS, CURVE_STEPS = 2, 8, 5
CLI_EPOCHS, CLI_STEPS, CLI_VAL = 2, 8, 2048  # the training CLI phase
DP_STEPS, DP_RANKS = 3, 2    # the data-parallel phase: steps per run, gloo ranks on the card
AMASS_STEPS, AMASS_VAL = 4, 1024

# H100 SXM peaks (NVIDIA data sheet): fp32 on CUDA cores, dense TF32 and
# bf16 on the tensor cores (the 3xTF32 kernels count three TF32 products per
# fp32 one; the bf16 rung's products count at the bf16 peak), and HBM3
# bandwidth; its L2 cache.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20
F32 = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS,
             tc_flops: float = 0.0, bf16_flops: float = 0.0):
    """(least ms, what bounds it): `flops` at `peak_flops` plus `tc_flops`, the
    fp32 operations run in 3xTF32 on the tensor cores (three TF32 products
    each), at the TF32 peak, plus `bf16_flops`, the bf16 rung's products, at
    the dense bf16 peak; against the bytes at the HBM rate."""
    t_ops = (flops / peak_flops + 3 * tc_flops / PEAK_TF32_FLOPS
             + bf16_flops / PEAK_BF16_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fns, iters: int = 20, replays: int = 1) -> float:
    """The card's time per call: `iters` calls captured in one CUDA graph and
    replayed, so the host's cost per call (Python, ctypes, the wrapper's
    checks) is not in it, as it is in time_ms when a kernel takes less time
    than its launch. `fns`: a callable, or a list of them taken in turn
    (calls on distinct copies of the inputs: `l2_copies`)."""
    fns = fns if isinstance(fns, (list, tuple)) else [fns]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()  # warm-up off the captured stream, as torch.cuda.graph asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def l2_copies(nbytes: int) -> int:
    """Copies of a call's inputs (`nbytes`) that, taken in turn, stream 4x
    the card's L2 between two reads of one copy: each call reads from HBM,
    as the bytes bound assumes."""
    return max(1, -(-4 * L2_BYTES // nbytes))


def kernel_name(symbol: str) -> str:
    """A kernel's name and integer template arguments from its mangled
    symbol ("task_attention_kernel<4, 17, 32>"); the symbol itself where it
    is not of that form."""
    pos, name = (3 if symbol.startswith("_ZN") else 2), None
    while (m := re.compile(r"\d+").match(symbol, pos)):
        name, pos = symbol[m.end():m.end() + int(m[0])], m.end() + int(m[0])
    if not name:
        return symbol
    args = re.match(r"I((?:Li-?\d+E)+)E", symbol[pos:])
    if args:
        return name + "<" + ", ".join(re.findall(r"Li(-?\d+)E", args[1])) + ">"
    return name if symbol[pos:pos + 1] != "I" else symbol


def ptxas_report(report: str):
    """(kernel, line) for each register and spill line of ptxas's report,
    the kernel named from the entry-function line before it."""
    kernel = "?"
    for line in report.splitlines():
        entry = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)",
                          line)
        if entry:
            kernel = kernel_name(entry[1])
        elif "Used" in line or "spill" in line:
            yield kernel, line.strip()


def max_err(got, ref) -> float:
    return float((got - ref).abs().max())


def tolerance(ref) -> float:
    # fp32 sums over K <= 2304 taken in another order than the plain version
    return 2e-4 * max(1.0, float(ref.abs().max()))


def out_check(torch, got, ref):
    """(max abs error, limit text, ok) of an output against its plain version."""
    err, tol = max_err(got, ref), tolerance(ref)
    return err, f"{tol:.3e}", err <= tol and bool(torch.isfinite(got).all())


def grad_check(torch, pairs):
    """The grad bar per leaf: |got - ref| <= 2e-4 * max(max|ref|, 1e-3) +
    2e-3 * |ref| (fp32 sums over up to 36,352 rows in another order). A pair
    may carry a third tensor: then the leaf's true gradient is 0 (the key
    bias shifts a softmax row by a constant) and both sides, float noise,
    must stay below 2e-4 of that tensor's scale."""
    worst, ok = 0.0, True
    for got, ref, *zero_at in pairs:
        worst = max(worst, max_err(got, ref))
        ok = ok and bool(torch.isfinite(got).all())
        if zero_at:
            bar = 2e-4 * max(float(zero_at[0].abs().max()), 1e-3)
            ok = ok and float(got.abs().max()) <= bar and float(ref.abs().max()) <= bar
            continue
        scale = max(float(ref.abs().max()), 1e-3)
        ok = ok and bool(((got - ref).abs() <= 2e-4 * scale + 2e-3 * ref.abs()).all())
    return worst, "grad bar", ok


def f64_check(torch, got, ref, ref64):
    """(kernel's max abs error against a float64 reference, the fp32 plain
    version's, ok): the 3xTF32 kernels keep fp32-level error, at most 4x the
    plain version's plus 1e-6 of the output scale (one TF32 pass would miss
    by ~1e-3)."""
    err = float((got.double() - ref64).abs().max())
    err_plain = float((ref.double() - ref64).abs().max())
    return err, err_plain, err <= 4 * err_plain + 1e-6 * float(ref64.abs().max())


def f64_check_all(torch, triples):
    """f64_check over (got, plain, float64) triples: the worst kernel and
    plain errors, and whether every triple holds the criterion."""
    checks = [f64_check(torch, *t) for t in triples]
    return (max(c[0] for c in checks), max(c[1] for c in checks), all(c[2] for c in checks))


def ops_bytes(ops, backward: bool = False) -> int:
    """Bytes of the operands a kernel reads: the dense matrices as the TF32
    halves the forward reads ("<name>_tc") or, with `backward`, the dX
    products read ("<name>_tc_dx"); the other operands as they are."""
    want = "_tc_dx" if backward else "_tc"
    split = {key[:-len(want)] for key in ops if key.endswith(want)}
    return sum(v.numel() for key, v in ops.items()
               if key.endswith(want) or ("_tc" not in key and key not in split)) * F32


FIRST_PROFILE = []  # when this process's first profiler session started


def profile_step(torch, run, top: int = 12, label: str = "phase 4 profile: one step") -> None:
    """`run` (one train step, one eval run) under `utils.profiling.trace`:
    the card's busy time (the union of kernel intervals) against the wall
    time, the kernels that took the most card time, and the launches whose
    kernel record the trace lost. Says so when the trace has no card
    activity."""
    from uplift_upsample_torch.utils.profiling import card_busy, trace

    if not FIRST_PROFILE:
        FIRST_PROFILE.append(time.perf_counter())
    with tempfile.TemporaryDirectory() as logdir:
        with trace(logdir, strict=False) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        busy_s, count, by_name = card_busy(prof.trace_file)
    if not count:
        log(f"{label}: the trace holds no card activity (time from CUDA events only)")
        return
    busy = 1e3 * busy_s
    rows = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    log(f"{label} {wall_ms:.3f} ms wall, card busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f} %, idle {100 - 100 * busy / wall_ms:.1f} %), "
        f"{count} kernels, {prof.lost_kernels} launches without their kernel's record; "
        f"top card time: " + "; ".join(
            f"{name[:70]} {1e3 * s:.3f} ms x{n}" for name, (s, n) in rows[:top]))


def train_sequences(np, rng, p: int):
    """TRAIN_SEQUENCES synthetic (3D, 2D) sequences of FRAMES frames:
    random-walk poses 5 m in front of the camera. Returns (p3d, p2d)."""
    p3d, p2d = [], []
    for _ in range(TRAIN_SEQUENCES):
        root = np.cumsum(rng.normal(size=(FRAMES, 1, 3)) * 0.005, axis=0) + [0.0, 0.0, 5.0]
        joints = (root + rng.normal(size=(1, p, 3)) * 0.25
                  + np.cumsum(rng.normal(size=(FRAMES, p, 3)) * 0.002, axis=0))
        p3d.append(joints.astype(np.float32))
        p2d.append((joints[..., :2] / joints[..., 2:]).astype(np.float32))
    return p3d, p2d


def train_generator(np, config, p3d, p2d):
    """The train-mode H36mSequenceGenerator over synthetic sequences."""
    from uplift_upsample_torch.data.generator import H36mSequenceGenerator

    count = len(p3d)
    return H36mSequenceGenerator(
        p3d, p2d, camera_params=[np.zeros(11, np.float32)] * count,
        subjects=list(range(count)), actions=[0] * count,
        frame_rates=[50] * count, split="train",
        seq_len=config.SEQUENCE_LENGTH, target_frame_rate=50,
        subsample=config.DATASET_TRAIN_3D_SUBSAMPLE_STEP, stride=config.SEQUENCE_STRIDE,
        padding_type=config.PADDING_TYPE, flip_augment=config.AUGM_FLIP_PROB > 0,
        in_batch_augment=config.IN_BATCH_AUGMENT,
        flip_lr_indices=config.AUGM_FLIP_KEYPOINT_ORDER, mask_stride=config.MASK_STRIDE,
        stride_mask_align_global=False, rand_shift_stride_mask=config.STRIDE_MASK_RAND_SHIFT,
        shuffle=True, seed=config.SHUFFLE_SEED, verbose=False)


def train_phase(args, torch, np, rng, config, failed, label="phase 4"):
    """Phase 4: make_train_step on synthetic H36M-shaped sequences through the
    train-mode generator and batcher; returns the launch counts of the timed
    steps (the main path's run). With TRAIN_FUSED_STRIDED set in `config`
    strided block 1 runs through K6; then neither the profile nor the loss
    curve is repeated."""
    from uplift_upsample_torch.data.fast_batcher import FastH36mBatcher
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.ops import cuda_lib
    from uplift_upsample_torch.ops.strided import DENSE as STRIDED_DENSE
    from uplift_upsample_torch.ops.temporal import DENSE as TEMPORAL_DENSE
    from uplift_upsample_torch.parallel import make_optimizer, make_train_step
    from uplift_upsample_torch.parallel.train_step import (batch_to_device,
                                                           fused_stages,
                                                           make_loss_fn,
                                                           set_droppath_generator,
                                                           step_generator)

    b = config.BATCH_SIZE
    seqs = train_sequences(np, rng, config.NUM_KEYPOINTS)

    def batches():
        return FastH36mBatcher(train_generator(np, config, *seqs), batch_size=b).batches()

    def fresh(kernels):
        model = build_uplift_upsample_transformer(config, device="cuda", seed=args.seed)
        opt, _, _ = make_optimizer(config)
        state = opt.init(model, ema=bool(config.EMA_ENABLED))
        return model, state, make_train_step(model, opt, config, device="cuda",
                                             kernels=kernels)

    model, state, step = fresh(True)
    fused = fused_stages(model, config, True)[2]
    feed = batches()
    for _ in range(WARMUP_STEPS):
        state, loss = step(state, next(feed))
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    host_ms, step_ms, losses = [], [], []
    t_wall = time.perf_counter()
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        batch = next(feed)
        host_ms.append(1e3 * (time.perf_counter() - t0))
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        state, loss = step(state, batch)
        ev1.record()
        ev1.synchronize()
        step_ms.append(ev0.elapsed_time(ev1))
        losses.append(float(loss))
    wall_ms = 1e3 * (time.perf_counter() - t_wall) / TIMED_STEPS
    train_counts = dict(cuda_lib.LAUNCHES)
    per_step = {k: v / TIMED_STEPS for k, v in sorted(train_counts.items())}
    log(f"{label} train: h36m_351 B={b}, {TIMED_STEPS} steps after {WARMUP_STEPS}, "
        f"TRAIN_FUSED_STRIDED {'on (K6)' if fused else 'off'}: "
        f"card step {np.mean(step_ms):.3f} ms (CUDA events, min {min(step_ms):.3f}, "
        f"max {max(step_ms):.3f}), host batch {np.mean(host_ms):.3f} ms, wall "
        f"{wall_ms:.3f} ms per step = {1e3 * b / wall_ms:.1f} windows/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; launches per step {per_step}")
    if not fused:
        profile_step(torch, lambda: step(state, next(feed)))
    if not all(np.isfinite(losses)):
        failed.append(f"train_loss_not_finite{'_fused' if fused else ''}")
    # every dense layer on the tensor cores (the four C entries of gemm_tc.cuh's
    # kernels), from TF32 halves split anew from each step's weights: one
    # tf32_halves_f32 launch per matrix and layout, stacked over blocks (K6:
    # its three dense matrices and the conv kernel, each on its own)
    for key in ("spatial_stack", "spatial_bwd", "temporal_train_fwd", "temporal_train_bwd",
                "gemm_f32", "gemm_branch_f32", "gemm_dx_f32", "gemm_dw_f32"):
        if train_counts.get(key, 0) == 0:
            failed.append(f"no_launch_{key}")
    if fused:  # and the conv's three products on them too
        for key in ("strided_conv_f32", "strided_dh1_f32", "strided_dwc_f32"):
            if train_counts.get(key, 0) != TIMED_STEPS:
                failed.append(f"{key}_not_once_per_step")
    halves = len(TEMPORAL_DENSE) + (len(STRIDED_DENSE) if fused else 0)
    if train_counts.get("tf32_halves_f32", 0) != TIMED_STEPS * 2 * halves:
        failed.append(f"halves_not_split_each_step{'_fused' if fused else ''}")
    if fused:  # K6 counts calls: one forward and one backward per step
        for key in ("strided_train_fwd", "strided_train_bwd"):
            if train_counts.get(key, 0) != TIMED_STEPS:
                failed.append(f"{key}_not_once_per_step")

    # One batch through the kernel path and through the plain versions. A relu
    # pre-activation within rounding of 0 can take the other side of the kink
    # on the plain path (K5's forward and cuBLAS round differently, and the
    # tail sees inputs that differ by ~1e-6), which moves that unit's
    # gradient by its whole upstream value. So the kernel path's relu
    # decisions (K5's and the tail's strided MLPs') are recorded and replayed
    # on the plain path for the grad bar; the comparison without the replay
    # is reported beside it.
    import functools

    import uplift_upsample_torch.ops.strided_train as strided_train_mod
    import uplift_upsample_torch.ops.temporal_train as temporal_train_mod
    import uplift_upsample_torch.parallel.train_step as train_step_mod

    batch = batch_to_device(next(feed), "cuda")
    model.train()
    mlps = [blk.mlp for name, blk in model.named_children()
            if name.startswith("strided_temporal_block_")]
    relu = mlps[0].activation
    kernel_fwd, plain_stack = (temporal_train_mod.temporal_train_fwd,
                               train_step_mod.temporal_stack_plain)
    k6_fwd = strided_train_mod.strided_train_fwd
    decisions = {"temporal": None, "tail": [], "k6": []}

    def recording_fwd(*a, **kw):
        out, saved = kernel_fwd(*a, **kw)
        decisions["temporal"] = temporal_train_mod.saved_relu_masks(saved)
        return out, saved

    def recording_k6(*a, **kw):  # strided block 1's relu, ahead of the tail's
        out, saved = k6_fwd(*a, **kw)
        decisions["k6"] = [strided_train_mod.saved_relu_mask(saved)]
        return out, saved

    def recording_relu(x):
        decisions["tail"].append(x > 0)
        return relu(x)

    def loss_and_grads(kernels, replay=False):
        for q in model.parameters():
            q.grad = None
        if kernels:
            decisions["tail"].clear()
            temporal_train_mod.temporal_train_fwd = recording_fwd
            strided_train_mod.strided_train_fwd = recording_k6
            for mlp in mlps:
                mlp.activation = recording_relu
        elif replay:
            tail = iter(decisions["k6"] + decisions["tail"])
            train_step_mod.temporal_stack_plain = functools.partial(
                plain_stack, relu_masks=decisions["temporal"])
            for mlp in mlps:
                mlp.activation = lambda x: x * next(tail).reshape(x.shape).to(x.dtype)
        try:
            generator = step_generator(config.SHUFFLE_SEED, 0)
            set_droppath_generator(model, generator)
            loss = make_loss_fn(model, config, kernels=kernels)(batch, generator)
            loss.backward()
        finally:
            temporal_train_mod.temporal_train_fwd = kernel_fwd
            strided_train_mod.strided_train_fwd = k6_fwd
            train_step_mod.temporal_stack_plain = plain_stack
            for mlp in mlps:
                mlp.activation = relu
        return float(loss.detach()), {k: q.grad.clone() for k, q in model.named_parameters()}

    def compare(grads_k, grads_p):
        pairs = [(grads_k[k], grads_p[k],
                  *([grads_p[k.replace("wk", "wq")]] if k.endswith("attn.wk.bias") else []))
                 for k in grads_p]
        over = [k for k, pair in zip(grads_p, pairs) if not grad_check(torch, [pair])[2]]
        l2 = max(float((grads_k[k] - grads_p[k]).norm() / grads_p[k].norm().clamp_min(1e-30))
                 for k in grads_p if not k.endswith("attn.wk.bias"))
        return grad_check(torch, pairs), over, l2

    loss_k, grads_k = loss_and_grads(True)
    loss_p, grads_p = loss_and_grads(False, replay=True)
    (g_err, _, g_ok), over, l2 = compare(grads_k, grads_p)
    loss_ok = abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    log(f"{label} grads: kernel path loss {loss_k:.7f}, plain {loss_p:.7f} "
        f"({'ok' if loss_ok else 'FAILED'}, rtol 1e-5); {len(grads_p)} gradient leaves "
        f"with the kernel path's relu decisions replayed ({len(decisions['tail'])} tail "
        f"relus, {len(decisions['k6'])} K6, {len(decisions['temporal'])} K5 blocks): "
        f"max abs err {g_err:.3e}, largest per-leaf L2 error {l2:.2e}, under the grad "
        f"bar: {'ok' if g_ok else 'FAILED ' + str(over)}")
    if not (loss_ok and g_ok):
        failed.append(f"train_grads_vs_plain{'_fused' if fused else ''}")
    if fused:
        del model, state, step, grads_k, grads_p
        torch.cuda.empty_cache()
        return train_counts
    _, grads_own = loss_and_grads(False)
    (g_err, _, _), over, l2 = compare(grads_k, grads_own)
    log(f"phase 4 grads, plain path with its own relu decisions: max abs err "
        f"{g_err:.3e}, largest per-leaf L2 error {l2:.2e}; leaves over the grad bar "
        f"{over}")
    del model, state, step, grads_k, grads_p, grads_own
    torch.cuda.empty_cache()

    # The first steps of both paths from the same weights and batches.
    curves = {}
    for kernels in (True, False):
        model, state, step = fresh(kernels)
        feed = batches()
        curves[kernels] = [float(step(state, next(feed))[1]) for _ in range(CURVE_STEPS)]
        del model, state, step
    curve_ok = bool(np.allclose(curves[True], curves[False], rtol=1e-3, atol=0))
    log(f"phase 4 curve: {CURVE_STEPS} steps, kernel path {curves[True]}, plain "
        f"{curves[False]} ({'ok' if curve_ok else 'FAILED'}, rtol 1e-3)")
    if not curve_ok:
        failed.append("train_curve_vs_plain")
    return train_counts


EVAL_ACTIONS = ("Walking", "Eating", "Sitting")  # x 2 variants, S9 and S11


def write_h36m_npz(np, rng, directory, frames=(2000, 2501), subjects=("S9", "S11")):
    """A synthetic Human3.6M pair in the reference .npz layout: positions_3d
    [subject][action] (T, 32, 3) world metres, positions_2d[subject][action]
    4 cameras of (T + 0..2, 17, 2) pixels. Returns (3D path, 2D path, the
    sequence lengths)."""
    p3d, p2d, lengths = {}, {}, []
    for subject in subjects:
        p3d[subject], p2d[subject] = {}, {}
        for action in EVAL_ACTIONS:
            for variant in (action, f"{action} 1"):
                t = int(rng.integers(*frames))
                pose = (rng.normal(size=(t, 32, 3)) * 0.2).astype(np.float32)
                pose[..., 2] += 1.0
                p3d[subject][variant] = pose
                extra = int(rng.integers(0, 3))
                p2d[subject][variant] = [rng.uniform(100, 900, size=(t + extra, 17, 2))
                                         .astype(np.float32) for _ in range(4)]
                lengths.append(t)
    paths = (os.path.join(directory, "data_3d_h36m.npz"),
             os.path.join(directory, "data_2d_h36m_synth.npz"))
    np.savez(paths[0], positions_3d=p3d)
    np.savez(paths[1], positions_2d=p2d)
    return paths[0], paths[1], lengths


def shared_call_ms(torch, np, rng, config, model) -> None:
    """The card time of one call of the shared eval step (CUDA events): B
    consecutive windows of one stream, so B + N - 1 unique frames, flip-TTA,
    all-real windows (MASK_STRIDE 5)."""
    from uplift_upsample_torch.eval import make_test_step

    b, n = config.BATCH_SIZE, config.SEQUENCE_LENGTH
    step = make_test_step(model, flip_tta=True, flip_lr_indices=config.AUGM_FLIP_KEYPOINT_ORDER,
                          fused="full", assume_dense_mask=True, shared_spatial=True)
    uq = torch.from_numpy((rng.normal(size=(b + n - 1, 17, 2)) * 0.3)
                          .astype(np.float32)).cuda()
    idx = (torch.arange(b)[:, None] + torch.arange(n)[None, :]).cuda()
    smb = torch.ones((b, n), dtype=torch.bool, device="cuda")
    log(f"phase 5 step: one shared call ({2 * b} windows, {2 * (b + n - 1)} unique "
        f"frames with flip-TTA) {time_ms(torch, lambda: step(uq, idx, smb), 5):.3f} ms "
        f"on the card (CUDA events)")


def eval_metrics(result):
    """Every number run_eval reports: frame and action-wise averages, all
    frames and keyframes."""
    return {f"{sec}/{kind}/{m}": float(v)
            for sec, part in zip(("all", "kf"), result)
            for kind, d in zip(("frame", "aw"), part[:2]) for m, v in d.items()}


def eval_phase(args, torch, np, rng, failed, tmp):
    """Phase 5: the eval CLI's run_eval_multi_mask_stride on synthetic H3.6M
    data (written into `tmp`) with seeded full-width weights, then three runs
    at MASK_STRIDE 10 against which the kernel paths are held: (a)
    USE_PALLAS_ATTENTION on the fused path, (b) EVAL_FUSED "none" with it, (c)
    EVAL_FUSED "none" alone, the plain model on the card. Returns the launch
    counts of the default run (all strides) and of run (b), and the data:
    (3D path, 2D path, eval samples, run_eval's wall per stride)."""
    import contextlib
    import io

    import uplift_upsample_torch.eval as eval_mod
    from uplift_upsample_torch.configs import get_config
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.ops import cuda_lib

    config = get_config("h36m_351")
    runs = []
    real_run_eval = eval_mod.run_eval

    def timed_run_eval(cfg, *a, **kw):
        """run_eval with the launch counts set to 0 before and read after, its
        wall time and its log (the attribution and fallback lines)."""
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = real_run_eval(cfg, *a, **kw)
        wall = time.perf_counter() - t0
        lines = [ln for ln in out.getvalue().splitlines()
                 if ln.startswith(("Eval wall attribution", "Shared-spatial"))]
        runs.append(dict(stride=cfg.MASK_STRIDE, wall=wall, counts=dict(cuda_lib.LAUNCHES),
                         lines=lines, result=result))
        return result

    p3, p2, lengths = write_h36m_npz(np, rng, tmp)
    samples = 4 * sum(lengths)
    windows_ = 4 * sum(math.ceil(t / config.SEQUENCE_STRIDE) for t in lengths)
    data = dict(dataset_name="h36m", dataset_path=p3, dataset2d_path=p2,
                test_subset="test", action_wise=False, verbose=False)
    model = build_uplift_upsample_transformer(config, device="cuda", seed=args.seed)
    eval_mod.run_eval = timed_run_eval
    try:
        eval_mod.run_eval_multi_mask_stride(config, model=model, **data)
        default = list(runs)
        shared_call_ms(torch, np, rng, config, model)
        cfg = config.copy()
        cfg.MASK_STRIDE = 10

        def quiet_run():
            with contextlib.redirect_stdout(io.StringIO()):
                real_run_eval(cfg, model=model, **data)

        profile_step(torch, quiet_run,
                     label="phase 5 profile: one run_eval at MASK_STRIDE 10,")
        for label, fused, pallas in (("a", "auto", True), ("b", "none", True),
                                     ("c", "none", False)):
            cfg = config.copy()
            cfg.MASK_STRIDE, cfg.EVAL_FUSED, cfg.USE_PALLAS_ATTENTION = 10, fused, pallas
            m = model if not pallas else build_uplift_upsample_transformer(
                cfg, device="cuda", seed=args.seed)
            timed_run_eval(cfg, model=m, **data)
            runs[-1]["label"] = label
            del m
    finally:
        eval_mod.run_eval = real_run_eval
    del model
    torch.cuda.empty_cache()

    keys = ("spatial_stack", "temporal_stack", "strided_block1", "packed_attention")
    for r in default:
        mets = eval_metrics(r["result"])
        ok = all(np.isfinite(v) for v in mets.values())
        if not ok:
            failed.append(f"eval_metrics_not_finite_{r['stride']}")
        for key in (*keys[:3], "gemm_f32"):
            if r["counts"].get(key, 0) == 0:
                failed.append(f"no_launch_{key}_eval_{r['stride']}")
        frame = r["result"][0][0]
        log(f"phase 5 eval: h36m_351 MASK_STRIDE {r['stride']}, {samples} eval samples, "
            f"{windows_} computed windows, flip-TTA, shared spatial: wall {r['wall']:.3f} s = "
            f"{samples / r['wall']:.1f} protocol frames/s; MPJPE {frame['mpjpe']:.3f} "
            f"N-MPJPE {frame['nmpjpe']:.3f} PA-MPJPE {frame['pampjpe']:.3f} mm (all frames), "
            f"keyframes {', '.join(f'{v:.3f}' for v in r['result'][1][0].values())}; "
            f"launches {dict((k, r['counts'].get(k, 0)) for k in keys)}")
        for line in r["lines"]:
            log(f"  {line}")
    ref = eval_metrics(runs[-1]["result"])  # (c): the plain model
    compared = [("default", next(r for r in default if r["stride"] == 10))] + [
        (f"({r['label']})", r) for r in runs[len(default):-1]]
    for label, r in compared:
        mets = eval_metrics(r["result"])
        gap = max(abs(mets[k] - ref[k]) for k in ref)
        ok = gap <= 0.1 and all(np.isfinite(v) for v in mets.values())
        log(f"phase 5 eval {label} at MASK_STRIDE 10 against (c) the plain model: largest "
            f"gap over {len(ref)} metrics {gap:.3e} mm (bar 0.1) {'ok' if ok else 'FAILED'}; "
            f"wall {r['wall']:.3f} s = {samples / r['wall']:.1f} frames/s; launches "
            f"{dict((k, r['counts'].get(k, 0)) for k in keys)}")
        if not ok:
            failed.append(f"eval_{label}_vs_plain")
    r_c = runs[-1]
    log(f"phase 5 eval (c) plain model: wall {r_c['wall']:.3f} s = "
        f"{samples / r_c['wall']:.1f} frames/s; launches "
        f"{dict((k, r_c['counts'].get(k, 0)) for k in keys)}")
    for label in ("a", "b"):
        r = next(r for r in runs if r.get("label") == label)
        if r["counts"].get("packed_attention", 0) == 0:
            failed.append(f"no_launch_packed_attention_eval_{label}")
    total = collections.Counter()
    for r in default:
        total.update(r["counts"])
    return (dict(total), next(r for r in runs if r.get("label") == "b")["counts"],
            (p3, p2, samples, {r["stride"]: r["wall"] for r in default},
             {r["stride"]: r["result"] for r in default}))


class TimedLines:
    """A stdout stand-in that keeps each line with the time it was written,
    so a phase can time the CLI's own log lines."""

    def __init__(self):
        self.lines, self._part = [], ""

    def write(self, text):
        self._part += text
        *done, self._part = self._part.split("\n")
        now = time.perf_counter()
        self.lines += [(now, line) for line in done]
        return len(text)

    def flush(self):
        pass

    def first(self, prefix, after=0.0):
        return next((t, line) for t, line in self.lines if t >= after and line.startswith(prefix))


def _same(torch, a, b) -> bool:
    """Bit-for-bit equality of nested dicts of tensors and plain values."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(torch, a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(_same(torch, x, y) for x, y in zip(a, b)))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    return a == b


def write_amass_tree(np, rng, directory, frames=(2000, 2501)):
    """A synthetic AMASS tree: CMU.npz (the train split) and SFU.npz (val),
    positions_3d[subject][action] = {positions_3d (T, 17, 3) world metres,
    frame_rate 50}: random-walk poses about 1 m up, where the Human3.6M
    cameras look."""
    for name in ("CMU", "SFU"):
        data = {}
        for subject in ("s0", "s1"):
            data[subject] = {}
            t = int(rng.integers(*frames))
            root = np.cumsum(rng.normal(size=(t, 1, 3)) * 0.003, axis=0) + [0.0, 0.0, 1.0]
            pose = root + rng.normal(size=(1, 17, 3)) * 0.3 + np.cumsum(
                rng.normal(size=(t, 17, 3)) * 0.002, axis=0)
            data[subject]["walk"] = {"positions_3d": pose.astype(np.float32),
                                     "frame_rate": 50.0}
        np.savez(os.path.join(directory, f"{name}.npz"), positions_3d=data)


def train_cli_phase(args, torch, np, rng, failed):
    """Phase 6: the training CLI (`train.train_and_validate`) on synthetic
    Human3.6M and AMASS data; returns the launch counts of its H3.6M training
    run (2 epochs x 8 steps)."""
    import contextlib
    import tempfile

    import uplift_upsample_torch.train as train_mod
    from uplift_upsample_torch.configs import get_config
    from uplift_upsample_torch.ops import cuda_lib

    config = fp32_train_config(get_config)
    config.update_from(dict(TRAIN_FUSED_STRIDED=True, EPOCHS=CLI_EPOCHS,
                            STEPS_PER_EPOCH=CLI_STEPS, VALIDATION_EXAMPLES=CLI_VAL,
                            CHECKPOINT_INTERVAL=1, VALIDATION_INTERVAL=1,
                            SHUFFLE_SEED=args.seed))
    b = config.BATCH_SIZE
    record = {"saved": {}, "save_s": [], "mb": [], "restore_s": [], "restored_same": []}
    real_save, real_restore = train_mod.save_checkpoint, train_mod.restore_checkpoint

    def snapshot(model, state):
        fields = {f: getattr(state, f) for f in ("mu", "nu", "nu_max", "ema", "step",
                                                 "loss_sum")}
        clone = lambda v: ({k: clone(x) for k, x in v.items()} if isinstance(v, dict)
                           else v.detach().clone() if isinstance(v, torch.Tensor) else v)
        return clone(dict(model.state_dict())), clone(fields)

    def timed_save(ckpt_dir, epoch, model, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = real_save(ckpt_dir, epoch, model, state)
        record["save_s"].append(time.perf_counter() - t0)
        record["mb"].append(os.path.getsize(path) / 1e6)
        record["saved"][epoch] = snapshot(model, state)
        return path

    def timed_restore(ckpt_dir, epoch, model, state):
        t0 = time.perf_counter()
        real_restore(ckpt_dir, epoch, model, state)
        torch.cuda.synchronize()
        record["restore_s"].append(time.perf_counter() - t0)
        record["restored_same"].append(_same(torch, snapshot(model, state),
                                             record["saved"][epoch]))

    def run(cfg, **kw):
        """train_and_validate with its log kept line by line; the launch
        counts of the run."""
        out = TimedLines()
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        try:
            with contextlib.redirect_stdout(out):
                result = train_mod.train_and_validate(cfg, device="cuda", export_h5=False, **kw)
        except Exception:
            log("\n".join(line for _, line in out.lines[-40:]))
            raise
        torch.cuda.synchronize()
        return result, out, dict(cuda_lib.LAUNCHES)

    def report(tag, out_dir, out, counts, steps):
        with open(os.path.join(out_dir, "scalars.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        step_s = {r["step"]: r["value"] for r in rows if r["tag"] == "train/step_duration"}
        vals = [r["value"] for r in rows]
        waits = [line.split(": ")[1] for _, line in out.lines if " feed wait: " in line]
        t_run, _ = out.first("Running validation")
        t_done, line = out.first("Finished validation", after=t_run)
        k6 = {k: counts.get(k, 0) / steps for k in ("strided_train_fwd", "strided_train_bwd")}
        log(f"phase 6 {tag}: " + "; ".join(
            f"epoch {e} {s:.3f} s/step = {b / s:.1f} windows/s" for e, s in sorted(step_s.items()))
            + f"; feed host wait {', '.join(waits)}; first validation "
            f"{t_done - t_run:.3f} s wall ({line.split(', ', 1)[1]}); K6 calls per step "
            f"{k6}; launches per step "
            + str({k: v / steps for k, v in sorted(counts.items()) if k in (
                "spatial_stack", "spatial_bwd", "temporal_train_fwd", "temporal_train_bwd")}))
        if not all(math.isfinite(v) for v in vals):
            failed.append(f"cli_{tag}_not_finite")
        if k6 != {"strided_train_fwd": 1.0, "strided_train_bwd": 1.0}:
            failed.append(f"cli_{tag}_k6_not_once_per_step")

    train_mod.save_checkpoint, train_mod.restore_checkpoint = timed_save, timed_restore
    try:
        with tempfile.TemporaryDirectory() as tmp:
            p3, p2, lengths = write_h36m_npz(np, rng, tmp,
                                             subjects=("S1", "S5", "S6", "S7", "S8"))
            out_dir = os.path.join(tmp, "run")
            data = dict(out_dir=out_dir, dataset_name="h36m", h36m_path=p3, dataset_2d_path=p2,
                        train_subset="train", val_subset="val", test_subset=None)
            (hist, _, _), out, counts = run(config.copy(), **data)
            log(f"phase 6 train CLI: h36m_351 B={b}, TRAIN_FUSED_STRIDED on, device feed "
                f"'{config.TRAIN_DEVICE_FEED}', {len(lengths)} synthetic sequences x 4 cameras "
                f"({4 * sum(lengths)} frames; S1, S5, S6, S7 train, S8 val), "
                f"{CLI_EPOCHS} epochs x {CLI_STEPS} steps, validation on {CLI_VAL} windows; "
                f"export_h5=False (this machine has no h5py): no .h5 written; "
                + next(line for _, line in out.lines if line.startswith("Device feed")))
            report("h36m", out_dir, out, counts, CLI_EPOCHS * CLI_STEPS)
            config3 = config.copy()
            config3.EPOCHS = CLI_EPOCHS + 1
            (hist2, _, _), out, counts3 = run(config3, continue_training=True, **data)
            kept = all(hist2.value_at_step("MPJPE", e) == hist.value_at_step("MPJPE", e)
                       is not None for e in range(1, CLI_EPOCHS + 1))
            restored = record["restored_same"] == [True]
            log(f"phase 6 resume to epoch {CLI_EPOCHS + 1}: checkpoint "
                f"{record['mb'][-1]:.1f} MB, save {', '.join(f'{t:.3f}' for t in record['save_s'])} s, "
                f"restore {record['restore_s'][0]:.3f} s; restored state bit-identical to the "
                f"saved one: {'yes' if restored else 'NO'}; epochs 1-{CLI_EPOCHS} kept in the "
                f"history: {'yes' if kept else 'NO'}; MPJPE by epoch "
                f"{[round(hist2.value_at_step('MPJPE', e), 3) for e in range(1, CLI_EPOCHS + 2)]}")
            if not restored:
                failed.append("cli_restore_not_bit_identical")
            if not kept:
                failed.append("cli_resume_history")
            if hist2.value_at_step("MPJPE", CLI_EPOCHS + 1) is None:
                failed.append("cli_resume_no_epoch_3")

            amass_dir = os.path.join(tmp, "amass")
            os.makedirs(amass_dir)
            write_amass_tree(np, rng, amass_dir)
            aconfig = config.copy()
            aconfig.update_from(dict(EPOCHS=1, STEPS_PER_EPOCH=AMASS_STEPS,
                                     VALIDATION_EXAMPLES=AMASS_VAL))
            a_dir = os.path.join(tmp, "amass_run")
            (ahist, _, _), out, acounts = run(
                aconfig, out_dir=a_dir, dataset_name="amass", amass_path=amass_dir,
                h36m_path=None, train_subset="train", val_subset="val", test_subset=None)
            report("amass", a_dir, out, acounts, AMASS_STEPS)
            if "AW-MPJPE" in ahist.metrics or ahist.latest_value("MPJPE") is None:
                failed.append("cli_amass_metrics")
    finally:
        train_mod.save_checkpoint, train_mod.restore_checkpoint = real_save, real_restore
    torch.cuda.empty_cache()
    return counts


def routes_phase(args, torch, np, rng, failed, record, alias):
    """Phase 7: the s2t prologue kernel, rows 8 and 9 against their plain
    versions, every route of `bench_forward` (and `shared_spatial_forward`
    with strided_sel) at h36m_351 and h36m_81 full width on 1,024 windows
    against the plain model on the card, with each route's launches counted
    from 0; `temporal_stack_apply` and strided block 1 as its own pass as
    paths of their own. Returns the launch counts by path."""
    from uplift_upsample_torch.configs import get_config
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.models.bench_forward import (bench_forward,
                                                            prepare_fused_params,
                                                            shared_spatial_forward)
    from uplift_upsample_torch.ops import cuda_lib
    from uplift_upsample_torch.ops.s2t import s2t_prologue, s2t_prologue_plain
    from uplift_upsample_torch.ops.strided import (output_length, strided_block1,
                                                   strided_block1_plain)
    from uplift_upsample_torch.ops.temporal import (temporal_block, temporal_stack_apply,
                                                    temporal_stack_plain, tf32_halves)
    from uplift_upsample_torch.utils.dedup import dedup_rows

    dev = torch.device("cuda")
    counts = {}

    def counted(path, fn):
        """fn() with the launch counts set to 0 just before and read just after."""
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts[path] = dict(cuda_lib.LAUNCHES)
        return out

    def rand(*shape, scale=0.5):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dev)

    def stride_mask(b, n, ms):
        phase = rng.integers(0, ms, size=(b, 1))
        return torch.from_numpy((np.arange(n)[None] + phase) % ms == 0).to(dev)

    config = get_config("h36m_351")
    model = build_uplift_upsample_transformer(config, device="cuda", seed=args.seed)
    fp = prepare_fused_params(model)
    heads, fmb = model.num_heads, model.first_strided_token_attention_layer
    windows = 2 * config.BATCH_SIZE
    n, c = config.SEQUENCE_LENGTH, config.TEMPORAL_EMBED_DIM
    hid = int(c * config.MLP_RATIO)
    k = config.NUM_KEYPOINTS * config.SPATIAL_EMBED_DIM

    # The s2t prologue kernel on the tiled route's shapes (1,024 x 71 x 544 →
    # 384), beside addmm + where + add and addmm alone (TF32 off).
    sp = rand(windows, n, k, scale=1.0)
    sm = stride_mask(windows, n, 10)
    s2t = fp["s2t"]
    s2t_fn = lambda: s2t_prologue(sp, s2t, sm)
    s2t_plain = lambda: s2t_prologue_plain(sp, s2t, sm)
    sp2, sm3 = sp.reshape(windows * n, k), sm[..., None]
    s2t_lib = lambda: torch.where(sm3, torch.addmm(s2t["bias"], sp2, s2t["w"]).reshape(
        windows, n, c), s2t["token"]) + s2t["pe"]
    got, ref = s2t_fn(), s2t_plain()
    ref64 = s2t_prologue_plain(sp.double(), {key: v.double() for key, v in s2t.items()}, sm)
    # bound: 3xTF32 runs three TF32 products per fp32 one on the tensor cores
    record("s2t_prologue", "uplift_upsample_torch/csrc/s2t.cu",
           "uplift_upsample_tpu/ops/pallas_temporal_v3.py:518", out_check(torch, got, ref),
           time_ms(torch, s2t_fn, 10), time_ms(torch, s2t_plain, 5),
           3 * 2 * windows * n * k * c,
           (sp.numel() + got.numel() + sm.numel() + s2t["w"].numel()
            + 2 * c + s2t["pe"].numel()) * F32,
           library_ms=time_ms(torch, s2t_lib, 10), phase="route tiled",
           f64=f64_check(torch, got, ref, ref64), peak_flops=PEAK_TF32_FLOPS,
           extra=dict(addmm_ms=time_ms(
               torch, lambda: torch.addmm(s2t["bias"], sp2, s2t["w"]), 10),
               # W split on every call, as the wrapper did before s2t_params split it once
               with_split_ms=time_ms(torch, lambda: (tf32_halves(s2t["w"]), s2t_fn()), 10)))
    del sp, sp2, sm3, got, ref, ref64

    # Row 9: K2 over one block with a key mask; temporal_stack_apply, block by
    # block, as its own path. Row 8: strided block 1 as its own pass.
    x_tm = rand(windows, n, c)
    km = 1.0 - stride_mask(windows, n, 10).float()
    one = {key: v[:1].contiguous() for key, v in fp["temporal"].items()}
    tb_fn = lambda: temporal_block(x_tm, one, km, num_heads=heads)
    tb_plain = lambda: temporal_stack_plain(x_tm, one, km, num_heads=heads,
                                            first_masked_blocks=1)
    got, ref = tb_fn(), tb_plain()
    rows = windows * n
    record("temporal_block", "uplift_upsample_torch/csrc/temporal.cu",
           "uplift_upsample_tpu/ops/pallas_temporal.py:94", out_check(torch, got, ref),
           time_ms(torch, tb_fn, 5), time_ms(torch, tb_plain, 3), 0,
           (2 * x_tm.numel() + km.numel()) * F32 + ops_bytes(one),
           counter="temporal_stack", phase="temporal_stack_apply",
           tc_flops=rows * 2 * c * (3 * c + c + 2 * hid) + windows * 4 * n * n * c)
    got = counted("temporal_stack_apply", lambda: temporal_stack_apply(
        fp["temporal"], x_tm, km, num_heads=heads, first_masked_blocks=fmb))
    err, tol, ok = out_check(torch, got, temporal_stack_plain(
        x_tm, fp["temporal"], km, num_heads=heads, first_masked_blocks=fmb))
    log(f"phase 7 temporal_stack_apply (row 9's path, {model.temporal_depth} blocks one at "
        f"a time): max_abs_err {err:.3e} (limit {tol}) {'ok' if ok else 'FAILED'}; launches "
        f"{counts['temporal_stack_apply']}")
    if not ok:
        failed.append("temporal_stack_apply")
    s0, st_ops = model.strides[0], fp["strided"]
    n_out = output_length(n, s0, (0, 0))
    sb_fn = lambda: strided_block1(x_tm, st_ops, num_heads=heads, stride=s0, paddings=(0, 0))
    sb_plain = lambda: strided_block1_plain(x_tm, st_ops, num_heads=heads, stride=s0,
                                            paddings=(0, 0))
    got, ref = sb_fn(), sb_plain()
    record("strided_block1_pass", "uplift_upsample_torch/csrc/strided.cu",
           "uplift_upsample_tpu/ops/pallas_strided.py:175", out_check(torch, got, ref),
           time_ms(torch, sb_fn, 5), time_ms(torch, sb_plain, 3), 0,
           (x_tm.numel() + got.numel()) * F32 + ops_bytes(st_ops),
           counter="strided_block1", phase="strided pass",
           tc_flops=(rows * 2 * c * (3 * c + c + hid) + windows * 4 * n * n * c
                     + windows * n_out * 2 * 3 * hid * c))
    counted("strided pass", sb_fn)
    del x_tm, km, got, ref

    # Every route against the plain model on the card: 1,024 windows at mask
    # stride 10 (h36m_81: 4) with random phases, so block 1 is key-masked.
    def windows_of(m, cfg, ms):
        nn_ = cfg.SEQUENCE_LENGTH
        sm_ = stride_mask(windows, nn_, ms)
        xm = rand(windows, nn_, config.NUM_KEYPOINTS, 2, scale=0.3) * sm_[..., None, None]
        with torch.inference_mode():
            return xm, sm_, m(xm, sm_)[1]

    inputs = windows_of(model, config, 10)
    # consecutive windows of one stream, deduplicated on the host, for the
    # shared spatial stage (the eval protocol's mask alignment at s_in 10)
    stream = rng.normal(size=(windows + n - 1, config.NUM_KEYPOINTS, 2)).astype(np.float32)
    t_off = config.SEQUENCE_STRIDE * (np.arange(n) - n // 2)
    sm_np = np.stack([(config.SEQUENCE_STRIDE * r + t_off) % 10 == 0 for r in range(windows)])
    xm_np = 0.3 * stream[np.arange(windows)[:, None] + np.arange(n)] * sm_np[..., None, None]
    uniq, inv = dedup_rows(xm_np.reshape(windows * n, -1))
    uq = torch.from_numpy(uniq.reshape(-1, config.NUM_KEYPOINTS, 2)).to(dev)
    idx = torch.from_numpy(inv.reshape(windows, n)).to(dev)
    sm_s = torch.from_numpy(sm_np).to(dev)
    with torch.inference_mode():
        ref_s = model(torch.from_numpy(xm_np).to(dev), sm_s)[1]
    config81 = get_config("h36m_81")
    model81 = build_uplift_upsample_transformer(config81, device="cuda", seed=args.seed)
    fp81 = prepare_fused_params(model81)
    inputs81 = windows_of(model81, config81, 4)

    def dense(m, fp_, inp, **kw):
        return lambda: bench_forward(m, inp[0], inp[1], fp_, **kw), inp[2]

    routes = [  # (name, (call, plain reference), launches it must reach beyond K1 and K2)
        ("default", dense(model, fp, inputs), {"strided_block1"}),
        ("banded", dense(model, fp, inputs, temporal_attn="banded"), {"strided_block1"}),
        ("v2", dense(model, fp, inputs, temporal_impl="v2"), set()),
        ("tiled", dense(model, fp, inputs, temporal_attn="banded", fuse_s2t=True),
         {"strided_block1", "s2t_prologue"}),
        ("strided_sel", dense(model, fp, inputs, strided_sel=True), {"strided_block1"}),
        ("strided_sel shared", (lambda: shared_spatial_forward(
            model, uq, idx, sm_s, fp, strided_sel=True), ref_s), {"strided_block1"}),
        ("h36m_81 banded", dense(model81, fp81, inputs81, temporal_attn="banded"), set()),
        ("h36m_81 v2", dense(model81, fp81, inputs81, temporal_impl="v2"), set()),
    ]
    for name, (fn, ref), extra in routes:
        got = counted(f"route {name}", fn)
        err, tol, ok = out_check(torch, got, ref)
        seen = counts[f"route {name}"]
        wrappers = ("spatial_stack", "temporal_stack", "strided_block1", "s2t_prologue")
        launches_ok = (all(seen.get(key, 0) > 0 for key in ("spatial_stack", "temporal_stack"))
                       and all((seen.get(key, 0) > 0) == (key in extra)
                               for key in ("strided_block1", "s2t_prologue"))
                       and seen.get("s2t_prologue", 0) in (0, 1))
        log(f"phase 7 route {name}: max_abs_err vs the plain model {err:.3e} (limit {tol}) "
            f"{'ok' if ok else 'FAILED'}; {time_ms(torch, fn, 3):.3f} ms per call (CUDA "
            f"events); launches {dict((key, seen.get(key, 0)) for key in wrappers)} "
            f"{'as expected' if launches_ok else 'NOT AS EXPECTED'}")
        if not ok:
            failed.append(f"route_{name}")
        if not launches_ok:
            failed.append(f"route_{name}_launches")

    # Rows 4, 6, 7 and 10 are K1, K2 and K3 at the shapes phase 2 measured;
    # their launches are their routes'.
    alias("spatial_stack_tiled", "spatial_stack",
          "uplift_upsample_tpu/ops/pallas_spatial.py:481", "route tiled")
    alias("temporal_stack_banded", "temporal_stack",
          "uplift_upsample_tpu/ops/pallas_temporal_v3.py:343", "route banded")
    alias("strided_block1_sel", "strided_block1",
          "uplift_upsample_tpu/ops/pallas_strided.py:306", "route strided_sel")
    alias("temporal_stack_v2", "temporal_stack",
          "uplift_upsample_tpu/ops/pallas_temporal.py:355", "route v2")
    # rows 5 and 6 beyond their first kernel: K2 inside the tiled call, K3
    # for the banded epilogues
    alias("temporal_stack_tiled", "temporal_stack",
          "uplift_upsample_tpu/ops/pallas_temporal_v3.py:518", "route tiled")
    alias("strided_block1_banded_sel", "strided_block1",
          "uplift_upsample_tpu/ops/pallas_strided.py:377", "route tiled")
    alias("strided_block1_banded", "strided_block1",
          "uplift_upsample_tpu/ops/pallas_strided.py:429", "route banded")
    del model, model81, fp, fp81, inputs, inputs81, uq, idx, ref_s
    torch.cuda.empty_cache()
    return counts


def train_flags_check(args, torch, np, failed) -> None:
    """Phase 7: one train step of h36m_351 at B=512 per setting of
    TRAIN_FUSED_SPATIAL / TRAIN_FUSED_TEMPORAL, launches counted from 0: the
    temporal kernel (K5) runs only with both on, and K1/K4 only with spatial."""
    from uplift_upsample_torch.configs import get_config
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.ops import cuda_lib
    from uplift_upsample_torch.parallel import make_optimizer, make_train_step

    config = fp32_train_config(get_config)
    b, n, k = config.BATCH_SIZE, config.SEQUENCE_LENGTH, config.NUM_KEYPOINTS
    rng = np.random.default_rng(args.seed)
    batch = (rng.normal(size=(b, n, k, 3)).astype(np.float32) * 0.1,
             rng.normal(size=(b, n, k, 2)).astype(np.float32) * 0.1,
             (np.arange(n) % 5 == 0)[None].repeat(b, 0))
    for spatial, temporal in ((True, False), (False, True)):
        cfg = config.copy()
        cfg.TRAIN_FUSED_SPATIAL, cfg.TRAIN_FUSED_TEMPORAL = spatial, temporal
        model = build_uplift_upsample_transformer(cfg, device="cuda", seed=args.seed)
        opt, _, _ = make_optimizer(cfg)
        step = make_train_step(model, opt, cfg, device="cuda")
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        _, loss = step(opt.init(model, ema=bool(cfg.EMA_ENABLED)), batch)
        torch.cuda.synchronize()
        seen = {key: cuda_lib.LAUNCHES.get(key, 0) for key in (
            "spatial_stack", "spatial_bwd", "temporal_train_fwd", "temporal_train_bwd")}
        ok = (math.isfinite(float(loss))
              and (seen["spatial_stack"] > 0) == (seen["spatial_bwd"] > 0) == spatial
              and seen["temporal_train_fwd"] == seen["temporal_train_bwd"] == 0)
        log(f"phase 7 train flags: TRAIN_FUSED_SPATIAL {spatial}, TRAIN_FUSED_TEMPORAL "
            f"{temporal}: one step, loss {float(loss):.5f}, launches {seen} "
            f"{'as expected' if ok else 'NOT AS EXPECTED'}")
        if not ok:
            failed.append(f"train_flags_{spatial}_{temporal}")
        del model, opt, step
    torch.cuda.empty_cache()


def bench_cli_phase(failed) -> None:
    """Phase 7, the bench CLI: `python -m uplift_upsample_torch.bench --iters 8`
    as a subprocess (default eval, --strided-sel, --train), each JSON line
    echoed on a line of its own after a prefix."""
    for label, extra in (("eval", []), ("eval --strided-sel", ["--strided-sel"]),
                         ("train", ["--train", "--train-precision", "high"])):
        cmd = [sys.executable, "-m", "uplift_upsample_torch.bench", "--iters", "8", *extra]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        except subprocess.TimeoutExpired:
            log(f"phase 7 bench {label}: FAILED, no end within 300 s")
            failed.append(f"bench_{label}")
            continue
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1])
        except (IndexError, ValueError):
            result = {}
        ok = proc.returncode == 0 and result.get("value", 0) > 0 and "provisional" not in result
        summary = [ln for ln in proc.stderr.splitlines()
                   if ln.startswith(("# device=", "# train device="))]
        log(f"phase 7 bench {label}: exit {proc.returncode} after "
            f"{time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAILED'}; "
            f"{summary[-1] if summary else ''}")
        log(f"phase 7 bench {label} line: {lines[-1] if lines else ''}")
        if not ok:
            log("\n".join(proc.stderr.splitlines()[-30:]))
            failed.append(f"bench_{label}")


def run_cli(cmd, timeout: int = 300, env=None):
    """A CLI as a subprocess in its own session, its process group killed at
    `timeout`: (exit code, its output and errors as lines, wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        text, _ = proc.communicate()
    return proc.returncode, text.splitlines(), time.perf_counter() - t0


# ---- phase 8: data parallel -------------------------------------------------

def dp_train_steps(torch, np, config, seqs, seed, dp=None):
    """DP_STEPS train steps from the seeded weights over the train-mode batches
    of `seqs`: the 1-process step, or with `dp` this rank's rows of each
    batch. Returns (losses, params, EMA on the host, the launch counts of the
    steps)."""
    from uplift_upsample_torch.data.fast_batcher import FastH36mBatcher
    from uplift_upsample_torch.data.multihost import HostShardedBatcher
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.ops import cuda_lib
    from uplift_upsample_torch.parallel import make_optimizer, make_train_step

    device = "cuda" if dp is None else dp.device
    model = build_uplift_upsample_transformer(config, device=device, seed=seed)
    opt, _, _ = make_optimizer(config)
    state = opt.init(model, ema=True)
    step = make_train_step(model, opt, config, device=device, dp=dp)
    batcher = FastH36mBatcher(train_generator(np, config, *seqs), config.BATCH_SIZE)
    feed = (batcher if dp is None else HostShardedBatcher(batcher, dp.rank, dp.world)).batches()
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    losses = [float(step(state, next(feed))[1]) for _ in range(DP_STEPS)]
    return (losses, {k: v.detach().cpu() for k, v in model.state_dict().items()},
            {k: v.cpu() for k, v in state.ema.items()}, dict(cuda_lib.LAUNCHES))


def dp_gaps(torch, got, ref):
    """(largest relative loss gap, largest params gap, largest EMA gap)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got[0], ref[0]))
    return (loss,) + tuple(max(float((x[k] - y[k]).abs().max()) for k in y)
                           for x, y in zip(got[1:3], ref[1:3]))


def dp_rank(rank, world, store, seqs, eval_data, seed, out_dir):
    """Phase 8 (b) and (c) as rank `rank` of `world` gloo ranks on the one
    card: DP_STEPS train steps of the shipped config on this rank's rows,
    then run_eval at MASK_STRIDE 10 with the windows split over the ranks.
    Saves what it computed to out_dir/rank<r>.pt."""
    import contextlib
    import io

    import numpy as np
    import torch

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the ranks share the host
    from uplift_upsample_torch.configs import get_config
    from uplift_upsample_torch.eval import run_eval
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.parallel.mesh import init_data_parallel

    dp = init_data_parallel("cuda", backend="gloo", init_method=store)
    t0 = time.perf_counter()
    train = dp_train_steps(torch, np, fp32_train_config(get_config), seqs, seed, dp)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    config = get_config("h36m_351")
    config.MASK_STRIDE = 10
    model = build_uplift_upsample_transformer(config, device=dp.device, seed=seed)
    with contextlib.redirect_stdout(io.StringIO()):
        result = run_eval(config, model=model, dp=dp, **eval_data)
    torch.save(dict(train=train, eval=eval_metrics(result), train_s=t1 - t0,
                    eval_s=time.perf_counter() - t1),
               os.path.join(out_dir, f"rank{rank}.pt"))
    dp.close()


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dp_phase(args, torch, np, rng, failed):
    """Phase 8: the data-parallel step, eval and training CLI at h36m_351 full
    width on the one card: (a) NCCL at world size 1 in this process against
    the 1-process step, TRAIN_FUSED_STRIDED on (K6); (b) and (c) DP_RANKS gloo
    ranks spawned on the card, the shipped config's steps and run_eval at
    MASK_STRIDE 10 against the 1-process ones; (d) the training CLI under
    torchrun, one rank (NCCL). Each sub-phase's wall time is logged."""
    import contextlib
    import io
    import tempfile

    import torch.multiprocessing as mp

    from uplift_upsample_torch.configs import get_config
    from uplift_upsample_torch.eval import run_eval
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.parallel.mesh import init_data_parallel

    log(f"phase 8 card: {card_line()}")
    # every rank of this phase runs on this host
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    seqs = train_sequences(np, rng, 17)
    config = fp32_train_config(get_config)  # B=512, mask strides [5, 10, 20], droppath, AdamW
    b = config.BATCH_SIZE

    # (a) NCCL at world size 1, in this process
    t0 = time.perf_counter()
    kconfig = config.copy()
    kconfig.TRAIN_FUSED_STRIDED = True
    ref = dp_train_steps(torch, np, kconfig, seqs, args.seed)
    again = dp_train_steps(torch, np, kconfig, seqs, args.seed)
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        dp = init_data_parallel("cuda")
        got = dp_train_steps(torch, np, kconfig, seqs, args.seed, dp)
        dp.close()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    gap, noise = dp_gaps(torch, got, ref), dp_gaps(torch, again, ref)
    ok = gap[0] <= 1e-5 and max(gap[1:]) <= 2e-4 and got[3].get("strided_train_fwd", 0) > 0
    log(f"phase 8 (a) NCCL world 1: h36m_351 B={b}, TRAIN_FUSED_STRIDED on (K6), {DP_STEPS} "
        f"steps from seed {args.seed}: losses {got[0]} against the 1-process {ref[0]}; largest "
        f"gap loss {gap[0]:.2e} (rtol 1e-5), params {gap[1]:.2e}, EMA {gap[2]:.2e} (atol "
        f"2e-4); two 1-process runs: loss {noise[0]:.2e}, params {noise[1]:.2e}, EMA "
        f"{noise[2]:.2e}; K6 calls {got[3].get('strided_train_fwd', 0)}; "
        f"{'ok' if ok else 'FAILED'}; wall {time.perf_counter() - t0:.1f} s")
    if not ok:
        failed.append("dp_nccl_world1")
    del ref, again, got
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        # (b) and (c): DP_RANKS gloo ranks on the card against one process
        t0 = time.perf_counter()
        p3, p2, lengths = write_h36m_npz(np, rng, tmp)
        eval_data = dict(dataset_name="h36m", dataset_path=p3, dataset2d_path=p2,
                         test_subset="test", action_wise=False, verbose=False)
        ref = dp_train_steps(torch, np, config, seqs, args.seed)
        econfig = config.copy()
        econfig.MASK_STRIDE = 10
        model = build_uplift_upsample_transformer(econfig, device="cuda", seed=args.seed)
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            ref_eval = eval_metrics(run_eval(econfig, model=model, **eval_data))
        ref_eval_s = time.perf_counter() - t1
        del model
        torch.cuda.empty_cache()
        out = os.path.join(tmp, "ranks")
        os.makedirs(out)
        t1 = time.perf_counter()
        ctx = mp.start_processes(dp_rank, nprocs=DP_RANKS, join=False, start_method="spawn",
                                 args=(DP_RANKS, f"file://{tmp}/store", seqs, eval_data,
                                       args.seed, out))
        try:
            while not ctx.join(timeout=5.0):
                if time.perf_counter() - t1 > 240:
                    raise TimeoutError(f"{DP_RANKS} ranks still running after 240 s")
            ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                     for r in range(DP_RANKS)]
        except Exception as e:  # the phase fails; no rank's result is used
            log(f"phase 8 (b)/(c): the {DP_RANKS} ranks FAILED: {type(e).__name__}: {e}")
            failed.append("dp_gloo_ranks")
            ranks = None
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join(10)
        spawn_s = time.perf_counter() - t1
        if ranks is not None:
            gap = dp_gaps(torch, ranks[0]["train"], ref)
            same = all(_same(torch, ranks[0]["train"][i], r["train"][i])
                       for r in ranks[1:] for i in range(3))
            keys = ("spatial_stack", "spatial_bwd", "temporal_train_fwd", "temporal_train_bwd")
            launched = all(r["train"][3].get(k, 0) > 0 for r in ranks for k in keys)
            ok = gap[0] <= 2e-5 and max(gap[1:]) <= 2e-4 and same and launched
            log(f"phase 8 (b) gloo world {DP_RANKS} on one card: local batch {b // DP_RANKS}, "
                f"{DP_STEPS} steps: losses {ranks[0]['train'][0]} against the 1-process "
                f"{ref[0]}; largest gap loss {gap[0]:.2e} (rtol 2e-5), params {gap[1]:.2e}, "
                f"EMA {gap[2]:.2e} (atol 2e-4); ranks' losses, params and EMA bit-identical: "
                f"{'yes' if same else 'NO'}; launches per rank "
                + "; ".join(str({k: r['train'][3].get(k, 0) for k in keys}) for r in ranks)
                + f"; {'ok' if ok else 'FAILED'}; rank wall "
                + ", ".join(f"{r['train_s']:.1f}" for r in ranks) + " s")
            if not ok:
                failed.append("dp_gloo_train")
            egap = max(abs(ranks[0]["eval"][k] - ref_eval[k]) for k in ref_eval)
            agree = all(r["eval"] == ranks[0]["eval"] for r in ranks[1:])
            finite = all(np.isfinite(v) for v in ranks[0]["eval"].values())
            ok = egap <= 0.1 and agree and finite
            frame = {k.split("/")[-1]: round(v, 3) for k, v in ranks[0]["eval"].items()
                     if k.startswith("all/frame/")}
            log(f"phase 8 (c) run_eval over {DP_RANKS} gloo ranks on one card, MASK_STRIDE 10, "
                f"{4 * sum(lengths)} eval samples: {frame} mm; largest gap over "
                f"{len(ref_eval)} metrics to the 1-process run {egap:.3e} mm (bar 0.1); ranks "
                f"agree: {'yes' if agree else 'NO'}; {'ok' if ok else 'FAILED'}; rank wall "
                + ", ".join(f"{r['eval_s']:.1f}" for r in ranks)
                + f" s, 1-process {ref_eval_s:.1f} s")
            if not ok:
                failed.append("dp_gloo_eval")
        log(f"phase 8 (b)+(c) wall {time.perf_counter() - t0:.1f} s (the ranks' spawn to "
            f"exit {spawn_s:.1f} s)")
        del ref
        torch.cuda.empty_cache()

        # (d) the training CLI under torchrun, one rank (NCCL)
        t0 = time.perf_counter()
        p3, p2, _ = write_h36m_npz(np, rng, tmp, subjects=("S1", "S5", "S6", "S7", "S8"))
        cconfig = config.copy()
        cconfig.update_from(dict(TRAIN_FUSED_STRIDED=True, EPOCHS=1, STEPS_PER_EPOCH=CLI_STEPS,
                                 VALIDATION_EXAMPLES=CLI_VAL, CHECKPOINT_INTERVAL=1,
                                 VALIDATION_INTERVAL=1, SHUFFLE_SEED=args.seed))
        cfg_path, run_dir = os.path.join(tmp, "dp_cli.json"), os.path.join(tmp, "cli")
        cconfig.dump(cfg_path)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "1", "-m", "uplift_upsample_torch.train",
               "--config", cfg_path, "--out_dir", run_dir, "--h36m_path", p3,
               "--dataset_2d_path", p2, "--export_h5", "false"]
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                            "MASTER_ADDR", "MASTER_PORT")}
        rc, lines, _ = run_cli(cmd, timeout=240, env=env)
        ckpts = sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) \
            if os.path.isdir(os.path.join(run_dir, "checkpoints")) else []
        dp_line = next((ln for ln in lines if ln.startswith("Data-parallel training")), "")
        epoch = next((ln for ln in lines if ln.startswith("Finished epoch 1")), "")
        val = next((ln for ln in lines if ln.startswith("Finished validation")), "")
        ok = rc == 0 and ckpts == ["ckpt_0001.pt"] and "(nccl)" in dp_line
        log(f"phase 8 (d) torchrun --nproc-per-node 1 -m uplift_upsample_torch.train: exit "
            f"{rc}, checkpoints {ckpts}; {dp_line}; {epoch}; {val}; "
            f"{'ok' if ok else 'FAILED'}; wall {time.perf_counter() - t0:.1f} s")
        if not ok:
            log("\n".join(lines[-40:]))
            failed.append("dp_torchrun_cli")



# ---- phase 9: the native gather, npz weights, profiling ---------------------

# Substrings of each kernel's CUDA kernel names in a trace of a serving call:
# K1's tiles, K2's LayerNorm and window attention, K3's conv (the persistent
# GEMM with its taps gathered from h1)
TRACE_KERNELS = {"K1": ("spatial_stack_tc_kernel",),
                 "K2": ("layernorm_kernel", "head_attention_tc_kernel", "gemm_tc_kernel"),
                 "K3": ("ConvTaps",)}

# The eval CLI run as a subprocess through its `main`, which returns the
# metrics that the CLI prints to 3 decimals: the last line is all of them
EVAL_CLI = ("import json, sys\n"
            "from uplift_upsample_torch.eval import main\n"
            "res = main(sys.argv[1:])\n"
            "print(json.dumps({str(s): [[{k: float(v) for k, v in d.items()}\n"
            "                            for d in part[:2]] for part in r]\n"
            "                  for s, r in res.items()}))\n")


def json_lines(lines):
    """The lines of a subprocess's output that hold a JSON object."""
    return [ln for ln in lines if ln.startswith("{")]


def best_s(fn, reps: int = 5) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def gather_checks(torch, np, config, rng, eval_data, failed) -> None:
    """Phase 9 (a): the C++ window gather against the numpy one at the train
    batch's shapes (flip and zero-fill on) and on phase 5's eval batches; the
    eval batcher's seconds per stride with each."""
    from unittest import mock

    from uplift_upsample_torch.data import fast_batcher, native
    from uplift_upsample_torch.eval import build_eval_generator

    t0 = time.perf_counter()
    lib = native.build()
    native.gather_windows(np.zeros((1, 17, 2), np.float32), np.zeros((1, 1), np.int64))
    log(f"phase 9 (a) native gather: {lib.name} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s (g++ {' '.join(native.CXX_FLAGS)}); "
        f"{os.cpu_count()} host cores, {torch.get_num_threads()} torch threads")
    b, n, p = config.BATCH_SIZE, config.SEQUENCE_LENGTH, config.NUM_KEYPOINTS
    perm = np.asarray(config.AUGM_FLIP_KEYPOINT_ORDER, np.int32)
    # phase 4's batch (B windows of N frames, 2D and 3D), windows of 351 and
    # the eval's central 3D rows
    for bn, c in (((b, n), 2), ((b, n), 3), ((b, 351), 2), ((b, 1), 3)):
        src = rng.normal(size=(50_000, p, c)).astype(np.float32)
        idx = rng.integers(0, len(src), size=bn)
        zero = rng.random(bn) < 0.1
        flip = (np.arange(bn[0]) % 2).astype(np.uint8)  # in-batch flips
        args = (src, idx, zero, flip, perm)
        got, ref = native.gather_windows(*args), native.gather_windows_plain(*args)
        sign = np.signbit(got) != np.signbit(ref)
        allowed = np.zeros_like(sign)
        allowed[..., 0] = (zero & flip[:, None].astype(bool))[..., None]
        ok = (np.array_equal(got, ref) and not (sign & ~allowed).any()
              and not got[sign].any())
        t_native = best_s(lambda: native.gather_windows(*args))
        t_plain = best_s(lambda: native.gather_windows_plain(*args))
        # the basis of native.default_threads: the gather on 1-8 threads
        sweep = {k: best_s(lambda: native.gather_windows(*args, n_threads=k), reps=20)
                 for k in (1, 2, 3, 4, 6, 8)}
        log(f"phase 9 (a) gather {bn[0]} x {bn[1]} x {p} x {c} ({got.nbytes / 2 ** 20:.2f} "
            f"MiB), flip + zero-fill: equal to the numpy gather in value "
            f"{'ok' if ok else 'FAILED'} ({int(sign.sum())} zeros of another sign, all in "
            f"channel 0 of zero-filled flipped rows); native {1e3 * t_native:.3f} ms on "
            f"{native.default_threads(got.nbytes)} threads, numpy {1e3 * t_plain:.3f} ms; "
            f"by threads " + ", ".join(f"{k}: {1e3 * v:.3f}" for k, v in sweep.items()))
        if not ok:
            failed.append(f"native_gather_{bn[1]}x{c}")

    p3, p2 = eval_data[:2]
    plain = mock.patch.object(fast_batcher, "gather_windows", native.gather_windows_plain)
    for stride in config.MASK_STRIDE:
        cfg = config.copy()
        cfg.MASK_STRIDE = stride
        gen = build_eval_generator(cfg, p3, p2, "test", verbose=False)
        count = -(-len(gen) // cfg.BATCH_SIZE)
        stream = lambda: itertools.islice(fast_batcher.FastH36mBatcher(
            gen, batch_size=cfg.BATCH_SIZE, central_3d_only=True).batches(), count)
        # one pass, each batch made by both gathers in turn (the epoch plan
        # in each stream's first batch): the batcher's seconds with each
        ok, t_native, t_plain, ours, ref = True, 0.0, 0.0, stream(), stream()
        for _ in range(count):
            t1 = time.perf_counter()
            got = next(ours)
            t2 = time.perf_counter()
            with plain:
                want = next(ref)
            t_native, t_plain = t_native + t2 - t1, t_plain + time.perf_counter() - t2
            ok = ok and all(np.array_equal(x, y) for x, y in zip(got, want))
        log(f"phase 9 (a) eval batcher (phase 5's data), MASK_STRIDE {stride}: {count} "
            f"batches, {len(gen)} eval samples: native gather {t_native:.3f} s, numpy "
            f"{t_plain:.3f} s per stride; every batch equal {'ok' if ok else 'FAILED'}")
        if not ok:
            failed.append(f"native_gather_eval_{stride}")


def serving_call(torch, np, seed: int):
    """One call of a seeded h36m_351 serving step on a seeded batch, warmed
    up (the function that phase 9 (d) traces)."""
    from uplift_upsample_torch.configs import get_config
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.predict import make_predict_step

    config = get_config("h36m_351")
    config.MASK_STRIDE = config.MASK_STRIDE[0]
    model = build_uplift_upsample_transformer(config, device="cuda", seed=seed)
    step = make_predict_step(model, config, flip_tta=True)
    b, n, p = config.BATCH_SIZE, config.SEQUENCE_LENGTH, config.NUM_KEYPOINTS
    rng = np.random.default_rng(seed)
    xb = torch.from_numpy((rng.normal(size=(b, n, p, 2)) * 0.3).astype(np.float32)).cuda()
    smb = torch.ones((b, n), dtype=torch.bool, device="cuda")
    step(xb, smb)
    torch.cuda.synchronize()
    return lambda: step(xb, smb)


def trace_kernels(path: str):
    """The kernel records of a Chrome trace: their number, and K1-K3's by
    name substring."""
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    return len(names), {k: {s: sum(s in name for name in names) for s in subs}
                        for k, subs in TRACE_KERNELS.items()}


def trace_serving_call(logdir: str, seed: int) -> None:
    """Phase 9 (d), run in a fresh process: `utils.profiling.trace` (strict)
    around one serving call; prints the trace file, its size, its kernel
    records and K1-K3's by name (JSON)."""
    import numpy as np
    import torch

    from uplift_upsample_torch.utils.profiling import trace

    call = serving_call(torch, np, seed)
    with trace(logdir) as prof:
        call()
    events, kernels = trace_kernels(prof.trace_file)
    print(json.dumps({"file": os.path.basename(prof.trace_file),
                      "mb": os.path.getsize(prof.trace_file) / 1e6, "events": events,
                      "lost": prof.lost_kernels, "kernels": kernels}))


def trace_in_process(torch, np, seed: int) -> None:
    """Phase 9 (d) in this process, after phases 4 and 5's profiler
    sessions: one serving call under a plain torch.profiler session, which
    records from its first kernel, and under `utils.profiling.trace`, which
    records after a warm-up step; the kernel records of each and the launches
    whose record each lost. Printed, not held: the count grows with the time
    since the process's first session."""
    from torch.profiler import ProfilerActivity, profile

    from uplift_upsample_torch.utils.profiling import lost_kernels, trace

    call = serving_call(torch, np, seed)
    age = time.perf_counter() - FIRST_PROFILE[0] if FIRST_PROFILE else float("nan")
    with tempfile.TemporaryDirectory() as logdir:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as plain:
            call()
            torch.cuda.synchronize()
        path = os.path.join(logdir, "plain.pt.trace.json")
        plain.export_chrome_trace(path)
        plain_events, plain_lost = trace_kernels(path)[0], lost_kernels(path)
        with trace(logdir, strict=False) as prof:
            call()
        events = trace_kernels(prof.trace_file)[0]
    log(f"phase 9 (d) in this process, {age:.1f} s after its first profiler session, one "
        f"serving call: a plain torch.profiler session {plain_events} kernel records, "
        f"{plain_lost} launches without theirs; utils.profiling.trace (warm-up step) "
        f"{events} kernel records, {prof.lost_kernels} launches without theirs")


def tools_phase(args, torch, np, rng, failed, eval_data, tmp) -> None:
    """Phase 9: (a) the native gather; (b) npz weights: save_npz / load_npz
    bit for bit, then the predict and eval CLIs from `--weights w.npz` as
    subprocesses against the same model in process; (c) `device_timer` on K2
    beside `time_ms`; (d) `trace` around one serving call. Each with its
    wall time."""
    from uplift_upsample_torch.configs import get_config
    from uplift_upsample_torch.eval import run_eval
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.models.bench_forward import prepare_fused_params
    from uplift_upsample_torch.ops.temporal import temporal_stack
    from uplift_upsample_torch.predict import predict_sequence
    from uplift_upsample_torch.utils.profiling import device_timer
    from uplift_upsample_torch.utils.weights_npz import load_npz, save_npz

    config = get_config("h36m_351")
    t0 = time.perf_counter()
    gather_checks(torch, np, config, rng, eval_data, failed)
    log(f"phase 9 (a) wall {time.perf_counter() - t0:.1f} s")

    # (b) npz weights on the card
    t0 = time.perf_counter()
    model = build_uplift_upsample_transformer(config, device="cuda", seed=args.seed)
    weights = os.path.join(tmp, "h36m_351.npz")
    save_npz(weights, None, model)
    fresh = load_npz(weights, build_uplift_upsample_transformer(config, device="cuda",
                                                                seed=args.seed + 1))
    same = _same(torch, model.state_dict(), fresh.state_dict())
    del fresh
    log(f"phase 9 (b) save_npz -> load_npz into a fresh h36m_351 on the card: "
        f"{os.path.getsize(weights) / 1e6:.1f} MB, state equal bit for bit "
        f"{'ok' if same else 'FAILED'}")
    if not same:
        failed.append("npz_round_trip")

    pconfig = config.copy()
    pconfig.MASK_STRIDE = pconfig.MASK_STRIDE[0]  # the predict CLI's choice
    p = pconfig.NUM_KEYPOINTS
    kps = (np.cumsum(rng.normal(size=(FRAMES, p, 2)) * 0.01, axis=0)
           + rng.normal(size=(1, p, 2)) * 0.3).astype(np.float32)
    inp, out = os.path.join(tmp, "kps2d.npz"), os.path.join(tmp, "poses3d.npz")
    np.savez(inp, positions_2d={"seq": kps})
    rc, lines, wall = run_cli([sys.executable, "-m", "uplift_upsample_torch.predict",
                               "--weights", weights, "--config", "h36m_351",
                               "--input", inp, "--output", out])
    ok = rc == 0 and os.path.exists(out)
    gap = tol = float("nan")
    if ok:
        got = np.load(out)["seq"]
        ref = predict_sequence(model, pconfig, kps)
        gap = float(np.abs(got - ref).max())
        tol = 2e-4 * max(1.0, float(np.abs(ref).max()))
        ok = got.shape == (FRAMES, p, 3) and bool(np.isfinite(got).all()) and gap <= tol
    log(f"phase 9 (b) python -m uplift_upsample_torch.predict --weights {weights}: exit {rc}, "
        f"{FRAMES} frames, max |gap| to predict_sequence in process {gap:.3e} (limit "
        f"{tol:.3e}) {'ok' if ok else 'FAILED'}; wall {wall:.1f} s")
    if not ok:
        log("\n".join(lines[-30:]))
        failed.append("predict_cli_npz")

    p3, p2 = eval_data[:2]
    rc, lines, wall = run_cli([sys.executable, "-c", EVAL_CLI, "--weights", weights,
                               "--config", "h36m_351", "--dataset", p3, "--dataset_2d", p2,
                               "--forced_mask_stride", "10"])
    cfg = config.copy()
    cfg.MASK_STRIDE = 10
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        mine = eval_metrics(run_eval(cfg, "h36m", p3, p2, "test", model=model))
    gap, ok = float("nan"), False
    if rc == 0 and json_lines(lines):
        sub = json.loads(json_lines(lines)[-1])["10"]
        theirs = {f"{sec}/{kind}/{m}": v for sec, part in zip(("all", "kf"), sub)
                  for kind, d in zip(("frame", "aw"), part) for m, v in d.items()}
        gap = max(abs(theirs[k] - mine[k]) for k in mine) if theirs.keys() == mine.keys() \
            else float("inf")
        ok = gap <= 1e-6
    attribution = next((ln for ln in lines if ln.startswith("Eval wall attribution")), "")
    log(f"phase 9 (b) the eval CLI (main) --weights {os.path.basename(weights)} "
        f"--forced_mask_stride 10 in a subprocess: exit {rc}, largest gap over {len(mine)} "
        f"metrics to run_eval in process {gap:.3e} mm (limit 1e-6) {'ok' if ok else 'FAILED'}"
        f"; wall {wall:.1f} s; {attribution}")
    if not ok:
        log("\n".join(lines[-30:]))
        failed.append("eval_cli_npz")
    log(f"phase 9 (b) wall {time.perf_counter() - t0:.1f} s")

    # (c) device_timer against time_ms on K2 at 1,024 windows
    t0 = time.perf_counter()
    fp = prepare_fused_params(model)
    windows, n, c = 2 * config.BATCH_SIZE, config.SEQUENCE_LENGTH, config.TEMPORAL_EMBED_DIM
    x = torch.from_numpy((rng.normal(size=(windows, n, c)) * 0.5).astype(np.float32)).cuda()
    km = torch.from_numpy(((np.arange(n)[None] + rng.integers(0, 10, size=(windows, 1)))
                           % 10 != 0).astype(np.float32)).cuda()
    k2 = lambda a: temporal_stack(a, fp["temporal"], km, num_heads=model.num_heads,
                                  first_masked_blocks=model.first_strided_token_attention_layer)
    dt_ms = 1e3 * device_timer(k2, x)
    ev_ms = time_ms(torch, lambda: k2(x), 5)
    gap_pct = 100 * (dt_ms - ev_ms) / ev_ms
    log(f"phase 9 (c) K2 on {windows} windows: device_timer {dt_ms:.3f} ms per call (slope "
        f"of 16 and 4 chained calls, each with the carry's add), time_ms {ev_ms:.3f} ms: "
        f"gap {gap_pct:+.1f} % ({'within' if abs(gap_pct) <= 10 else 'OUTSIDE'} 10 %); wall "
        f"{time.perf_counter() - t0:.1f} s")
    del x, km, fp

    # (d) trace around one serving call in a fresh process (strict: every
    # launch's kernel recorded), then plain and warmed-up sessions in this one
    t0 = time.perf_counter()
    logdir = os.path.join(tmp, "trace")
    rc, lines, wall = run_cli([sys.executable, "-c", "import chip_smoke; "
                               f"chip_smoke.trace_serving_call({logdir!r}, {args.seed})"])
    found = json.loads(json_lines(lines)[-1]) if rc == 0 and json_lines(lines) else {}
    ok = (bool(found) and found["lost"] == 0
          and all(n for subs in found["kernels"].values() for n in subs.values()))
    log(f"phase 9 (d) utils.profiling.trace of one serving call ({2 * config.BATCH_SIZE} "
        f"windows) in a fresh process: exit {rc}, {found.get('file', 'no file')} "
        f"({found.get('mb', 0):.1f} MB), {found.get('events', 0)} kernel records, "
        f"{found.get('lost')} launches without theirs; by kernel {found.get('kernels')} "
        f"{'ok' if ok else 'FAILED'}; wall {wall:.1f} s")
    if not ok:
        log("\n".join(lines[-30:]))
        failed.append("trace_serving_call")
    trace_in_process(torch, np, args.seed)
    log(f"phase 9 (d) wall {time.perf_counter() - t0:.1f} s")
    del model
    torch.cuda.empty_cache()


# ---- phase 10: tensor parallel ----------------------------------------------

TP_RANKS = 2     # gloo ranks sharing the card: dp = 1, mp = 2
TP_WINDOWS = 64  # (a)'s split passes and (b)'s serving forward
TP_BATCH = 64    # (b)'s train batch
TP_STEPS = 3


def tp_batches(np, rng, config):
    """TP_STEPS random train batches of TP_BATCH windows, stride masks from
    the shipped mask-stride mix (5, 10, 20 over the sequence stride 5)."""
    b, n, k = TP_BATCH, config.SEQUENCE_LENGTH, config.NUM_KEYPOINTS
    out = []
    for _ in range(TP_STEPS):
        strides = rng.choice([1, 2, 4], size=b)
        sm = (np.arange(n)[None] + rng.integers(0, 4, size=(b, 1))) % strides[:, None] == 0
        out.append((rng.normal(size=(b, n, k, 3)).astype(np.float32) * 0.1,
                    rng.normal(size=(b, n, k, 2)).astype(np.float32) * 0.1,
                    np.ones((b, n), np.float32), np.zeros((b, 11), np.float32),
                    np.zeros(b, np.int32), np.zeros(b, np.int32), np.zeros(b, np.int32), sm))
    return out


def tp_train_config(get_config):
    config = fp32_train_config(get_config)  # mask strides [5, 10, 20], droppath, AdamW, EMA
    config.update_from(dict(BATCH_SIZE=TP_BATCH, TRAIN_FUSED_STRIDED=True))
    return config


def tp_train_steps(torch, config, seed, batches, device, mesh=None):
    """TP_STEPS train steps from the seeded weights (with `mesh`, its mp
    rank's shard): (losses, the local state, the whole params and EMA on the
    host, the launch counts of the steps)."""
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.ops import cuda_lib
    from uplift_upsample_torch.parallel import make_optimizer, make_train_step
    from uplift_upsample_torch.parallel.sharding import gather_params_tp

    tp = None if mesh is None else mesh.tp
    model = build_uplift_upsample_transformer(config, device=device, seed=seed, tp=tp)
    opt, _, _ = make_optimizer(config)
    state = opt.init(model, ema=True)
    step = make_train_step(model, opt, config, device=device, dp=mesh, tp=tp)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    losses = [float(step(state, batch)[1]) for batch in batches]
    counts = dict(cuda_lib.LAUNCHES)
    local = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    whole = lambda d: {k: v.cpu() for k, v in gather_params_tp(d, tp).items()}
    return losses, local, whole(dict(model.state_dict())), whole(state.ema), counts


def tp_rank(rank, world, store, seed, data, out_dir):
    """Phase 10 (a) and (b) as mp rank `rank` of `world` gloo ranks on the one
    card (dp = 1): K2 and K3 split over the ranks on (a)'s input, the split
    passes and the all-reduce timed; then the TP serving forward on (b)'s
    shared windows and TP_STEPS TP train steps. Saves what it computed,
    with the launch counts of each part, to out_dir/rank<r>.pt."""
    import torch

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the ranks share the host
    from uplift_upsample_torch.configs import get_config
    from uplift_upsample_torch.eval import make_test_step
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.models.bench_forward import prepare_fused_params
    from uplift_upsample_torch.ops import cuda_lib
    from uplift_upsample_torch.ops.strided import strided_block1
    from uplift_upsample_torch.ops.temporal import temporal_stack
    from uplift_upsample_torch.parallel.mesh import init_mesh
    from uplift_upsample_torch.parallel.sharding import all_reduce_sum

    mesh = init_mesh(1, world, device="cuda", backend="gloo", init_method=store)
    tp, dev = mesh.tp, mesh.device
    config = get_config("h36m_351")
    model = build_uplift_upsample_transformer(config, device=dev, seed=seed, tp=tp)
    fp = prepare_fused_params(model)
    heads, s0, pads = model.num_heads, model.strides[0], model.paddings[0]
    y, key_mask = (t.to(dev) for t in data["split"])
    k2 = lambda: temporal_stack(y, fp["temporal"], key_mask, num_heads=heads,
                                first_masked_blocks=1, tp=tp)
    k3 = lambda t: strided_block1(t, fp["strided"], num_heads=heads, stride=s0, paddings=pads,
                                  tp=tp)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t_out = k2()
    s_out = k3(t_out)
    torch.cuda.synchronize()
    out = dict(split=(t_out.cpu(), s_out.cpu()), split_counts=dict(cuda_lib.LAUNCHES))
    # both ranks time the same collectives in step; the card is shared
    out["split_ms"] = dict(k2=time_ms(torch, k2, 5), k3=time_ms(torch, lambda: k3(t_out), 5),
                           all_reduce=time_ms(torch, lambda: all_reduce_sum(tp, t_out), 10))

    uq, win_idx, sm = (t.to(dev) for t in data["shared"])
    step = make_test_step(model, flip_tta=True, flip_lr_indices=config.AUGM_FLIP_KEYPOINT_ORDER,
                          fused="full", shared_spatial=True, tp=tp)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    central = step(uq, win_idx, sm)[1]
    torch.cuda.synchronize()
    out.update(serve=central.cpu(), serve_counts=dict(cuda_lib.LAUNCHES),
               serve_ms=time_ms(torch, lambda: step(uq, win_idx, sm), 3))
    del model, fp, step
    t0 = time.perf_counter()
    out["train"] = tp_train_steps(torch, tp_train_config(get_config), seed, data["batches"],
                                  dev, mesh)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.close()


def tp_launch_times(torch, rand, model, fp, windows, n):
    """(name, split ms, full-width ms) of each launch of K2's and K3's blocks
    at mp rank 0's widths beside the same launch at full width, on `windows`
    windows, from the rank's operands (`shard_params_tp`), in this process
    with nothing else on the card."""
    from uplift_upsample_torch.ops.strided import stack_strided_block1_params, strided_conv
    from uplift_upsample_torch.ops.temporal import gemm, stack_temporal_params, window_attention
    from uplift_upsample_torch.parallel.sharding import shard_params_tp

    local = shard_params_tp({k: v.detach() for k, v in model.state_dict().items()}, 0, 2)
    lt, ls = stack_temporal_params(local, model.temporal_depth), stack_strided_block1_params(local)
    ft, fs = fp["temporal"], fp["strided"]
    rows, c, heads = windows * n, model.temporal_d_model, model.num_heads
    x, mask = rand(rows, c), (torch.rand((windows, n), device="cuda") < 0.5).float()
    out = []

    def pair(name, split_fn, full_fn):
        out.append((name, time_ms(torch, split_fn, 20), time_ms(torch, full_fn, 20)))

    def product(name, w, b, **kw):  # mp rank 0's epilogue: the bias (and the residual)
        a_l, a_f = rand(rows, lt[w].shape[1]), rand(rows, ft[w].shape[1])
        pair(name, lambda: gemm(a_l, lt[f"{w}_tc"][0], lt[b][0], counter=None, **kw),
             lambda: gemm(a_f, ft[f"{w}_tc"][0], ft[b][0], counter=None, **kw))

    product("qkv", "wqkv", "bqkv")
    product("proj (+ bp + h)", "wp", "bp", residual=x)
    product("fc1 + relu", "w1", "b1", relu=True)
    product("fc2 (+ b2 + h)", "w2", "b2", residual=x)
    qkv_l, qkv_f = rand(rows, 3 * c // 2), rand(rows, 3 * c)
    pair("attention", lambda: window_attention(qkv_l, mask, windows=windows, n=n,
                                               num_heads=heads // 2, counter=None),
         lambda: window_attention(qkv_f, mask, windows=windows, n=n, num_heads=heads,
                                  counter=None))
    h1_l, h1_f = (torch.relu(rand(windows, n, ops["w1"].shape[1])) for ops in (ls, fs))
    xs = rand(windows, n, c)
    kw = dict(stride=model.strides[0], paddings=model.paddings[0], counter=None)
    pair("conv (+ bc + crop)", lambda: strided_conv(h1_l, xs, ls, **kw),
         lambda: strided_conv(h1_f, xs, fs, **kw))
    return out


def tp_phase(args, torch, np, rng, failed) -> None:
    """Phase 10: tensor parallelism at h36m_351 full width on the one card:
    (a) K2 and K3 split over TP_RANKS gloo ranks against the unsplit kernels,
    the split launches timed beside the full-width ones; (b) the TP serving
    forward and TP_STEPS TP train steps against one process; (c) the dry-run
    tool over 4 gloo ranks; (d) the phase's wall time."""
    import tempfile

    import torch.multiprocessing as mp

    from uplift_upsample_torch.configs import get_config
    from uplift_upsample_torch.eval import make_test_step
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.models.bench_forward import prepare_fused_params
    from uplift_upsample_torch.ops.strided import (output_length, stack_strided_block1_params,
                                                   strided_block1)
    from uplift_upsample_torch.ops.temporal import stack_temporal_params, temporal_stack
    from uplift_upsample_torch.parallel.sharding import param_spec, shard_params_tp
    from uplift_upsample_torch.utils.dedup import dedup_rows

    t_phase = time.perf_counter()
    card = card_line()
    log(f"phase 10 card: {card}")
    config = get_config("h36m_351")
    n, k = config.SEQUENCE_LENGTH, config.NUM_KEYPOINTS
    model = build_uplift_upsample_transformer(config, device="cuda", seed=args.seed)
    fp = prepare_fused_params(model)
    heads, s0, pads = model.num_heads, model.strides[0], model.paddings[0]
    depth = model.temporal_depth

    def rand(*shape, scale=0.5):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).cuda()

    # (a)'s input: the temporal stack's input and its key mask (stride 5)
    y = rand(TP_WINDOWS, n, model.temporal_d_model)
    sm_a = (np.arange(n)[None] + rng.integers(0, 5, size=(TP_WINDOWS, 1))) % 5 == 0
    key_mask = torch.from_numpy(1.0 - sm_a.astype(np.float32)).cuda()
    k2 = lambda: temporal_stack(y, fp["temporal"], key_mask, num_heads=heads,
                                first_masked_blocks=1)
    ref_t = k2()
    k3 = lambda: strided_block1(ref_t, fp["strided"], num_heads=heads, stride=s0, paddings=pads)
    ref_s = k3()
    unsplit_ms = dict(k2=time_ms(torch, k2, 5), k3=time_ms(torch, k3, 5))
    # the least time of one rank's share of the split passes (half of every
    # product, the attention included, in 3xTF32; its operands read once)
    c, hid, rows = model.temporal_d_model, int(model.temporal_d_model * config.MLP_RATIO), \
        TP_WINDOWS * n
    n_out = output_length(n, s0, pads)
    local = shard_params_tp({key: v.detach() for key, v in model.state_dict().items()}, 0, 2)
    split_bound = dict(
        k2=bound_ms(0, (2 * y.numel() + key_mask.numel()) * F32
                    + ops_bytes(stack_temporal_params(local, depth)),
                    tc_flops=depth * (rows * 2 * c * (3 * c + c + 2 * hid)
                                      + TP_WINDOWS * 4 * n * n * c) / 2),
        k3=bound_ms(0, (y.numel() + ref_s.numel()) * F32
                    + ops_bytes(stack_strided_block1_params(local)),
                    tc_flops=(rows * 2 * c * (3 * c + c + hid) + TP_WINDOWS * 4 * n * n * c
                              + TP_WINDOWS * n_out * 2 * 3 * hid * c) / 2))
    for windows in (TP_WINDOWS, 1024):
        t0 = time.perf_counter()
        launches = tp_launch_times(torch, rand, model, fp, windows, n)
        log(f"phase 10 (a) launches at mp rank 0's widths beside full width, {windows} windows "
            f"({card}): " + "; ".join(f"{name} {a:.4f} ms vs {b:.4f}" for name, a, b in launches)
            + f"; wall {time.perf_counter() - t0:.1f} s")

    # (b)'s inputs: TP_WINDOWS overlapping windows of masked unique frames, train batches
    x2d = rng.normal(size=(TP_WINDOWS + n - 1, k, 2)).astype(np.float32) * 0.3
    win = np.arange(TP_WINDOWS)[:, None] + np.arange(n)
    sm_b = (win % 5 == 0)
    uniq, inv = dedup_rows((x2d[win] * sm_b[..., None, None]).reshape(TP_WINDOWS * n, -1))
    uq = np.zeros((-(-len(uniq) // 8) * 8, k, 2), np.float32)
    uq[:len(uniq)] = uniq.reshape(-1, k, 2)
    shared = tuple(torch.from_numpy(a) for a in (uq, inv.reshape(TP_WINDOWS, n).astype(np.int64),
                                                 sm_b))
    serve = make_test_step(model, flip_tta=True, flip_lr_indices=config.AUGM_FLIP_KEYPOINT_ORDER,
                           fused="full", shared_spatial=True)
    serve_ref = serve(*(t.cuda() for t in shared))[1].cpu()
    serve_ref_ms = time_ms(torch, lambda: serve(*(t.cuda() for t in shared)), 3)
    batches = tp_batches(np, rng, config)
    t0 = time.perf_counter()
    ref = tp_train_steps(torch, tp_train_config(get_config), args.seed, batches, "cuda")
    ref_s_train = time.perf_counter() - t0
    data = dict(split=(y.cpu(), key_mask.cpu()), shared=shared, batches=batches)
    del model, fp, serve, local
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(tp_rank, nprocs=TP_RANKS, join=False, start_method="spawn",
                                 args=(TP_RANKS, f"file://{tmp}/store", args.seed, data, tmp))
        try:
            while not ctx.join(timeout=5.0):
                if time.perf_counter() - t0 > 240:
                    raise TimeoutError(f"{TP_RANKS} ranks still running after 240 s")
            ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                     for r in range(TP_RANKS)]
        except Exception as e:  # the phase fails; no rank's result is used
            log(f"phase 10 (a)/(b): the {TP_RANKS} ranks FAILED: {type(e).__name__}: {e}")
            failed.append("tp_ranks")
            ranks = None
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join(10)
        spawn_s = time.perf_counter() - t0
    if ranks is not None:
        # (a) the split passes against the unsplit kernels
        checks = [out_check(torch, r["split"][i], got.cpu()) for r in ranks
                  for i, got in enumerate((ref_t, ref_s))]
        want = dict(temporal_stack=7 * depth, strided_block1=7)
        counted = all(r["split_counts"].get(key, 0) == v for r in ranks for key, v in want.items())
        ok = all(c_[2] for c_ in checks) and counted
        log(f"phase 10 (a) K2 ({depth} blocks, key mask in block 1) and K3 "
            f"split over {TP_RANKS} gloo ranks on one card, {TP_WINDOWS} windows: largest error "
            f"against the unsplit kernels {max(c_[0] for c_ in checks):.3e} (limit "
            f"{checks[0][1]}); launches per rank "
            + "; ".join(str({key: r["split_counts"].get(key, 0) for key in
                             ("temporal_stack", "strided_block1", "gemm_f32",
                              "window_attention_f32", "layernorm_f32", "strided_conv_f32")})
                        for r in ranks)
            + f" (want {want}); split pass ms per rank (both ranks at once, all-reduces through "
            f"the host): " + "; ".join(
                f"K2 {r['split_ms']['k2']:.3f}, K3 {r['split_ms']['k3']:.3f}, one all-reduce "
                f"of {TP_WINDOWS * n} x {config.TEMPORAL_EMBED_DIM} {r['split_ms']['all_reduce']:.3f}"
                for r in ranks)
            + f"; a rank's bound K2 {split_bound['k2'][0]:.4f} ({split_bound['k2'][1]}), K3 "
            f"{split_bound['k3'][0]:.4f} ({split_bound['k3'][1]}); unsplit in one process K2 "
            f"{unsplit_ms['k2']:.3f}, K3 {unsplit_ms['k3']:.3f} ({card}); "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            failed.append("tp_split_kernels")
        # (b) serving forward and train steps against one process
        serve_gap = max(float((r["serve"] - serve_ref).abs().max()) for r in ranks)
        serve_launched = all(r["serve_counts"].get(key, 0) > 0 for r in ranks
                             for key in ("spatial_stack", "temporal_stack", "strided_block1"))
        loss_gap = max(abs(a - b) / abs(b) for r in ranks for a, b in zip(r["train"][0], ref[0]))
        param_gap, ema_gap = (max(float((r["train"][i][key] - ref[i][key]).abs().max())
                                  for r in ranks for key in ref[i]) for i in (2, 3))
        same = all(torch.equal(v, r["train"][1][key]) for r in ranks[1:]
                   for key, v in ranks[0]["train"][1].items() if param_spec(key, v) is None)
        keys = ("spatial_stack", "spatial_bwd", "temporal_train_fwd", "temporal_train_bwd",
                "strided_train_fwd", "strided_train_bwd")
        launched = all(r["train"][4].get(key, 0) > 0 for r in ranks for key in keys)
        ok = (serve_gap <= 1e-4 and serve_launched and all(torch.isfinite(r["serve"]).all()
                                                           for r in ranks))
        log(f"phase 10 (b) TP serving forward (fused full, shared spatial, flip-TTA, "
            f"{TP_WINDOWS} windows) on dp 1 x mp {TP_RANKS}: largest gap to one process "
            f"{serve_gap:.3e} (bar 1e-4); K1/K2/K3 launches per rank "
            + "; ".join(str({key: r["serve_counts"].get(key, 0) for key in
                             ("spatial_stack", "temporal_stack", "strided_block1")})
                        for r in ranks)
            + "; ms per call per rank " + ", ".join(f"{r['serve_ms']:.3f}" for r in ranks)
            + f", one process {serve_ref_ms:.3f} ({card}); {'ok' if ok else 'FAILED'}")
        if not ok:
            failed.append("tp_serving")
        ok = loss_gap <= 2e-5 and max(param_gap, ema_gap) <= 2e-4 and same and launched
        log(f"phase 10 (b) TP train: h36m_351 B={TP_BATCH}, TRAIN_FUSED_STRIDED on, {TP_STEPS} "
            f"steps: losses {ranks[0]['train'][0]} against the 1-process {ref[0]}; largest gap "
            f"loss {loss_gap:.2e} (rtol 2e-5), params {param_gap:.2e}, EMA {ema_gap:.2e} (atol "
            f"2e-4); replicated parameters bit-identical over the ranks: "
            f"{'yes' if same else 'NO'}; launches per rank "
            + "; ".join(str({key: r["train"][4].get(key, 0) for key in keys}) for r in ranks)
            + f"; {'ok' if ok else 'FAILED'}; rank wall "
            + ", ".join(f"{r['train_s']:.1f}" for r in ranks)
            + f" s, 1-process {ref_s_train:.1f} s")
        if not ok:
            failed.append("tp_train")
    log(f"phase 10 (a)+(b) the ranks' spawn to exit {spawn_s:.1f} s")

    # (c) the dry-run tool over 4 gloo ranks on the card
    env = dict(os.environ, MULTICHIP_BUDGET_S="300")
    rc, lines, wall = run_cli([sys.executable, "-m", "uplift_upsample_torch.tools.dryrun_multichip",
                               "--devices", "4", "--seed", str(args.seed)], timeout=360, env=env)
    stages = [ln for ln in lines if ": ok, wall" in ln or "SKIP " in ln]
    summary = next((ln for ln in lines if "dryrun staged summary" in ln), "")
    core = any("MULTICHIP_CORE_OK" in ln for ln in lines)
    ok = rc == 0 and core
    log(f"phase 10 (c) python -m uplift_upsample_torch.tools.dryrun_multichip --devices 4: exit "
        f"{rc}, MULTICHIP_CORE_OK {'yes' if core else 'NO'}; {summary.strip()}; wall {wall:.1f} s")
    for ln in stages:
        log(f"phase 10 (c) {ln.strip()}")
    if not ok:
        log("\n".join(lines[-40:]))
        failed.append("tp_dryrun")
    log(f"phase 10 (d) wall {time.perf_counter() - t_phase:.1f} s ({card})")


# ---- phase 11: the bf16 eval rung -----------------------------------------------

BF16_DRIFT_FRAC = 0.25  # mean |kernel - plain| over the rung's mean drift, at most


def rung_checks(torch, got, plain, plain_high, rung64, mean_frac=BF16_DRIFT_FRAC,
                largest=2.0):
    """A bf16 instance against its plain version at the same rung: (max
    |got - plain|, the bars' text, ok), and the numbers. Bars: the distance
    to the rung with exact sums (`rung64`, the plain version in float64),
    mean at most 2x and largest at most `largest` x the fp32 plain
    version's, + 1e-6 of the scale; and mean |got - plain| at most
    `mean_frac` x the rung's mean drift |plain - plain_high| (None:
    reported, not held). Both round the same operands; their sum orders
    differ, which flips a later bf16 rounding now and then, so the largest
    gap is held through rung64 only."""
    got, plain, plain_high = (t.double() for t in (got, plain, plain_high))
    err, err_plain = (got - rung64).abs(), (plain - rung64).abs()
    slack = 1e-6 * float(rung64.abs().max())
    gap, drift = (got - plain).abs(), (plain - plain_high).abs()
    ok = (float(err.mean()) <= 2 * float(err_plain.mean()) + slack
          and float(err.max()) <= largest * float(err_plain.max()) + slack
          and bool(torch.isfinite(got).all()))
    if mean_frac is not None:
        ok = ok and float(gap.mean()) <= mean_frac * float(drift.mean())
    nums = dict(rung64_mean=float(err.mean()), plain_rung64_mean=float(err_plain.mean()),
                rung64_max=float(err.max()), plain_rung64_max=float(err_plain.max()),
                gap_mean_over_drift=float(gap.mean() / max(float(drift.mean()), 1e-30)),
                gap_max_over_drift=float(gap.max() / max(float(drift.max()), 1e-30)))
    bar = (f"rung64 mean 2x, largest {largest}x plain"
           + ("" if mean_frac is None else f", mean <= {mean_frac} drift"))
    return (float(gap.max()), bar, ok), nums


def bf16_phase(args, torch, np, rng, failed, record, eval_data):
    """Phase 11, the bf16 eval rung (EVAL_MATMUL_PRECISION "default") at
    h36m_351 full width, seed --seed: (a) each bf16 instance against its
    plain version (`rung_checks`) at the main path's shapes, timed beside its
    "high" instance; (b) predict (3 x 3,000 frames, flip-TTA) and the tiled
    route with their launches, and run_eval per mask stride on phase 5's
    data, each against "high"; (c) the drift matrix; (d) the bench CLI at
    --precision default; (e) K4 bit for bit against its build before the
    bf16 mode. Returns the launch counts by path."""
    import torch.nn.functional as F

    import uplift_upsample_torch.eval as eval_mod
    from uplift_upsample_torch.configs import get_config
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.models.bench_forward import bench_forward, prepare_fused_params
    from uplift_upsample_torch.ops import cuda_lib
    from uplift_upsample_torch.ops.s2t import s2t_prologue, s2t_prologue_plain
    from uplift_upsample_torch.ops.spatial import spatial_stack, spatial_stack_plain
    from uplift_upsample_torch.ops.strided import (output_length, strided_block1,
                                                   strided_block1_plain, strided_conv,
                                                   strided_conv_plain)
    from uplift_upsample_torch.ops.temporal import (gemm, temporal_stack, temporal_stack_plain,
                                                    window_attention, window_attention_plain)
    from uplift_upsample_torch.precision import mm
    from uplift_upsample_torch.predict import make_predict_step, predict_sequence

    # the gpu test's K4 case, imported from its directory (an installed
    # package may own the name "tests")
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_precision_kernels import K4_DIGEST, _k4_outputs, k4_digest

    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64
    counts = {}

    def rand(*shape, scale=0.5):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dev)

    def cast(value, dtype):
        if isinstance(value, dict):
            return {k: cast(v, dtype) for k, v in value.items()}
        return value.to(dtype) if torch.is_tensor(value) and value.is_floating_point() else value

    def stride_mask(b, n_, ms):
        phase = rng.integers(0, ms, size=(b, 1))
        return torch.from_numpy((np.arange(n_)[None] + phase) % ms == 0).to(dev)

    def case(name, replaces, source, kernel, plain, counter, bf16_flops, nbytes, flops=0.0,
             library=None, mean_frac=BF16_DRIFT_FRAC, listed=True, phase="predict bf16",
             extra=None):
        """kernel(rung) against plain(rung, dtype), timed beside kernel("high")."""
        got = kernel("default")
        check, nums = rung_checks(torch, got, plain("default", f32), plain("high", f32),
                                  plain("default", f64), mean_frac)
        ms = time_ms(torch, lambda: kernel("default"), 10)
        high_ms = time_ms(torch, lambda: kernel("high"), 10)
        record(name, source, replaces, check, ms, time_ms(torch, lambda: plain("default", f32), 3),
               flops, nbytes, library_ms=None if library is None else time_ms(torch, library, 10),
               counter=counter, phase=phase, listed=listed, stage="phase 11",
               bf16_flops=bf16_flops, extra=dict(high_ms=high_ms, **nums, **(extra or {})))
        torch.cuda.empty_cache()

    config = get_config("h36m_351")
    config.MASK_STRIDE = config.MASK_STRIDE[0]
    model = build_uplift_upsample_transformer(config, device="cuda", seed=args.seed)
    fp = prepare_fused_params(model, "default")
    heads, fmb = model.num_heads, model.first_strided_token_attention_layer
    windows, n = 2 * config.BATCH_SIZE, config.SEQUENCE_LENGTH
    c, hid, p, cs = (config.TEMPORAL_EMBED_DIM, int(config.TEMPORAL_EMBED_DIM * config.MLP_RATIO),
                     config.NUM_KEYPOINTS, config.SPATIAL_EMBED_DIM)
    rows, frames = windows * n, windows * n
    plane_bytes = lambda ops: sum(v.numel() for k, v in ops.items()
                                  if k.endswith("_bf") or not (k.endswith("_tc") or "_tc_" in k
                                                               or f"{k}_bf" in ops)) * F32

    # (a) each bf16 instance against its plain version
    x_sp, sp_ops = rand(frames, p, 2), fp["spatial"]
    dense_frame = model.spatial_depth * (2 * p * cs * cs * 4 + 2 * p * cs * 2 * cs * 2)
    case("spatial_stack_bf16", "uplift_upsample_tpu/ops/pallas_spatial.py:398",
         "uplift_upsample_torch/csrc/spatial.cu",
         lambda r: spatial_stack(x_sp, sp_ops, num_heads=heads, packed=fp["spatial_packed"],
                                 precision=r),
         lambda r, d: spatial_stack_plain(x_sp.to(d), cast(sp_ops, d), num_heads=heads,
                                          precision=r),
         "spatial_stack_bf16", frames * (dense_frame + p * 2 * cs * 2),
         (x_sp.numel() + frames * p * cs + fp["spatial_packed"].numel()) * F32,
         flops=frames * model.spatial_depth * 4 * p * p * cs)  # the attention: fp32, CUDA cores
    del x_sp
    x_tm = rand(windows, n, c)
    km = 1.0 - stride_mask(windows, n, 10).float()
    tm_ops = fp["temporal"]
    block_flops = rows * 2 * c * (3 * c + c + 2 * hid) + windows * 4 * n * n * c
    for blocks, mean_frac in ((4, None), (1, BF16_DRIFT_FRAC)):
        ops_b = {k: v[:blocks] for k, v in tm_ops.items()}
        kw = dict(num_heads=heads, first_masked_blocks=fmb)
        case("temporal_stack_bf16" + ("" if blocks == 4 else "_one_block"),
             "uplift_upsample_tpu/ops/pallas_temporal_v3.py:343",
             "uplift_upsample_torch/csrc/temporal.cu",
             lambda r, o=ops_b: temporal_stack(x_tm, o, km, precision=r, **kw),
             lambda r, d, o=ops_b: temporal_stack_plain(x_tm.to(d), cast(o, d), km.to(d),
                                                        precision=r, **kw),
             "temporal_stack", blocks * block_flops,
             (2 * x_tm.numel() + km.numel()) * F32 + plane_bytes(ops_b), mean_frac=mean_frac,
             listed=blocks == 4)
    qkv = rand(rows, 3 * c, scale=1.0)
    q, k, v = (t.reshape(windows, n, heads, c // heads).transpose(1, 2).to(torch.bfloat16)
               for t in qkv.reshape(windows, n, 3 * c).split(c, dim=-1))
    mask_bf = (km * -1e9)[:, None, None, :].to(torch.bfloat16)
    case("window_attention_bf16", "uplift_upsample_tpu/ops/pallas_temporal_v3.py:248",
         "uplift_upsample_torch/csrc/attention.cuh",
         lambda r: window_attention(qkv, km, windows=windows, n=n, num_heads=heads,
                                    counter="probe", precision=r),
         lambda r, d: window_attention_plain(qkv.reshape(windows, n, 3 * c).to(d), km.to(d),
                                             heads, r).reshape(rows, c),
         "window_attention_bf16", windows * 4 * n * n * c,
         (qkv.numel() + km.numel() + rows * c) * F32,
         library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask_bf))
    del qkv, q, k, v
    v3 = "uplift_upsample_tpu/ops/pallas_temporal_v3.py"
    for name, line, wname, bname, k_in, relu, residual in (
            ("gemm_bf16", 174, "wqkv", "bqkv", c, False, False),
            ("gemm_bf16_proj", 260, "wp", "bp", c, False, True),
            ("gemm_bf16_fc1", 264, "w1", "b1", c, True, False),
            ("gemm_bf16_fc2", 270, "w2", "b2", hid, False, True)):
        a = torch.relu(rand(rows, k_in)) if wname == "w2" else rand(rows, k_in)
        w, bias = tm_ops[wname][0], tm_ops[bname][0]
        res = rand(rows, w.shape[1]) if residual else None
        planes = {"default": tm_ops[wname + "_bf"][0], "high": tm_ops[wname + "_tc"][0]}
        act = torch.relu if relu else (lambda t: t)
        a_bf, w_bf = a.to(torch.bfloat16), w.to(torch.bfloat16)
        case(name, f"{v3}:{line}", "uplift_upsample_torch/csrc/gemm_tc.cuh",
             lambda r: gemm(a, planes[r], bias, relu=relu, residual=res, counter="probe",
                            precision=r),
             lambda r, d: act(mm(a.to(d), w.to(d), r) + bias.to(d)) + (
                 0 if res is None else res.to(d)),
             "gemm_bf16", 2 * rows * k_in * w.shape[1],
             (a.numel() + w.numel() + w.shape[1] + rows * w.shape[1] * (2 if residual else 1))
             * F32, library=lambda: torch.matmul(a_bf, w_bf))  # bf16 in, bf16 out
        del a, res, a_bf, w_bf

    def strided_case(name, model_, fp_, x_, listed):
        s0, pads = model_.strides[0], model_.paddings[0]
        kw = dict(num_heads=heads, stride=s0, paddings=pads)
        b_, n_, _ = x_.shape
        n_out = output_length(n_, s0, pads)
        case(name, "uplift_upsample_tpu/ops/pallas_strided.py:231",
             "uplift_upsample_torch/csrc/strided.cu",
             lambda r: strided_block1(x_, fp_["strided"], precision=r, **kw),
             lambda r, d: strided_block1_plain(x_.to(d), cast(fp_["strided"], d), precision=r,
                                               **kw),
             "strided_block1", b_ * n_ * 2 * c * (3 * c + c + hid) + b_ * 4 * n_ * n_ * c
             + b_ * n_out * 2 * 3 * hid * c,
             (x_.numel() + b_ * n_out * c) * F32 + plane_bytes(fp_["strided"]), listed=listed)

    strided_case("strided_block1_bf16", model, fp, x_tm, True)
    config81 = get_config("h36m_81")
    config81.MASK_STRIDE = config81.MASK_STRIDE[0]
    model81 = build_uplift_upsample_transformer(config81, device="cuda", seed=args.seed)
    strided_case("strided_block1_bf16_h36m_81", model81, prepare_fused_params(model81, "default"),
                 rand(2 * config81.BATCH_SIZE, config81.SEQUENCE_LENGTH, c), False)
    del model81
    st_ops, s0 = fp["strided"], model.strides[0]
    h1, x_res = torch.relu(rand(windows, n, hid)), rand(windows, n, c)
    n_out = output_length(n, s0, (0, 0))
    h1t = h1.transpose(1, 2).contiguous().to(torch.bfloat16)
    wt = st_ops["wc"].reshape(3, hid, c).permute(2, 1, 0).contiguous().to(torch.bfloat16)
    res_rows = x_res[:, 1: 2 + s0 * (n_out - 1): s0].to(torch.bfloat16)
    bc_bf = st_ops["bc"].to(torch.bfloat16)
    case("strided_conv_bf16", "uplift_upsample_tpu/ops/pallas_strided.py:231",
         "uplift_upsample_torch/csrc/strided.cu",
         lambda r: strided_conv(h1, x_res, st_ops, stride=s0, paddings=(0, 0), counter="probe",
                                precision=r),
         lambda r, d: strided_conv_plain(h1.to(d), x_res.to(d), st_ops["wc"].to(d),
                                         st_ops["bc"].to(d), stride=s0, paddings=(0, 0),
                                         precision=r),
         "strided_conv_bf16", 2 * windows * n_out * 3 * hid * c,
         (h1.numel() + 2 * windows * n_out * c + 3 * hid * c + c) * F32,
         library=lambda: res_rows + F.conv1d(h1t, wt, bc_bf, stride=s0).transpose(1, 2))
    del h1, x_res, h1t, wt, res_rows
    kk = p * cs
    sp, sm = rand(windows, n, kk, scale=1.0), stride_mask(windows, n, 10)
    s2t = fp["s2t"]
    sp_bf, w_bf, b_bf = (t.to(torch.bfloat16) for t in (sp.reshape(rows, kk), s2t["w"],
                                                         s2t["bias"]))
    tok_bf, pe_bf = s2t["token"].to(torch.bfloat16), s2t["pe"].to(torch.bfloat16)
    case("s2t_prologue_bf16", "uplift_upsample_tpu/ops/pallas_temporal_v3.py:518",
         "uplift_upsample_torch/csrc/s2t.cu",
         lambda r: s2t_prologue(sp, s2t, sm, precision=r),
         lambda r, d: s2t_prologue_plain(sp.to(d), cast(s2t, d), sm, precision=r),
         "s2t_prologue_bf16", 2 * rows * kk * c,
         (sp.numel() + rows * c + sm.numel() + kk * c + 2 * c + n * c) * F32,
         phase="route tiled bf16",
         library=lambda: torch.where(sm[..., None], torch.addmm(b_bf, sp_bf, w_bf).reshape(
             windows, n, c), tok_bf) + pe_bf)
    del sp, sp_bf, w_bf, x_tm
    torch.cuda.empty_cache()

    # (b) predict, the tiled route and the eval at "default" against "high"
    seqs = []
    for _ in range(SEQUENCES):
        walk = np.cumsum(rng.normal(size=(FRAMES, p, 2)) * 0.01, axis=0)
        seqs.append((walk + rng.normal(size=(1, p, 2)) * 0.3).astype(np.float32))
    total = sum(len(s_) for s_ in seqs)
    config_def = config.copy()
    config_def.EVAL_MATMUL_PRECISION = "default"
    preds, walls = {}, {}
    for rung, cfg in (("high", config), ("default", config_def)):
        step = make_predict_step(model, cfg, flip_tta=True)
        predict_sequence(model, cfg, seqs[0][:400], step=step)  # warm the allocator
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        preds[rung] = [predict_sequence(model, cfg, s_, step=step) for s_ in seqs]
        torch.cuda.synchronize()
        walls[rung] = time.perf_counter() - t0
        counts["predict " + rung] = dict(cuda_lib.LAUNCHES)
    counts["predict bf16"] = counts.pop("predict default")
    gap = max(float(np.abs(a - b).max()) for a, b in zip(preds["default"], preds["high"]))
    mean_gap = float(np.mean([np.abs(a - b).mean() for a, b in zip(preds["default"],
                                                                     preds["high"])]))
    scale = max(float(np.abs(b).max()) for b in preds["high"])
    finite = all(np.isfinite(a).all() and a.shape == (len(s_), p, 3)
                 for a, s_ in zip(preds["default"], seqs))
    seen = counts["predict bf16"]
    log(f"phase 11 predict: {SEQUENCES} x {FRAMES} frames, flip-TTA: default "
        f"{total / walls['default']:.1f} frames/s, high {total / walls['high']:.1f} frames/s; "
        f"|default - high| mean {mean_gap:.4e} max {gap:.4e} (output scale {scale:.3f}); "
        f"launches {seen}")
    wanted = ("spatial_stack_bf16", "gemm_bf16", "window_attention_bf16", "strided_conv_bf16")
    if not finite:
        failed.append("bf16_predict_not_finite")
    for key in wanted:
        if seen.get(key, 0) == 0 or seen.get(key.replace("_bf16", "_f32"), 0) != 0:
            failed.append(f"bf16_predict_launches_{key}")
    xb = rand(windows, n, p, 2, scale=0.3)
    smb = stride_mask(windows, n, 10)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    tiled = bench_forward(model, xb * smb[..., None, None], smb, fp, precision="default",
                          temporal_attn="banded", fuse_s2t=True)
    torch.cuda.synchronize()
    counts["route tiled bf16"] = dict(cuda_lib.LAUNCHES)
    log(f"phase 11 tiled route at default: launches {counts['route tiled bf16']}")
    if (counts["route tiled bf16"].get("s2t_prologue_bf16", 0) != 1
            or not bool(torch.isfinite(tiled).all())):
        failed.append("bf16_tiled_route")
    del xb, smb, tiled
    p3, p2, samples, walls_high, results_high = eval_data
    data = dict(dataset_name="h36m", dataset_path=p3, dataset2d_path=p2, test_subset="test",
                action_wise=False, verbose=False)
    econfig = get_config("h36m_351")
    econfig.EVAL_MATMUL_PRECISION = "default"
    walls_def, real_run_eval = {}, eval_mod.run_eval

    def timed(cfg, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = real_run_eval(cfg, *a, **kw)
        walls_def[cfg.MASK_STRIDE] = time.perf_counter() - t0
        return out

    eval_mod.run_eval = timed
    try:
        results = eval_mod.run_eval_multi_mask_stride(econfig, model=model, **data)
    finally:
        eval_mod.run_eval = real_run_eval
    for stride, res in results.items():
        got, ref = eval_metrics(res), eval_metrics(results_high[stride])
        mpjpe_gap = abs(got["all/frame/mpjpe"] - ref["all/frame/mpjpe"])
        worst = max(abs(got[key] - ref[key]) / abs(ref[key]) for key in ref)
        ok = all(np.isfinite(v_) for v_ in got.values()) and worst <= 0.01
        log(f"phase 11 eval MASK_STRIDE {stride} at default: MPJPE {got['all/frame/mpjpe']:.3f} "
            f"against high {ref['all/frame/mpjpe']:.3f} mm (gap {mpjpe_gap:.4f} mm; the largest "
            f"relative gap over {len(ref)} metrics {worst:.3e}, bar 0.01) "
            f"{'ok' if ok else 'FAILED'}; wall {walls_def[stride]:.3f} s = "
            f"{samples / walls_def[stride]:.1f} protocol frames/s (high: "
            f"{samples / walls_high[stride]:.1f})")
        if not ok:
            failed.append(f"bf16_eval_{stride}")
    del model
    torch.cuda.empty_cache()

    # (c) the drift matrix, (d) the bench CLI at --precision default
    rc, lines, wall = run_cli([sys.executable, "-m", "uplift_upsample_torch.tools.check_parity",
                               "--assert-bounds"], timeout=300)
    for line in lines:
        log(f"phase 11 check_parity: {line}")
    log(f"phase 11 check_parity: exit {rc} after {wall:.1f} s")
    if rc != 0:
        failed.append("bf16_drift_matrix")
    rc, lines, wall = run_cli([sys.executable, "-m", "uplift_upsample_torch.bench", "--iters",
                               "8", "--precision", "default"], timeout=300)
    result = next((ln for ln in reversed(lines) if ln.startswith("{")), "")  # the JSON line
    log(f"phase 11 bench --precision default: exit {rc} after {wall:.1f} s; line: {result}")
    if rc != 0 or '"precision_rung": "default"' not in result or "provisional" in result:
        failed.append("bf16_bench_cli")

    # (e) K4 (spatial_common.cuh is shared with K1's bf16 instance)
    first, second = _k4_outputs(), _k4_outputs()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    digest = k4_digest(first)
    log(f"phase 11 K4: bit-identical on repeat {'yes' if same else 'NO'}; digest {digest} "
        f"{'equals' if digest == K4_DIGEST else 'DIFFERS FROM'} its build before the bf16 mode")
    if not same or digest != K4_DIGEST:
        failed.append("k4_changed")
    return counts


# ---- phase 12: the training rungs ------------------------------------------------

RUNG_LOSS_BAR = 0.02  # "default" and "mixed" end within 2 % of "high" (tools/rung_convergence.py)
# The training instances' largest distance to the float64-sum rung, over the
# fp32 plain version's (the mean stays held at 2x): a bf16 rounding that
# flips between two sum orders sets the largest error. Two fp32 plain
# versions of K1 (the card's and the host's) part by up to 2.17x on it over
# seeds, and a plain K4 whose softmax is K4's (base 2, the scale folded with
# log2 e) by 1.64x on the q bias's gradient, where K4 sits at 3.57x
# (tests/test_torch_train_rung_kernels.py).
TRAIN_RUNG_LARGEST = 4.0


def fp32_train_config(get_config, name: str = "h36m_351"):
    """The named config on the fp32 training rung (TRAIN_MATMUL_PRECISION
    "high"): phases 2 and 4-10 check the training they checked before the
    port read the rung; phase 12 runs the others."""
    config = get_config(name)
    config.TRAIN_MATMUL_PRECISION = "high"
    return config


def train_rungs_phase(args, torch, np, rng, failed, record):
    """Phase 12, the training rungs (TRAIN_MATMUL_PRECISION) at h36m_351 full
    width, B=512, seed --seed: (a) each bf16 training instance (K1's training
    launch and K4 on the keyframe budget; K5 forward and backward over four
    blocks and over one (row 14), its attention backward and its bf16 pieces;
    K6 forward and backward, its conv's dH1 and dWc) against its plain
    version at the rung (`rung_checks`' 2x bar on every output), timed beside
    its "high" instance, the plain version and, for the pieces, a PyTorch
    call on bf16 tensors; (b) `make_train_step` at each rung, 8 steps after
    2 on the same batches: card ms, windows/s, launches (bf16 entries where
    the rung puts them), the loss curve ("default" and "mixed" end within 2 %
    of "high"); then "default" with TRAIN_FUSED_STRIDED on (K6); (c) one
    epoch of the training CLI at "default" (K6 on) and `bench --train
    --train-precision default`. Returns the launch counts by path."""
    import torch.nn.functional as F

    import uplift_upsample_torch.train as train_mod
    from uplift_upsample_torch.configs import get_config
    from uplift_upsample_torch.data.fast_batcher import FastH36mBatcher
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.models.bench_forward import prepare_fused_params
    from uplift_upsample_torch.ops import cuda_lib
    from uplift_upsample_torch.ops.spatial import (make_droppath_scales, spatial_stack,
                                                   spatial_stack_plain)
    from uplift_upsample_torch.ops.spatial_bwd import spatial_stack_bwd, spatial_stack_bwd_plain
    from uplift_upsample_torch.ops.strided import (conv_taps_plain, output_length,
                                                   stack_strided_block1_params)
    from uplift_upsample_torch.ops.strided_train import ORDER as STRIDED_ORDER
    from uplift_upsample_torch.ops.strided_train import (conv_dh1, conv_dh1_plain, conv_dwc,
                                                         conv_dwc_plain, saved_relu_mask,
                                                         strided_block1_bwd_plain,
                                                         strided_block1_train_plain,
                                                         strided_train_bwd, strided_train_fwd)
    from uplift_upsample_torch.ops.temporal import (stack_temporal_params, temporal_stack_plain,
                                                    window_attention_plain)
    from uplift_upsample_torch.ops.temporal_train import (ORDER, _branch_gemm, gemm_dw, gemm_dx,
                                                          saved_relu_masks,
                                                          temporal_stack_bwd_plain,
                                                          temporal_train_bwd,
                                                          temporal_train_fwd,
                                                          window_attention_bwd,
                                                          window_attention_bwd_plain,
                                                          window_attention_train)
    from uplift_upsample_torch.parallel import make_optimizer, make_train_step
    from uplift_upsample_torch.parallel.train_step import keyframe_budget
    from uplift_upsample_torch.precision import mm

    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64
    counts = {"test only": {}}  # row 14: one block, launched by the tests alone
    t_phase = time.perf_counter()

    def rand(*shape, scale=0.5):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dev)

    def cast(value, dtype):
        if isinstance(value, dict):
            return {k: cast(v, dtype) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return type(value)(cast(v, dtype) for v in value)
        return value.to(dtype) if torch.is_tensor(value) and value.is_floating_point() else value

    def flat(*parts):
        out = []
        for part in parts:
            if isinstance(part, dict):
                out += [part[k] for k in sorted(part)]
            elif isinstance(part, (list, tuple)):
                out += flat(*part)
            else:
                out.append(part)
        return out

    def no_key_bias(names, tensors, c_):
        """Each output, the q|k|v bias gradient without its key third (a true
        gradient of 0: float noise on every side)."""
        return [torch.cat([t[..., :c_], t[..., 2 * c_:]], dim=-1) if n_ == "bqkv" else t
                for n_, t in zip(names, tensors)]

    def case(name, replaces, source, kernel, plain, counter, bf16_flops, nbytes, flops=0.0,
             library=None, phase="train default", listed=True, reps=5):
        """kernel(rung) and plain(rung, dtype) return lists of outputs; each
        output held to `rung_checks`' 2x bar; timed beside kernel("high")."""
        got = kernel("default")
        p32, p_high, p64 = plain("default", f32), plain("high", f32), plain("default", f64)
        ok, worst, err = True, {}, 0.0
        for a, b, h, d in zip(got, p32, p_high, p64):
            (gap, _, ok_), nums = rung_checks(torch, a, b, h, d, None, TRAIN_RUNG_LARGEST)
            ok, err = ok and ok_, max(err, gap)
            for key in ("rung64_mean", "plain_rung64_mean", "rung64_max", "plain_rung64_max"):
                worst.setdefault(key, []).append(nums[key])
        ratio = max(m / max(pm, 1e-30) for m, pm in zip(worst["rung64_mean"],
                                                        worst["plain_rung64_mean"]))
        ratio_max = max(m / max(pm, 1e-30) for m, pm in zip(worst["rung64_max"],
                                                            worst["plain_rung64_max"]))
        del got, p32, p_high, p64
        ms = time_ms(torch, lambda: kernel("default"), reps)
        high_ms = time_ms(torch, lambda: kernel("high"), reps)
        plain_ms = time_ms(torch, lambda: plain("default", f32), 2, warmup=1)
        record(name, source, replaces,
               (err, f"rung64 mean 2x, largest {TRAIN_RUNG_LARGEST}x plain, every output", ok),
               ms, plain_ms,
               flops, nbytes, library_ms=None if library is None else time_ms(torch, library, 10),
               counter=counter, phase=phase, listed=listed, stage="phase 12",
               bf16_flops=bf16_flops,
               extra=dict(high_ms=high_ms, outputs=len(worst["rung64_mean"]),
                          worst_rung64_mean_over_plain=ratio,
                          worst_rung64_max_over_plain=ratio_max))
        torch.cuda.empty_cache()

    config = fp32_train_config(get_config)  # mask strides [5, 10, 20], B=512, droppath
    model = build_uplift_upsample_transformer(config, device="cuda", seed=args.seed)
    state = {k: v.detach() for k, v in model.state_dict().items()}
    heads, fmb = model.num_heads, model.first_strided_token_attention_layer
    bt, n = config.BATCH_SIZE, config.SEQUENCE_LENGTH
    c, hid = config.TEMPORAL_EMBED_DIM, int(config.TEMPORAL_EMBED_DIM * config.MLP_RATIO)
    p, cs = config.NUM_KEYPOINTS, config.SPATIAL_EMBED_DIM
    rows = bt * n
    gen = torch.Generator().manual_seed(args.seed)

    # (a) K1's training launch and K4 on the keyframe budget
    fp = prepare_fused_params(model)
    sp_ops, sp_packed = fp["spatial"], fp["spatial_packed"]
    budget = keyframe_budget(model, config)
    depth_s = model.spatial_depth
    sc = make_droppath_scales(gen, [config.DROP_PATH_RATE[0] * i / (depth_s - 1)
                                    for i in range(depth_s)], budget).to(dev)
    x_kf, g_sp = rand(budget, p, 2), rand(budget, p * cs, scale=1.0)
    dense_frame = depth_s * (2 * p * cs * cs * 4 + 2 * p * cs * 2 * cs * 2)
    attn_frame = depth_s * 4 * p * p * cs
    sp_in = (x_kf.numel() + sc.numel() + sp_packed.numel()) * F32
    case("spatial_stack_train_bf16", "uplift_upsample_tpu/ops/pallas_spatial.py:593",
         "uplift_upsample_torch/csrc/spatial.cu",
         lambda r: [spatial_stack(x_kf, sp_ops, num_heads=heads, packed=sp_packed,
                                  droppath_scales=sc, precision=r)],
         lambda r, d: [spatial_stack_plain(x_kf.to(d), cast(sp_ops, d), num_heads=heads,
                                           droppath_scales=sc.to(d), precision=r)],
         "spatial_stack_bf16", budget * (dense_frame + p * 2 * cs * 2),
         sp_in + budget * p * cs * F32, flops=budget * attn_frame)
    names_sp = sorted(sp_ops)

    def k4(r):
        dparams, dx, ddp = spatial_stack_bwd(x_kf, sp_ops, sc, g_sp, num_heads=heads,
                                             packed=sp_packed, precision=r)
        return [dparams[k] for k in names_sp if k != "bk"] + [dx, ddp]

    def k4_plain(r, d):
        dparams, dx, ddp = spatial_stack_bwd_plain(x_kf.to(d), cast(sp_ops, d), sc.to(d),
                                                   g_sp.to(d), num_heads=heads, precision=r)
        return [dparams[k] for k in names_sp if k != "bk"] + [dx, ddp]

    case("spatial_bwd_bf16", "uplift_upsample_tpu/ops/pallas_spatial_bwd.py:418",
         "uplift_upsample_torch/csrc/spatial_bwd.cu", k4, k4_plain, "spatial_bwd_bf16",
         3 * budget * dense_frame, 2 * sp_in + g_sp.numel() * F32,
         flops=3 * budget * attn_frame, reps=3)
    del x_kf, g_sp, sc, fp
    torch.cuda.empty_cache()

    # K5 over the stack's four blocks and over one (row 14), at 512 windows
    tm = {r: stack_temporal_params(state, model.temporal_depth, precision=r)
          for r in ("default", "high")}
    x = rand(bt, n, c)
    step_ = rng.choice([1, 2, 4], size=(bt, 1))
    km = torch.from_numpy(((np.arange(n)[None] + rng.integers(0, 4, size=(bt, 1))) % step_ != 0)
                          .astype(np.float32)).to(dev)
    cot = rand(bt, n, c, scale=1.0)
    gemm_flops = rows * 2 * c * (3 * c + c + 2 * hid)
    attn_flops = bt * 4 * n * n * c
    src = "uplift_upsample_tpu/ops/pallas_temporal_bwd.py"
    for blocks, suffix, listed in ((model.temporal_depth, "", True), (1, "_one_block", True)):
        ops = {r: {k: v[:blocks] for k, v in tm[r].items()} for r in tm}
        dp = make_droppath_scales(gen, [0.1] * blocks, bt).reshape(blocks, 2, bt).to(dev)
        kw = dict(num_heads=heads, first_masked_blocks=fmb)
        saved = {r: temporal_train_fwd(x, ops[r], km, dp, precision=r, **kw)[1] for r in ops}
        masks = saved_relu_masks(saved["default"])
        w_bytes = sum(ops["default"][k].numel() for k in ORDER) * F32
        in_bytes = (x.numel() + km.numel() + dp.numel()) * F32 + w_bytes
        row14 = blocks == 1
        fwd_name = "temporal_block_fwd_bf16" if row14 else "temporal_train_fwd_bf16"
        bwd_name = "temporal_block_bwd_bf16" if row14 else "temporal_train_bwd_bf16"
        case(fwd_name, f"{src}:263" if row14 else f"{src}:574",
             "uplift_upsample_torch/csrc/temporal_bwd.cu",
             lambda r, o=ops: [temporal_train_fwd(x, o[r], km, dp, precision=r, **kw)[0]],
             lambda r, d, o=ops, dp_=dp: [temporal_stack_plain(
                 x.to(d), cast(o["default"], d), km.to(d), droppath=dp_.to(d), relu_masks=masks,
                 precision=r, train=True, **kw)],
             "temporal_train_fwd", blocks * (gemm_flops + attn_flops),
             in_bytes + x.numel() * F32, phase="test only" if row14 else "train default",
             listed=listed)

        def bwd(r, o=ops, s_=saved, dp_=dp):
            dx, grads, ddp = temporal_train_bwd(s_[r], cot, o[r], km, dp_, precision=r, **kw)
            return [dx, ddp] + no_key_bias(ORDER, [grads[k] for k in ORDER], c)

        def bwd_plain(r, d, o=ops, dp_=dp):
            dx, grads, ddp = temporal_stack_bwd_plain(
                x.to(d), cast(o["default"], d), km.to(d), dp_.to(d), cot.to(d),
                relu_masks=masks, precision=r, **kw)
            return [dx, ddp] + no_key_bias(ORDER, [grads[k] for k in ORDER], c)

        saved_bytes = sum(t.numel() for blk in saved["default"] for t in blk.values()) * F32
        case(bwd_name, f"{src}:300" if row14 else f"{src}:634",
             "uplift_upsample_torch/csrc/temporal_bwd.cu", bwd, bwd_plain, "temporal_train_bwd",
             blocks * (2 * gemm_flops + 2.5 * attn_flops),
             saved_bytes + in_bytes + 2 * cot.numel() * F32 + w_bytes,
             phase="test only" if row14 else "train default", listed=listed, reps=3)
        del saved, ops
        torch.cuda.empty_cache()

    # K5's pieces at the train step's shapes (block 1's weights)
    o1 = {r: {k: v[:1] for k, v in tm[r].items()} for r in tm}
    qkv, dctx = rand(rows, 3 * c, scale=1.0), rand(rows, c, scale=1.0)
    qb, kb, vb = (t.reshape(bt, n, heads, c // heads).transpose(1, 2).to(torch.bfloat16)
                  .detach().requires_grad_(True) for t in qkv.reshape(bt, n, 3 * c).split(c, -1))
    mask_bf = (km * -1e9)[:, None, None, :].to(torch.bfloat16)
    dout = dctx.reshape(bt, n, heads, c // heads).transpose(1, 2).to(torch.bfloat16)

    def sdpa_bwd():
        out = F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask_bf)
        return torch.autograd.grad(out, (qb, kb, vb), dout)

    attn_kw = dict(windows=bt, n=n, num_heads=heads)
    case("window_attention_bwd_bf16", f"{src}:514", "uplift_upsample_torch/csrc/temporal_bwd.cu",
         lambda r: [window_attention_bwd(qkv, dctx, km, precision=r, **attn_kw)],
         lambda r, d: [window_attention_bwd_plain(qkv.to(d), dctx.to(d), km.to(d), precision=r,
                                                  **attn_kw)],
         "window_attention_bwd_bf16", 2.5 * attn_flops,
         (qkv.numel() * 2 + dctx.numel() + km.numel()) * F32, library=sdpa_bwd)
    case("window_attention_train_bf16", f"{src}:420", "uplift_upsample_torch/csrc/attention.cuh",
         lambda r: [window_attention_train(qkv, km, counter="probe", precision=r, **attn_kw)],
         lambda r, d: [window_attention_plain(qkv.reshape(bt, n, 3 * c).to(d), km.to(d), heads,
                                              r, train=True).reshape(rows, c)],
         "window_attention_train_bf16", attn_flops, (qkv.numel() + km.numel() + rows * c) * F32,
         library=lambda: F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask_bf))
    del qkv, dctx, qb, kb, vb, dout
    s2 = make_droppath_scales(gen, [0.1], bt)[1].to(dev)
    h1, g = torch.relu(rand(rows, hid)), rand(rows, c, scale=1.0)
    res = rand(rows, c)
    w2 = o1["default"]["w2"][0]
    sg = g * s2.repeat_interleave(n)[:, None]
    w = {"default": (o1["default"]["w2_bf"][0], o1["default"]["w2_bf_dx"][0]),
         "high": (o1["high"]["w2_tc"][0], o1["high"]["w2_tc_dx"][0])}
    a_bf, w_bf, g_bf = h1.to(torch.bfloat16), w2.to(torch.bfloat16), sg.to(torch.bfloat16)
    mm_bytes = (rows * (hid + 2 * c) + hid * c) * F32
    case("gemm_branch_bf16", f"{src}:446", "uplift_upsample_torch/csrc/gemm_tc.cuh",
         lambda r: list(_branch_gemm(h1, w[r][0], o1[r]["b2"][0], s2, n, res, precision=r)),
         lambda r, d: (lambda z: [res.to(d) + z * s2.to(d).repeat_interleave(n)[:, None], z])(
             mm(h1.to(d), w2.to(d), r) + o1["default"]["b2"][0].to(d)),
         "gemm_branch_bf16", 2 * rows * hid * c, mm_bytes + rows * c * F32,
         library=lambda: torch.matmul(a_bf, w_bf))
    case("gemm_dx_bf16", f"{src}:496", "uplift_upsample_torch/csrc/gemm_tc.cuh",
         lambda r: [gemm_dx(g, s2, n, w[r][1], mask=h1, precision=r)],
         lambda r, d: [torch.where(h1.to(d) > 0, mm(sg.to(d), w2.t().to(d), r), 0.0)],
         "gemm_dx_bf16", 2 * rows * hid * c, mm_bytes,
         library=lambda: torch.matmul(g_bf, w_bf.t()))
    dw_out = torch.empty((hid, c), dtype=f32, device=dev)
    case("gemm_dw_bf16", f"{src}:493", "uplift_upsample_torch/csrc/gemm_tc.cuh",
         lambda r: (gemm_dw(h1, g, s2, n, dw_out, precision=r), [dw_out.clone()])[1],
         lambda r, d: [mm(h1.t().to(d), sg.to(d), r)],
         "gemm_dw_bf16", 2 * rows * hid * c, mm_bytes,
         library=lambda: torch.matmul(a_bf.t(), g_bf))
    del h1, g, res, sg, a_bf, w_bf, g_bf, o1, tm, x, cot
    torch.cuda.empty_cache()

    # K6 (strided block 1 in training) at 512 windows, and its conv's backward
    st = {r: stack_strided_block1_params(state, precision=r) for r in ("default", "high")}
    s0, pads = model.strides[0], tuple(model.paddings[0])
    n_out = output_length(n, s0, pads)
    skw = dict(num_heads=heads, stride=s0, paddings=pads)
    xs = rand(bt, n, c)
    gs = rand(bt, n_out, c, scale=1.0)
    ssaved = {r: strided_train_fwd(xs, st[r], precision=r, **skw)[1] for r in st}
    smask = saved_relu_mask(ssaved["default"])
    st_bytes = sum(st["default"][k].numel() for k in ("pe", "wqkv", "wp", "w1", "wc")) * F32
    blk_flops = rows * 2 * c * (3 * c + c + hid) + attn_flops + bt * n_out * 2 * 3 * hid * c
    bwd_src = "uplift_upsample_tpu/ops/pallas_strided_bwd.py"
    case("strided_train_fwd_bf16", f"{bwd_src}:215", "uplift_upsample_torch/csrc/strided.cu",
         lambda r: [strided_train_fwd(xs, st[r], precision=r, **skw)[0]],
         lambda r, d: [strided_block1_train_plain(xs.to(d), cast(st["default"], d),
                                                  relu_mask=smask, precision=r, **skw)],
         "strided_train_fwd", blk_flops, (xs.numel() + gs.numel()) * F32 + st_bytes,
         phase="train default K6")
    sorder = STRIDED_ORDER

    def sbwd(r):
        dx, grads = strided_train_bwd(ssaved[r], gs, st[r], precision=r, **skw)
        return [dx] + no_key_bias(sorder, [grads[k] for k in sorder], c)

    def sbwd_plain(r, d):
        dx, grads = strided_block1_bwd_plain(xs.to(d), cast(st["default"], d), gs.to(d),
                                             relu_mask=smask, precision=r, **skw)
        return [dx] + no_key_bias(sorder, [grads[k] for k in sorder], c)

    ssaved_bytes = sum(t.numel() for t in ssaved["default"].values()) * F32
    case("strided_train_bwd_bf16", f"{bwd_src}:240", "uplift_upsample_torch/csrc/strided_bwd.cu",
         sbwd, sbwd_plain, "strided_train_bwd", 2 * blk_flops + 1.5 * attn_flops,
         ssaved_bytes + (2 * xs.numel() + gs.numel()) * F32 + 2 * st_bytes,
         phase="train default K6", reps=3)
    h1s = ssaved["default"]["h1"].reshape(bt, n, hid)
    ckw = dict(stride=s0, paddings=pads)
    wc = st["default"]["wc"]
    wc_bf, gsb = wc.to(torch.bfloat16), gs.reshape(-1, c).to(torch.bfloat16)
    taps_bf = conv_taps_plain(h1s, s0, pads).reshape(-1, 3 * hid).to(torch.bfloat16)
    case("strided_dh1_bf16", f"{bwd_src}:266", "uplift_upsample_torch/csrc/strided_bwd.cu",
         lambda r: [conv_dh1(gs, st[r], h1s, precision=r, **ckw)],
         lambda r, d: [conv_dh1_plain(gs.to(d), wc.to(d), h1s.to(d), precision=r, **ckw)],
         "strided_dh1_bf16", 2 * bt * n_out * 3 * hid * c,
         (gs.numel() + 2 * h1s.numel() + wc.numel()) * F32, phase="train default K6",
         library=lambda: torch.matmul(gsb, wc_bf.t()))
    dwc_out = torch.empty_like(wc)
    case("strided_dwc_bf16", f"{bwd_src}:266", "uplift_upsample_torch/csrc/strided_bwd.cu",
         lambda r: [conv_dwc(h1s, gs, dwc_out, precision=r, **ckw).clone()],
         lambda r, d: [conv_dwc_plain(h1s.to(d), gs.to(d), precision=r, **ckw)],
         "strided_dwc_bf16", 2 * bt * n_out * 3 * hid * c,
         (gs.numel() + h1s.numel() + wc.numel()) * F32, phase="train default K6",
         library=lambda: torch.matmul(taps_bf.t(), gsb))
    del st, xs, gs, ssaved, h1s, wc_bf, gsb, taps_bf, model, state
    torch.cuda.empty_cache()
    log(f"phase 12 (a) wall {time.perf_counter() - t_phase:.1f} s")

    # (b) the train step at each rung on the same batches
    t_b = time.perf_counter()
    seqs = train_sequences(np, rng, p)
    feed = FastH36mBatcher(train_generator(np, config, *seqs), batch_size=bt).batches()
    batches, host_ms = [], []
    for _ in range(WARMUP_STEPS + TIMED_STEPS):
        t0 = time.perf_counter()
        batches.append(next(feed))
        host_ms.append(1e3 * (time.perf_counter() - t0))
    host = float(np.mean(host_ms[WARMUP_STEPS:]))
    curves, step_ms_by, runs = {}, {}, {}
    wanted = {"spatial": ("spatial_stack", "spatial_bwd"),
              "temporal": ("gemm_branch", "gemm_dx", "gemm_dw", "window_attention_bwd"),
              "strided": ("strided_dh1", "strided_dwc", "strided_conv")}

    def timed_steps(run, steps, count=False):
        """`steps` steps of one rung's step on the batches; (losses, card ms)."""
        losses, ms = [], []
        for i in range(steps):
            if count and i == WARMUP_STEPS:
                torch.cuda.synchronize()
                cuda_lib.reset_launches()
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            run["state"], loss = run["step"](run["state"], batches[i % len(batches)])
            ev1.record()
            ev1.synchronize()
            losses.append(float(loss))
            ms.append(ev0.elapsed_time(ev1))
        return losses, ms

    labels = [("high", False), ("highest", False), ("mixed", False), ("default", False),
              ("default", True)]
    for rung, k6 in labels:  # round 1: the loss curve (2 + 8 steps) and the launches
        cfg = config.copy()
        cfg.TRAIN_MATMUL_PRECISION, cfg.TRAIN_FUSED_STRIDED = rung, k6
        model = build_uplift_upsample_transformer(cfg, device="cuda", seed=args.seed)
        opt, _, _ = make_optimizer(cfg)
        label = rung + (" K6" if k6 else "")
        run = runs[label] = dict(state=opt.init(model, ema=bool(cfg.EMA_ENABLED)),
                                 step=make_train_step(model, opt, cfg, device="cuda"))
        losses, ms = timed_steps(run, WARMUP_STEPS + TIMED_STEPS, count=True)
        seen = dict(cuda_lib.LAUNCHES)
        counts[f"train {label}"] = seen
        curves[label], step_ms_by[label] = losses, [float(np.mean(ms[WARMUP_STEPS:]))]
        bf16 = {"spatial": rung == "default", "temporal": rung in ("default", "mixed"),
                "strided": rung in ("default", "mixed") and k6}
        launch_ok = all(np.isfinite(losses))
        for stage, names in wanted.items():
            if stage == "strided" and not k6:
                continue
            for name in names:
                on, off = (f"{name}_bf16", f"{name}_f32") if bf16[stage] else (
                    f"{name}_f32", f"{name}_bf16")
                launch_ok = launch_ok and seen.get(on, 0) > 0 and seen.get(off, 0) == 0
        per_step = {k: v / TIMED_STEPS for k, v in sorted(seen.items())
                    if k.endswith(("_bf16", "_f32"))}
        log(f"phase 12 (b) train step {label}: losses {[round(v, 6) for v in losses]}; "
            f"launches per step {per_step} {'ok' if launch_ok else 'FAILED'}")
        if not launch_ok:
            failed.append(f"train_rung_{label.replace(' ', '_')}")
    for _ in range(2):  # rounds 2 and 3, the rungs alternated: the card's time moves
        for label in runs:
            step_ms_by[label].append(float(np.mean(timed_steps(runs[label], TIMED_STEPS)[1])))
    for label, rounds in step_ms_by.items():
        best = min(rounds)
        log(f"phase 12 (b) train step {label}: card ms/step by round "
            f"{[round(v, 3) for v in rounds]}, best {best:.3f} (host batch {host:.3f} ms) = "
            f"{bt / ((best + host) / 1e3):.1f} windows/s")
    runs.clear()
    torch.cuda.empty_cache()
    for label in ("default", "mixed", "default K6"):
        end, high_end = curves[label][-1], curves["high"][-1]
        gap = abs(end - high_end) / abs(high_end)
        ok = gap <= RUNG_LOSS_BAR
        log(f"phase 12 (b) loss curve {label}: ends at {end:.6f} against high {high_end:.6f} "
            f"(relative gap {gap:.3e}, bar {RUNG_LOSS_BAR}) {'ok' if ok else 'FAILED'}; "
            f"best card ms/step {min(step_ms_by[label]):.3f} against high "
            f"{min(step_ms_by['high']):.3f}")
        if not ok:
            failed.append(f"rung_loss_{label.replace(' ', '_')}")
    if curves["high"] != curves["highest"]:
        failed.append("rung_high_highest_differ")
    log(f"phase 12 (b) 'high' and 'highest' the same losses: "
        f"{'yes' if curves['high'] == curves['highest'] else 'NO'}; wall "
        f"{time.perf_counter() - t_b:.1f} s")

    # (c) one epoch of the training CLI at "default" (K6 on), the bench at --train-precision
    t_c = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        p3, p2, _ = write_h36m_npz(np, rng, tmp, subjects=("S1", "S5", "S6", "S7", "S8"))
        cconfig = get_config("h36m_351")  # the class default rung, "default"
        cconfig.update_from(dict(TRAIN_FUSED_STRIDED=True, EPOCHS=1, STEPS_PER_EPOCH=CLI_STEPS,
                                 VALIDATION_EXAMPLES=CLI_VAL, CHECKPOINT_INTERVAL=1,
                                 VALIDATION_INTERVAL=1, SHUFFLE_SEED=args.seed))
        out = io.StringIO()
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        with contextlib.redirect_stdout(out):
            hist, _, _ = train_mod.train_and_validate(
                cconfig, out_dir=os.path.join(tmp, "run"), dataset_name="h36m", h36m_path=p3,
                dataset_2d_path=p2, train_subset="train", val_subset="val", test_subset=None,
                device="cuda", export_h5=False)
        torch.cuda.synchronize()
        seen = dict(cuda_lib.LAUNCHES)
        counts["train_cli default"] = seen
        rung_line = next((ln for ln in out.getvalue().splitlines()
                          if ln.startswith("TRAIN_MATMUL_PRECISION")), "")
        mpjpe = hist.latest_value("MPJPE")
        kinds = ("spatial_bwd_bf16", "gemm_dx_bf16", "strided_dh1_bf16", "spatial_bwd_f32")
        ok = (mpjpe is not None and math.isfinite(mpjpe) and "'default'" in rung_line
              and all(seen.get(k, 0) > 0 for k in ("spatial_bwd_bf16", "gemm_dx_bf16",
                                                   "strided_dh1_bf16"))
              and not any(seen.get(k, 0) for k in ("spatial_bwd_f32", "gemm_dx_f32",
                                                   "strided_dh1_f32")))
        log(f"phase 12 (c) train CLI at the class default rung: 1 epoch x {CLI_STEPS} steps, "
            f"K6 on; {rung_line}; validation MPJPE {mpjpe}; K4/K5/K6 launches "
            f"{ {k: seen.get(k, 0) for k in kinds} } "
            f"{'ok' if ok else 'FAILED'}; wall {time.perf_counter() - t_c:.1f} s")
        if not ok:
            failed.append("train_cli_default_rung")
    rc, lines, wall = run_cli([sys.executable, "-m", "uplift_upsample_torch.bench", "--iters",
                               "8", "--train", "--train-precision", "default"], timeout=300)
    result = next((ln for ln in reversed(lines) if ln.startswith("{")), "")
    summary = next((ln for ln in lines if ln.startswith("# train")), "")
    log(f"phase 12 (c) bench --train --train-precision default: exit {rc} after {wall:.1f} s; "
        f"line: {result}; {summary}")
    if rc != 0 or "provisional" in result or "precision=default" not in summary:
        failed.append("train_rung_bench_cli")
    log(f"phase 12 wall {time.perf_counter() - t_phase:.1f} s ({card_line()})")
    return counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs a card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from uplift_upsample_torch.configs import get_config
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from uplift_upsample_torch.eval import make_test_step
    from uplift_upsample_torch.models import build_uplift_upsample_transformer
    from uplift_upsample_torch.models.bench_forward import prepare_fused_params
    from uplift_upsample_torch.models.uplift_upsample import strided_sequence_lengths
    from uplift_upsample_torch.ops import cuda_lib
    from uplift_upsample_torch.ops.packed_attention import (packed_attention_plain,
                                                            packed_multihead_attention)
    from uplift_upsample_torch.ops.spatial import (make_droppath_scales, spatial_stack,
                                                   spatial_stack_apply, spatial_stack_plain)
    from uplift_upsample_torch.ops.spatial_bwd import (spatial_stack_bwd,
                                                       spatial_stack_bwd_plain)
    from uplift_upsample_torch.ops.strided import (output_length, strided_block1,
                                                   strided_block1_plain, strided_conv,
                                                   strided_conv_plain)
    from uplift_upsample_torch.ops.strided_train import (conv_dh1, conv_dh1_plain, conv_dwc,
                                                         conv_dwc_plain, saved_relu_mask,
                                                         strided_block1_bwd_plain,
                                                         strided_block1_train_plain,
                                                         strided_train_bwd,
                                                         strided_train_fwd)
    from uplift_upsample_torch.ops.temporal import (gemm, layernorm,
                                                    temporal_stack,
                                                    temporal_stack_plain,
                                                    window_attention,
                                                    window_attention_plain)
    from uplift_upsample_torch.ops.temporal_train import (_branch_gemm, gemm_dw, gemm_dx,
                                                          layernorm_bwd, saved_relu_masks,
                                                          temporal_stack_bwd_plain,
                                                          temporal_train_bwd,
                                                          temporal_train_fwd,
                                                          window_attention_bwd,
                                                          window_attention_bwd_plain)
    from uplift_upsample_torch.parallel.train_step import keyframe_budget
    from uplift_upsample_torch.predict import make_predict_step, predict_sequence

    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")

    # ---- phase 1: build ------------------------------------------------------
    starts = [("1", time.perf_counter())]  # (phase, its start): the wall per phase
    t0 = time.perf_counter()
    built = cuda_lib.build(verbose=True)
    log(f"phase 1 build: {len(cuda_lib.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in cuda_lib.SOURCES:
        for kernel, line in ptxas_report(built[f"{name}.log"]):
            log(f"  ptxas {name} {kernel}: {line}")

    # ---- phase 2: each kernel against its plain version ----------------------
    starts.append(("2", time.perf_counter()))
    config = get_config("h36m_351")
    config.MASK_STRIDE = config.MASK_STRIDE[0]
    model = build_uplift_upsample_transformer(config, device="cuda", seed=args.seed)
    fp = prepare_fused_params(model)
    heads = model.num_heads
    rng = np.random.default_rng(args.seed)
    windows = 2 * config.BATCH_SIZE            # flip-TTA doubles the batch
    n, c = config.SEQUENCE_LENGTH, config.TEMPORAL_EMBED_DIM
    hid = int(c * config.MLP_RATIO)
    frames = windows * n
    p, cs = config.NUM_KEYPOINTS, config.SPATIAL_EMBED_DIM
    model_seq_lengths = strided_sequence_lengths(n, model.strides, model.paddings)

    def rand(*shape, scale=0.5):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dev)

    results = {}
    failed = []

    def record(name, source, replaces, check, ms, plain_ms, flops, nbytes,
               library_ms=None, counter=None, phase="predict", listed=True,
               stage="phase 2", f64=None, peak_flops=PEAK_FP32_FLOPS, extra=None,
               tc_flops=0.0, bf16_flops=0.0):
        """One kernel line. `check` is out_check's or grad_check's result;
        `launches` is read later from the `phase` run's count of `counter`.
        `f64` is f64_check's result for the 3xTF32 kernels (both errors go
        into the line); `extra` adds keys to it. The bound counts `flops` at
        `peak_flops` and `tc_flops` (fp32 products run in 3xTF32 on the
        tensor cores) at the TF32 peak."""
        err, tol, ok = check
        b_ms, b_by = bound_ms(flops, nbytes, peak_flops, tc_flops, bf16_flops)
        flops = flops + 3 * tc_flops + bf16_flops  # the operations issued, for the log line
        entry = dict(name=name, route="cuda", source=source, replaces=replaces,
                     launches=0, counter=counter or name, phase=phase, max_abs_err=err,
                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=library_ms, **(extra or {}))
        f64_text = ""
        if f64 is not None:
            entry.update(max_abs_err_f64=f64[0], plain_max_abs_err_f64=f64[1])
            ok = ok and f64[2]
            f64_text = (f"; vs float64 {f64[0]:.3e}, plain {f64[1]:.3e} "
                        f"{'ok' if f64[2] else 'FAILED'}")
        if listed:  # a second geometry of a kernel is checked but not listed
            results[name] = entry
        if not ok:
            failed.append(name)
        lib = "null" if library_ms is None else f"{library_ms:.4f}"
        more = "".join(f" {key} {val:.4g}" for key, val in (extra or {}).items())
        log(f"{stage} {name}: max_abs_err {err:.3e} (limit {tol}) "
            f"{'ok' if ok else 'FAILED'}{f64_text}; ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms {lib}{more} bound_ms {b_ms:.4f} ({b_by}; {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")

    def alias(name, of, replaces, phase):
        """A TPU kernel whose Hopper counterpart is the kernel `of` at the same
        shapes: `of`'s numbers, its own TPU source, its own path's launches."""
        results[name] = dict(results[of], name=name, replaces=replaces, phase=phase)
        log(f"phase 7 {name}: {of} at the same shapes (its phase 2 numbers); "
            f"launches from the path '{phase}'")

    def repeat_identical(name, first, second):
        """The backward kernels, K1 and row 11 sum in a fixed order, without
        float atomics: a second call must give the same bits."""
        flat = lambda r: [t for part in r for t in
                          (part.values() if isinstance(part, dict) else [part])]
        same = all(torch.equal(a, b) for a, b in zip(flat(first), flat(second)))
        log(f"phase 2 {name}: a second call is bit-identical: {'yes' if same else 'NO'}")
        if not same:
            failed.append(f"{name}_not_deterministic")

    # K1: the spatial stack on every frame of a flip-TTA batch
    x_sp = rand(frames, p, 2)
    sp_ops = fp["spatial"]
    sp_fn = lambda: spatial_stack(x_sp, sp_ops, num_heads=heads,
                                  packed=fp["spatial_packed"])
    sp_plain = lambda: spatial_stack_plain(x_sp, sp_ops, num_heads=heads)
    got, ref = sp_fn(), sp_plain()
    sp_ops64 = {key: v.double() for key, v in sp_ops.items()}
    ref64 = spatial_stack_plain(x_sp.double(), sp_ops64, num_heads=heads)
    per_frame = (p * 2 * cs * 2 + model.spatial_depth
                 * (2 * p * cs * cs * 4 + 2 * p * cs * 2 * cs * 2 + 4 * p * p * cs))
    # the dense products (q, k, v, proj, fc1, fc2) run in 3xTF32 on the tensor
    # cores, the attention and the embedding in fp32 on the CUDA cores
    dense_frame = model.spatial_depth * (2 * p * cs * cs * 4 + 2 * p * cs * 2 * cs * 2)
    record("spatial_stack", "uplift_upsample_torch/csrc/spatial.cu",
           "uplift_upsample_tpu/ops/pallas_spatial.py:398", out_check(torch, got, ref),
           time_ms(torch, sp_fn, 10), time_ms(torch, sp_plain, 3),
           frames * (per_frame - dense_frame),
           (x_sp.numel() + got.numel() + fp["spatial_packed"].numel()) * F32,
           f64=f64_check(torch, got, ref, ref64), tc_flops=frames * dense_frame)
    repeat_identical("spatial_stack", (got,), (sp_fn(),))
    del got, ref, ref64

    # K2: the temporal stack, key mask from a mask stride of 10 at random phases
    x_tm = rand(windows, n, c)
    phase = rng.integers(0, 10, size=(windows, 1))
    km = torch.from_numpy(((np.arange(n)[None] + phase) % 10 != 0)
                          .astype(np.float32)).to(dev)
    tm_ops = fp["temporal"]
    fmb = model.first_strided_token_attention_layer
    tm_fn = lambda: temporal_stack(x_tm, tm_ops, km, num_heads=heads,
                                   first_masked_blocks=fmb)
    tm_plain = lambda: temporal_stack_plain(x_tm, tm_ops, km, num_heads=heads,
                                            first_masked_blocks=fmb)
    got, ref = tm_fn(), tm_plain()
    rows = windows * n
    block_flops = rows * 2 * c * (3 * c + c + 2 * hid) + windows * 4 * n * n * c
    record("temporal_stack", "uplift_upsample_torch/csrc/temporal.cu",
           "uplift_upsample_tpu/ops/pallas_temporal_v3.py:343", out_check(torch, got, ref),
           time_ms(torch, tm_fn, 5), time_ms(torch, tm_plain, 3), 0,
           (2 * x_tm.numel() + km.numel()) * F32 + ops_bytes(tm_ops),
           tc_flops=model.temporal_depth * block_flops)
    del got, ref

    # K3: strided block 1 at h36m_351 (0,0) and at the h36m_81 geometry (1,1)
    def strided_case(name, ops, x, stride, pads, listed=True):
        fn = lambda: strided_block1(x, ops, num_heads=heads, stride=stride,
                                    paddings=pads)
        plain = lambda: strided_block1_plain(x, ops, num_heads=heads, stride=stride,
                                             paddings=pads)
        got, ref = fn(), plain()
        b, nn_, _ = x.shape
        n_out = output_length(nn_, stride, pads)
        # every product on the tensor cores: the dense layers, the attention, the conv
        record(name, "uplift_upsample_torch/csrc/strided.cu",
               "uplift_upsample_tpu/ops/pallas_strided.py:231", out_check(torch, got, ref),
               time_ms(torch, fn, 5), time_ms(torch, plain, 3), 0,
               (x.numel() + got.numel()) * F32 + ops_bytes(ops),
               counter="strided_block1", listed=listed,
               tc_flops=(b * nn_ * 2 * c * (3 * c + c + hid) + b * 4 * nn_ * nn_ * c
                         + b * n_out * 2 * 3 * hid * c))

    strided_case("strided_block1", fp["strided"], x_tm, model.strides[0],
                 model.paddings[0])
    config81 = get_config("h36m_81")
    config81.MASK_STRIDE = config81.MASK_STRIDE[0]
    model81 = build_uplift_upsample_transformer(config81, device="cuda", seed=args.seed)
    strided_case("strided_block1_h36m_81", prepare_fused_params(model81)["strided"],
                 rand(2 * config81.BATCH_SIZE, config81.SEQUENCE_LENGTH, c),
                 model81.strides[0], model81.paddings[0], listed=False)
    del model81

    # The conv of strided block 1 alone, K3's and K6's products over the taps
    # matrix T (B·n_out, 3·hidden) that the kernels gather from h1, beside
    # one cuDNN call each (TF32 off, as the package sets it) on operands laid
    # out as cuDNN wants them: the forward against F.conv1d on a transposed
    # h1 plus the residual add; dH1 and dWc against convolution_backward.
    def conv_operands(ops, b_, stride, pads):
        """h1 (relu'd), the block input x, the cuDNN layouts and the residual rows."""
        h1_, x_ = torch.relu(rand(b_, n, hid)), rand(b_, n, c)
        n_out = output_length(n, stride, pads)
        off = 1 if pads[0] == 0 else 0
        lib = dict(h1t=h1_.transpose(1, 2).contiguous(),  # (B, hidden, n)
                   wt=ops["wc"].reshape(3, hid, c).permute(2, 1, 0).contiguous(),  # (C, hid, 3)
                   res=x_[:, off: off + stride * (n_out - 1) + 1: stride])
        return h1_, x_, n_out, lib

    def conv_fwd_record(name, ops, b_, stride, pads, phase_):
        h1_, x_, n_out, lib = conv_operands(ops, b_, stride, pads)
        kw_ = dict(stride=stride, paddings=pads)
        fn = lambda: strided_conv(h1_, x_, ops, counter="probe", **kw_)
        plain = lambda: strided_conv_plain(h1_, x_, ops["wc"], ops["bc"], **kw_)
        lib_fn = lambda: lib["res"] + F.conv1d(lib["h1t"], lib["wt"], ops["bc"], stride=stride,
                                               padding=pads[0]).transpose(1, 2)
        got, ref = fn(), plain()
        ref64 = strided_conv_plain(h1_.double(), x_.double(), ops["wc"].double(),
                                   ops["bc"].double(), **kw_)
        log(f"phase 2 {name}: F.conv1d + add against the plain version: max_abs_err "
            f"{max_err(lib_fn(), ref):.3e}")
        m_ = b_ * n_out
        record(name, "uplift_upsample_torch/csrc/strided.cu",
               "uplift_upsample_tpu/ops/pallas_strided.py:231", out_check(torch, got, ref),
               time_ms(torch, fn, 10), time_ms(torch, plain, 5), 0,
               (h1_.numel() + 2 * m_ * c + 3 * hid * c * 2 + c) * F32,
               library_ms=time_ms(torch, lib_fn, 10), counter="strided_conv_f32",
               phase=phase_, f64=f64_check(torch, got, ref, ref64),
               tc_flops=2 * m_ * 3 * hid * c)

    conv_fwd_record("strided_conv", fp["strided"], windows, model.strides[0],
                    model.paddings[0], "predict")

    # The pieces K2 and K3 are made of, each beside the one PyTorch call that
    # computes the same function (timed here only; the port never calls them).
    # The dense layers run on the tensor cores in 3xTF32 (gemm_tc.cuh): each
    # product at each main-path shape against its plain version, addmm and
    # float64; the bound counts three TF32 products per fp32 one.
    def gemm_record(name, replaces, a_, w_, halves, bias_, relu=False, res=None,
                    alias=False, phase_="predict"):
        """act(a_ @ w_ + bias_) (+ res, written over res with `alias`, as the
        fc2 sublayer does) through gemm_f32; returns the kernel's output."""
        m_, k_ = a_.shape
        n_ = w_.shape[1]
        act = torch.relu if relu else (lambda t: t)
        buf = None if res is None else res.clone()  # timed launches write here
        fn = lambda: gemm(a_, halves, bias_, relu=relu, residual=buf,
                          out=buf if alias else None, counter="probe")
        out_ = None if res is None else res.clone()
        got_ = gemm(a_, halves, bias_, relu=relu, residual=out_,
                    out=out_ if alias else None, counter="probe")
        plain = lambda: act(a_ @ w_ + bias_) + (0 if res is None else res)
        ref_ = plain()
        ref64 = act(a_.double() @ w_.double() + bias_.double())
        if res is not None:
            ref64 = ref64 + res.double()
        record(name, "uplift_upsample_torch/csrc/gemm_tc.cuh", replaces,
               out_check(torch, got_, ref_), time_ms(torch, fn, 10), time_ms(torch, plain, 10),
               0, (a_.numel() + halves.numel() + n_ + m_ * n_ * (1 if res is None else 2)) * F32,
               library_ms=time_ms(torch, lambda: torch.addmm(bias_, a_, w_), 10),
               counter="gemm_f32", phase=phase_, f64=f64_check(torch, got_, ref_, ref64),
               tc_flops=2 * m_ * k_ * n_)
        return got_

    v3 = "uplift_upsample_tpu/ops/pallas_temporal_v3.py"
    y = rand(rows, c)
    qkv = gemm_record("gemm", f"{v3}:174", y, tm_ops["wqkv"][0], tm_ops["wqkv_tc"][0],
                      tm_ops["bqkv"][0])
    gemm_record("gemm_proj", f"{v3}:260", rand(rows, c), tm_ops["wp"][0], tm_ops["wp_tc"][0],
                tm_ops["bp"][0], res=rand(rows, c))
    gemm_record("gemm_fc1", f"{v3}:264", rand(rows, c), tm_ops["w1"][0], tm_ops["w1_tc"][0],
                tm_ops["b1"][0], relu=True)
    gemm_record("gemm_fc2", f"{v3}:270", torch.relu(rand(rows, hid)), tm_ops["w2"][0],
                tm_ops["w2_tc"][0], tm_ops["b2"][0], res=rand(rows, c), alias=True)
    torch.cuda.empty_cache()
    a_fn = lambda: window_attention(qkv, km, windows=windows, n=n, num_heads=heads,
                                    counter="probe")
    got = a_fn()
    a_plain = lambda: window_attention_plain(qkv.reshape(windows, n, 3 * c), km, heads)
    ref = a_plain().reshape(rows, c)
    q, k, v = (t.reshape(windows, n, heads, c // heads).transpose(1, 2)
               for t in qkv.reshape(windows, n, 3 * c).split(c, dim=-1))
    add_mask = (km * -1e9)[:, None, None, :]
    ref64 = window_attention_plain(qkv.reshape(windows, n, 3 * c).double(), km.double(),
                                   heads).reshape(rows, c)
    record("window_attention", "uplift_upsample_torch/csrc/attention.cuh",
           "uplift_upsample_tpu/ops/pallas_temporal_v3.py:248", out_check(torch, got, ref),
           time_ms(torch, a_fn, 10), time_ms(torch, a_plain, 5),
           windows * 4 * n * n * c, (qkv.numel() + km.numel() + got.numel()) * F32,
           library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=add_mask), 10),
           counter="window_attention_f32", f64=f64_check(torch, got, ref, ref64))
    del ref64
    g1, b1 = tm_ops["ln1_g"][0], tm_ops["ln1_b"][0]
    ln_fn = lambda: layernorm(y, g1, b1, 1e-5, counter="probe")
    ln_plain = lambda: F.layer_norm(y, (c,), g1, b1, 1e-5)
    got, ref = ln_fn(), ln_plain()
    record("layernorm", "uplift_upsample_torch/csrc/temporal.cu",
           "uplift_upsample_tpu/ops/pallas_temporal_v3.py:128", out_check(torch, got, ref),
           time_ms(torch, ln_fn, 10), time_ms(torch, ln_plain, 10),
           rows * c * 8, 2 * y.numel() * F32, library_ms=time_ms(torch, ln_plain, 10),
           counter="layernorm_f32")
    del y, qkv, got, ref, q, k, v

    # The eval step's shapes: K1 on the shared step's 2 x 1,536 unique frames
    # (N = 1), and K2 without a key mask (assume_dense at MASK_STRIDE 5).
    u_frames = 2 * (config.BATCH_SIZE + config.EVAL_SHARED_UMAX_EXTRA)
    x_u = rand(u_frames, 1, p, 2)
    su_fn = lambda: spatial_stack_apply(sp_ops, x_u, num_heads=heads,
                                        packed=fp["spatial_packed"])
    su_plain = lambda: spatial_stack_plain(x_u[:, 0], sp_ops, num_heads=heads)
    got, ref = su_fn(), su_plain()
    ref64 = spatial_stack_plain(x_u[:, 0].double(), sp_ops64, num_heads=heads)
    record("spatial_stack_shared", "uplift_upsample_torch/csrc/spatial.cu",
           "uplift_upsample_tpu/ops/pallas_spatial.py:398",
           out_check(torch, got.reshape(ref.shape), ref), time_ms(torch, su_fn, 10),
           time_ms(torch, su_plain, 3), u_frames * (per_frame - dense_frame),
           (x_u.numel() + got.numel() + fp["spatial_packed"].numel()) * F32,
           counter="spatial_stack", phase="eval",
           f64=f64_check(torch, got.reshape(ref.shape), ref, ref64),
           tc_flops=u_frames * dense_frame)
    repeat_identical("spatial_stack_shared", (got,), (su_fn(),))
    del ref64, sp_ops64
    tn_fn = lambda: temporal_stack(x_tm, tm_ops, None, num_heads=heads)
    tn_plain = lambda: temporal_stack_plain(x_tm, tm_ops, None, num_heads=heads)
    got, ref = tn_fn(), tn_plain()
    record("temporal_stack_no_mask", "uplift_upsample_torch/csrc/temporal.cu",
           "uplift_upsample_tpu/ops/pallas_temporal_v3.py:343", out_check(torch, got, ref),
           time_ms(torch, tn_fn, 5), time_ms(torch, tn_plain, 3), 0,
           2 * x_tm.numel() * F32 + ops_bytes(tm_ops), counter="temporal_stack",
           phase="eval", tc_flops=model.temporal_depth * block_flops)
    del x_u, got, ref

    # Row 11, packed attention, at every shape the eval path gives it with
    # --pallas (1,024 windows per call), beside SDPA on the head-split view.
    # Beside the back-to-back time, "graph_ms" is the card's alone: 20 calls in
    # a CUDA graph, on copies of the inputs that keep them out of L2 (at
    # 1,024 x 3 the kernel takes less time than the wrapper's Python).
    for name, f_, s_, c_, masked in (
            ("packed_attention_spatial", frames, p, cs, False),
            ("packed_attention_temporal_mask", windows, n, c, True),
            ("packed_attention_temporal", windows, n, c, False),
            ("packed_attention_strided2", windows, model_seq_lengths[1], c, False),
            ("packed_attention_strided3", windows, model_seq_lengths[2], c, False)):
        qa, ka, va = (rand(f_, s_, c_, scale=1.0) for _ in range(3))
        km_a = km if masked else None
        pa_fn = lambda: packed_multihead_attention(qa, ka, va, km_a, num_heads=heads)
        pa_plain = lambda: packed_attention_plain(qa, ka, va, km_a, num_heads=heads)
        got, ref = pa_fn(), pa_plain()
        repeat_identical(name, [got], [pa_fn()])
        d_a = c_ // heads
        split = lambda t: t.reshape(f_, s_, heads, d_a).transpose(1, 2)
        add_mask = None if km_a is None else (km_a * -1e9)[:, None, None, :]
        f64 = f64_check(torch, got, ref, packed_attention_plain(
            qa.double(), ka.double(), va.double(), km_a, num_heads=heads))
        nbytes = (4 * qa.numel() + (0 if km_a is None else km_a.numel())) * F32
        copies = [(qa, ka, va)] + [(qa.clone(), ka.clone(), va.clone())
                                   for _ in range(l2_copies(nbytes) - 1)]
        cold = [lambda x=x: packed_multihead_attention(*x, km_a, num_heads=heads)
                for x in copies]
        record(name, "uplift_upsample_torch/csrc/attention.cu",
               "uplift_upsample_tpu/ops/pallas_attention.py:75", out_check(torch, got, ref),
               time_ms(torch, pa_fn, 10), time_ms(torch, pa_plain, 3),
               4 * f_ * s_ * s_ * c_, nbytes,
               library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                   split(qa), split(ka), split(va), attn_mask=add_mask), 10),
               counter="packed_attention", phase="eval_pallas", f64=f64,
               extra={"graph_ms": graph_ms(torch, cold)})
        del copies, cold
        del qa, ka, va, got, ref
    torch.cuda.empty_cache()

    # ---- phase 2, training kernels at the train step's shapes ----------------
    tconfig = fp32_train_config(get_config)  # mask strides [5, 10, 20], B=512, droppath
    tmodel = build_uplift_upsample_transformer(tconfig, device="cuda", seed=args.seed)
    tfp = prepare_fused_params(tmodel)
    budget = keyframe_budget(tmodel, tconfig)  # 25,600 of 36,352 frames
    bt, nt = tconfig.BATCH_SIZE, tconfig.SEQUENCE_LENGTH
    gen = torch.Generator().manual_seed(args.seed)
    depth_s = tmodel.spatial_depth
    sp_rates = [tconfig.DROP_PATH_RATE[0] * i / (depth_s - 1) for i in range(depth_s)]
    sp_ops, sp_packed = tfp["spatial"], tfp["spatial_packed"]
    x_kf = rand(budget, p, 2)
    sc = make_droppath_scales(gen, sp_rates, budget).to(dev)
    k1 = lambda: spatial_stack(x_kf, sp_ops, num_heads=heads, packed=sp_packed,
                               droppath_scales=sc)
    k1_plain = lambda: spatial_stack_plain(x_kf, sp_ops, num_heads=heads, droppath_scales=sc)
    got, ref = k1(), k1_plain()
    ref64 = spatial_stack_plain(x_kf.double(), {key: v.double() for key, v in sp_ops.items()},
                                num_heads=heads, droppath_scales=sc.double())
    sp_in = (x_kf.numel() + sc.numel() + sp_packed.numel()) * F32
    record("spatial_stack_droppath", "uplift_upsample_torch/csrc/spatial.cu",
           "uplift_upsample_tpu/ops/pallas_spatial.py:398", out_check(torch, got, ref),
           time_ms(torch, k1, 10), time_ms(torch, k1_plain, 3),
           budget * (per_frame - dense_frame), sp_in + got.numel() * F32,
           counter="spatial_stack", phase="train", f64=f64_check(torch, got, ref, ref64),
           tc_flops=budget * dense_frame)
    repeat_identical("spatial_stack_droppath", (got,), (k1(),))
    del ref64
    g_sp = rand(budget, p * cs, scale=1.0)
    k4 = lambda: spatial_stack_bwd(x_kf, sp_ops, sc, g_sp, num_heads=heads, packed=sp_packed)
    k4_plain = lambda: spatial_stack_bwd_plain(x_kf, sp_ops, sc, g_sp, num_heads=heads)
    (dpk, dxk, ddk), (dpp, dxp, ddpp) = k4(), k4_plain()
    repeat_identical("spatial_bwd", (dpk, dxk, ddk), k4())
    pairs = [(dpk[k], dpp[k], *([dpp["bq"]] if k == "bk" else [])) for k in dpp]
    dp64, dx64, dd64 = spatial_stack_bwd_plain(
        x_kf.double(), {k: v.double() for k, v in sp_ops.items()}, sc.double(),
        g_sp.double(), num_heads=heads)
    # float64 per leaf but the key bias (its true gradient is 0: noise on both sides)
    f64_k4 = f64_check_all(torch, [(dpk[k], dpp[k], dp64[k]) for k in dpp if k != "bk"]
                           + [(dxk, dxp, dx64), (ddk, ddpp, dd64)])
    # the VJP's least work: the forward plus twice its products; the dense
    # products (q, k, v, proj, fc1, fc2) in 3xTF32 on the tensor cores
    record("spatial_bwd", "uplift_upsample_torch/csrc/spatial_bwd.cu",
           "uplift_upsample_tpu/ops/pallas_spatial_bwd.py:418",
           grad_check(torch, pairs + [(dxk, dxp), (ddk, ddpp)]),
           time_ms(torch, k4, 5), time_ms(torch, k4_plain, 3),
           3 * budget * (per_frame - dense_frame),
           2 * sp_in + g_sp.numel() * F32, phase="train", f64=f64_k4,
           tc_flops=3 * budget * dense_frame)
    del got, ref, dpk, dxk, ddk, dpp, dxp, ddpp, pairs, dp64, dx64, dd64
    torch.cuda.empty_cache()

    tm_ops_t = tfp["temporal"]
    fmb_t = tmodel.first_strided_token_attention_layer

    def key_mask(b_, n_):
        """1 - stride mask of mask strides 5/10/20 (1/2/4 frames) at random phases."""
        step_ = rng.choice([1, 2, 4], size=(b_, 1))
        phase_ = rng.integers(0, 4, size=(b_, 1))
        return torch.from_numpy(((np.arange(n_)[None] + phase_) % step_ != 0)
                                .astype(np.float32)).to(dev)

    def temporal_train_case(suffix, x, ops, listed):
        """K5 forward and backward on x (B, S, C) at keep 0.9 with a key mask in
        the first block, against the plain stack and its autograd."""
        kw = dict(num_heads=heads, first_masked_blocks=fmb_t)
        blocks_, (b_, n_, _) = ops["ln1_g"].shape[0], x.shape
        km_ = key_mask(b_, n_)
        dp_ = make_droppath_scales(gen, [0.1] * blocks_, b_).reshape(blocks_, 2, b_).to(dev)
        cot = rand(b_, n_, c, scale=1.0)
        fwd = lambda: temporal_train_fwd(x, ops, km_, dp_, **kw)
        fwd_plain = lambda: temporal_stack_plain(x, ops, km_, droppath=dp_, **kw)
        (out, saved), ref = fwd(), fwd_plain()
        gemm_flops = b_ * n_ * 2 * c * (3 * c + c + 2 * hid)
        attn_flops = b_ * 4 * n_ * n_ * c
        blk_flops = gemm_flops + attn_flops
        io = (x.numel() + km_.numel() + dp_.numel()) * F32 + ops_bytes(ops)
        record("temporal_train_fwd" + suffix, "uplift_upsample_torch/csrc/temporal_bwd.cu",
               "uplift_upsample_tpu/ops/pallas_temporal_bwd.py:613",
               out_check(torch, out, ref), time_ms(torch, fwd, 3),
               time_ms(torch, fwd_plain, 3), 0, io + out.numel() * F32,
               tc_flops=blocks_ * blk_flops,
               counter="temporal_train_fwd", phase="train", listed=listed)
        bwd = lambda: temporal_train_bwd(saved, cot, ops, km_, dp_, **kw)
        # the plain backward takes each relu's kink on the side K5's forward took
        bwd_plain = lambda: temporal_stack_bwd_plain(x, ops, km_, dp_, cot,
                                                     relu_masks=saved_relu_masks(saved), **kw)
        (dxk_, gk, ddk_), (dxp_, gp, ddp_) = bwd(), bwd_plain()
        repeat_identical("temporal_train_bwd" + suffix, (dxk_, gk, ddk_), bwd())
        pairs_ = [(dxk_, dxp_), (ddk_, ddp_)]
        for name_ in gp:
            if name_ == "bqkv":  # the key bias's third has a true gradient of 0
                pairs_ += [(gk[name_][:, c:2 * c], gp[name_][:, c:2 * c], gp[name_][:, :c]),
                           (gk[name_][:, :c], gp[name_][:, :c]),
                           (gk[name_][:, 2 * c:], gp[name_][:, 2 * c:])]
            else:
                pairs_.append((gk[name_], gp[name_]))
        saved_bytes = sum(t.numel() for blk_ in saved for t in blk_.values()) * F32
        grads_bytes = sum(ops[name_].numel() for name_ in gp) * F32
        # dX and dW on the tensor cores; the attention backward on CUDA cores
        record("temporal_train_bwd" + suffix, "uplift_upsample_torch/csrc/temporal_bwd.cu",
               "uplift_upsample_tpu/ops/pallas_temporal_bwd.py:681",
               grad_check(torch, pairs_), time_ms(torch, bwd, 3),
               time_ms(torch, bwd_plain, 2), 2 * blocks_ * attn_flops,
               saved_bytes + (x.numel() + km_.numel() + 2 * cot.numel() + 2 * dp_.numel())
               * F32 + ops_bytes(ops, backward=True) + grads_bytes,
               counter="temporal_train_bwd", phase="train", listed=listed,
               tc_flops=2 * blocks_ * gemm_flops)

    x_t = rand(bt, nt, c)
    temporal_train_case("", x_t, tm_ops_t, True)
    torch.cuda.empty_cache()
    # one block: the TPU's single-block train kernels (fused_temporal_block_fwd/bwd)
    temporal_train_case("_one_block", x_t, {k: v[:1].contiguous() for k, v in tm_ops_t.items()},
                        False)
    torch.cuda.empty_cache()
    config81 = get_config("h36m_81")
    temporal_train_case("_h36m_81", rand(config81.BATCH_SIZE, config81.SEQUENCE_LENGTH, c),
                        tm_ops_t, False)
    torch.cuda.empty_cache()

    # The pieces of K5 beside one PyTorch call each (timed only): its dense
    # layers on the tensor cores at the train step's 36,352 rows. Forward:
    # qkv and fc1 through gemm_f32, proj and fc2 through gemm_branch_f32 (the
    # per-window stochastic-depth scale and the unscaled branch); backward:
    # dX = (s · dY) @ Wᵀ (gemm_dx_f32, fc1's relu mask on dh1) and dW = Xᵀ @ (s
    # · dY) (gemm_dw_f32, split over the rows, summed in a fixed order).
    rows_t = bt * nt
    bwd_src = "uplift_upsample_tpu/ops/pallas_temporal_bwd.py"
    s_t = torch.tensor(np.where(rng.uniform(size=bt) < 0.9, 1 / 0.9, 0.0),
                       dtype=torch.float32, device=dev)  # keep 0.9, per window
    s_rows = s_t.repeat_interleave(nt)[:, None]
    op = lambda name_: (tm_ops_t[name_][0], tm_ops_t[f"{name_}_tc"][0],
                        tm_ops_t[f"{name_}_tc_dx"][0])
    gemm_record("gemm_qkv_train", f"{bwd_src}:420", rand(rows_t, c), *op("wqkv")[:2],
                tm_ops_t["bqkv"][0], phase_="train")
    gemm_record("gemm_fc1_train", f"{bwd_src}:436", rand(rows_t, c), *op("w1")[:2],
                tm_ops_t["b1"][0], relu=True, phase_="train")
    for name_, line, k_, wname, bname in (("proj", 433, c, "wp", "bp"),
                                          ("fc2", 438, hid, "w2", "b2")):
        a_, res_ = rand(rows_t, k_), rand(rows_t, c)
        w_, halves = op(wname)[:2]
        bias_ = tm_ops_t[bname][0]
        br_fn = lambda: _branch_gemm(a_, halves, bias_, s_t, nt, res_)
        br_plain = lambda: (res_ + (a_ @ w_ + bias_) * s_rows, a_ @ w_ + bias_)
        (out_, br_), (ref_out, ref_br) = br_fn(), br_plain()
        checks = [out_check(torch, out_, ref_out), out_check(torch, br_, ref_br)]
        record(f"gemm_branch_{name_}", "uplift_upsample_torch/csrc/gemm_tc.cuh",
               f"{bwd_src}:{line}",
               (max(ch[0] for ch in checks), checks[0][1], all(ch[2] for ch in checks)),
               time_ms(torch, br_fn, 10), time_ms(torch, br_plain, 10), 0,
               (a_.numel() + halves.numel() + c + bt + 3 * res_.numel()) * F32,
               library_ms=time_ms(torch, lambda: torch.addmm(bias_, a_, w_), 10),
               counter="gemm_branch_f32", phase="train",
               f64=f64_check(torch, br_, ref_br, a_.double() @ w_.double() + bias_.double()),
               tc_flops=2 * rows_t * k_ * c)
        del a_, res_, out_, br_, ref_out, ref_br
    # dX per product: (dY's width, the mask's, scaled); dW: X's width
    for name_, line_dx, line_dw, wname, x_w, scaled in (
            ("fc2", 494, 492, "w2", hid, True), ("fc1", 498, 496, "w1", c, False),
            ("proj", 508, 506, "wp", c, True), ("qkv", 524, 522, "wqkv", c, False)):
        w_, _, halves = op(wname)
        n_, k_ = w_.shape  # dX (rows, n_) = dY (rows, k_) @ wᵀ
        dy_ = rand(rows_t, k_, scale=1.0)
        sc_, rs_ = (s_t, s_rows) if scaled else (None, 1.0)
        mask_ = torch.relu(rand(rows_t, n_)) if name_ == "fc2" else None
        keep = 1.0 if mask_ is None else (mask_ > 0).float()
        dx_fn = lambda: gemm_dx(dy_, sc_, nt, halves, mask=mask_)
        dx_plain = lambda: (dy_ * rs_) @ w_.t() * keep
        got, ref = dx_fn(), dx_plain()
        ref64 = (dy_.double() * (rs_.double() if scaled else 1.0)) @ w_.double().t()
        record(f"gemm_dx_{name_}", "uplift_upsample_torch/csrc/gemm_tc.cuh",
               f"{bwd_src}:{line_dx}", grad_check(torch, [(got, ref)]),
               time_ms(torch, dx_fn, 10), time_ms(torch, dx_plain, 10), 0,
               (dy_.numel() + halves.numel() + got.numel() * (1 if mask_ is None else 2)) * F32,
               library_ms=time_ms(torch, lambda: torch.mm(dy_, w_.t()), 10),
               counter="gemm_dx_f32", phase="train",
               f64=f64_check(torch, got, ref, ref64 * (keep.double() if name_ == "fc2" else 1.0)),
               tc_flops=2 * rows_t * k_ * n_)
        # dW = xᵀ @ (s · dY) with the same dY and scale, x (rows, n_)
        x_ = rand(rows_t, x_w)
        dw_out = torch.empty((x_w, k_), device=dev)
        dw_fn = lambda: gemm_dw(x_, dy_, sc_, nt, dw_out)
        dw_plain = lambda: x_.t() @ (dy_ * rs_)
        dw_fn()
        got, ref = dw_out.clone(), dw_plain()
        dw_fn()
        repeat_identical(f"gemm_dw_{name_}", [got], [dw_out])
        ref64 = x_.double().t() @ (dy_.double() * (rs_.double() if scaled else 1.0))
        record("gemm_dw" if name_ == "qkv" else f"gemm_dw_{name_}",
               "uplift_upsample_torch/csrc/gemm_tc.cuh", f"{bwd_src}:{line_dw}",
               grad_check(torch, [(got, ref)]), time_ms(torch, dw_fn, 10),
               time_ms(torch, dw_plain, 10), 0,
               (x_.numel() + dy_.numel() + got.numel() + (bt if scaled else 0)) * F32,
               library_ms=time_ms(torch, lambda: torch.mm(x_.t(), dy_), 10),
               counter="gemm_dw_f32", phase="train", f64=f64_check(torch, got, ref, ref64),
               tc_flops=2 * rows_t * x_w * k_)
        del dy_, mask_, x_, got, ref, ref64
    torch.cuda.empty_cache()
    km_t = key_mask(bt, nt)
    qkv_t, dctx_t = rand(rows_t, 3 * c), rand(rows_t, c, scale=1.0)
    ab_fn = lambda: window_attention_bwd(qkv_t, dctx_t, km_t, windows=bt, n=nt,
                                         num_heads=heads)
    got = ab_fn()
    qkv_req = qkv_t.reshape(bt, nt, 3 * c).clone().requires_grad_(True)
    out_plain = window_attention_plain(qkv_req, km_t, heads)
    ab_plain = lambda: torch.autograd.grad(out_plain, qkv_req, dctx_t.reshape(bt, nt, c),
                                           retain_graph=True)[0]
    ref = ab_plain().reshape(rows_t, 3 * c)
    d_h = c // heads
    q, k, v = (t.reshape(bt, nt, heads, d_h).transpose(1, 2).detach().requires_grad_(True)
               for t in qkv_t.split(c, dim=-1))
    out_lib = F.scaled_dot_product_attention(q, k, v, attn_mask=(km_t * -1e9)[:, None, None, :])
    g_lib = dctx_t.reshape(bt, nt, heads, d_h).transpose(1, 2)
    repeat_identical("window_attention_bwd", [got], [ab_fn()])
    ref64 = window_attention_bwd_plain(qkv_t.double(), dctx_t.double(), km_t.double(),
                                       windows=bt, n=nt, num_heads=heads)
    # four products (dP, dq, dk, dv) of 2·n²·d per head, in 3xTF32
    record("window_attention_bwd", "uplift_upsample_torch/csrc/temporal_bwd.cu",
           "uplift_upsample_tpu/ops/pallas_temporal_bwd.py:514",
           grad_check(torch, [(got, ref)]), time_ms(torch, ab_fn, 10), time_ms(torch, ab_plain, 5),
           0, (qkv_t.numel() + dctx_t.numel() + km_t.numel() + got.numel()) * F32,
           library_ms=time_ms(torch, lambda: torch.autograd.grad(
               out_lib, (q, k, v), g_lib, retain_graph=True), 10),
           counter="window_attention_bwd_f32", phase="train",
           f64=f64_check(torch, got, ref, ref64), tc_flops=bt * 8 * nt * nt * c)
    del ref64
    del qkv_req, out_plain, q, k, v, out_lib
    x_ln, dy_ln = rand(rows_t, c), rand(rows_t, c, scale=1.0)
    g1, b1 = tm_ops_t["ln1_g"][0], tm_ops_t["ln1_b"][0]
    og, ob = torch.empty(c, device=dev), torch.empty(c, device=dev)
    ln_fn = lambda: layernorm_bwd(x_ln, dy_ln, g1, None, og, ob)
    got = [ln_fn(), og.clone(), ob.clone()]
    leaves = [t.detach().clone().requires_grad_(True) for t in (x_ln, g1, b1)]
    out_ln = F.layer_norm(leaves[0], (c,), leaves[1], leaves[2], 1e-5)
    ln_plain = lambda: torch.autograd.grad(out_ln, leaves, dy_ln, retain_graph=True)
    _, ln_mean, ln_rstd = torch.ops.aten.native_layer_norm(x_ln, [c], g1, b1, 1e-5)
    record("layernorm_bwd", "uplift_upsample_torch/csrc/temporal_bwd.cu",
           "uplift_upsample_tpu/ops/pallas_temporal_bwd.py:501",
           grad_check(torch, list(zip(got, ln_plain()))), time_ms(torch, ln_fn, 10),
           time_ms(torch, ln_plain, 10), rows_t * c * 12, 3 * x_ln.numel() * F32,
           library_ms=time_ms(torch, lambda: torch.ops.aten.native_layer_norm_backward(
               dy_ln, x_ln, [c], ln_mean, ln_rstd, g1, b1, [True, True, True]), 10),
           counter="layernorm_bwd_f32", phase="train")
    del qkv_t, dctx_t, x_ln, dy_ln, got, ref, leaves, out_ln, sp_ops, sp_packed
    del x_kf, sc, g_sp
    torch.cuda.empty_cache()

    # K6: strided block 1 in training on the temporal stack's output at the
    # train step's shapes (512 x 71 x 384, s0 = 3), forward and backward.
    st_ops, s0 = tfp["strided"], tmodel.strides[0]
    n_out_t = output_length(nt, s0, (0, 0))
    kw6 = dict(num_heads=heads, stride=s0, paddings=(0, 0))
    cot6 = rand(bt, n_out_t, c, scale=1.0)
    fwd6 = lambda: strided_train_fwd(x_t, st_ops, **kw6)
    fwd6_plain = lambda: strided_block1_train_plain(x_t, st_ops, **kw6)
    (out6, saved6), ref6 = fwd6(), fwd6_plain()
    # every product on the tensor cores but the backward's attention (CUDA cores)
    gemm6 = bt * nt * 2 * c * (3 * c + c + hid)
    attn6, conv6 = bt * 4 * nt * nt * c, bt * n_out_t * 2 * 3 * hid * c
    io6 = x_t.numel() * F32 + ops_bytes(st_ops)
    record("strided_train_fwd", "uplift_upsample_torch/csrc/strided.cu",
           "uplift_upsample_tpu/ops/pallas_strided_bwd.py:222", out_check(torch, out6, ref6),
           time_ms(torch, fwd6, 5), time_ms(torch, fwd6_plain, 3), 0,
           io6 + out6.numel() * F32, counter="strided_train_fwd", phase="train_cli",
           tc_flops=gemm6 + attn6 + conv6)
    bwd6 = lambda: strided_train_bwd(saved6, cot6, st_ops, **kw6)
    # the plain backward takes fc1's relu kink on the side K6's forward took
    bwd6_plain = lambda: strided_block1_bwd_plain(x_t, st_ops, cot6,
                                                  relu_mask=saved_relu_mask(saved6), **kw6)
    (dx6, gk6), (dxp6, gp6) = bwd6(), bwd6_plain()
    repeat_identical("strided_train_bwd", (dx6, gk6), bwd6())
    pairs6 = [(dx6, dxp6)]
    for name_, g_ in gp6.items():
        if name_ == "bqkv":  # the key bias's third has a true gradient of 0
            pairs6 += [(gk6[name_][c:2 * c], g_[c:2 * c], g_[:c]), (gk6[name_][:c], g_[:c]),
                       (gk6[name_][2 * c:], g_[2 * c:])]
        else:
            pairs6.append((gk6[name_], g_))
    saved6_bytes = sum(t.numel() for t in saved6.values()) * F32
    record("strided_train_bwd", "uplift_upsample_torch/csrc/strided_bwd.cu",
           "uplift_upsample_tpu/ops/pallas_strided_bwd.py:266", grad_check(torch, pairs6),
           time_ms(torch, bwd6, 5), time_ms(torch, bwd6_plain, 3), 2 * attn6,
           saved6_bytes + (2 * x_t.numel() + cot6.numel()) * F32
           + ops_bytes(st_ops, backward=True) + sum(g_.numel() for g_ in gp6.values()) * F32,
           counter="strided_train_bwd", phase="train_cli", tc_flops=2 * (gemm6 + conv6))
    del out6, saved6, ref6, dx6, gk6, dxp6, gp6, pairs6, cot6, x_t
    torch.cuda.empty_cache()

    # K6's conv alone at the train step's shapes: the forward, then dH1 (the
    # taps' gradient scattered onto the h1 rows they read, relu-masked) and
    # dWc = Tᵀ·g, each against convolution_backward for its own output (and
    # for the pair, the call the backward would make).
    conv_fwd_record("strided_conv_train", st_ops, bt, s0, (0, 0), "train_cli")
    h1_, _, _, lib = conv_operands(st_ops, bt, s0, (0, 0))
    g_ = rand(bt, n_out_t, c, scale=1.0)
    kw_ = dict(stride=s0, paddings=(0, 0))
    g_t = g_.transpose(1, 2).contiguous()  # (B, C, n_out)
    conv_bwd = lambda mask_: torch.ops.aten.convolution_backward(
        g_t, lib["h1t"], lib["wt"], None, [s0], [0], [1], False, [0], 1, mask_)
    pair_ms = time_ms(torch, lambda: conv_bwd([True, True, False]), 10)
    dh1_fn = lambda: conv_dh1(g_, st_ops, h1_, **kw_)
    dh1_plain = lambda: conv_dh1_plain(g_, st_ops["wc"], h1_, **kw_)
    got, ref = dh1_fn(), dh1_plain()
    repeat_identical("strided_dh1", [got], [dh1_fn()])
    ref64 = conv_dh1_plain(g_.double(), st_ops["wc"].double(), h1_.double(), **kw_)
    m_ = bt * n_out_t
    record("strided_dh1", "uplift_upsample_torch/csrc/strided_bwd.cu",
           "uplift_upsample_tpu/ops/pallas_strided_bwd.py:266", grad_check(torch, [(got, ref)]),
           time_ms(torch, dh1_fn, 10), time_ms(torch, dh1_plain, 5), 0,
           (g_.numel() + 3 * hid * c * 2 + 2 * h1_.numel()) * F32,
           library_ms=time_ms(torch, lambda: conv_bwd([True, False, False]), 10),
           counter="strided_dh1_f32", phase="train_cli", f64=f64_check(torch, got, ref, ref64),
           extra=dict(library_pair_ms=pair_ms), tc_flops=2 * m_ * c * 3 * hid)
    dwc_out = torch.empty((3 * hid, c), device=dev)
    dwc_fn = lambda: conv_dwc(h1_, g_, dwc_out, **kw_)
    dwc_plain = lambda: conv_dwc_plain(h1_, g_, **kw_)
    got, ref = dwc_fn().clone(), dwc_plain()
    repeat_identical("strided_dwc", [got], [dwc_fn()])
    ref64 = conv_dwc_plain(h1_.double(), g_.double(), **kw_)
    record("strided_dwc", "uplift_upsample_torch/csrc/strided_bwd.cu",
           "uplift_upsample_tpu/ops/pallas_strided_bwd.py:266", grad_check(torch, [(got, ref)]),
           time_ms(torch, dwc_fn, 10), time_ms(torch, dwc_plain, 5), 0,
           (h1_.numel() + g_.numel() + got.numel()) * F32,
           library_ms=time_ms(torch, lambda: conv_bwd([False, True, False]), 10),
           counter="strided_dwc_f32", phase="train_cli", f64=f64_check(torch, got, ref, ref64),
           tc_flops=2 * m_ * 3 * hid * c)
    del h1_, g_, g_t, lib, got, ref, ref64, dwc_out, tfp, tmodel, st_ops
    torch.cuda.empty_cache()

    # ---- phase 3: the serving path end to end --------------------------------
    starts.append(("3", time.perf_counter()))
    seqs = []
    for _ in range(SEQUENCES):
        walk = np.cumsum(rng.normal(size=(FRAMES, p, 2)) * 0.01, axis=0)
        seqs.append((walk + rng.normal(size=(1, p, 2)) * 0.3).astype(np.float32))
    total = sum(len(s) for s in seqs)

    step = make_predict_step(model, config, flip_tta=True)
    predict_sequence(model, config, seqs[0][:400], step=step)  # warm the allocator
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    preds = [predict_sequence(model, config, s, step=step) for s in seqs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(cuda_lib.LAUNCHES)

    plain_step = make_test_step(
        model, flip_tta=True, flip_lr_indices=config.AUGM_FLIP_KEYPOINT_ORDER,
        fused="none")
    t1 = time.perf_counter()
    plain_preds = [predict_sequence(model, config, s, step=plain_step) for s in seqs]
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t1
    windows_run = [math.ceil(len(s) / config.SEQUENCE_STRIDE) for s in seqs]
    calls = sum(math.ceil(w / config.BATCH_SIZE) for w in windows_run)
    e2e_err = max(float(np.abs(a - b).max()) for a, b in zip(preds, plain_preds))
    e2e_tol = 2e-4 * max(1.0, max(float(np.abs(b).max()) for b in plain_preds))
    shapes_ok = all(a.shape == (len(s), p, 3) and np.isfinite(a).all()
                    for a, s in zip(preds, seqs))
    log(f"phase 3 predict: {SEQUENCES} sequences x {FRAMES} frames, flip-TTA, "
        f"{sum(windows_run)} computed windows in {calls} calls of "
        f"{2 * config.BATCH_SIZE} windows: kernel path {wall:.3f} s = "
        f"{total / wall:.1f} frames/s, plain model {plain_wall:.3f} s = "
        f"{total / plain_wall:.1f} frames/s; max_abs_err vs plain {e2e_err:.3e} "
        f"(tol {e2e_tol:.3e}); launches {counts}")
    # One step alone (card work and launches of one call, no host windowing
    # or copies), to split the wall time above.
    xb = rand(config.BATCH_SIZE, n, p, 2, scale=0.3)
    smb = torch.ones((config.BATCH_SIZE, n), dtype=torch.bool, device=dev)
    log(f"phase 3 step: one call {time_ms(torch, lambda: step(xb, smb), 5):.3f} ms "
        f"on the kernel path, {time_ms(torch, lambda: plain_step(xb, smb), 3):.3f} ms "
        f"on the plain model; predict wall per call {1e3 * wall / calls:.3f} ms")
    if not shapes_ok:
        failed.append("predict_shapes")
    if e2e_err > e2e_tol:
        failed.append("predict_vs_plain")
    for key in ("spatial_stack", "temporal_stack", "strided_block1", "gemm_f32"):
        if counts.get(key, 0) == 0:
            failed.append(f"no_launch_{key}")
    del model, fp
    torch.cuda.empty_cache()

    # ---- phase 4: the training step end to end -------------------------------
    starts.append(("4", time.perf_counter()))
    train_counts = train_phase(args, torch, np, rng, tconfig, failed)
    fconfig = tconfig.copy()
    fconfig.TRAIN_FUSED_STRIDED = True
    train_phase(args, torch, np, rng, fconfig, failed, label="phase 4 K6")

    # ---- phase 5: the eval protocol end to end -------------------------------
    starts.append(("5", time.perf_counter()))
    data_dir = tempfile.TemporaryDirectory()  # phase 5's data, read again in phase 9
    eval_counts, pallas_counts, eval_data = eval_phase(args, torch, np, rng, failed,
                                                       data_dir.name)

    # ---- phase 6: the training CLI end to end --------------------------------
    starts.append(("6", time.perf_counter()))
    cli_counts = train_cli_phase(args, torch, np, rng, failed)

    # ---- phase 7: the bench routes and the bench CLI -------------------------
    starts.append(("7", time.perf_counter()))
    route_counts = routes_phase(
        args, torch, np, rng, failed,
        lambda *a, **kw: record(*a, stage="phase 7", **kw), alias)
    train_flags_check(args, torch, np, failed)
    bench_cli_phase(failed)

    # ---- phase 8: data parallel ----------------------------------------------
    starts.append(("8", time.perf_counter()))
    dp_phase(args, torch, np, rng, failed)

    # ---- phase 9: the native gather, npz weights, profiling -------------------
    starts.append(("9", time.perf_counter()))
    tools_phase(args, torch, np, rng, failed, eval_data, data_dir.name)

    # ---- phase 10: tensor parallel ------------------------------------------
    starts.append(("10", time.perf_counter()))
    tp_phase(args, torch, np, rng, failed)

    # ---- phase 11: the bf16 eval rung ---------------------------------------
    starts.append(("11", time.perf_counter()))
    bf16_counts = bf16_phase(args, torch, np, rng, failed, record, eval_data)
    data_dir.cleanup()

    # ---- phase 12: the training rungs ----------------------------------------
    starts.append(("12", time.perf_counter()))
    rung_counts = train_rungs_phase(args, torch, np, rng, failed, record)
    counts_by_phase = {"predict": counts, "train": train_counts, "eval": eval_counts,
                       "eval_pallas": pallas_counts, "train_cli": cli_counts,
                       **route_counts, **bf16_counts, **rung_counts}
    for r in results.values():
        r["launches"] = counts_by_phase[r.pop("phase")].get(r.pop("counter"), 0)

    # ---- phase 13: report ----------------------------------------------------
    starts.append(("13", time.perf_counter()))
    log("phase wall times: " + ", ".join(
        f"{name} {t1 - t0_:.1f} s" for (name, t0_), (_, t1) in zip(starts, starts[1:])))
    if failed:
        log(f"FAILED: {failed}")
        return 1
    log(json.dumps({"kernels": list(results.values())}))
    log(f"card: {card_line()}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
