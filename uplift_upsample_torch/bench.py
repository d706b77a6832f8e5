"""Benchmark of the port: uplifted frames/s per card on the h36m_351 eval
protocol, or training windows/s with --train (counterpart of the repository's
`bench.py`, with its flags, protocol masks, metric names and JSON keys).

    python -m uplift_upsample_torch.bench [--config h36m_351] [--batch 2048]
        [--iters 32] [--flip-tta] [--pallas] [--strided-sel] [--mask-stride 10]
        [--no-shared-spatial] [--train [--train-dataset amass]] [--device cuda|cpu]

Eval: the timed workload is `eval.make_test_step(fused="full")` on B
keyframe-centred windows with the protocol's token masks at input stride
s_in (--mask-stride, default the config's first MASK_STRIDE); with the shared
spatial stage (the default, as the eval CLI runs it) the windows are B
consecutive windows of one synthetic stream, deduplicated on the host
(timed, best of 3). Each computed window stands for SEQUENCE_STRIDE uplifted
frames (the window-sparse protocol), so

    uplifted frames/s = computed windows/s x SEQUENCE_STRIDE.

Train: `make_train_step` (forward, backward, AdamW) on one fixed synthetic
batch on the card, h36m (pre-projected 2D) or amass (world-space 3D and a
camera, projected inside the step).

Method: a loop of L = max(2, iters // 4) calls chained through a carried
scalar (eval: the sum of the output, scaled by 1e-20, added to the input;
train: the parameters the steps update in place), timed with the host clock
up to a read of the scalar (which waits for the card), best of 3, for chains
of k = 1 and k = 4 loops; the time per call is the slope, which cancels the
fixed costs of a chain. BENCH_BUDGET_S (default 540, 0 disables) arms a
watchdog that prints the best provisional result as the JSON line before the
budget runs out.

Prints ONE JSON line on stdout; progress and a summary line on stderr.
--precision default runs the eval step on the one-pass bf16 rung (the
kernels' bf16 instances, `precision.py`); --train-precision puts the
training rung (TRAIN_MATMUL_PRECISION: "default", "mixed", "high",
"highest") into the train step's config, as the JAX bench does; --dtype
bfloat16 (COMPUTE_DTYPE: bf16 activations) runs the model at bf16 in the
eval step or, with --train, in the train step (the kernels keep fp32
operands, the tail runs bf16). --eval-wpt, --spatial-block-f,
--train-spatial-attn and --train-wpt are TPU kernel tilings: they are read
and logged, and change nothing.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np

BASELINE_FRAMES_PER_SEC = 50_000.0


class Bench:
    """Progress lines, the provisional result and the budget watchdog of one run."""

    def __init__(self, budget_s: float):
        self.t0 = time.monotonic()
        self.budget = budget_s
        self.stage = "startup"
        self.provisional = None
        self._stop = threading.Event()

    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def progress(self, msg: str) -> None:
        self.stage = msg
        print(f"# [{self.elapsed():6.1f}s] {msg}", file=sys.stderr, flush=True)

    def over_budget(self, margin: float) -> bool:
        return self.budget > 0 and self.elapsed() > self.budget - margin

    def start_watchdog(self) -> None:
        """Emit the best provisional result just before the budget runs out."""
        if self.budget <= 0:
            return

        def watch():
            while not self._stop.wait(min(5.0, max(0.1, self.budget - self.elapsed()))):
                if self.elapsed() < self.budget:
                    continue
                if self.provisional is not None:
                    emit(dict(self.provisional, provisional=True))
                    print(f"# WATCHDOG: budget {self.budget:.0f}s exhausted during stage "
                          f"'{self.stage}'; emitted provisional result",
                          file=sys.stderr, flush=True)
                    os._exit(0)
                print(f"# WATCHDOG: budget {self.budget:.0f}s exhausted during stage "
                      f"'{self.stage}' with no measurement yet", file=sys.stderr, flush=True)
                os._exit(3)

        threading.Thread(target=watch, daemon=True).start()

    def stop(self) -> None:
        self._stop.set()


def emit(result) -> None:
    print(json.dumps(result), flush=True)


def cleanliness_probe(bench: Bench) -> None:
    """Log other python processes and the load: they skew host-clock timings."""
    try:
        out = subprocess.run(["ps", "aux"], capture_output=True, text=True,
                             timeout=10).stdout
        me = str(os.getpid())
        others = [ln for ln in out.splitlines()
                  if "python" in ln and ln.split()[1] != me and "ps aux" not in ln]
        bench.progress(f"cleanliness: {len(others)} other python proc(s), "
                       f"load1={os.getloadavg()[0]:.2f}")
        for ln in others[:8]:
            print(f"#   {ln[:160]}", file=sys.stderr, flush=True)
    except (OSError, subprocess.SubprocessError) as e:
        bench.progress(f"cleanliness probe failed: {e}")


def slope(bench: Bench, chain, per_chain: int, make_result):
    """(seconds per call, method) from chains of k = 1 and k = 4 loops, each
    the best of 3; k = 4 is skipped when the budget would not allow it."""
    def timed(k_calls, reps=3):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            chain(k_calls)
            best = min(best, time.perf_counter() - t0)
            if bench.over_budget(30):
                break
        return best

    chain(1)  # warm-up: the kernels' first launches, the allocator
    bench.progress("warm; timing k=1")
    t1 = timed(1)
    bench.provisional = make_result(t1 / per_chain, "single")
    bench.progress(f"k=1: {t1:.3f}s (~{t1 / per_chain * 1e3:.1f} ms/call upper bound)")
    k2 = 4
    if bench.budget <= 0 or bench.elapsed() + (k2 * t1) * 3.5 < bench.budget - 15:
        t2 = timed(k2)
        return (t2 - t1) / ((k2 - 1) * per_chain), "slope"
    bench.progress("budget tight: skipping the k=4 slope refinement")
    return t1 / per_chain, "single"


def device_name(torch, dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def bench_train(args, bench: Bench, torch, dev):
    """Training-step throughput: forward, backward and AdamW on h36m_351."""
    from .configs import get_config
    from .models import build_uplift_upsample_transformer
    from .parallel import make_optimizer, make_train_step

    config = get_config(args.config)
    config.update_from({
        "BATCH_SIZE": args.batch,
        "OPTIMIZER": "AdamW", "OPTIMIZER_PARAMS": {}, "WEIGHT_DECAY": 4e-6,
        "EMA_ENABLED": False, "SCHEDULE": "ExponentialDecay",
        "SCHEDULE_PARAMS": {"initial_learning_rate": 4e-5, "decay_steps": 6000,
                            "decay_rate": 0.99, "staircase": True},
        "TRAIN_FUSED_SPATIAL": args.train_fused,
        "TRAIN_FUSED_TEMPORAL": args.train_fused_temporal,
        "TRAIN_MATMUL_PRECISION": args.train_precision,
        # bfloat16: the kernels on fp32 operands, the tail at bf16 (train_step.py)
        "COMPUTE_DTYPE": args.dtype,
    })
    bench.progress("building model + optimizer state")
    model = build_uplift_upsample_transformer(config, device=dev, seed=0)
    opt, _, _ = make_optimizer(config)
    state = opt.init(model, ema=False)
    step = make_train_step(model, opt, config, dataset_name=args.train_dataset, device=dev)

    b, n, k = args.batch, config.SEQUENCE_LENGTH, config.NUM_KEYPOINTS
    ms = config.MASK_STRIDE
    ms0 = (ms[0] if isinstance(ms, (list, tuple)) else ms) or 1
    rng = np.random.default_rng(0)
    stride_mask = (np.arange(n) % ms0 == 0)[None].repeat(b, 0)
    if args.train_dataset == "amass":
        # world-space 3D + an 18-vector camera (quat|trans|intrinsics); the
        # world→camera transform and the distorted projection run in the step
        cam18 = np.zeros((b, 18), np.float32)
        cam18[:, 0] = 1.0                      # identity quaternion
        cam18[:, 9:11] = 2.3                   # fx, fy (normalized units)
        cam18[:, 7:9] = 1000.0                 # res_w, res_h
        world = rng.normal(size=(b, n, k, 3)).astype(np.float32) * 0.3
        world[..., 2] += 4.0                   # in front of the camera
        batch = (world, cam18, stride_mask)
    else:
        batch = (rng.normal(size=(b, n, k, 3)).astype(np.float32) * 0.1,
                 rng.normal(size=(b, n, k, 2)).astype(np.float32) * 0.1, stride_mask)
    batch = tuple(torch.from_numpy(a).to(dev) for a in batch)  # on the card once
    L = max(2, args.iters // 4)

    def chain(k_calls):
        """k·L steps; the parameters carry from step to step (updated in place)."""
        nonlocal state
        loss = None
        for _ in range(k_calls * L):
            state, loss = step(state, batch)
        return float(loss)

    suffix = "" if args.train_dataset == "h36m" else f"_{args.train_dataset}"
    n_protocol = (n - 1) * config.SEQUENCE_STRIDE + 1

    def make_result(per_step, method):
        wps = args.batch / per_step
        return {
            "metric": f"train_windows_per_sec_per_chip_n{n_protocol}{suffix}",
            "value": round(wps, 1),
            "unit": "windows/s",
            "vs_baseline": round(wps / 5000.0, 3),
            "ms_per_step": round(per_step * 1e3, 2),
            "method": method,
        }

    bench.progress(f"train loop (L={L})")
    per_step, method = slope(bench, chain, L, make_result)
    result = make_result(per_step, method)
    result["elapsed_s"] = round(bench.elapsed(), 1)
    emit(result)
    print(f"# train device={device_name(torch, dev)} batch={args.batch} "
          f"dataset={args.train_dataset} ms/step={per_step * 1e3:.1f} "
          f"fused={args.train_fused} fused_temporal={args.train_fused_temporal} "
          f"precision={args.train_precision}", file=sys.stderr)


def bench_eval(args, bench: Bench, torch, dev):
    """Eval-protocol throughput of the test step on keyframe-centred windows."""
    from .configs import get_config
    from .data.keypoint_order import H36MOrder17P
    from .eval import make_test_step
    from .models import build_uplift_upsample_transformer
    from .utils.dedup import dedup_rows

    bench.progress("building model")
    config = get_config(args.config)
    config.update_from({"COMPUTE_DTYPE": args.dtype, "USE_PALLAS_ATTENTION": args.pallas})
    model = build_uplift_upsample_transformer(config, device=dev, seed=0)

    # Protocol token masks of the benched windows at input stride s_in: global
    # alignment marks tokens whose global frame 5·(r + t - mid) ≡ 0 (mod s_in).
    # At s_in = 5 every token is real (assume_dense); at 10/20 the windows are
    # token-sparse and, without the shared stage, max_keyframes engages.
    n_frames, mid = config.SEQUENCE_LENGTH, config.SEQUENCE_LENGTH // 2
    seq_stride = config.SEQUENCE_STRIDE
    ms = config.MASK_STRIDE
    s_in = args.mask_stride
    if s_in is None:
        s_in = (ms[0] if isinstance(ms, (list, tuple)) else ms) or seq_stride
    period = s_in // math.gcd(seq_stride, s_in)
    t_off = seq_stride * (np.arange(n_frames) - mid)
    sm_np = np.stack([((seq_stride * r + t_off) % s_in) == 0 for r in range(args.batch)])
    max_kf = (-(-n_frames // period)) if period > 1 else None
    use_shared = args.shared_spatial and args.fused_spatial
    test_step = make_test_step(
        model, flip_tta=args.flip_tta, flip_lr_indices=H36MOrder17P.flip_lr_indices(),
        fused="full" if args.fused_spatial else "none", precision=args.precision,
        max_keyframes=None if use_shared else max_kf, assume_dense_mask=period == 1,
        shared_spatial=use_shared, tta_batched=args.tta_batched,
        temporal_wpt=args.eval_wpt, strided_sel=args.strided_sel)

    rng = np.random.default_rng(0)
    host_dedup_s, n_unique = 0.0, 0
    if use_shared:
        # B consecutive keyframe-centred windows of one sequence: window r
        # token t sits at global frame 5·(r + t - mid), so windows overlap in
        # N - 1 frames and the dedup (as the eval loop's flush runs it) gives
        # ~B + N - 1 unique frames (+1 zero row at s_in > 5).
        bench.progress("host dedup prep")
        stream = rng.normal(size=(args.batch + n_frames - 1, config.NUM_KEYPOINTS,
                                  2)).astype(np.float32) * 0.3
        win_idx_full = np.arange(args.batch)[:, None] + np.arange(n_frames)
        xm_np = stream[win_idx_full] * sm_np[:, :, None, None]
        host_dedup_s = float("inf")  # steady state: best of 3
        for _ in range(3):
            t0 = time.perf_counter()
            uniq, inv = dedup_rows(xm_np.reshape(args.batch * n_frames, -1))
            host_dedup_s = min(host_dedup_s, time.perf_counter() - t0)
        n_unique = len(uniq)
        u_max = -(-min(args.batch * n_frames, args.batch + 1024) // 8) * 8
        if n_unique > u_max:
            raise RuntimeError(f"{n_unique} unique frames exceed the capacity {u_max}")
        uq_np = np.zeros((u_max, config.NUM_KEYPOINTS, 2), np.float32)
        uq_np[:n_unique] = uniq.reshape(-1, config.NUM_KEYPOINTS, 2)
        x = torch.from_numpy(uq_np).to(dev)
        idx = torch.from_numpy(inv.reshape(args.batch, n_frames).astype(np.int64)).to(dev)

        def forward(xc, sm):
            return test_step(xc, idx, sm)[1]
    else:
        x = torch.from_numpy(rng.normal(size=(args.batch, n_frames, config.NUM_KEYPOINTS,
                                              2)).astype(np.float32) * 0.3).to(dev)

        def forward(xc, sm):
            return test_step(xc, sm)[1]
    sm = torch.from_numpy(sm_np).to(dev)
    L = max(2, args.iters // 4)

    def chain(k_calls):
        """k·L forwards, each input shifted by the previous output's scaled sum."""
        c = torch.zeros((), dtype=x.dtype, device=dev)
        for _ in range(k_calls * L):
            c = forward(x + c, sm).sum() * 1e-20
        return float(c)

    factor = 1 if args.per_window else seq_stride
    baseline = BASELINE_FRAMES_PER_SEC / (seq_stride if args.per_window else 1)
    n_protocol = (n_frames - 1) * seq_stride + 1

    def make_result(per_forward, method):
        windows_per_sec = args.batch / per_forward
        value = windows_per_sec * factor
        return {
            "metric": (f"computed_windows_per_sec_per_chip_n{n_protocol}"
                       if args.per_window
                       else f"uplifted_frames_per_sec_per_chip_n{n_protocol}"),
            "value": round(value, 1),
            "unit": "windows/s" if args.per_window else "frames/s",
            "vs_baseline": round(value / baseline, 3),
            "windows_per_sec": round(windows_per_sec, 1),
            "frames_per_window": seq_stride,
            "precision_rung": args.precision,
            "s_in": s_in,
            "shared_spatial": use_shared,
            "method": method,
        }

    bench.progress(f"eval loop (L={L})")
    per_forward, method = slope(bench, chain, L, make_result)
    result = make_result(per_forward, method)
    result["elapsed_s"] = round(bench.elapsed(), 1)
    emit(result)
    shared_note = ""
    if use_shared:
        # the host dedup has to keep up with the card for the number to hold
        # end to end; both rates are printed
        shared_note = (f" shared_spatial=True unique_frames={n_unique} "
                       f"host_dedup_ms={host_dedup_s * 1e3:.1f} "
                       f"host_dedup_windows_per_s={args.batch / max(host_dedup_s, 1e-9):.0f}")
    print(f"# device={device_name(torch, dev)} batch={args.batch} iters={args.iters} "
          f"dtype={args.dtype} flip_tta={args.flip_tta} tta_batched={args.tta_batched} "
          f"fused={'full' if args.fused_spatial else 'none'} precision={args.precision} "
          f"strided_sel={args.strided_sel} s_in={s_in} "
          f"windows_per_s={args.batch / per_forward:.1f} frames_per_window={factor} "
          f"elapsed={bench.elapsed():.3f}s{shared_note}", file=sys.stderr)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="h36m_351",
                        help="bundled config to bench (h36m_351 or h36m_81)")
    parser.add_argument("--batch", type=int, default=None,
                        help="batch size (default: 2048 eval / 512 train)")
    parser.add_argument("--iters", type=int, default=32)
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                        help="COMPUTE_DTYPE of the model, in the eval step or with "
                             "--train in the train step (bf16 activations)")
    parser.add_argument("--flip-tta", action="store_true")
    parser.add_argument("--pallas", action="store_true",
                        help="USE_PALLAS_ATTENTION: the packed attention kernel in the "
                             "model's attention layers")
    parser.add_argument("--no-fused-spatial", dest="fused_spatial", action="store_false",
                        help="the plain model instead of the kernel path")
    parser.add_argument("--precision", default="high",
                        choices=["default", "high", "highest"],
                        help="matmul precision rung: 'high' and 'highest' both run "
                             "fp32-level products; 'default' the one-pass bf16 rung")
    parser.add_argument("--train", action="store_true",
                        help="measure the training step (forward, backward, AdamW) "
                             "instead of the eval forward")
    parser.add_argument("--no-train-fused", dest="train_fused", action="store_false",
                        help="with --train: TRAIN_FUSED_SPATIAL off (and with it the "
                             "temporal and strided kernels)")
    parser.add_argument("--no-train-fused-temporal", dest="train_fused_temporal",
                        action="store_false",
                        help="with --train: TRAIN_FUSED_TEMPORAL off")
    parser.add_argument("--train-dataset", default="h36m", choices=["h36m", "amass"],
                        help="with --train: h36m (pre-projected 2D) or amass "
                             "(world-space 3D + camera projection in the step)")
    parser.add_argument("--spatial-block-f", type=int, default=None,
                        help="a TPU kernel tiling: logged, not used")
    parser.add_argument("--train-spatial-attn", default=None, choices=["fma", "hpack"],
                        help="a TPU kernel tiling: logged, not used")
    parser.add_argument("--train-wpt", type=int, default=8,
                        help="a TPU kernel tiling: logged, not used")
    parser.add_argument("--train-precision", default="default",
                        choices=["mixed", "default", "high", "highest"],
                        help="with --train: TRAIN_MATMUL_PRECISION, the training rung "
                             "(precision.train_rungs)")
    parser.add_argument("--eval-wpt", default=None,
                        help="EVAL_TEMPORAL_WPT, a TPU kernel tiling: resolved and "
                             "logged, changes no launch")
    parser.add_argument("--mask-stride", type=int, default=None,
                        help="protocol input stride s_in of the benched windows "
                             "(default: the config's first MASK_STRIDE)")
    parser.add_argument("--no-shared-spatial", dest="shared_spatial", action="store_false",
                        help="without the cross-window shared spatial stage")
    parser.add_argument("--tta-2call", dest="tta_batched", action="store_false",
                        help="with --flip-tta: the flipped pass as a second forward")
    parser.add_argument("--strided-sel", dest="strided_sel", action="store_true",
                        help="the route of the TPU's in-kernel strided-block-1 "
                             "selection (the same K3 launches on the card)")
    parser.add_argument("--per-window", action="store_true",
                        help="report computed windows/s instead of uplifted frames/s")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.set_defaults(fused_spatial=True, shared_spatial=True, train_fused=True,
                        train_fused_temporal=True, tta_batched=True, strided_sel=False)
    args = parser.parse_args(argv)
    if args.batch is None:
        args.batch = 512 if args.train else 2048
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    import torch

    from .precision import check_rung
    from .models.build import resolve_device

    check_rung(args.precision)
    dev = resolve_device(args.device)
    bench = Bench(float(os.environ.get("BENCH_BUDGET_S", "540")))
    bench.start_watchdog()
    try:
        cleanliness_probe(bench)
        bench.progress(f"device {device_name(torch, dev)}; budget={bench.budget:.0f}s")
        print(f"# read, not used by the port: --eval-wpt={args.eval_wpt} "
              f"--spatial-block-f={args.spatial_block_f} "
              f"--train-spatial-attn={args.train_spatial_attn} "
              f"--train-wpt={args.train_wpt} (TPU kernel tilings)",
              file=sys.stderr, flush=True)
        if args.train:
            bench_train(args, bench, torch, dev)
        else:
            bench_eval(args, bench, torch, dev)
    finally:
        bench.stop()


if __name__ == "__main__":
    main()
