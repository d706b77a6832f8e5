"""TRAIN_MATMUL_PRECISION rung convergence on learnable synthetic data (the
JAX package's `tools/rung_convergence.py`, in torch).

The training kernels and the plain products run at the rung the config
names (`precision.train_rungs`): "default" (one bf16 pass everywhere, the
class default), "mixed" (the spatial kernels at "highest") and "high"
(fp32-level). The gradient tests hold one step per rung; whether the bf16
rungs converge as "high" does over thousands of steps is measured here:

  1. a LEARNABLE synthetic Human3.6M pair (`utils.testing.
     make_learnable_h36m_npz`: smooth 3D world motion, 2D its distorted
     projection through the calibrated cameras), written once into
     `--data-dir`;
  2. the config (h36m_351 by default, its widths unchanged) trained once
     per rung through `train.train_and_validate`, each with the same
     SHUFFLE_SEED: the same data order, initial weights and random draws;
  3. per rung one JSON line on stdout (the run's log goes to stderr): the
     mean train loss per epoch, the val MPJPE per validation, seconds per
     step, the wall time; then one summary line with each rung's final val
     MPJPE and its delta against the first rung, and whether every delta
     meets the bar (within 2 %).

    python -m uplift_upsample_torch.tools.rung_convergence \\
        [--rungs default,mixed,high] [--epochs 10] [--steps-per-epoch 500] \\
        [--batch 512] [--device cpu] [--config h36m_351]

It runs on the card unless `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

BAR_PCT = 2.0


def learnable_data(data_dir: str, action_frames=None):
    """(3D npz, 2D npz) of the learnable synthetic pair in `data_dir`, made
    once (`action_frames` scales the clips; None: make_learnable_h36m_npz's defaults)."""
    from ..utils.testing import make_learnable_h36m_npz

    os.makedirs(data_dir, exist_ok=True)
    path_3d = os.path.join(data_dir, "data_3d_h36m.npz")
    path_2d = os.path.join(data_dir, "data_2d_h36m_synth.npz")
    if not (os.path.exists(path_3d) and os.path.exists(path_2d)):
        kwargs = {} if action_frames is None else dict(action_frames=action_frames)
        make_learnable_h36m_npz(path_3d, path_2d, **kwargs)
    return path_3d, path_2d


def scalars(out_dir: str, tag: str):
    """[(step, value)] of one tag in a run's scalars.jsonl."""
    with open(os.path.join(out_dir, "scalars.jsonl")) as f:
        return [(r["step"], r["value"]) for r in map(json.loads, f) if r["tag"] == tag]


def train_config(args, rung: str):
    from ..configs import resolve_config
    from ..data.keypoint_order import H36MOrder17P

    config = resolve_config(args.config)
    config.update_from({
        "BATCH_SIZE": args.batch, "EPOCHS": args.epochs,
        "STEPS_PER_EPOCH": args.steps_per_epoch,
        "VALIDATION_INTERVAL": args.validation_interval, "CHECKPOINT_INTERVAL": 10_000,
        "VALIDATION_EXAMPLES": args.validation_examples,
        "TRAIN_MATMUL_PRECISION": rung,
        # one loss fetch an epoch: each syncs the card
        "TRAIN_LOG_EVERY": args.steps_per_epoch,
    })
    config.AUGM_FLIP_KEYPOINT_ORDER = H36MOrder17P.flip_lr_indices()
    return config


def summary(results: dict) -> dict:
    """Final loss and val MPJPE per rung, each rung's MPJPE delta (%)
    against the first rung, and whether all are within the bar."""
    rungs = list(results)
    final = {r: {"final_loss": v["loss"][-1][1] if v["loss"] else None,
                 "final_mpjpe": v["val_mpjpe"][-1][1] if v["val_mpjpe"] else None}
             for r, v in results.items()}
    base = final[rungs[0]]["final_mpjpe"]
    deltas = {}
    for r in rungs[1:]:
        got = final[r]["final_mpjpe"]
        deltas[r] = None if base is None or got is None else 100.0 * (got / base - 1.0)
    ok = bool(deltas) and all(d is not None and abs(d) <= BAR_PCT for d in deltas.values())
    return {"summary": final, "base": rungs[0], "mpjpe_delta_pct": deltas,
            "bar_pct": BAR_PCT, "within_bar": ok}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rungs", default="default,mixed,high")
    parser.add_argument("--config", default="h36m_351",
                        help="a bundled config name or a JSON file")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--steps-per-epoch", type=int, default=500)
    parser.add_argument("--batch", type=int, default=512)
    parser.add_argument("--validation-interval", type=int, default=2)
    parser.add_argument("--validation-examples", type=int, default=2048)
    parser.add_argument("--action-frames", type=int, default=None,
                        help="frames of each synthetic clip (default: make_learnable_h36m_npz's)")
    parser.add_argument("--data-dir", default=None,
                        help="default: <tmp>/learnable_h36m[_<frames>]")
    parser.add_argument("--out-base", default=None, help="default: <tmp>/rung_convergence")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from ..models.build import resolve_device
    from ..train import train_and_validate

    device = resolve_device(args.device)
    tmp = tempfile.gettempdir()
    frames = None
    if args.action_frames:
        frames = tuple((name, args.action_frames) for name in
                       ("Walking", "Walking 1", "Photo", "Sitting"))
    data_dir = args.data_dir or os.path.join(
        tmp, "learnable_h36m" + (f"_{args.action_frames}" if frames else ""))
    path_3d, path_2d = learnable_data(data_dir, frames)
    out_base = args.out_base or os.path.join(tmp, "rung_convergence")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    results = {}
    for rung in (r.strip() for r in args.rungs.split(",")):
        out_dir = os.path.join(out_base, rung)
        if os.path.exists(os.path.join(out_dir, "scalars.jsonl")):
            os.remove(os.path.join(out_dir, "scalars.jsonl"))  # a fresh curve
        config = train_config(args, rung)
        print(f"# rung {rung} -> {out_dir}", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # the run's log
            train_and_validate(config=config, out_dir=out_dir, dataset_name="h36m",
                               h36m_path=path_3d, dataset_2d_path=path_2d,
                               train_subset="train", val_subset="val", test_subset=None,
                               device=device, export_h5=False)
        results[rung] = {"loss": scalars(out_dir, "train/loss"),
                         "val_mpjpe": scalars(out_dir, "val/MPJPE"),
                         "s_per_step": [v for _, v in scalars(out_dir, "train/step_duration")],
                         "wall_s": time.perf_counter() - t0}
        print(json.dumps({"rung": rung, "device": name, **results[rung]}), flush=True)
    print(json.dumps({"device": name, "batch": args.batch, "epochs": args.epochs,
                      "steps_per_epoch": args.steps_per_epoch, **summary(results)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
