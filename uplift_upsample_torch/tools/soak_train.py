"""A training soak: the real training loop with the process's RSS and the
step times recorded, and a kill → resume continuity check (the JAX
package's `tools/soak_train.py`, in torch).

Runs `train.train_and_validate` on the learnable synthetic Human3.6M pair
(`tools.rung_convergence.learnable_data`) at the config's geometry
(h36m_351, B=512 by default), checkpoints every `--checkpoint-interval`
epochs, and samples the process's resident set from a daemon thread every
`--rss-interval` seconds and as each epoch starts into
`<out_dir>/soak_rss.jsonl` ({"t", "rss_gb", "epoch"} a line; the epoch is
the last the run logged). Step records come
from the run's `scalars.jsonl` (train/loss and train/step_duration per
epoch). The run's log goes to stderr; at the end one JSON line on
stdout: the loss and s/step per epoch, the RSS samples' first, last and
largest, and the final val MPJPE.

`--resume` continues from the last checkpoint in `--out-dir` (after a kill
or a shorter run), to `--epochs`. `--kill-after-epoch E` (below
`--epochs`) makes the run end its process abruptly (`os._exit(3)`, no
clean-up) as epoch E + 1 starts, epoch E's checkpoint, scalars and
history written, as a kill would. A resumed run's line adds `continuity`: the
mean train loss of the last epoch before the resume, of the first after
it and of the run's first epoch; the curve continues when the first
after it lies nearer the last before it than the first epoch's (a run
that restarted from its initial weights would sit near the first
epoch's). Kill after epoch 2 or later for the check to tell them apart.

    python -m uplift_upsample_torch.tools.soak_train [--epochs 60]
        [--steps-per-epoch 2000] [--out-dir DIR] [--resume] [--device cpu]

It runs on the card unless `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import threading
import time


def rss_gb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1e6
    return float("nan")


class RssSampler(threading.Thread):
    """Appends {"t", "rss_gb", "epoch"} to `path` every `interval` seconds."""

    def __init__(self, path: str, interval: float):
        super().__init__(daemon=True)
        self.path, self.interval = path, interval
        self.epoch = 0
        self.t0 = time.time()
        self.samples = []

    def sample(self):
        rec = {"t": time.time() - self.t0, "rss_gb": rss_gb(), "epoch": self.epoch}
        self.samples.append(rec)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def run(self):
        while True:
            self.sample()
            time.sleep(self.interval)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="h36m_351",
                        help="a bundled config name or a JSON file")
    parser.add_argument("--epochs", type=int, default=60)
    parser.add_argument("--steps-per-epoch", type=int, default=2000)
    parser.add_argument("--batch", type=int, default=512)
    parser.add_argument("--validation-interval", type=int, default=5)
    parser.add_argument("--checkpoint-interval", type=int, default=5)
    parser.add_argument("--validation-examples", type=int, default=2048)
    parser.add_argument("--log-every", type=int, default=250)
    parser.add_argument("--action-frames", type=int, default=None,
                        help="frames of each synthetic clip (default: make_learnable_h36m_npz's)")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--out-dir", default=None, help="default: <tmp>/soak_train")
    parser.add_argument("--rss-interval", type=float, default=30.0)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--kill-after-epoch", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from .. import train as train_mod
    from ..configs import resolve_config
    from ..data.keypoint_order import H36MOrder17P
    from ..models.build import resolve_device
    from .rung_convergence import learnable_data, scalars

    device = resolve_device(args.device)
    tmp = tempfile.gettempdir()
    frames = None
    if args.action_frames:
        frames = tuple((name, args.action_frames) for name in
                       ("Walking", "Walking 1", "Photo", "Sitting"))
    data_dir = args.data_dir or os.path.join(
        tmp, "learnable_h36m" + (f"_{args.action_frames}" if frames else ""))
    path_3d, path_2d = learnable_data(data_dir, frames)
    out_dir = args.out_dir or os.path.join(tmp, "soak_train")
    os.makedirs(out_dir, exist_ok=True)
    if not args.resume and os.path.exists(os.path.join(out_dir, "scalars.jsonl")):
        os.remove(os.path.join(out_dir, "scalars.jsonl"))

    config = resolve_config(args.config)
    config.update_from({
        "BATCH_SIZE": args.batch, "EPOCHS": args.epochs,
        "STEPS_PER_EPOCH": args.steps_per_epoch,
        "VALIDATION_INTERVAL": args.validation_interval,
        "CHECKPOINT_INTERVAL": args.checkpoint_interval,
        "VALIDATION_EXAMPLES": args.validation_examples,
        "TRAIN_LOG_EVERY": args.log_every,
    })
    config.AUGM_FLIP_KEYPOINT_ORDER = H36MOrder17P.flip_lr_indices()

    restored = None
    if args.resume:
        from ..train import checkpoint_epochs
        restored = checkpoint_epochs(os.path.join(out_dir, "checkpoints"))[-1]
    sampler = RssSampler(os.path.join(out_dir, "soak_rss.jsonl"), args.rss_interval)
    sampler.start()
    log = train_mod.log

    def watching(*parts):
        """The run's log, read for the epoch it is in and its checkpoints."""
        log(*parts)
        msg = " ".join(map(str, parts))
        if msg.startswith("## EPOCH "):
            sampler.epoch = int(msg.split()[2])
            sampler.sample()
        if (args.kill_after_epoch is not None
                and msg.startswith(f"## EPOCH {args.kill_after_epoch + 1} ")):
            print(f"# killed after epoch {args.kill_after_epoch}", file=sys.stderr,
                  flush=True)
            sys.stdout.flush()
            os._exit(3)

    train_mod.log = watching
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(sys.stderr):  # the run's log
            train_mod.train_and_validate(
                config=config, out_dir=out_dir, dataset_name="h36m", h36m_path=path_3d,
                dataset_2d_path=path_2d, train_subset="train", val_subset="val",
                test_subset=None, continue_training=args.resume, device=device,
                export_h5=False)
    finally:
        train_mod.log = log
    sampler.sample()
    rss = [s["rss_gb"] for s in sampler.samples]
    mpjpe = scalars(out_dir, "val/MPJPE")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    losses = scalars(out_dir, "train/loss")
    line = {"device": name, "batch": args.batch, "wall_s": time.time() - t0,
            "resumed": args.resume, "loss": losses,
            "s_per_step": scalars(out_dir, "train/step_duration"),
            "rss_gb": {"first": rss[0], "last": rss[-1], "max": max(rss),
                       "samples": len(rss)},
            "final_val_mpjpe": mpjpe[-1][1] if mpjpe else None}
    if args.resume:
        line["continuity"] = continuity(losses, restored)
    print(json.dumps(line), flush=True)
    return 0


def continuity(losses, restored: int) -> dict:
    """The curve across a resume from epoch `restored`'s checkpoint."""
    by_epoch = dict(losses)
    first, before, after = by_epoch[1], by_epoch[restored], by_epoch[restored + 1]
    return {"first": first, "before": before, "after": after,
            "continues": abs(after - before) < abs(after - first)}


if __name__ == "__main__":
    sys.exit(main())
