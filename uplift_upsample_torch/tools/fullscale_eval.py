"""Full-scale dress rehearsal of the real-data eval on the card (counterpart of
`tools/fullscale_eval.py`).

Generates a synthetic Human3.6M at the true dataset volume: all 7 subjects,
the 15 canonical actions x 2 variants each (S11 missing "Directions", the
real corrupted-video gap), frame counts drawn to land S9+S11 at ~545 k mocap
frames (x 4 cameras ~= 2.18 M eval samples, the published protocol's test
volume), with the JAX tool's seed and draw order, so the data are the same.
Weights: a seeded h36m_351 model written as npz (the card's machine has no
h5py). `--run` then runs the eval CLI's 3-stride sweep in a subprocess, as
the real run would, and records its wall time, the child's peak RSS and,
per stride, the eval samples, the run's wall time, the protocol frames/s
and the wall attribution from the CLI's own output. `--card-busy` then runs
one stride (MASK_STRIDE 10) in this process under `utils.profiling.trace`
and prints the card's busy share of it.

    python -m uplift_upsample_torch.tools.fullscale_eval --make-data --run --card-busy
    python -m uplift_upsample_torch.tools.fullscale_eval --run -- --forced_mask_stride 5

The data (~1.7 GB of npz) go to $FULLSCALE_DIR (default: fullscale_h36m in
the temporary directory). Arguments after `--` go to the eval CLI.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATA_DIR = os.environ.get("FULLSCALE_DIR", os.path.join(tempfile.gettempdir(),
                                                        "fullscale_h36m"))
ACTIONS_15 = ["Directions", "Discussion", "Eating", "Greeting", "Phoning",
              "Photo", "Posing", "Purchases", "Sitting", "SittingDown",
              "Smoking", "Waiting", "WalkDog", "Walking", "WalkTogether"]
SUBJECTS = ("S1", "S5", "S6", "S7", "S8", "S9", "S11")


def paths(data_dir: str = DATA_DIR):
    """(3D npz, 2D npz, weights npz) under `data_dir`."""
    return (os.path.join(data_dir, "data_3d_h36m_fullscale.npz"),
            os.path.join(data_dir, "data_2d_h36m_fullscale.npz"),
            os.path.join(data_dir, "fullscale_weights.npz"))


def make_data(seed=20260819, frames=(6_000, 12_500), data_dir: str = DATA_DIR):
    """Write the dataset pair and the weights. `frames`: the range each
    sequence's length is drawn from (the real volume's; a test cuts it)."""
    path_3d, path_2d, path_w = paths(data_dir)
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    positions_3d, positions_2d = {}, {}
    total, test_total = 0, 0
    for subject in SUBJECTS:
        positions_3d[subject] = {}
        positions_2d[subject] = {}
        for action in ACTIONS_15:
            if subject == "S11" and action == "Directions":
                continue  # the real corrupted-video gap
            for variant in (action, f"{action} 1"):
                # Real S9+S11 total ~545k mocap frames over 59 sequences
                # (~9.2k mean); spread 6k-12.5k like the real length mix.
                t = int(rng.integers(*frames))
                pose = (rng.normal(size=(t, 32, 3)) * 0.2).astype(np.float32)
                pose[..., 2] += 1.0
                positions_3d[subject][variant] = pose
                extra = int(rng.integers(0, 3))
                cams = [rng.uniform(100, 900, size=(t + extra, 17, 2)
                                    ).astype(np.float32) for _ in range(4)]
                positions_2d[subject][variant] = cams
                total += t
                if subject in ("S9", "S11"):
                    test_total += t
    t0 = time.perf_counter()
    np.savez(path_3d, positions_3d=positions_3d)
    np.savez(path_2d, positions_2d=positions_2d)
    print(f"wrote {path_3d} + {path_2d} in {time.perf_counter() - t0:.1f}s: "
          f"{total:,} mocap frames total, S9+S11 {test_total:,} "
          f"(x4 cams = {4 * test_total:,} eval samples)", flush=True)

    # Seeded flagship weights in the convert_weights npz layout
    from ..configs import get_config
    from ..models import build_uplift_upsample_transformer
    from ..utils.weights_npz import save_npz
    model = build_uplift_upsample_transformer(get_config("h36m_351"), device="cpu", seed=0)
    save_npz(path_w, None, model)
    print(f"wrote {path_w}", flush=True)
    return test_total


_STRIDE = re.compile(r"### Running evaluation for mask stride value: (\S+) ###")
_EXAMPLES = re.compile(r"Running evaluation on '.*' with (\d+) examples")
_ATTRIBUTION = re.compile(r"Eval wall attribution: .* total=([0-9.]+)s")


def parse_strides(lines):
    """Per stride of the eval CLI's output: the mask stride, the eval samples,
    the run's wall seconds (its attribution line's total), the protocol
    frames/s and the attribution line."""
    out, current = [], {}
    for line in lines:
        if m := _STRIDE.search(line):
            current = {"mask_stride": m.group(1)}
        elif m := _EXAMPLES.search(line):
            current["eval_samples"] = int(m.group(1))
        elif m := _ATTRIBUTION.search(line):
            wall = float(m.group(1))
            current.update(wall_s=wall, attribution=line.strip(),
                           protocol_frames_per_s=current.get("eval_samples", 0) / wall)
            out.append(current)
            current = {}
    return out


def run(extra_args=(), data_dir: str = DATA_DIR):
    """Run the eval CLI's sweep as a subprocess, its output passed through;
    print one JSON line with the wall time, the child's peak RSS, the exit
    code and the per-stride numbers. Returns the exit code."""
    path_3d, path_2d, path_w = paths(data_dir)
    if not os.path.exists(path_3d):
        raise FileNotFoundError(f"{path_3d}: run --make-data first")
    cmd = [sys.executable, "-m", "uplift_upsample_torch.eval",
           "--weights", path_w, "--config", "h36m_351",
           "--dataset", path_3d, "--dataset_2d", path_2d, *extra_args]
    print("exec:", " ".join(cmd), flush=True)
    lines = []
    t0 = time.perf_counter()
    with subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, text=True) as proc:
        for line in proc.stdout:
            print(line, end="", flush=True)
            lines.append(line)
    wall = time.perf_counter() - t0
    peak_child_gb = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1e6
    print(json.dumps({
        "fullscale_eval_wall_s": round(wall, 1),
        "peak_child_rss_gb": round(peak_child_gb, 2),
        "rc": proc.returncode,
        "strides": parse_strides(lines),
    }), flush=True)
    return proc.returncode


CARD_BUSY_STRIDE = 10  # the mask stride of `--card-busy`'s run


def card_busy(data_dir: str = DATA_DIR, device: str = "cuda"):
    """One eval run at CARD_BUSY_STRIDE on the written data and weights, in this
    process under `utils.profiling.trace` (its Chrome trace into
    `<data_dir>/trace`): prints the run's output, then one JSON line with the
    run's wall time (loading included), the card's busy time (the union of
    its kernels' intervals), its share of the run and of the eval loop (the
    run's attribution line's total), the kernel records, the launches the trace lost, the port's kernel launches
    (by wrapper, and in all: every C entry launches one kernel) and the
    kernels that took the most card time. Returns the
    line's dict."""
    import torch

    from ..configs import get_config
    from ..eval import run_eval
    from ..ops import cuda_lib
    from ..utils.profiling import card_busy as busy_of, trace

    path_3d, path_2d, path_w = paths(data_dir)
    config = get_config("h36m_351")
    config.MASK_STRIDE = CARD_BUSY_STRIDE
    cuda_lib.reset_launches()
    log = io.StringIO()
    with trace(os.path.join(data_dir, "trace"), strict=False) as prof:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            run_eval(config, "h36m", path_3d, path_2d, "test", weights_path=path_w,
                     device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(log.getvalue(), end="", flush=True)
    loop = (parse_strides(log.getvalue().splitlines()) or [{}])[-1]
    busy, kernels, by_name = busy_of(prof.trace_file)
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:8]
    out = {"card_busy_mask_stride": CARD_BUSY_STRIDE, "wall_s": wall, "card_busy_s": busy,
           "card_busy_share": busy / wall, "eval_loop_s": loop.get("wall_s"),
           "card_busy_share_of_loop": busy / loop["wall_s"] if loop else None,
           "attribution": loop.get("attribution"), "kernels": kernels,
           "lost_kernels": prof.lost_kernels,
           "launches": {k: v for k, v in cuda_lib.LAUNCHES.items() if not k.endswith("_f32")},
           "port_kernel_launches": sum(v for k, v in cuda_lib.LAUNCHES.items()
                                       if k.endswith("_f32")),
           "trace_mb": os.path.getsize(prof.trace_file) / 1e6,
           "top": [[name[:80], seconds, n] for name, (seconds, n) in top]}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--make-data", action="store_true")
    ap.add_argument("--run", action="store_true")
    ap.add_argument("--card-busy", action="store_true",
                    help="one stride (MASK_STRIDE 10) under the profiler, in this process")
    ap.add_argument("rest", nargs="*", help="extra args forwarded to the eval CLI")
    args = ap.parse_args(argv)
    if args.make_data:
        make_data()
    rc = run(args.rest) if args.run else 0
    if args.card_busy and rc == 0:
        card_busy()
    sys.exit(rc)


if __name__ == "__main__":
    main()
