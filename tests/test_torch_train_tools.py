"""The port's three training tools on the CPU, at a tiny config.

  - `tools/rung_convergence.py`: two rungs, 2 epochs x 3 steps on the
    learnable synthetic pair (short clips): one JSON line per rung (loss per
    epoch, val MPJPE), then the summary with the delta against the first
    rung; with the same SHUFFLE_SEED each rung starts from the same weights
    and data, so "high" and "highest" (the same fp32 products) give the
    same curve;
  - `tools/profile_train.py`: every variant once at B=4 (chains of 1 and
    2 calls), one JSON line each, and the card-busy line (no card: no
    kernels);
  - `tools/soak_train.py`: 3 epochs with a kill as epoch 3 starts (a
    subprocess that ends itself, as a kill would), then `--resume` to
    epoch 3: RSS samples in soak_rss.jsonl, and the loss after the resume
    continues the curve.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from uplift_upsample_torch.tools import profile_train, rung_convergence, soak_train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {
    "SEQUENCE_LENGTH": 9, "SEQUENCE_STRIDE": 5, "SPATIAL_EMBED_DIM": 16,
    "TEMPORAL_EMBED_DIM": 32, "SPATIAL_TRANSFORMER_BLOCKS": 1,
    "TEMPORAL_TRANSFORMER_BLOCKS": 2, "STRIDES": [3, 3], "PADDINGS": [[0, 0], [0, 0]],
    "NUM_HEADS": 4, "MASK_STRIDE": [5, 10, 20], "FIRST_STRIDED_TOKEN_ATTENTION_LAYER": 1,
    "DROP_PATH_RATE": [0.1, 0.1, 0.0], "DATASET_VAL_3D_SUBSAMPLE_STEP": 10,
    "BEST_CHECKPOINT_METRIC": "MPJPE",
}
FRAMES = ["--action-frames", "120"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny(tmp_path):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(TINY))
    return str(path)


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_rung_convergence(tiny, tmp_path, capsys):
    assert rung_convergence.main([
        "--device", "cpu", "--config", tiny, "--rungs", "high,highest", "--epochs", "2",
        "--steps-per-epoch", "3", "--batch", "8", "--validation-interval", "1",
        "--validation-examples", "16", "--data-dir", str(tmp_path / "data"),
        "--out-base", str(tmp_path / "runs"), *FRAMES]) == 0
    high, highest, summary = _lines(capsys)
    assert (high["rung"], highest["rung"]) == ("high", "highest")
    assert [e for e, _ in high["loss"]] == [1, 2] and len(high["val_mpjpe"]) == 2
    assert high["loss"] == highest["loss"] and high["val_mpjpe"] == highest["val_mpjpe"]
    assert summary["base"] == "high" and summary["mpjpe_delta_pct"] == {"highest": 0.0}
    assert summary["within_bar"] and summary["device"] == "cpu"


def test_profile_train(tiny, tmp_path, capsys):
    assert profile_train.main([
        "--device", "cpu", "--config", tiny, "--batch", "4", "--m-small", "1",
        "--m-large", "2", "--reps", "1", "--precision", "high",
        "--logdir", str(tmp_path / "trace")]) == 0
    lines = _lines(capsys)
    assert [line["variant"] for line in lines] == [*profile_train.VARIANTS, "card_busy"]
    assert all(line["device"] == "cpu" and line["batch"] == 4 for line in lines)
    busy = lines[-1]
    assert busy["step_ms"] > 0 and busy["kernels"] == 0 and busy["busy_share"] == 0.0


def test_soak_kill_and_resume(tiny, tmp_path, capsys):
    out = tmp_path / "soak"
    common = ["--device", "cpu", "--config", tiny, "--steps-per-epoch", "4", "--batch", "8",
              "--validation-interval", "1", "--checkpoint-interval", "1",
              "--validation-examples", "16", "--log-every", "2", "--rss-interval", "0.2",
              "--data-dir", str(tmp_path / "data"), "--out-dir", str(out), *FRAMES]
    killed = subprocess.run(
        [sys.executable, "-m", "uplift_upsample_torch.tools.soak_train", "--epochs", "3",
         "--kill-after-epoch", "2", *common], cwd=ROOT, capture_output=True, text=True,
        timeout=240, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert killed.returncode == 3, killed.stderr[-2000:]
    assert "killed after epoch 2" in killed.stderr and '"loss"' not in killed.stdout
    assert soak_train.main(["--epochs", "3", "--resume", *common]) == 0
    line = _lines(capsys)[-1]
    assert line["resumed"] and [e for e, _ in line["loss"]] == [1, 2, 3]
    assert line["continuity"]["continues"], line["continuity"]
    samples = [json.loads(s) for s in (out / "soak_rss.jsonl").read_text().splitlines()]
    assert len(samples) >= 3 and all(s["rss_gb"] > 0 for s in samples)
    assert {s["epoch"] for s in samples} >= {1, 2, 3}
