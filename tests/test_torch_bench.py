"""The port's bench CLI (`python -m uplift_upsample_torch.bench`) on the CPU.

`main` runs with `--device cpu` at a tiny batch and iters (the watchdog off:
BENCH_BUDGET_S=0) on the default eval invocation, `--strided-sel`,
`--no-shared-spatial --mask-stride 10` and `--train`; each prints one JSON
line whose metric name and keys are those of the repository's `bench.py`
(its `make_result` dicts, read from its source). The watchdog's provisional
line runs in a subprocess, since it ends its process.
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from uplift_upsample_torch import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_bench_keys():
    """The keys of bench.py's two make_result dicts (eval, train), plus the
    elapsed_s both add before printing."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    keys = {}
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef) and fn.name in ("bench_train", "main"):
            inner = next(n for n in ast.walk(fn)
                         if isinstance(n, ast.FunctionDef) and n.name == "make_result")
            d = next(n for n in ast.walk(inner) if isinstance(n, ast.Dict))
            keys["train" if fn.name == "bench_train" else "eval"] = (
                {k.value for k in d.keys} | {"elapsed_s"})
    return keys


def _run(monkeypatch, capsys, *argv):
    monkeypatch.setenv("BENCH_BUDGET_S", "0")
    bench.main(["--device", "cpu", "--iters", "4", *argv])
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1, out
    return json.loads(lines[0]), err


@pytest.mark.parametrize("argv,s_in,shared", [
    ((), 5, True),
    (("--strided-sel",), 5, True),
    (("--no-shared-spatial", "--mask-stride", "10"), 10, False),
])
def test_bench_eval_json_line(monkeypatch, capsys, argv, s_in, shared):
    result, err = _run(monkeypatch, capsys, "--batch", "3", *argv)
    assert set(result) == _jax_bench_keys()["eval"]
    assert result["metric"] == "uplifted_frames_per_sec_per_chip_n351"
    assert result["unit"] == "frames/s" and result["method"] == "slope"
    assert (result["s_in"], result["shared_spatial"]) == (s_in, shared)
    assert result["frames_per_window"] == 5 and result["precision_rung"] == "high"
    # both rounded to 0.1
    assert result["value"] == pytest.approx(5 * result["windows_per_sec"], abs=0.3)
    assert result["windows_per_sec"] > 0
    assert "read, not used by the port: --eval-wpt=None" in err
    assert "# device=cpu batch=3" in err
    if shared:
        assert "unique_frames=" in err


def test_bench_train_json_line(monkeypatch, capsys):
    result, err = _run(monkeypatch, capsys, "--train", "--batch", "2",
                       "--no-train-fused-temporal", "--train-precision", "high")
    assert set(result) == _jax_bench_keys()["train"]
    assert result["metric"] == "train_windows_per_sec_per_chip_n351"
    assert result["unit"] == "windows/s" and result["value"] > 0
    # value is windows/s rounded to 0.1 (ms_per_step to 0.01 ms): on a slow
    # step that rounding alone exceeds 1 % of value
    assert result["value"] == pytest.approx(2e3 / result["ms_per_step"], abs=0.051)
    assert "fused=True fused_temporal=False" in err


def test_bench_refuses_what_is_not_ported(monkeypatch, capsys):
    """The bf16 matmul rung runs (tests/test_torch_precision.py), but not
    with the packed attention op (ROADMAP A8); bf16 activations raise."""
    monkeypatch.setenv("BENCH_BUDGET_S", "0")
    with pytest.raises(NotImplementedError, match="A8"):
        bench.main(["--device", "cpu", "--precision", "default", "--pallas"])
    with pytest.raises(ValueError, match="COMPUTE_DTYPE"):
        bench.main(["--device", "cpu", "--dtype", "bfloat16", "--batch", "2"])
    assert capsys.readouterr().out == ""


def test_watchdog_prints_the_provisional_line():
    """Past the budget the watchdog prints the provisional result, marked as
    such, and ends the process with 0."""
    code = ("import time; from uplift_upsample_torch.bench import Bench; "
            "b = Bench(0.3); b.provisional = {'metric': 'm', 'value': 1.0}; "
            "b.start_watchdog(); time.sleep(30)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == {"metric": "m", "value": 1.0, "provisional": True}
    assert "WATCHDOG" in proc.stderr
