"""The port's `utils/profiling.py` on the CPU: `StepTimer` against the JAX
package's, `device_timer`'s chained slope, and `trace` writing its Chrome
trace. The card's side (CUDA events, kernel names in the trace) runs in
chip_smoke.py's phase 9."""

import glob
import json
import time

import pytest
import torch

from uplift_upsample_torch.utils.profiling import (StepTimer, card_busy, device_timer,
                                                   lost_kernels, trace)


def test_step_timer_matches_jax(monkeypatch):
    from uplift_upsample_tpu.utils.profiling import StepTimer as JaxStepTimer

    clock = [1000.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    ours, ref = StepTimer(10), JaxStepTimer(10)
    assert ours.eta == ref.eta == "?"
    for dt in (2.5, 3.0, 61.0, 3600.0):
        clock[0] += dt
        ours.step()
        ref.step()
        assert (ours.elapsed, ours.eta, ours.mean_step, ours.completed) == (
            ref.elapsed, ref.eta, ref.mean_step, ref.completed)


@pytest.mark.parametrize("out", ["tensor", "tuple", "dict"])
def test_device_timer_chains_calls_on_the_cpu(out):
    """Each call gets the first argument plus the carried scalar; (1 warm-up
    + reps) chains of m_small and of m_large calls; the slope of a matrix
    product chain is positive and finite."""
    torch.manual_seed(0)
    x, w = torch.randn(384, 384), torch.randn(384, 384)
    seen = []

    def fn(a, b):
        seen.append(a)
        y = a @ b
        return {"tensor": y, "tuple": (y, None), "dict": {"y": y}}[out]

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # beside five other test workers
    try:
        seconds = device_timer(fn, x, w, m_small=2, m_large=10, reps=2)
    finally:
        torch.set_num_threads(threads)
    assert len(seen) == (1 + 2) * (2 + 10)
    assert all(a.shape == x.shape for a in seen)
    assert torch.equal(seen[0], x)  # the first call of a chain: a zero carry
    assert 0 < seconds < 1


def test_trace_writes_a_chrome_trace(tmp_path):
    torch.randn(8, 8) @ torch.randn(8, 8)  # before the session: not in it
    with trace(str(tmp_path)) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert sum("aten::mm" in e.name for e in prof.events()) == 1
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert files == [prof.trace_file]
    assert prof.lost_kernels == 0
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == "aten::mm" for e in events) == 1


def test_trace_of_a_block_that_raises_writes_nothing(tmp_path):
    with pytest.raises(ValueError, match="inside"):
        with trace(str(tmp_path)):
            raise ValueError("inside")
    assert not list(tmp_path.iterdir())


def test_lost_kernels_counts_launches_without_a_kernel_record(tmp_path):
    def launch(cat, name, corr):
        return {"cat": cat, "name": name, "ts": corr, "args": {"correlation": corr}}

    events = [launch("cuda_runtime", "cudaLaunchKernel", 1),
              launch("cuda_runtime", "cudaLaunchKernel", 2),
              launch("cuda_driver", "cuLaunchKernel", 3),
              launch("cuda_runtime", "cudaLaunchKernelExC_v11060", 4),
              launch("cuda_driver", "cuLaunchKernelEx", 5),
              launch("cuda_runtime", "cudaMemcpyAsync", 6),  # not a launch
              launch("kernel", "gemm", 1), launch("kernel", "relu", 3),
              launch("gpu_memcpy", "Memcpy HtoD", 6),
              {"cat": "cpu_op", "name": "aten::mm", "ts": 0}]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert lost_kernels(str(path)) == 3  # 2, 4 and 5


def test_card_busy_is_the_union_of_kernel_intervals(tmp_path):
    def event(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [event("kernel", "b", 50, 30), event("kernel", "a", 0, 100),
              event("kernel", "a", 300, 100),
              # on the card's timeline, but not kernels
              event("gpu_user_annotation", "ProfilerStep#1", 0, 1000),
              event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 500, 200),
              event("cpu_op", "aten::mm", 0, 1000)]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    busy, count, by_name = card_busy(str(path))
    assert count == 3
    assert busy == pytest.approx(200e-6)
    assert by_name == {"a": [pytest.approx(200e-6), 2], "b": [pytest.approx(30e-6), 1]}
    path.write_text(json.dumps({"traceEvents": events[3:]}))
    assert card_busy(str(path)) == (0.0, 0, {})
