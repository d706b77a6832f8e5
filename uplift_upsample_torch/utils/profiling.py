"""Profiling and step timing (counterpart of the JAX package's `utils/profiling.py`).

  - `trace(logdir)`: `torch.profiler` around a block, the card's kernels
    included when there is one; writes a Chrome trace
    (`<host>_<pid>.<ns>.pt.trace.json`, which TensorBoard's profiler plugin
    and chrome://tracing read) into `logdir` and checks that every kernel
    launch in it has its kernel's record. A profiler that fails to start
    raises.
  - `card_busy(path)`: the card's busy time in a Chrome trace, the union of
    its kernels' intervals.
  - `StepTimer`: wall-clock step statistics with ETA formatting.
  - `device_timer`: seconds per call of a function on the card, as the slope
    between two chains of calls, each call's input carrying the last
    output, so launch costs that do not grow with the chain drop out.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import socket
import time

import torch

from .time_format import format_time

# The runtime and driver calls that launch one kernel; a Chrome trace gives
# each the correlation id of its kernel's record
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel",
                 "cuLaunchCooperativeKernel")
_WARMUP_KERNELS = 64


def _trace_events(path: str):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def lost_kernels(path: str) -> int:
    """The kernel launches in the Chrome trace at `path` whose kernel has no
    record there."""
    events = _trace_events(path)
    kernels = {e["args"].get("correlation") for e in events
               if e.get("cat") == "kernel" and "args" in e}
    return sum(1 for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and e.get("name", "").startswith(_LAUNCH_CALLS)
               and e.get("args", {}).get("correlation") not in kernels)


@contextlib.contextmanager
def trace(logdir: str, strict: bool = True):
    """Profile the block; yields the `torch.profiler.profile` (its
    `key_averages()`, `events()`; after the block also `trace_file`, the
    Chrome trace written into `logdir`, and `lost_kernels`).

    With a card, the session records the block only after a warm-up step in
    which tracing is already on and a burst of small kernels has run: a
    session that records from its first kernel loses the records of its
    first launches once an earlier session has run in the process (PERF.md
    §6, PR 13). Every launch in the written trace
    is then looked up by its correlation id;
    launches without their kernel's record raise RuntimeError (naming the
    file, which stays) unless `strict` is False, and are counted in
    `lost_kernels` either way. A block that raises writes no trace.
    """
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities,
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    prof.start()  # the warm-up step: tracing on, its events dropped
    if cuda:
        torch.cuda.synchronize()
        flag = torch.zeros(1, device="cuda")
        for _ in range(_WARMUP_KERNELS):
            flag.add_(1.0)
        torch.cuda.synchronize()
    prof.step()  # records from here
    try:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    finally:
        prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                                f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    prof.trace_file = path
    prof.lost_kernels = lost_kernels(path) if cuda else 0
    if strict and prof.lost_kernels:
        raise RuntimeError(f"{path}: {prof.lost_kernels} kernel launches have no kernel "
                           f"record in the trace")


def card_busy(path: str):
    """The card's work in the Chrome trace at `path`: (busy seconds, the
    union of its kernels' intervals; the number of kernels; {kernel name:
    [seconds, launches]}). Copies, memsets and the profiler's own spans on
    the card's timeline are not kernels and are not counted."""
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in _trace_events(path)
                     if e.get("cat") == "kernel")
    busy, end = 0.0, float("-inf")
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for start, stop, name in kernels:  # microseconds
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name][0] += (stop - start) / 1e6
        by_name[name][1] += 1
    return busy / 1e6, len(kernels), dict(by_name)


class StepTimer:
    def __init__(self, total_steps: int):
        self.total_steps = total_steps
        self.start = time.time()
        self.completed = 0

    def step(self) -> None:
        self.completed += 1

    @property
    def elapsed(self) -> float:
        return time.time() - self.start

    @property
    def eta(self) -> str:
        if self.completed == 0:
            return "?"
        rate = self.elapsed / self.completed
        return format_time((self.total_steps - self.completed) * rate)

    @property
    def mean_step(self) -> float:
        return self.elapsed / max(self.completed, 1)


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    return _first_tensor(out[0])


def device_timer(fn, *args, m_small: int = 4, m_large: int = 16, reps: int = 3) -> float:
    """Seconds per call of `fn(*args)`: the best of `reps` timed chains of
    `m_large` calls less that of `m_small`, over the difference.

    `fn` must accept its first argument perturbed additively: each call gets
    `args[0] + carry`, the carry a scalar from the previous call's first
    output (times 1e-20), so the calls run in order. A chain on the card is
    timed with CUDA events, one on the CPU with the host clock.
    """
    x = args[0]
    on_card = x.is_cuda

    def chain(m):
        carry = torch.zeros((), dtype=x.dtype, device=x.device)
        for _ in range(m):
            out = _first_tensor(fn(x + carry, *args[1:]))
            carry = (out.reshape(-1)[:1].sum() * 1e-20).to(x.dtype)
        return carry

    def run(m):
        chain(m)  # warm
        best = float("inf")
        for _ in range(reps):
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                chain(m)
                end.record()
                end.synchronize()
                seconds = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                chain(m).item()
                seconds = time.perf_counter() - t0
            best = min(best, seconds)
        return best

    return (run(m_large) - run(m_small)) / (m_large - m_small)
