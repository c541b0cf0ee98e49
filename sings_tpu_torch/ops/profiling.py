"""Profiling and tracing (port of sings_tpu/ops/profiling.py).

  * trace(log_dir): a torch.profiler session (CPU activity, and CUDA
    activity when a card is present) that writes a Chrome trace,
    trace.json, into log_dir on exit;
  * annotate(name): torch.profiler.record_function, a named range of
    the host's work (and the kernels it launches) inside a trace;
  * StepTimer: the steady-state wall time of a step after `warmup`
    steps, and the Mpix/s that bench.py reports. On exit it waits for
    the card (torch.cuda.synchronize when a card is present), so that a
    step's time holds its kernels: the JAX timer stops when the host
    returns from dispatch.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body; writes log_dir/trace.json (Chrome format)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling wall-clock timer with warm-up exclusion."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.total += dt

    @property
    def mean_s(self) -> float:
        return self.total / max(self.count - self.warmup, 1)

    def mpix_s(self, height: int, width: int) -> float:
        return height * width / max(self.mean_s, 1e-12) / 1e6
