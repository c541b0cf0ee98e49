"""Seconds per call of a function, by differencing two run lengths.

Counterpart of sings_tpu/ops/timing.py::device_time, with its
signature. There, K dependent calls are chained in one lax.scan so
that a remote backend cannot hide the work; here the card runs what it
is given in order on PyTorch's current stream, so k back-to-back calls
between two CUDA events measure the same thing. Differencing k2 and k1
calls cancels the fixed cost around a run, as the JAX version does:

    t_iter = (T(k2) - T(k1)) / (k2 - k1),  the best of `repeats`

On CUDA tensors the times come from CUDA events; on CPU tensors (the
tests) from the host clock. The device is read from the first tensor
in args.
"""
from __future__ import annotations

import time

import torch


def _device(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    raise ValueError("device_time needs at least one tensor argument")


def _run_seconds(fn, args, k: int, cuda: bool) -> float:
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            fn(*args)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e-3
    t0 = time.perf_counter()
    for _ in range(k):
        fn(*args)
    return time.perf_counter() - t0


def device_time(fn, args, *, k1: int = 2, k2: int = 18,
                repeats: int = 3) -> float:
    """Per-iteration seconds for fn(*args) on the device of args."""
    if k2 <= k1:
        raise ValueError(f"k2 ({k2}) must exceed k1 ({k1})")
    cuda = _device(args).type == "cuda"
    fn(*args)  # warm up: first-use builds, caches
    if cuda:
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        t1 = _run_seconds(fn, args, k1, cuda)
        t2 = _run_seconds(fn, args, k2, cuda)
        best = min(best, (t2 - t1) / (k2 - k1))
    return max(best, 0.0)
