"""Pieces the benchmark's runners and metric readers share: the run's
context, the traced window and its reading, the comparison's numbers,
and the check that nothing loaded JAX or the JAX package."""
from __future__ import annotations

import json
import math
import os
import sys
from dataclasses import dataclass
from typing import Any

import torch

# top-level module names that may not be loaded in a run, compared whole
# (sings_tpu_torch begins with sings_tpu and is the program)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "sings_tpu")

# spin kernels run at the start of every profiled window: torch.profiler
# on the card's machine has dropped the first kernel records of a
# session (chip_smoke.py's PREAMBLE); their records are left out
PREAMBLE = 4
SPIN = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def forbidden_loaded(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names
                   if m.split(".")[0] in FORBIDDEN_MODULES})


@dataclass
class Ctx:
    """What a runner gets: the checkout, the cell and its files, the
    seed, the window's length, the device and a fresh directory."""
    root: str
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    tmp: str
    t_start: float

    def note(self, msg: str) -> None:
        """A line on standard output, before the result."""
        print(msg, flush=True)


@dataclass
class Trace:
    """The device's records of a traced window: kernels (name, start,
    end) in microseconds, host operations and the benchmark's ranges
    (name, start, end) where the host was traced too, the window
    [t0, t1] on the trace's timeline and its length in seconds."""
    kernels: list
    ops: list
    ranges: list
    t0: float
    t1: float
    window_s: float

    def clipped(self) -> list:
        """Device records inside the window, clipped to it."""
        return [(n, max(a, self.t0), min(b, self.t1))
                for n, a, b in self.kernels
                if b > self.t0 and a < self.t1]

    def busy_intervals(self) -> list:
        """The union of the device's records in the window."""
        ivs = sorted((a, b) for _n, a, b in self.clipped() if b > a)
        merged = []
        for a, b in ivs:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_s(self, key: str | None = None) -> float:
        """Summed device time of the records whose name holds key (all
        records for None), in the window."""
        return sum(b - a for n, a, b in self.clipped()
                   if key is None or key in n) / 1e6

    def launches(self, key: str) -> list:
        """(start, end) of each record whose name holds key, in time
        order, in the window."""
        return sorted((a, b) for n, a, b in self.clipped() if key in n)

    def top_kernels(self, n: int = 10) -> list:
        tot: dict = {}
        for name, a, b in self.clipped():
            tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
        return sorted(([k[:160], v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time in the window by what the host was doing at
        each gap's middle: the innermost benchmark range and the
        outermost host operation there, summed over the gaps."""
        import bisect

        busy = self.busy_intervals()
        if not busy:
            return []
        t0 = busy[0][0] if math.isinf(self.t0) else self.t0
        t1 = busy[-1][1] if math.isinf(self.t1) else self.t1
        edges = [t0] + [x for iv in busy for x in iv] + [t1]
        tops = _outermost(self.ops)
        starts = [o[1] for o in tops]
        ranges = sorted(self.ranges, key=lambda r: r[2] - r[1])
        tot: dict = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            name = next((r[0] for r in ranges if r[1] <= mid <= r[2]), "-")
            i = bisect.bisect_right(starts, mid) - 1
            op = tops[i][0] if i >= 0 and tops[i][2] >= mid else "-"
            key = f"{name}|{op}"[:160]
            tot[key] = tot.get(key, 0.0) + (b - a) / 1e6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]


def _outermost(ops: list) -> list:
    """The host operations that no other operation contains, by start."""
    out = []
    for op in sorted(ops, key=lambda o: (o[1], -o[2])):
        if out and op[2] <= out[-1][2]:
            continue
        out.append(op)
    return out


def profile_start(host: bool):
    """Start torch.profiler and run the preamble. host False records the
    device alone, which keeps the profiler's cost on the host out of the
    window; host True also records the host's operations and the
    benchmark's ranges."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    for _ in range(PREAMBLE):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    return prof


def profile_stop(prof, path: str, window: str | None = None,
                 window_s: float | None = None) -> Trace:
    """Stop the profiler, write its trace to path and read it. The
    window: for a device-only trace, every record after the preamble,
    window_s long by the host's clock; for a host trace, the span of
    the benchmark's ranges from the first named `window` to the end of
    the last."""
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    os.remove(path)
    kernels, ranges, ops = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            if SPIN not in e.get("name", ""):
                kernels.append((e.get("name", ""), a, b))
        elif cat == "user_annotation":
            ranges.append((e["name"], a, b))
        elif cat == "cpu_op":
            ops.append((e["name"], a, b))
    if not kernels:
        raise RuntimeError("the trace holds no device records")
    if window is None:
        return Trace(kernels=kernels, ops=ops, ranges=ranges,
                     t0=-math.inf, t1=math.inf, window_s=float(window_s))
    spans = [r for r in ranges if r[0] == window]
    if not spans:
        raise RuntimeError(f"no {window!r} range in the trace")
    t0 = min(r[1] for r in spans)
    t1 = max(r[2] for r in ranges if r[1] >= t0)
    return Trace(kernels=kernels, ops=ops, ranges=ranges, t0=t0, t1=t1,
                 window_s=(t1 - t0) / 1e6)


def rel_gap(got: float, want: float, floor: float) -> float:
    """|got - want| over the larger of |want| and floor."""
    return abs(got - want) / max(abs(want), floor, 1e-30)


def device_info(count: int) -> dict:
    """The card's name, the cards used, the peak of allocated memory and
    the power limit."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
            "power_limit_w": power_limit()}


def power_limit():
    """The card's power limit in watts from nvidia-smi, None if it does
    not answer."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class Run:
    """A traced run as the per-layer readers see it: the context, the
    runner's state, the trace, the units (steps or frames) of the traced
    window, the launch inputs the runner captured, and anything else the
    runner measured. A reader appends what it prints to lines."""

    def __init__(self, ctx, state, trace, units, attempted, failed,
                 captured=None, gaps=None, **extra):
        self.ctx = ctx
        self.state = state
        self.trace = trace
        self.units = units
        self.attempted = attempted
        self.failed = failed
        self.captured = captured or {}
        self.gaps = gaps or []
        self.extra = extra
        self.lines = []
        self.cache = {}


class capture_first:
    """Within the block, keep the arguments of the first call of each
    named launcher of a module (its CUDA wrappers) in `captured`, by
    short name; the launchers run as before."""

    def __init__(self, module, names: dict):
        self.module, self.names = module, names
        self.captured = {}
        self.saved = {}

    def __enter__(self):
        for short, attr in self.names.items():
            fn = getattr(self.module, attr)
            self.saved[attr] = fn
            setattr(self.module, attr, self._wrap(short, fn))
        return self.captured

    def _wrap(self, short, fn):
        def launch(*args, **kw):
            self.captured.setdefault(short, (args, dict(kw)))
            return fn(*args, **kw)
        return launch

    def __exit__(self, *exc):
        for attr, fn in self.saved.items():
            setattr(self.module, attr, fn)
        return False
