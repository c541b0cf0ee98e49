"""The program's spans (sings_tpu_torch/ops/profiling.py::span) read
from three more units of the cell's own traffic.

After the runner's traced() has returned, read(run) runs three more
units through the runner module run.py loaded (one chunk of training
through its _chunk, one whole pass of animation through its _pass),
each timed on the host's clock:

  * one untraced: the rate the traced units are held against;
  * one under a ranges-only profiler session: the card's records, the
    CUDA runtime and driver calls and the record_function ranges, but no
    aten operation (RecordScope.USER_SCOPE), so that the profiler costs
    the host a launch's and a range's record and nothing per operation.
    Its idle time, and the idle time under each span, are this unit's;
  * one under common.profile_start(host=True), the host's operations
    too: device time, launches and waits by span are this unit's.

Each trace is exported and parsed here: device records (kernel, memcpy,
memset) with their correlation, runtime and driver calls with their
correlation and thread, user_annotation ranges and host operations
(with autograd's sequence number) by thread. A device record goes to
what was innermost at its launch call on the launching thread:

  * a program span: that span;
  * an autograd backward operation (autograd's device thread runs them,
    outside the caller's spans): "bwd:" and the innermost program span
    at the forward operation of the same sequence number, so that a
    layer's backward counts with it (bwd:step.decode, bwd:raster.bin);
  * neither: the span opened last on any thread at that instant (the
    caller's step.backward), else "-".

The summary is cached in run.cache["spans"], so that every reader shares
one run. The window is that of common.profile_stop: from the first of
the runner's unit ranges to the end of the last range of the benchmark.
Device time is summed over records clipped to it; launches and waits
are the calls that start in it; idle time is the window less the union
of the device's records.
"""
from __future__ import annotations

import json
import os
import sys
import time

# the benchmark's own ranges (runners/*.py)
BENCH_RANGES = ("chunk", "readback", "render_chunk", "writer")
NONE = "-"
# device time of a backward operation, by its forward operation's span
BWD = "bwd:"
HOST_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")
# calls that make the host wait for the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
# runner -> (the function of one unit, the unit's range, its unit)
UNITS = {"train": ("_chunk", "chunk", "steps/s"),
         "anim": ("_pass", "render_chunk", "frames/s")}


def read(run) -> dict:
    """The summary of the three more units of the cell's traffic, run
    once a run."""
    if "spans" not in run.cache:
        run.cache["spans"] = _trace_units(run)
        run.lines.extend(notes(run.cache["spans"]))
    return run.cache["spans"]


def _runner(name: str):
    """The runner module run.py loaded for this run: run.py holds it in
    its `runner` local, not in sys.modules."""
    want = "bench_runner_" + name
    frame = sys._getframe(1)
    while frame is not None:
        mod = frame.f_locals.get("runner")
        if getattr(mod, "__name__", None) == want:
            return mod
        frame = frame.f_back
    raise RuntimeError(f"no caller holds the {want} module")


def _ranges_only_start():
    """A profiler session of the card's activity, the CUDA calls and the
    record_function ranges alone, after common.PREAMBLE spin kernels."""
    import torch
    from torch._C._profiler import RecordScope, _ExperimentalConfig
    from torch.autograd import ProfilerConfig, ProfilerState
    from torch.profiler import ProfilerActivity

    from common import PREAMBLE

    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                         False, _ExperimentalConfig())
    acts = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
    torch.cuda.synchronize()
    torch.autograd._prepare_profiler(cfg, acts)
    torch.autograd._enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    for _ in range(PREAMBLE):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def _trace_units(run) -> dict:
    import torch

    from common import profile_start

    name = run.ctx.traffic["runner"]
    fn_name, window, unit = UNITS[name]
    fn = getattr(_runner(name), fn_name)
    st = run.state
    path = os.path.join(run.ctx.tmp, "spans_trace.json")

    def one(stop=None):
        frames0 = getattr(st, "frames", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(st)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if stop is not None:
            stop()
        n = len(res[0]) if name == "train" else st.frames - frames0
        return n, sec

    def events():
        with open(path) as fh:
            ev = json.load(fh)["traceEvents"]
        os.remove(path)
        return ev

    rates = {}
    n, sec = one()
    rates["untraced"] = n / sec
    _ranges_only_start()
    n, sec = one(lambda: torch.autograd._disable_profiler().save(path))
    rates["ranges_only"] = n / sec
    light = summarize(parse(events()), window, n)
    prof = profile_start(host=True)
    n, sec = one(lambda: (prof.__exit__(None, None, None),
                          prof.export_chrome_trace(path)))
    rates["host"] = n / sec
    s = summarize(parse(events()), window, n)
    s.update(idle=light, rates=rates, rate_unit=unit)
    return s


def parse(events: list) -> dict:
    """Device records (name, start, end, correlation), host calls (name,
    start, end, thread, correlation), ranges (name, start, end, thread)
    and host operations (name, start, end, thread, sequence number,
    forward thread: 0 for a forward operation) of a Chrome trace's
    complete events, in microseconds."""
    from common import DEVICE_CATS, SPIN

    device, calls, ranges, ops = [], [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat, name = e.get("cat", ""), e.get("name", "")
        args = e.get("args") or {}
        thread = (e.get("pid"), e.get("tid"))
        if cat in DEVICE_CATS:
            if SPIN not in name:
                device.append((name, a, b, args.get("correlation")))
        elif cat in HOST_CATS:
            calls.append((name, a, b, thread, args.get("correlation")))
        elif cat == "user_annotation":
            ranges.append((name, a, b, thread))
        elif cat == "cpu_op":
            ops.append((name, a, b, thread, args.get("Sequence number"),
                        args.get("Fwd thread id", 0)))
    return {"device": device, "calls": calls, "ranges": ranges, "ops": ops}


def _innermost(items: list, points: list) -> list:
    """For each time in points, the index into items (name, start, end,
    ...) of the item opened last of those open there (the innermost,
    where they nest), or None."""
    # at one instant: opens (the longer first), then the points, then
    # closes
    ev = [(it[1], 0, it[1] - it[2], i) for i, it in enumerate(items)]
    ev += [(it[2], 2, 0.0, i) for i, it in enumerate(items)]
    ev += [(t, 1, 0.0, j) for j, t in enumerate(points)]
    ev.sort()
    out = [None] * len(points)
    stack: list = []
    for _t, kind, _tb, i in ev:
        if kind == 0:
            stack.append(i)
        elif kind == 2:
            stack.remove(i)
        else:
            out[i] = stack[-1] if stack else None
    return out


def _own(points: list, items: list) -> list:
    """For each (thread, time) in points (or None), the index into items
    (name, start, end, thread, ...) of the innermost one open there on
    the same thread, or None."""
    out = [None] * len(points)
    by_thread: dict = {}
    for k, p in enumerate(points):
        if p is not None:
            by_thread.setdefault(p[0], []).append(k)
    for thread, ks in by_thread.items():
        mine = [i for i, it in enumerate(items) if it[3] == thread]
        hits = _innermost([items[i] for i in mine], [points[k][1] for k in ks])
        for k, h in zip(ks, hits):
            out[k] = None if h is None else mine[h]
    return out


def _attribute(points: list, spans: list, ops: list = ()) -> list:
    """The program span of each launch (thread, time) in points, by the
    rules of the module's docstring; "-" for None or a launch in none."""
    bwd = [o for o in ops if o[4] is not None and o[5]]
    fwd: dict = {}
    for o in ops:
        if o[4] is not None and not o[5]:
            fwd.setdefault(o[4], []).append((o[1], o[3]))
    span_at, bwd_at = _own(points, spans), _own(points, bwd)
    # each backward operation met: its forward operation, at its start
    origin = {}
    for j in {j for j in bwd_at if j is not None}:
        before = [f for f in fwd.get(bwd[j][4], ()) if f[0] < bwd[j][1]]
        if before:
            a, thread = max(before)
            origin[j] = (thread, a)
    fspan = dict(zip(origin, _own(list(origin.values()), spans)))
    who, left = [NONE] * len(points), []
    for k, p in enumerate(points):
        if p is None:
            continue
        i, j = span_at[k], bwd_at[k]
        if (j is not None and fspan.get(j) is not None
                and (i is None or spans[i][1] < bwd[j][1])):
            who[k] = BWD + spans[fspan[j]][0]
        elif i is not None:
            who[k] = spans[i][0]
        else:
            left.append(k)
    for k, h in zip(left, _innermost(spans, [points[k][1] for k in left])):
        if h is not None:
            who[k] = spans[h][0]
    return who


def _union(ivs, t0: float, t1: float) -> list:
    """The union of the intervals (start, end), clipped to [t0, t1]."""
    from common import Trace

    return Trace(kernels=[("", a, b) for a, b in ivs], ops=[], ranges=[],
                 t0=t0, t1=t1, window_s=0.0).busy_intervals()


def _overlap(xs: list, ys: list) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    tot = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            tot += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return tot


def _outermost_calls(calls: list) -> list:
    """The calls no other call of the list contains on the same thread
    (a driver call a runtime call makes counts once)."""
    from common import _outermost

    threads: dict = {}
    for c in calls:
        threads.setdefault(c[3], []).append(c)
    return [c for cs in threads.values() for c in _outermost(cs)]


def _count(names: list) -> dict:
    out: dict = {}
    for n in names:
        out[n] = out.get(n, 0) + 1
    return out


def summarize(parsed: dict, window: str, units: int) -> dict:
    """Device time by program span, launches, waits and idle time under
    the program's spans, in the window that starts at the first `window`
    range."""
    ranges = parsed["ranges"]
    starts = [r[1] for r in ranges if r[0] == window]
    if not starts:
        raise RuntimeError(f"no {window!r} range in the trace")
    t0 = min(starts)
    t1 = max(r[2] for r in ranges if r[0] in BENCH_RANGES and r[1] >= t0)
    # the program's spans have dotted names (step.decode, raster.bin)
    spans = [r for r in ranges if "." in r[0] and r[0] not in BENCH_RANGES]
    ops = parsed["ops"]
    by_corr = {}
    for c in parsed["calls"]:
        if c[4] is not None and (c[4] not in by_corr
                                 or c[0].startswith("cuda")):
            by_corr[c[4]] = c
    # the launching call of each device record in the window
    recs = []
    for _n, a, b, corr in parsed["device"]:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            recs.append((b - a, by_corr.get(corr)))
    who = _attribute([c and (c[3], c[1]) for _d, c in recs], spans, ops)
    device_us: dict = {}
    for (dur, _c), name in zip(recs, who):
        device_us[name] = device_us.get(name, 0.0) + dur
    inside = [c for c in parsed["calls"] if t0 <= c[1] <= t1]
    launches = _outermost_calls([c for c in inside
                                 if c[0].startswith(LAUNCH_PREFIXES)])
    syncs = _outermost_calls([c for c in inside if c[0] in SYNC_CALLS])
    sync_points = [(c[3], c[1]) for c in syncs]
    sync_ops = _own(sync_points, ops)
    busy = _union([r[1:3] for r in parsed["device"]], t0, t1)
    idle = _union(zip([t0] + [b for _a, b in busy],
                      [a for a, _b in busy] + [t1]), t0, t1)
    names = sorted({r[0] for r in spans})
    return {"units": units, "window_us": t1 - t0, "device_us": device_us,
            "total_us": sum(dur for dur, _c in recs),
            "idle_us": sum(b - a for a, b in idle),
            "idle_under_spans_us": _overlap(
                idle, _union([r[1:3] for r in spans], t0, t1)),
            "idle_under_us": {n: _overlap(idle, _union(
                [r[1:3] for r in spans if r[0] == n], t0, t1))
                for n in names},
            "launches": len(launches), "device_records": len(recs),
            "syncs": len(syncs),
            "sync_calls": _count([c[0] for c in syncs]),
            "launches_by_span": _count(_attribute(
                [(c[3], c[1]) for c in launches], spans, ops)),
            "syncs_by_span": _count(_attribute(sync_points, spans, ops)),
            "syncs_by_op": _count([ops[i][0] if i is not None else NONE
                                   for i in sync_ops]),
            "span_names": names}


def span_ms_per_unit(s: dict, prefixes: tuple) -> float | None:
    """Device ms per unit launched under the spans (and backward
    operations, bwd:<span>) whose names start with one of prefixes; None
    where no record was or no unit."""
    names = [n for n in s["device_us"] if n.startswith(prefixes)]
    if not names or not s["units"]:
        return None
    return 1e-3 * sum(s["device_us"][n] for n in names) / s["units"]


def per_unit(s: dict, key: str) -> float | None:
    return s[key] / s["units"] if s["units"] else None


def idle_pct(s: dict, name: str) -> float | None:
    """The share of the ranges-only unit's idle time under the span
    name; None where that unit holds no such span or no idle time."""
    idle = s["idle"]
    if name not in idle["span_names"] or idle["idle_us"] <= 0:
        return None
    return 100.0 * idle["idle_under_us"][name] / idle["idle_us"]


def _idle_line(idle: dict) -> str:
    return (f"idle {idle['idle_us'] / 1e3:.3f} ms of a "
            f"{idle['window_us'] / 1e3:.3f} ms window, under program spans "
            f"{100 * idle['idle_under_spans_us'] / max(idle['idle_us'], 1e-9):.2f}"
            "%; by span (ms) " + ", ".join(
                f"{n} {v / 1e3:.3f}" for n, v in sorted(
                    idle["idle_under_us"].items(), key=lambda kv: -kv[1])))


def notes(s: dict) -> list:
    """The traced run's lines on the units: rates, conservation,
    coverage, counts and device time by span."""
    total = s["total_us"]
    under = total - s["device_us"].get(NONE, 0.0)
    parts = sum(s["device_us"].values())
    by_span = ", ".join(f"{n} {v / 1e3:.3f}" for n, v in sorted(
        s["device_us"].items(), key=lambda kv: -kv[1]))
    return [
        f"[spans] a unit of {s['units']}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in s["rates"].items())
        + f" {s['rate_unit']}",
        "[spans] ranges-only unit: " + _idle_line(s["idle"]),
        f"[spans] host-traced unit: device {total / 1e3:.3f} ms in "
        f"{s['device_records']} records, spans + '-' {parts / 1e3:.3f} ms "
        f"(conservation gap {abs(parts - total) / max(total, 1e-9):.2e}), "
        f"under program spans {100 * under / max(total, 1e-9):.2f}%",
        "[spans] host-traced unit: " + _idle_line(s),
        f"[spans] launches {s['launches']} by span {s['launches_by_span']}",
        f"[spans] host waits {s['syncs']} {s['sync_calls']} by span "
        f"{s['syncs_by_span']}, by operation {s['syncs_by_op']}",
        f"[spans] device ms by span: {by_span}",
    ]
