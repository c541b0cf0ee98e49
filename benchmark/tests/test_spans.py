"""counts/spans.py on a hand-written Chrome trace: runtime and driver
launches with their correlations, kernels and copies, nested program
spans on two threads, autograd's backward operations with the sequence
numbers of their forward ones, waits and idle gaps, each number counted
by hand; and on a trace torch.profiler writes on the CPU.
"""
import types

import pytest

from bench_tiny import HERE
from counts import spans

MAIN, AUTOGRAD, STREAM = 10, 20, 7
READERS = ("decode_device_ms.train", "raster_device_ms.train",
           "update_device_ms.train", "launches_per_step.train",
           "host_syncs_per_step.train", "bin_idle_pct.anim",
           "launches_per_frame.anim", "host_syncs_per_frame.anim")


def _x(cat, name, ts, dur, tid, corr=None, pid=1, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": pid, "tid": tid}
    if corr is not None:
        args["correlation"] = corr
    if args:
        e["args"] = args
    return e


def _op(name, a, b, tid, seq=None, fwd=0):
    """A host operation; seq and fwd as autograd's Sequence number and
    Fwd thread id (0 on a forward operation)."""
    if seq is None:
        return _x("cpu_op", name, a, b - a, tid)
    return _x("cpu_op", name, a, b - a, tid,
              **{"Sequence number": seq, "Fwd thread id": fwd})


def _launch(ts, corr, tid=MAIN, name="cudaLaunchKernel", dur=1):
    return _x("cuda_runtime" if name.startswith("cuda") else "cuda_driver",
              name, ts, dur, tid, corr)


def _kernel(ts, dur, corr, name="k", cat="kernel"):
    return _x(cat, name, ts, dur, STREAM, corr, pid=0)


def trace(program=True) -> list:
    """A unit of two steps in a `chunk` range [0, 100] and a `readback`
    [100, 110]; with program spans: step.decode [5, 30], step.rasterize
    [30, 60] holding raster.bin [35, 50], step.backward [60, 90] and a
    narrow x.narrow [63, 63.8] on the main thread, raster.composite_bwd
    [62, 70] on autograd's thread. Forward operations aten::mul [12, 14]
    (sequence 7, in step.decode) and _Composite [32, 34.5] (8, in
    step.rasterize); on autograd's thread their backward operations
    MulBackward0 [74, 81] and _CompositeBackward [61, 72], and
    UnknownBackward0 [84, 88] of no forward operation in the trace."""
    ev = [_x("user_annotation", "chunk", 0, 100, MAIN),
          _x("user_annotation", "readback", 100, 10, MAIN)]
    if program:
        ev += [_x("user_annotation", n, a, b - a, tid) for n, a, b, tid in (
            ("step.decode", 5, 30, MAIN), ("step.rasterize", 30, 60, MAIN),
            ("raster.bin", 35, 50, MAIN), ("step.backward", 60, 90, MAIN),
            ("x.narrow", 63, 63.8, MAIN),
            ("raster.composite_bwd", 62, 70, AUTOGRAD))]
    ev += [
        # before the window: left out
        _launch(-20, 90), _kernel(-9, 4, 90),
        # the profiler's spin preamble: left out
        _kernel(1, 0.5, 91, name="spin_kernel"),
        _launch(10, 1), _kernel(12, 8, 1),               # step.decode
        # a runtime launch holding a driver launch: one launch
        _launch(31, 8, dur=2),
        _launch(31.5, 9, name="cuLaunchKernel"),
        _kernel(33, 1, 8),                               # step.rasterize
        _launch(36, 2), _kernel(38, 2, 2),               # raster.bin
        _x("cuda_runtime", "cudaStreamSynchronize", 41, 4, MAIN),
        _launch(46, 3), _kernel(48, 1, 3),               # raster.bin
        _op("aten::mul", 12, 14, MAIN, seq=7),
        _op("_Composite", 32, 34.5, MAIN, seq=8),
        _op("aten::nonzero", 40.5, 45.5, MAIN),
        _op("_CompositeBackward", 61, 72, AUTOGRAD, seq=8, fwd=1),
        _op("MulBackward0", 74, 81, AUTOGRAD, seq=7, fwd=1),
        _op("UnknownBackward0", 84, 88, AUTOGRAD, seq=99, fwd=1),
        # autograd's thread: its own span inside a backward operation,
        # though the main thread has a narrower one open
        _launch(63, 4, AUTOGRAD), _kernel(65, 3, 4),     # composite_bwd
        # a backward operation: its forward operation's span
        _launch(71, 11, AUTOGRAD), _kernel(72, 1, 11),   # bwd:rasterize
        _launch(75, 5, AUTOGRAD), _kernel(77, 3, 5),     # bwd:decode
        # no forward operation, no span of its own: the caller's
        _launch(85, 10, AUTOGRAD), _kernel(86, 1, 10),   # step.backward
        _launch(95, 6), _kernel(96, 2, 6),               # "-"
        _x("cuda_runtime", "cudaMemcpyAsync", 101, 1, MAIN, 7),
        _kernel(102, 2, 7, name="Memcpy DtoH", cat="gpu_memcpy"),  # "-"
        _x("cuda_runtime", "cudaStreamSynchronize", 102, 3, MAIN),
        # not complete events: ignored
        {"ph": "i", "cat": "kernel", "name": "k", "ts": 50, "pid": 0,
         "tid": STREAM},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "ts": 10, "id": 1},
    ]
    return ev


def summary(program=True):
    """The summary as read() caches it, the ranges-only unit's idle time
    taken from the same trace."""
    s = spans.summarize(spans.parse(trace(program)), "chunk", units=2)
    s.update(idle=dict(s), rates={"untraced": 3.0, "ranges_only": 2.5,
                                  "host": 2.0}, rate_unit="steps/s")
    return s


def _reader(name):
    import run

    return run.metric_reader(HERE, name).read


def test_attribution_takes_the_innermost_span_on_the_launching_thread():
    s = summary()
    assert s["device_us"] == pytest.approx({
        "step.decode": 8, "step.rasterize": 1, "raster.bin": 3,
        "raster.composite_bwd": 3, "bwd:step.rasterize": 1,
        "bwd:step.decode": 3, "step.backward": 1, "-": 4})
    assert "x.narrow" not in s["device_us"]


def test_span_times_and_the_rest_sum_to_the_device_time():
    s = summary()
    assert s["total_us"] == pytest.approx(24)
    assert sum(s["device_us"].values()) == pytest.approx(s["total_us"])
    assert s["device_records"] == 10 and s["window_us"] == 110


def test_launches_waits_and_idle_match_hand_counts():
    s = summary()
    assert s["launches"] == 9
    assert s["syncs"] == 2
    assert s["sync_calls"] == {"cudaStreamSynchronize": 2}
    assert s["syncs_by_span"] == {"raster.bin": 1, "-": 1}
    assert s["syncs_by_op"] == {"aten::nonzero": 1, "-": 1}
    assert s["launches_by_span"] == {
        "step.decode": 1, "step.rasterize": 1, "raster.bin": 2,
        "raster.composite_bwd": 1, "bwd:step.rasterize": 1,
        "bwd:step.decode": 1, "step.backward": 1, "-": 1}
    assert s["idle_us"] == pytest.approx(110 - 24)
    # raster.bin [35, 50] less the kernels [38, 40] and [48, 49]
    assert s["idle_under_us"]["raster.bin"] == pytest.approx(12)
    # the program's spans cover [5, 90], 20 of it busy
    assert s["idle_under_spans_us"] == pytest.approx(85 - 20)
    run = types.SimpleNamespace(cache={"spans": s}, lines=[])
    got = {n: _reader(n)(run) for n in READERS}
    assert got == pytest.approx({
        # step.decode and its backward
        "decode_device_ms.train": (8 + 3) * 1e-3 / 2,
        # step.rasterize, raster.bin, raster.composite_bwd and the
        # backward of step.rasterize's _Composite
        "raster_device_ms.train": (1 + 3 + 3 + 1) * 1e-3 / 2,
        "update_device_ms.train": None,
        "launches_per_step.train": 4.5,
        "host_syncs_per_step.train": 1.0,
        "bin_idle_pct.anim": 100 * 12 / 86,
        "launches_per_frame.anim": 4.5,
        "host_syncs_per_frame.anim": 1.0}, nan_ok=False)
    # the ranges-only unit's idle time
    s["idle"]["idle_us"] = 24.0
    assert _reader("bin_idle_pct.anim")(run) == pytest.approx(50)


def test_a_trace_without_program_spans_reads_every_record_as_none():
    s = summary(program=False)
    assert s["device_us"] == pytest.approx({"-": 24})
    assert s["span_names"] == [] and s["idle_under_spans_us"] == 0
    run = types.SimpleNamespace(cache={"spans": s}, lines=[])
    got = {n: _reader(n)(run) for n in READERS}
    for n in ("decode_device_ms.train", "raster_device_ms.train",
              "update_device_ms.train", "bin_idle_pct.anim"):
        assert got[n] is None, n
    assert got["launches_per_step.train"] == 4.5
    assert got["host_syncs_per_frame.anim"] == 1.0
    assert all(line.startswith("[spans]") for line in spans.notes(s))


def test_the_window_needs_the_unit_range():
    ev = [e for e in trace() if e.get("name") != "chunk"]
    with pytest.raises(RuntimeError):
        spans.summarize(spans.parse(ev), "chunk", units=2)


def test_the_summary_is_made_once_a_run(monkeypatch):
    calls = []
    monkeypatch.setattr(spans, "_trace_units",
                        lambda run: calls.append(1) or summary())
    run = types.SimpleNamespace(cache={}, lines=[])
    for n in READERS:
        _reader(n)(run)
    assert calls == [1] and len(run.lines) == 7


def test_the_runner_module_is_the_one_the_caller_holds():
    runner = types.ModuleType("bench_runner_anim")

    def caller():
        return spans._runner("anim")

    assert caller() is runner
    with pytest.raises(RuntimeError):
        spans._runner("train")


def test_a_cpu_trace_gives_a_backward_operation_its_forward_span(tmp_path):
    """torch.profiler's own trace: the forward operations under
    step.decode, their backward ones (on the CPU, on the caller's thread
    inside step.backward) carry the same sequence numbers."""
    import json

    import torch

    x = torch.randn(32, 32, requires_grad=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("step.decode"):
            y = (x * 2).sin().sum()
        with torch.profiler.record_function("step.backward"):
            torch.autograd.grad(y, x)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as fh:
        parsed = spans.parse(json.load(fh)["traceEvents"])
    bwd = [o for o in parsed["ops"] if o[0] in ("MulBackward0",
                                                 "SinBackward0")]
    assert len(bwd) == 2 and all(o[4] is not None and o[5] for o in bwd)
    mids = [(o[3], 0.5 * (o[1] + o[2])) for o in bwd]
    assert spans._attribute(mids, parsed["ranges"], parsed["ops"]) == [
        "bwd:step.decode"] * 2
