#!/usr/bin/env python3
"""The benchmark of sings_tpu_torch, the PyTorch/CUDA port of SinGS, on
NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout that holds BENCHMARK.json. The cell
(an entry of its `workloads`) names a configuration, whose file holds
the dotlist over the port's DEFAULTS, and a traffic mix,
benchmark/traffic/<mix>.json, whose `runner` key names the loop in
benchmark/runners/<runner>.py. Each run loads, makes its inputs on the
card from the seed, warms the cell's own shapes, then measures for
--seconds (--trace 0: the cell's end-to-end metrics) or traces a fixed
stretch of whole chunks (--trace 1: the cell's per-layer metrics, each
read by benchmark/metrics/<metric>.py), compares what the timed path
produced with the plain reference in benchmark/reference, and prints
one JSON object as its last line. It refuses to run without a card.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# one host thread for the intra-op and BLAS pools: the run is one process
# whose host side issues work to the card
THREAD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
              "OPENBLAS_NUM_THREADS": "1"}
# caches of the program's builds, at fixed paths inside the checkout
CACHE_ENV = {"TRITON_CACHE_DIR": os.path.join(ROOT, "build", "triton_cache"),
             "TORCH_EXTENSIONS_DIR": os.path.join(ROOT, "build",
                                                  "torch_extensions"),
             "CUDA_CACHE_PATH": os.path.join(ROOT, "build", "cuda_cache")}


def load_module(path: str, name: str):
    """A module of the benchmark found by its file name."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell_files(root: str, man: dict, name: str) -> dict:
    """The cell's entry, its configuration, traffic mix and limits, and
    the per-layer metrics it reports, each found by name under the
    checkout at root."""
    here = os.path.join(root, man["paths"][0])
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the manifest has "
                         f"{sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    with open(os.path.join(root, configs[cell["config"]]["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(here, "traffic", cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    with open(os.path.join(here, "limits", name + ".json")) as fh:
        limits = json.load(fh)
    e2e = [m for m in man["end_to_end"]
           if name in m.get("workloads", [name])]
    layer = [m for m in man["per_layer"]
             if name in m.get("workloads", [name])]
    return {"cell": cell, "config": config, "traffic": traffic,
            "limits": limits, "end_to_end": e2e, "per_layer": layer,
            "here": here}


def metric_reader(here: str, name: str):
    return load_module(os.path.join(here, "metrics", name + ".py"),
                       "bench_metric_" + name.replace(".", "_"))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 3) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None, *, device=None, overrides=None, root=ROOT,
         t_start=None) -> int:
    """Run one cell. device, overrides ({"config": extra dotlist,
    "traffic": keys}) and root are for the benchmark's own tests: a run
    from the command line takes the card and this checkout."""
    args = parse(argv)
    for k, v in {**THREAD_ENV, **CACHE_ENV}.items():
        os.environ[k] = v
    os.environ.setdefault("USE_FLAX", "0")
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    if ROOT not in sys.path:
        sys.path.insert(1, ROOT)
    files = cell_files(root, manifest(root), args.workload)
    cell = files["cell"]

    import torch

    import inputs

    if device is None:
        if not torch.cuda.is_available():
            return fail("torch.cuda.is_available() is False: this "
                        "benchmark runs only on a card")
        if torch.cuda.device_count() < int(cell["chips"]):
            return fail(f"{torch.cuda.device_count()} cards, the cell "
                        f"asks for {cell['chips']}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    ctx, runner = make_ctx(files, args, device, overrides, root,
                           T_START if t_start is None else t_start)
    try:
        return _run(ctx, runner, files, device)
    finally:
        inputs.remove(ctx.tmp)


def make_ctx(files: dict, args, device, overrides, root: str,
             t_start: float) -> tuple:
    """The run's context (the cell's files with the tests' overrides, a
    fresh directory) and the cell's runner module."""
    import common
    import inputs

    overrides = overrides or {}
    config = dict(files["config"])
    config["dotlist"] = list(config["dotlist"]) + list(
        overrides.get("config", []))
    traffic = dict(files["traffic"], **overrides.get("traffic", {}))
    runner = load_module(os.path.join(files["here"], "runners",
                                      traffic["runner"] + ".py"),
                         "bench_runner_" + traffic["runner"])
    ctx = common.Ctx(root=root, cell=files["cell"], config=config,
                     traffic=traffic, limits=files["limits"], seed=args.seed,
                     seconds=args.seconds, trace=bool(args.trace),
                     device=device, tmp=inputs.tmpdir(), t_start=t_start)
    return ctx, runner


def _run(ctx, runner, files, device) -> int:
    import torch

    import common

    on_card = device.type == "cuda"
    st = runner.setup(ctx)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # the reference's own set-up work (a runner's `reference_s`) is not
    # the program's
    setup_s = time.time() - ctx.t_start - getattr(st, "reference_s", 0.0)
    metrics = {}
    breakdown = None
    if not ctx.trace:
        res = runner.window(st, ctx.seconds)
        for name, (value, unit) in res["metrics"].items():
            metrics[name] = {"value": value, "unit": unit}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        want = {m["name"] for m in files["end_to_end"]}
        if set(metrics) != want:
            raise RuntimeError(f"the runner measured {sorted(metrics)}, "
                               f"the manifest asks {sorted(want)}")
    else:
        res = runner.traced(st, os.path.join(ctx.tmp, "trace.json"))
        run = common.Run(ctx=ctx, state=st, **res)
        for m in files["per_layer"]:
            value = metric_reader(files["here"], m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": res["trace"].top_kernels(),
                     "idle_gaps": res["gaps"]}
        for line in run.lines:
            ctx.note(line)
    dev_info = (common.device_info(int(ctx.cell["chips"])) if on_card
                else {"platform": "cpu", "kind": "cpu", "count": 1,
                      "memory_peak_bytes": 0})
    if ctx.trace:
        dev_info.update(busy_s=res["trace"].busy_s(),
                        window_s=res["trace"].window_s)
    runner.release(st)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    correct, lines = runner.check(st)
    loaded = common.forbidden_loaded()
    if loaded:
        return fail(f"loaded {loaded}: the run may load neither JAX nor "
                    "the JAX package", 4)
    for name, value, limit in lines:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr,
              flush=True)
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics,
           "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in lines}
    if not all(math.isfinite(v["value"]) for v in metrics.values()):
        return fail(f"a metric is not finite: {metrics}", 4)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
