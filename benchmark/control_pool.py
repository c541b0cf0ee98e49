#!/usr/bin/env python3
"""The controls of the pool cell (complex-pool2), as control.py makes
them for the other cells: the reference put in the program's place for
every case, with one fault planted, against the reference itself, on
the cell's five numbers, each at its worst over the cases
(runners/pool.py). Each control but the last has to fail one of them.

    python3 benchmark/control_pool.py --kind <kind> --seeds <n> [<n> ...]

kinds: tf32 (each case's reference with TF32 on for matmuls and
cuDNN); half_batch (half of each step's patches left out, the mean
taken over the rest); swap_draws (the cases' draws exchanged: case 0
stepped with case 1's draws and case 1 with case 0's); stat_once (the
exact statistic taken once a checked call, at its head, as complex-train
takes it once a chunk, in place of every step: recorded, whatever it
shows). The benchmark's own runs never run this. It prints one line per
seed with the cell's numbers beside their limits, then a JSON line of
them all.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CELL = "complex-pool2"
KINDS = ("tf32", "half_batch", "swap_draws", "stat_once")


def _steps(ri: dict, step0: int, device, cfg=None, chunks=None) -> dict:
    """A case's checked steps by the reference, from its own inputs with
    the given configuration (its own: the exact statistic every step)
    and checked calls."""
    import inputs
    from reference import build as RB
    from reference.pool import case_steps
    from reference.train import checked_steps

    chunks = ri["chunks"] if chunks is None else chunks
    weights = inputs.clone_weights(ri["weights"])
    if cfg is None:
        return case_steps(ri["cfg"], ri["smpl"], weights, ri["camera"],
                          ri["images"], ri["masks"], chunks, step0, device)
    av = RB.avatar(cfg, ri["smpl"], weights, device)
    tr = RB.training(av, ri["camera"], device)
    return checked_steps(av, tr, ri["images"].to(device),
                         ri["masks"].to(device), chunks, step0)


def pool_control(ctx, runner, kind: str) -> dict:
    from compare import train_numbers
    from control import _tf32, half_batch
    from reference import build as RB

    step0 = int(ctx.traffic["step0"])
    n = int(ctx.config["cases"])
    cases = [runner.case_inputs(ctx, c) for c in range(n)]
    per_case = []
    for c, ri in enumerate(cases):
        _tf32(False)
        ref = _steps(ri, step0, ctx.device)
        if kind == "tf32":
            _tf32(True)
            got = _steps(ri, step0, ctx.device)
            _tf32(False)
        elif kind == "half_batch":
            got = _steps(ri, step0, ctx.device, chunks=[
                (f, half_batch(d)) for f, d in ri["chunks"]])
        elif kind == "swap_draws":
            other = cases[(c + 1) % n]
            got = _steps(ri, step0, ctx.device, chunks=[
                (f, d) for (f, _d), (_f, d) in zip(ri["chunks"],
                                                   other["chunks"])])
        elif kind == "stat_once":
            got = _steps(ri, step0, ctx.device, cfg=RB.config(
                runner.program_dotlist(ctx, c) + ["tpu.knn_backend=chunk"]))
        else:
            raise ValueError(f"kind {kind!r}; the kinds are {KINDS}")
        per_case.append(train_numbers(got, ref))
    return {k: runner._worst([p[k] for p in per_case]) for k in per_case[0]}


def main(argv=None, *, device=None, overrides=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kind", required=True, choices=KINDS)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for p in (HERE, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    import inputs
    import run

    if device is None:
        if not torch.cuda.is_available():
            print("control_pool: no card", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    files = run.cell_files(ROOT, run.manifest(ROOT), CELL)
    limits = files["limits"]
    readings = {}
    for seed in args.seeds:
        ctx, runner = run.make_ctx(
            files, argparse.Namespace(seed=seed, seconds=0.0, trace=0),
            device, overrides, ROOT, time.time())
        try:
            numbers = pool_control(ctx, runner, args.kind)
        finally:
            inputs.remove(ctx.tmp)
        readings[seed] = numbers
        fails = [k for k, v in numbers.items() if not v <= limits[k]]
        print(f"[control] {CELL} {args.kind} seed {seed}: "
              + ", ".join(f"{k} {v!r} (limit {limits[k]!r})"
                          for k, v in numbers.items())
              + f"; fails {fails}", flush=True)
    print(json.dumps({"workload": CELL, "kind": args.kind,
                      "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
