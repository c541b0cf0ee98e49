#!/usr/bin/env python3
"""The controls of the options cell (complex-options), as control.py
makes them for the other cells: the reference put in the program's
place with one fault planted, against the reference itself, on the
cell's own numbers (runners/train_options.py: control.py's five,
lpips_gap and connect_gap). Each control has to fail one of them.

    python3 benchmark/control_options.py --kind <kind>
        --seeds <n> [<n> ...]

kinds: tf32 (the whole reference with TF32 on for matmuls and cuDNN);
tf32_vgg (TF32 on for cuDNN in the LPIPS distance's forward and in its
input gradient's backward alone: the VGG16 convolutions both ways);
lpips_no_grad (the LPIPS term's value kept, its gradient cut);
half_batch (half of each step's patches left out, the mean taken over
the rest). The reference's LPIPS weights are the seed's
(runners/train_options.py::lpips_weights), as the cell draws them.
The benchmark's own runs never run this. It prints one line per seed
with the cell's numbers beside their limits, then a JSON line of them
all.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CELL = "complex-options"
KINDS = ("tf32", "tf32_vgg", "lpips_no_grad", "half_batch")


@contextlib.contextmanager
def _cudnn_tf32():
    import torch

    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = False


def _vgg_in_tf32(plain):
    """The LPIPS distance `plain` with cuDNN's TF32 on in its forward and
    in the backward to its predicted patches, which the step's
    autograd.grad runs later, outside the call: the distance runs on a
    detached copy of the patches inside an autograd.Function whose
    backward takes that copy's gradient with TF32 on."""
    import torch

    class VGGInTF32(torch.autograd.Function):
        @staticmethod
        def forward(ctx, params, x, y):
            with torch.enable_grad(), _cudnn_tf32():
                xg = x.detach().requires_grad_(True)
                d = plain(params, xg, y)
            ctx.graph = (xg, d)
            return d.detach()

        @staticmethod
        def backward(ctx, g):
            xg, d = ctx.graph
            with _cudnn_tf32():
                (gx,) = torch.autograd.grad(d, xg, g)
            return None, gx, None

    return VGGInTF32.apply


def _without_grad(plain):
    """The LPIPS distance `plain` on detached predicted patches: the same
    value, no gradient."""
    return lambda params, x, y: plain(params, x.detach(), y)


@contextlib.contextmanager
def _lpips_as(wrap):
    """The reference's options step calls wrap(its LPIPS distance)."""
    from reference.plain.train import step_options

    plain = step_options.lpips_distance
    step_options.lpips_distance = wrap(plain)
    try:
        yield
    finally:
        step_options.lpips_distance = plain


def options_control(ctx, runner, kind: str) -> dict:
    from control import _tf32, half_batch

    ri = runner.reference_inputs(ctx)
    ri["step0"] = ctx.traffic["step0"]
    ri["lpips"] = runner.lpips_weights(ctx.seed, ctx.device)
    _tf32(False)
    ref = runner.reference_steps(ri, ctx.device)
    if kind == "tf32":
        _tf32(True)
        got = runner.reference_steps(ri, ctx.device)
        _tf32(False)
    elif kind in ("tf32_vgg", "lpips_no_grad"):
        wrap = _vgg_in_tf32 if kind == "tf32_vgg" else _without_grad
        with _lpips_as(wrap):
            got = runner.reference_steps(ri, ctx.device)
    elif kind == "half_batch":
        got = runner.reference_steps(
            dict(ri, chunks=[(f, half_batch(d)) for f, d in ri["chunks"]]),
            ctx.device)
    else:
        raise ValueError(f"kind {kind!r}; the kinds are {KINDS}")
    return runner.numbers(got, ref)


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
            print("control_options: no card", file=sys.stderr)
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
            numbers = options_control(ctx, runner, args.kind)
        finally:
            inputs.remove(ctx.tmp)
        readings[seed] = numbers
        fails = [k for k, v in numbers.items() if v > limits[k]]
        print(f"[control] {CELL} {args.kind} seed {seed}: "
              + ", ".join(f"{k} {v!r} (limit {limits[k]!r})"
                          for k, v in numbers.items())
              + f"; fails {fails}", flush=True)
    print(json.dumps({"workload": CELL, "kind": args.kind,
                      "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
