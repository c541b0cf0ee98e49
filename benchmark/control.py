#!/usr/bin/env python3
"""The controls of the comparison that decides `correct`: the reference
put in the program's place, computed in the next precision below the
configuration's float32 with TF32 off (TF32 on for matmuls and cuDNN),
or with one of the faults a cell can have planted in it, against the
reference itself. Each control has to fail one of the cell's numbers.

    python3 benchmark/control.py --workload <cell> --kind <kind>
        --seeds <n> [<n> ...]

kinds: tf32 (both cells); half_batch (complex-train: half of each
step's patches left out, the mean taken over the rest). The
benchmark's own runs never run this. It prints one line per seed with
the cell's numbers beside their limits, then a JSON line of them all.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _tf32(on: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def half_batch(draws: list) -> list:
    """Each step's draws with the second half of its patches left out."""
    out = []
    for d in draws:
        n = d["ys"].shape[0] // 2
        out.append(dict(d, ys=d["ys"][:n], xs=d["xs"][:n]))
    return out


def train_control(ctx, runner, kind: str) -> dict:
    from compare import train_numbers

    ri = runner.reference_inputs(ctx)
    ri["step0"] = ctx.traffic["step0"]
    _tf32(False)
    ref = runner.reference_steps(ri, ctx.device)
    if kind == "tf32":
        _tf32(True)
        got = runner.reference_steps(ri, ctx.device)
        _tf32(False)
    elif kind == "half_batch":
        got = runner.reference_steps(
            dict(ri, chunks=[(f, half_batch(d)) for f, d in ri["chunks"]]),
            ctx.device)
    else:
        raise ValueError(f"kind {kind!r} for a training cell")
    return train_numbers(got, ref)


def anim_control(ctx, runner, kind: str) -> dict:
    import torch

    from compare import frame_numbers
    from reference import build as RB
    from reference.anim import chunk_frames
    from reference.plain.data.anim import load_anim_dataset

    if kind != "tf32":
        raise ValueError(f"kind {kind!r} for an animation cell")
    ri = runner.reference_inputs(ctx)
    tf, dev = ctx.traffic, ctx.device
    av = RB.avatar(ri["cfg"], ri["smpl"], ri["weights"], dev)
    ds = load_anim_dataset(ri["motion"], "custom", 0, -1,
                           int(tf["motion_skip"]), tuple(tf["render_size"]),
                           fx=float(tf["focal"]), fy=float(tf["focal"]),
                           device=dev)
    bg = (torch.ones(3, device=dev) if ri["cfg"].bg_color == "white"
          else torch.zeros(3, device=dev))
    size = int(tf["chunk_frames"])
    starts = runner.check_starts(ctx, ds.num_frames, size)
    _tf32(False)
    ref = [chunk_frames(av, ds, s, size, bg) for s in starts]
    _tf32(True)
    got = [chunk_frames(av, ds, s, size, bg) for s in starts]
    _tf32(False)
    return frame_numbers(got, ref)


def main(argv=None, *, device=None, overrides=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--kind", required=True)
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
            print("control: no card", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    files = run.cell_files(ROOT, run.manifest(ROOT), args.workload)
    readings = {}
    for seed in args.seeds:
        ctx, runner = run.make_ctx(
            files, argparse.Namespace(seed=seed, seconds=0.0, trace=0),
            device, overrides, ROOT, time.time())
        control = {"train": train_control,
                   "anim": anim_control}[ctx.traffic["runner"]]
        try:
            numbers = control(ctx, runner, args.kind)
        finally:
            inputs.remove(ctx.tmp)
        readings[seed] = numbers
        fails = [k for k, v in numbers.items() if v > files["limits"][k]]
        print(f"[control] {args.workload} {args.kind} seed {seed}: "
              + ", ".join(f"{k} {v!r} (limit {files['limits'][k]!r})"
                          for k, v in numbers.items())
              + f"; fails {fails}", flush=True)
    print(json.dumps({"workload": args.workload, "kind": args.kind,
                      "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
