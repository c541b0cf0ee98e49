"""Per-window prefix-sum strategies, one CTA over one (128, 256) block:
the triangular product, a running cumsum, seven shift-adds, and one
triangular product over three payloads. Counterpart of
scripts/exp_cumsum_kernel.py (run on each mode).

    python -m sings_tpu_torch.scripts.exp_cumsum_kernel [--device cuda]

Times each mode's `steps` steps with ops.timing.device_time (k1 1, k2
6, 2 repeats) and prints the total and the time per step (one window's
scan). Returns the numbers as a dict.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..ops.scan_bench import CHUNK, MODES, NPX, STEPS, chunk_scan_bench
from ..ops.timing import device_time


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--steps", type=int, default=STEPS)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        CHUNK, NPX).astype(np.float32)).to(dev)
    modes = {}
    for mode in MODES:
        def run(x_, mode=mode):
            return chunk_scan_bench(x_, mode=mode, steps=args.steps)

        ms = device_time(run, (x,), k1=1, k2=6, repeats=2) * 1e3
        per = ms / args.steps * 1e3
        print(f"{mode}: {ms:.3f} ms total, {per:.4f} us/chunk", flush=True)
        modes[mode] = {"ms": ms, "us_per_chunk": per}
    return {"device": str(dev), "steps": args.steps, "modes": modes}


if __name__ == "__main__":
    main()
