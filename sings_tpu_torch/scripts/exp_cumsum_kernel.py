"""Per-window prefix-sum strategies over one (128, 256) block: the
triangular product, a running cumsum, seven shift-adds, and one
triangular product over three payloads. Counterpart of
scripts/exp_cumsum_kernel.py (run on each mode).

    python -m sings_tpu_torch.scripts.exp_cumsum_kernel [--device cuda]
        [--steps N] [--ctas P]

The steps are shared by `ctas` CTAs (ops/scan_bench.py): by default the
card's SM count on a GPU, 1 on the CPU; --ctas 1 gives one window's
scan inside one CTA. Times each mode's `steps` steps with
ops.timing.device_time (k1 1, k2 6, 2 repeats) and prints the total and
the time per step. Returns the numbers as a dict.
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
    parser.add_argument("--ctas", type=int, default=None,
                        help="CTAs sharing the steps (default: the SM "
                             "count on a GPU, 1 on the CPU)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    ctas = args.ctas
    if ctas is None:
        ctas = (torch.cuda.get_device_properties(dev).multi_processor_count
                if dev.type == "cuda" else 1)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        CHUNK, NPX).astype(np.float32)).to(dev)
    modes = {}
    for mode in MODES:
        def run(x_, mode=mode):
            return chunk_scan_bench(x_, mode=mode, steps=args.steps,
                                    ctas=ctas)

        ms = device_time(run, (x,), k1=1, k2=6, repeats=2) * 1e3
        per = ms / args.steps * 1e3
        print(f"{mode}: {ms:.3f} ms total, {per:.4f} us/chunk "
              f"({ctas} CTAs)", flush=True)
        modes[mode] = {"ms": ms, "us_per_chunk": per}
    return {"device": str(dev), "steps": args.steps, "ctas": ctas,
            "modes": modes}


if __name__ == "__main__":
    main()
