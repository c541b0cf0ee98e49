"""A/B the backward's per-window reduction on the bench scene: the
production composite_bwd (lane reductions with the u/v CSE) against
composite_bwd_moments (moments of dl_dpow against the pixel basis,
combined per pair). Counterpart of scripts/exp_bwd_moments.py::main.

    python -m sings_tpu_torch.scripts.exp_bwd_moments [--device cuda]

Checks the moments kernel against composite_bwd on the written slots
(the main and tail tables, minus the spare) at the script's 2e-4 *
max(scale, 1), then times both with ops.timing.device_time (k1 2, k2
10). Returns the numbers as a dict.
"""
from __future__ import annotations

import argparse

from ..device import resolve_device
from ..ops.rasterizer.kernels import composite_bwd
from ..ops.rasterizer.variants import composite_bwd_moments
from ..ops.timing import device_time
from ._scene import HW, N, bench_scene, written_slots

RTOL = 2e-4


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--n", type=int, default=N)
    parser.add_argument("--hw", type=int, default=HW)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    sc = bench_scene(dev, n=args.n, hw=args.hw, gout="rand")

    def ref_fn(*a):
        return composite_bwd(*a, **sc.kw)

    def got_fn(*a):
        return composite_bwd_moments(*a, **sc.kw)

    ref, got = ref_fn(*sc.args), got_fn(*sc.args)
    slots = written_slots(sc.binning)
    r, g = ref[:, slots], got[:, slots]
    scale = float(r.abs().max())
    diff = float((r - g).abs().max())
    print("max abs diff:", diff, "scale:", scale, flush=True)
    if not diff < RTOL * max(scale, 1.0):
        raise AssertionError(f"MISMATCH: {diff} >= {RTOL} * max({scale}, 1)")
    ta = device_time(ref_fn, sc.args, k1=2, k2=10) * 1e3
    tb = device_time(got_fn, sc.args, k1=2, k2=10) * 1e3
    print(f"production bwd kernel: {ta:.4f} ms", flush=True)
    print(f"moment-matmul bwd kernel: {tb:.4f} ms", flush=True)
    return {"device": str(dev), "n": args.n, "hw": args.hw,
            "pairs": int(sc.binning.num_pairs), "slots": int(slots.numel()),
            "max_abs_diff": diff, "scale": scale, "composite_bwd_ms": ta,
            "composite_bwd_moments_ms": tb}


if __name__ == "__main__":
    main()
