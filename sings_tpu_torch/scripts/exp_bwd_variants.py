"""Bisect the backward's per-window formulas on the bench scene: v1
(three per-channel cumsums, nine per-pixel reductions), v3 (one
cotangent-weighted cumsum, the same reductions), v4 (v3 with moment
reductions), v2 (v4 with the TPU's K=3 matmul for gc; the same code on
the card). Counterpart of scripts/exp_bwd_variants.py, against the
current layout: grad_offsets and the zeroed (9, grad_cap) buffer.

    python -m sings_tpu_torch.scripts.exp_bwd_variants [--device cuda]

Times each variant, and composite_bwd on the same inputs, with
ops.timing.device_time (k1 1, k2 6, 2 repeats) and prints each variant's largest error against v1 after the un-sort
glue sums every gaussian's pairs, relative to v1's largest gradient.
Returns the numbers as a dict.
"""
from __future__ import annotations

import argparse

from ..device import resolve_device
from ..ops.rasterizer.api import unsort_pair_grads
from ..ops.rasterizer.kernels import composite_bwd
from ..ops.rasterizer.variants import VARIANTS, composite_bwd_variant
from ..ops.timing import device_time
from ._scene import HW, N, bench_scene


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--n", type=int, default=N)
    parser.add_argument("--hw", type=int, default=HW)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    sc = bench_scene(dev, n=args.n, hw=args.hw, gout="ones")
    outs, times = {}, {}
    for v in VARIANTS:
        def run(*a, v=v):
            return composite_bwd_variant(*a, variant=v, **sc.kw)

        outs[v] = run(*sc.args)
        times[v] = device_time(run, sc.args, k1=1, k2=6, repeats=2) * 1e3
        print(f"bwd {v}: {times[v]:.4f} ms", flush=True)

    def ref_fn(*a):
        return composite_bwd(*a, **sc.kw)

    ref_ms = device_time(ref_fn, sc.args, k1=1, k2=6, repeats=2) * 1e3
    print(f"production bwd kernel: {ref_ms:.4f} ms", flush=True)

    def reduce(o):
        o = o.clone()
        o[:, -1] = 0.0  # the spare slot that invalid pairs read
        return unsort_pair_grads(o, sc.binning, args.n)

    r1 = reduce(outs["v1"])
    errs = {}
    for v in VARIANTS[1:]:
        errs[v] = float((reduce(outs[v]) - r1).abs().max()
                        / (r1.abs().max() + 1e-12))
        print(f"{v} vs v1 max rel err: {errs[v]:.2e}", flush=True)
    return {"device": str(dev), "n": args.n, "hw": args.hw,
            "pairs": int(sc.binning.num_pairs), "ms": times,
            "composite_bwd_ms": ref_ms, "rel_err_vs_v1": errs}


if __name__ == "__main__":
    main()
