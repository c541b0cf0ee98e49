"""The data-dependent work of one captured composite launch: the pairs
its tiles walk and the pair-pixels that composite, counted by the
reference's plain walk over the launch's own inputs; and the device
time of that launch in the trace."""
from __future__ import annotations

# the kernels' names in the profiler's records
FWD_KERNEL = ("fwd_window_kernel",)
BWD_KERNEL = ("bwd_kernel", "Production")


def _grid(kw: dict) -> dict:
    return {k: kw[k] for k in ("tile", "chunk", "n_tiles_x", "n_tiles_y")}


def fwd_counts(run) -> dict | None:
    """walked pairs, tiles and tile size of the first captured forward."""
    if "fwd" not in run.captured:
        return None
    if "fwd" not in run.cache:
        from reference.plain.ops.rasterizer.kernels import (
            composite_fwd_plain,
        )

        args, kw = run.captured["fwd"]
        _out, walked = composite_fwd_plain(args[0], args[1], **_grid(kw),
                                           return_walked=True)
        run.cache["fwd"] = {"walked": int(walked),
                            "n_tiles": kw["n_tiles_x"] * kw["n_tiles_y"],
                            "tile": kw["tile"]}
        run.lines.append(f"[counts] first composite_fwd: {run.cache['fwd']}")
    return run.cache["fwd"]


def bwd_counts(run) -> dict | None:
    """walked pairs, compositing pair-pixels, tiles, tile size and
    gradient slots of the first captured backward."""
    if "bwd" not in run.captured:
        return None
    if "bwd" not in run.cache:
        from reference.plain.ops.rasterizer.kernels import (
            composite_bwd_plain,
        )

        args, kw = run.captured["bwd"]
        _g, walked, composited = composite_bwd_plain(
            *args[:6], **_grid(kw), grad_cap=kw["grad_cap"],
            return_counts=True)
        run.cache["bwd"] = {"walked": int(walked),
                            "composited": int(composited),
                            "n_tiles": kw["n_tiles_x"] * kw["n_tiles_y"],
                            "tile": kw["tile"], "grad_cap": kw["grad_cap"]}
        run.lines.append(f"[counts] first composite_bwd: {run.cache['bwd']}")
    return run.cache["bwd"]


def first_launch_s(run, keys: tuple) -> float | None:
    """Device seconds of the first record in the traced window whose
    name holds every key."""
    hits = sorted((a, b) for n, a, b in run.trace.clipped()
                  if all(k in n for k in keys))
    return (hits[0][1] - hits[0][0]) / 1e6 if hits else None
