"""The comparisons that decide `correct`: the numbers a cell compares
between the program's output and the reference's, each against the
limit in benchmark/limits/<cell>.json."""
from __future__ import annotations

from statistics import median

import numpy as np
import torch

from common import rel_gap

ADAM_B1 = 0.9
# leaves whose reference gradient is under this share of the median
# leaf's move by round-off alone under Adam: left out of the change
ZERO_GRAD_SHARE = 1e-3


def _norms(leaves) -> list:
    return [float(torch.linalg.vector_norm(x.double())) for x in leaves]


def train_numbers(prog: dict, ref: dict, where: dict | None = None) -> dict:
    """prog and ref: 'losses' of the checked steps, 'mu1' the first
    moments after the first step, 'p0' and 'p1' the parameters before
    and after the checked steps, 'mu' and 'nu' the moments after them
    (leaves in one order). Returns
    loss_gap: the largest relative gap of a step's loss;
    grad_gap: the worst leaf's gap between the first gradient's norms
      (mu1 / (1 - b1)), over the larger of the reference's norm of that
      leaf and of the median leaf;
    change_gap: the same for the norm of the parameters' change, over
      the leaves whose reference gradient is not nought;
    mu_gap, nu_gap: the same for the norms of the moments after the
      checked steps, over every leaf.
    where, if given, gets the step or leaf index behind each number."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the two sides took different numbers of steps")
    out, at = {}, {}
    out["loss_gap"], at["loss_gap"] = _worst(prog["losses"], ref["losses"],
                                             0.0)
    g_p = [n / (1 - ADAM_B1) for n in _norms(prog["mu1"])]
    g_r = [n / (1 - ADAM_B1) for n in _norms(ref["mu1"])]
    g_med = median(g_r)
    out["grad_gap"], at["grad_gap"] = _worst(g_p, g_r, g_med)
    d_p = _norms([b - a for a, b in zip(prog["p0"], prog["p1"])])
    d_r = _norms([b - a for a, b in zip(ref["p0"], ref["p1"])])
    keep = [i for i, g in enumerate(g_r) if g >= ZERO_GRAD_SHARE * g_med]
    out["change_gap"], at["change_gap"] = _worst(
        [d_p[i] for i in keep], [d_r[i] for i in keep],
        median([d_r[i] for i in keep]), keep)
    for key in ("mu", "nu"):
        n_r = _norms(ref[key])
        out[key + "_gap"], at[key + "_gap"] = _worst(_norms(prog[key]), n_r,
                                                     median(n_r))
    if where is not None:
        where.update(at)
    return out


def _worst(got: list, want: list, floor: float, index=None) -> tuple:
    """The largest rel_gap over pairs, and its index (in `index` if
    given)."""
    gaps = [rel_gap(a, b, floor) for a, b in zip(got, want)]
    i = max(range(len(gaps)), key=gaps.__getitem__)
    return gaps[i], (i if index is None else index[i])


def frame_numbers(prog: list, ref: list) -> dict:
    """prog and ref: lists of (b, H, W, 3) uint8 chunks. Returns
    off_share: the share of values more than one level apart;
    max_levels: the largest difference in levels."""
    off, total, worst = 0, 0, 0
    for a, b in zip(prog, ref):
        if a.shape != b.shape:
            return {"off_share": 1.0, "max_levels": 255.0}
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        off += int((d > 1).sum())
        total += d.size
        worst = max(worst, int(d.max()))
    return {"off_share": off / max(total, 1), "max_levels": float(worst)}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, lines): every number at or under its limit; a number
    that is not finite fails."""
    lines, ok = [], True
    for name, value in numbers.items():
        limit = float(limits[name])
        good = bool(np.isfinite(value)) and value <= limit
        ok = ok and good
        lines.append((name, float(value), limit))
    return ok, lines
