"""Analytic float32 operations of a training step of the options cell
(configuration human_complex_options), kept with the benchmark:
counts/flops.py's train_step, with the exact statistic's term (KNN_OPS
per distance over N_live^2 a chunk) taken out and, in its place, the
windowed statistic every step and the LPIPS term (counts/lpips.py).

The windowed statistic (reference/plain/ops/knn_window.py) takes every
slot of the buffers, N, live or not, in blocks of `block` sorted points,
each against `min(block + window, N)` candidates: N * min(block +
window, N) distances of KNN_OPS operations each (the dot product's
2 * 3 in the batched matmul, as torch.utils.flop_counter counts it, and
the norms' add and the scaled subtract), the top-k left out. The
cotangent laplacian is counted as flops.REG_OPS counts the uniform one.
"""
from __future__ import annotations

from . import flops, lpips


def window_distances(n: int, block: int = 256, window: int = 256) -> int:
    return n * min(block + window, n)


def window_stat_ops(n: int, block: int = 256, window: int = 256) -> int:
    return flops.KNN_OPS * window_distances(n, block, window)


def train_step(s: dict) -> float:
    """s: flops.train_step's keys, and capacity (the statistic's N)."""
    return (flops.train_step(s)
            - flops.KNN_OPS * s["n_live"] * s["n_live"] / s["k"]
            + window_stat_ops(s["capacity"])
            + lpips.step_ops(s["patches"], s["patch"]))
