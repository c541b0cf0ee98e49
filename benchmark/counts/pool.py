"""Analytic float32 operations of a case-step of the pool cell
(configuration human_complex_pool2), kept with the benchmark:
counts/flops.py's train_step, with the exact statistic's term taken
whole (KNN_OPS per distance over N_live^2, every step) in place of its
share of a chunk (N_live^2 / k): the case step computes the exact
statistic in every step of every case."""
from __future__ import annotations

from . import flops


def knn_stat_ops(n_live: int) -> float:
    return flops.KNN_OPS * n_live * n_live


def case_step(s: dict) -> float:
    """s: flops.train_step's keys, for one case."""
    return (flops.train_step(s) - knn_stat_ops(s["n_live"]) / s["k"]
            + knn_stat_ops(s["n_live"]))
