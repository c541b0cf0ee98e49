"""K nearest neighbours, dense (port of sings_tpu/ops/knn.py::knn).

A blocked |a|^2 + |b|^2 - 2 a.b distance matrix, one matmul and one
top-k per block of queries. The JAX package's approx=True asks the
TPU's approximate top-k; on other backends JAX computes the exact
top-k, and so does the port. knn_window_stat and knn_rows are not
ported yet.
"""
from __future__ import annotations

import torch


def knn(points: torch.Tensor, k: int, *, valid: torch.Tensor | None = None,
        block: int = 4096):
    """K nearest neighbours of each point among all points, self
    included; invalid points (valid False) are never neighbours.
    Returns (squared distances ascending, clamped at 0; indices), both
    (N, k)."""
    n = points.shape[0]
    sq = torch.sum(points * points, dim=-1)
    dists, idx = [], []
    for s in range(0, n, block):
        q = points[s: s + block]
        d2 = sq[s: s + block, None] + sq[None, :] - 2.0 * (q @ points.T)
        if valid is not None:
            d2 = torch.where(valid[None, :], d2,
                             torch.full_like(d2, float("inf")))
        d, i = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        dists.append(d)
        idx.append(i)
    return torch.clamp_min(torch.cat(dists), 0.0), torch.cat(idx)
