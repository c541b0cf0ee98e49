"""The KNN edge statistic over Morton-curve candidate windows (port of
sings_tpu/ops/knn.py's knn_window_stat and morton3d): after a stable
sort of the 30-bit Morton codes, each block of `block` sorted points
searches the `block + window` sorted positions around it with one
|a|^2 + |b|^2 - 2 a.b distance block and a top-k. Approximate: a curve
discontinuity can hide a true neighbour, so it never underestimates the
exact statistic. The port keeps this torch path on every device; the
copy departs from it only in raising ValueError where the port asserts
that the blocks tile the points.
"""
from __future__ import annotations

import torch

from .knn import _sum_squares

# blocks that share one batched matmul and top-k (memory only: every
# block's arithmetic is its own)
BLOCKS_PER_PASS = 64


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd bit (Morton interleave helper)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton3d(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N, 3) -> (N,) int32 30-bit Morton codes over the valid points'
    bounding box, in uniform cells (the largest extent over 1023);
    invalid points get INT32_MAX so that they sort to the end."""
    big = 3.0e38
    v = valid[:, None]
    lo = torch.where(v, points, torch.full_like(points, big)).amin(dim=0)
    hi = torch.where(v, points, torch.full_like(points, -big)).amax(dim=0)
    ext = torch.clamp_min((hi - lo).max(), 1e-9)
    q = torch.clamp((points - lo) / ext * 1023.0, 0.0, 1023.0).to(
        torch.int32)
    code = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
            | (_spread3(q[:, 2]) << 2))
    return torch.where(valid, code, torch.full_like(code, 2 ** 31 - 1))


@torch.no_grad()
def knn_window_stat(points: torch.Tensor, k: int, *,
                    valid: torch.Tensor | None = None, window: int = 256,
                    block: int = 256) -> torch.Tensor:
    """Mean distance to the K-1 nearest neighbours (self among the k),
    per point, over the candidate windows. Returns (N,) in the original
    point order; invalid points get 0."""
    n = points.shape[0]
    if n % block:
        raise ValueError(f"knn_window_stat: {n} points in blocks of {block}")
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=points.device)
    order = torch.sort(morton3d(points, valid), stable=True).indices
    ps = points[order]
    pv = valid[order]
    sq = _sum_squares(ps)
    cand = min(block + window, n)
    nblocks = n // block
    starts = torch.arange(nblocks, device=points.device) * block
    cstarts = torch.clamp(starts - window // 2, 0, max(n - cand, 0))
    ar = torch.arange(cand, device=points.device)
    out = []
    for b0 in range(0, nblocks, BLOCKS_PER_PASS):
        cidx = cstarts[b0: b0 + BLOCKS_PER_PASS, None] + ar   # (b, cand)
        q = ps[b0 * block: (b0 + cidx.shape[0]) * block].reshape(
            -1, block, 3)
        qsq = sq[b0 * block: (b0 + cidx.shape[0]) * block].reshape(
            -1, block)
        d2 = qsq[:, :, None] + sq[cidx][:, None, :] - 2.0 * torch.bmm(
            q, ps[cidx].transpose(1, 2))
        d2 = torch.where(pv[cidx][:, None, :], d2,
                         torch.full_like(d2, float("inf")))
        d = torch.topk(d2, k, dim=2, largest=False, sorted=True).values
        out.append(torch.sqrt(torch.clamp_min(d[..., 1:], 1e-24)).mean(
            dim=2).reshape(-1))
    stat_sorted = torch.where(pv, torch.cat(out), torch.zeros_like(sq))
    stat = torch.empty_like(stat_sorted)
    stat[order] = stat_sorted
    return stat
