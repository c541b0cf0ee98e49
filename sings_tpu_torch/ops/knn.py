"""K nearest neighbours (port of sings_tpu/ops/knn.py).

knn: a blocked |a|^2 + |b|^2 - 2 a.b distance matrix, one matmul and
one top-k per block of queries. The JAX package's approx=True asks the
TPU's approximate top-k; on other backends JAX computes the exact
top-k, and so does the port.

knn_window_stat: the KNN edge statistic over Morton-curve candidate
windows, O(N (window + block)) instead of O(N^2), approximate (a curve
discontinuity can hide a true neighbour, so the statistic never
underestimates the exact one). The codes are JAX's bit for bit
(morton3d quantises in its float order and truncates to int32) and the
sort is stable as jnp.argsort is, so both packages search the same
windows. knn_rows is knn restricted to a range of query rows (the
gs-sharded step's split of the statistic); its rows equal knn's.
"""
from __future__ import annotations

import torch


def _sum_squares(p: torch.Tensor) -> torch.Tensor:
    """sum(p * p, -1) over 3 components in XLA's order, a chain of fused
    multiply-adds (each product exact in float64, one rounding per
    step), so that the distances cancel as in the JAX package."""
    d = p.double()
    acc = (p[:, 0] * p[:, 0]).double()
    for i in (1, 2):
        acc = (acc + d[:, i] * d[:, i]).float().double()
    return acc.float()


def knn(points: torch.Tensor, k: int, *, valid: torch.Tensor | None = None,
        block: int = 4096):
    """K nearest neighbours of each point among all points, self
    included; invalid points (valid False) are never neighbours.
    Returns (squared distances ascending, clamped at 0; indices), both
    (N, k)."""
    n = points.shape[0]
    sq = _sum_squares(points)
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


def knn_rows(points: torch.Tensor, k: int, *, row_start: int, rows: int,
             valid: torch.Tensor | None = None, block: int = 4096):
    """knn restricted to the queries [row_start, row_start + rows); the
    candidates are still all points. The query range is padded up to a
    whole number of min(block, rows)-row blocks by a clamped row gather
    (the pad rows are dropped), as in the JAX package. Returns (rows, k)
    squared distances and indices, equal to knn's rows."""
    n = points.shape[0]
    sq = _sum_squares(points)
    bl = min(block, rows)
    nblocks = -(-rows // bl)
    inf = torch.full((), float("inf"), device=points.device)
    dists, idx = [], []
    for b in range(nblocks):
        qi = torch.clamp(row_start + b * bl + torch.arange(
            bl, device=points.device), 0, n - 1)
        d2 = sq[qi, None] + sq[None, :] - 2.0 * (points[qi] @ points.T)
        if valid is not None:
            d2 = torch.where(valid[None, :], d2, inf)
        d, i = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        dists.append(d)
        idx.append(i)
    return (torch.clamp_min(torch.cat(dists)[:rows], 0.0),
            torch.cat(idx)[:rows])


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


# blocks of knn_window_stat that share one batched matmul and top-k
# (memory only: every block's arithmetic is its own)
BLOCKS_PER_PASS = 64


@torch.no_grad()
def knn_window_stat(points: torch.Tensor, k: int, *,
                    valid: torch.Tensor | None = None, window: int = 256,
                    block: int = 256) -> torch.Tensor:
    """Mean distance to the K-1 nearest neighbours (self among the k, as
    in knn), per point, over Morton-curve candidate windows: after a
    stable sort along the curve, each block of `block` sorted points
    searches the `block + window` sorted positions around it. Returns
    (N,) in the original point order; invalid points get 0."""
    n = points.shape[0]
    assert n % block == 0, (n, block)
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
