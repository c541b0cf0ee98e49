"""Bilinear grid sampling (port of sings_tpu/ops/sampling.py).

Equivalent to grid_sample(mode='bilinear', padding_mode='border',
align_corners=True) on 2D grids, written out rather than calling
torch.nn.functional.grid_sample: the JAX package's clamped base corner
(x0 in [0, W-2]) and its corner-stacked gather table define the exact
arithmetic, and the triplane's nested path reuses both. The gradient is
autograd of this forward: the weight path for the coordinates (as in
JAX), a scatter-add for the grid (JAX sums the same terms in a sorted
segment reduction).
"""
from __future__ import annotations

import torch


def _corner_coords(coords: torch.Tensor, h: int, w: int):
    """Continuous -> clamped base-corner indices + fractional offsets."""
    x = (coords[:, 0] + 1.0) * 0.5 * (w - 1)
    y = (coords[:, 1] + 1.0) * 0.5 * (h - 1)
    x = x.clamp(0.0, w - 1)
    y = y.clamp(0.0, h - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x0 = x0.clamp(0, w - 2) if w > 1 else x0 * 0
    y0 = y0.clamp(0, h - 2) if h > 1 else y0 * 0
    tx = x - x0
    ty = y - y0
    return x0.long(), y0.long(), tx, ty


def _weights(tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    """(N, 4) bilinear corner weights [w00, w01, w10, w11]."""
    return torch.stack(
        [(1 - tx) * (1 - ty), tx * (1 - ty), (1 - tx) * ty, tx * ty], dim=1)


def _corner_table(grid: torch.Tensor) -> torch.Tensor:
    """(C, H, W) -> corner-stacked ((H-1)*(W-1), 4C) gather table."""
    c, h, w = grid.shape
    g = grid.permute(1, 2, 0)
    return torch.cat(
        [g[:-1, :-1], g[:-1, 1:], g[1:, :-1], g[1:, 1:]], dim=-1
    ).reshape((h - 1) * (w - 1), 4 * c)


def _combine(v: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """(N, 4, C) corner values x (N, 4) weights -> (N, C)."""
    return torch.einsum("nkc,nk->nc", v, wts)


def _sample_main(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    c, h, w = grid.shape
    x0i, y0i, tx, ty = _corner_coords(coords, h, w)
    g4 = _corner_table(grid)
    v = g4[y0i * (w - 1) + x0i].reshape(-1, 4, c)
    return _combine(v, _weights(tx, ty))


def _sample_degenerate(grid: torch.Tensor, coords: torch.Tensor):
    """h < 2 or w < 2: per-tap gathers."""
    c, h, w = grid.shape
    x0i, y0i, tx, ty = _corner_coords(coords, h, w)
    flat = grid.reshape(c, h * w)
    idx00 = y0i * w + x0i
    g00 = flat[:, idx00]
    g01 = flat[:, torch.clamp_max(idx00 + 1, h * w - 1)]
    g10 = flat[:, torch.clamp_max(idx00 + w, h * w - 1)]
    g11 = flat[:, torch.clamp_max(idx00 + w + 1, h * w - 1)]
    top = g00 * (1 - tx) + g01 * tx
    bot = g10 * (1 - tx) + g11 * tx
    return (top * (1 - ty) + bot * ty).T


def grid_sample_2d(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """grid (C, H, W), coords (N, 2) in [-1, 1] with coords[:, 0] = x
    (indexes W) and coords[:, 1] = y (indexes H) -> (N, C)."""
    _, h, w = grid.shape
    if h < 2 or w < 2:
        return _sample_degenerate(grid, coords)
    return _sample_main(grid, coords)
