"""Bilinear grid sampling (port of sings_tpu/ops/sampling.py).

Equivalent to grid_sample(mode='bilinear', padding_mode='border',
align_corners=True) on 2D grids, written out rather than calling
torch.nn.functional.grid_sample: the JAX package's clamped base corner
(x0 in [0, W-2]) and its corner-stacked gather table define the exact
arithmetic, and the triplane's nested path reuses both.

The gradient is _SampleGrid, the counterpart of JAX's _sample_cvjp:
ops/grid_grad.py::triplane_backward on one plane without the product
rule (a CUDA kernel on the card, its plain version on the CPU):
  * to the coordinates, the bilinear weight path by hand (the integer
    corner indices carry no gradient), through the border clip with
    jnp.clip's gradient (ops/clip.py: half the cotangent at a bound it
    equals);
  * to the grid, the per-cell sums of weight x cotangent and the corner
    unstack, where JAX sorts by cell and differences a blocked cumsum.
The forward keeps the grid, the coordinates and the cells, no corner
rows. The degenerate planes (h < 2 or w < 2) stay autograd, as in JAX.
"""
from __future__ import annotations

import torch

from . import grid_grad as GG
from .bilinear import _combine, _corner_coords, _corner_table, _weights


def _sample_main(grid: torch.Tensor, coords: torch.Tensor):
    """Samples (N, C), corner rows (N, 4, C), cells (N,), tx, ty."""
    c, h, w = grid.shape
    x0i, y0i, tx, ty = _corner_coords(coords, h, w)
    cell = y0i * (w - 1) + x0i
    v = _corner_table(grid)[cell].reshape(-1, 4, c)
    return _combine(v, _weights(tx, ty)), v, cell, tx, ty


class _SampleGrid(torch.autograd.Function):
    """grid_sample_2d on a plane of h, w >= 2 (JAX's _sample_cvjp)."""

    @staticmethod
    def forward(ctx, grid, coords):
        out, _v, cell, _tx, _ty = _sample_main(grid, coords)
        ctx.save_for_backward(grid, coords, cell.to(torch.int32))
        return out

    @staticmethod
    def backward(ctx, gout):
        grid, coords, cell = ctx.saved_tensors
        _, h, w = grid.shape
        layout = GG.Layout(planes=((h, w),),
                           groups=(GG.Group("cells", (0,)),))
        d_coords, (d_grid,) = GG.triplane_backward(
            ((0, 1, h, w),), coords, [grid], GG.Saved([], [cell], layout),
            gout, product=False)
        return (d_grid if ctx.needs_input_grad[0] else None,
                d_coords if ctx.needs_input_grad[1] else None)


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
    return _SampleGrid.apply(grid, coords)
