"""Bilinear grid sampling (port of sings_tpu/ops/sampling.py).

Equivalent to grid_sample(mode='bilinear', padding_mode='border',
align_corners=True) on 2D grids, written out rather than calling
torch.nn.functional.grid_sample: the JAX package's clamped base corner
(x0 in [0, W-2]) and its corner-stacked gather table define the exact
arithmetic, and the triplane's nested path reuses both.

The gradient is _SampleGrid, the counterpart of JAX's _sample_cvjp:
  * to the coordinates, the bilinear weight path by hand (the integer
    corner indices carry no gradient), through the border clip with
    jnp.clip's gradient (_clip: half the cotangent at a bound it equals);
  * to the grid, the per-cell sums of weight x cotangent and the corner
    unstack of ops/grid_grad.py (a CUDA kernel on the card, its plain
    version on the CPU), where JAX sorts by cell and differences a
    blocked cumsum.
The degenerate planes (h < 2 or w < 2) stay autograd, as in JAX.
"""
from __future__ import annotations

import torch

from . import grid_grad as GG


def _clip_factor(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """d clip(x, lo, hi) / dx as JAX differentiates jnp.clip =
    minimum(maximum(x, lo), hi): 1 inside, 1/2 at a bound x equals (1/4
    when x == lo == hi), 0 outside."""
    one, half, zero = (torch.ones_like(x), torch.full_like(x, 0.5),
                       torch.zeros_like(x))
    f_lo = torch.where(x > lo, one, torch.where(x == lo, half, zero))
    y = torch.clamp_min(x, lo)
    f_hi = torch.where(y < hi, one, torch.where(y == hi, half, zero))
    return f_lo * f_hi


class _Clip(torch.autograd.Function):
    """x.clamp(lo, hi) with jnp.clip's gradient (torch.clamp passes the
    whole cotangent at a bound)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return x.clamp(lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * _clip_factor(x, *ctx.bounds), None, None


def _unit(coords: torch.Tensor, h: int, w: int):
    """[-1, 1] -> continuous grid coordinates, before the border clip."""
    x = (coords[:, 0] + 1.0) * 0.5 * (w - 1)
    y = (coords[:, 1] + 1.0) * 0.5 * (h - 1)
    return x, y


def _corner_coords(coords: torch.Tensor, h: int, w: int):
    """Continuous -> clamped base-corner indices + fractional offsets."""
    x, y = _unit(coords, h, w)
    x = _Clip.apply(x, 0.0, float(w - 1))
    y = _Clip.apply(y, 0.0, float(h - 1))
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


def _coord_grad(coords: torch.Tensor, h: int, w: int, tx, ty,
                v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(N, 2) d coords of sum(g * combine(v, weights(tx, ty))): the weight
    path that JAX's _sample_bwd differentiates with jax.vjp, by hand.
    v: (N, 4, C) corner rows, g: (N, C) cotangent."""
    dw = torch.einsum("nc,nkc->nk", g, v)
    d_tx = (dw[:, 1] - dw[:, 0]) * (1 - ty) + (dw[:, 3] - dw[:, 2]) * ty
    d_ty = (dw[:, 2] - dw[:, 0]) * (1 - tx) + (dw[:, 3] - dw[:, 1]) * tx
    x, y = _unit(coords, h, w)
    d_x = d_tx * _clip_factor(x, 0.0, float(w - 1)) * (0.5 * (w - 1))
    d_y = d_ty * _clip_factor(y, 0.0, float(h - 1)) * (0.5 * (h - 1))
    return torch.stack([d_x, d_y], dim=1)


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
        out, v, cell, tx, ty = _sample_main(grid, coords)
        ctx.save_for_backward(coords, v, cell, tx, ty)
        ctx.shape = tuple(grid.shape)
        return out

    @staticmethod
    def backward(ctx, gout):
        coords, v, cell, tx, ty = ctx.saved_tensors
        c, h, w = ctx.shape
        gout = gout.contiguous()
        d_grid = d_coords = None
        if ctx.needs_input_grad[1]:
            d_coords = _coord_grad(coords, h, w, tx, ty, v, gout)
        if ctx.needs_input_grad[0]:
            layout = GG.Layout(planes=((h, w),), groups=(GG.Group(
                "cells", (0,)),))
            (d_grid,) = GG.segment_grads(
                [cell.to(torch.int32)], tx[None], ty[None], gout[None],
                layout)
        return d_grid, d_coords


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
