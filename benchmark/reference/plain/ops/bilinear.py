"""The corner arithmetic of bilinear sampling that the forward
(ops/sampling.py, fields/triplane.py) and the plain backward
(ops/grid_grad.py) share (port of sings_tpu/ops/sampling.py's helpers).

The JAX package's clamped base corner (x0 in [0, W-2]), its
corner-stacked gather table and its weight order define the exact
arithmetic; the border clip has jnp.clip's gradient (ops/clip.py).
"""
from __future__ import annotations

import torch

from .clip import clip, clip_factor


def _unit(coords: torch.Tensor, h: int, w: int):
    """[-1, 1] -> continuous grid coordinates, before the border clip."""
    x = (coords[:, 0] + 1.0) * 0.5 * (w - 1)
    y = (coords[:, 1] + 1.0) * 0.5 * (h - 1)
    return x, y


def _corner_coords(coords: torch.Tensor, h: int, w: int):
    """Continuous -> clamped base-corner indices + fractional offsets."""
    x, y = _unit(coords, h, w)
    x = clip(x, 0.0, float(w - 1))
    y = clip(y, 0.0, float(h - 1))
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
    d_x = d_tx * clip_factor(x, 0.0, float(w - 1)) * (0.5 * (w - 1))
    d_y = d_ty * clip_factor(y, 0.0, float(h - 1)) * (0.5 * (h - 1))
    return torch.stack([d_x, d_y], dim=1)
