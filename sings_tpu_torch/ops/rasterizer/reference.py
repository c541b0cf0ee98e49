"""Dense alpha compositor: the CPU oracle (port of
sings_tpu/ops/rasterizer/reference.py). O(H*W*N), tiny scenes only.

CUDA renderCUDA rules: skip when power > 0 or alpha < 1/255; alpha =
min(0.99, opacity * exp(power)); stop (this gaussian excluded) when
T * (1 - alpha) < 1e-4. T is non-increasing, so the flag computed from
the unfrozen exclusive cumprod is already monotone.
"""
from __future__ import annotations

import torch

from .common import Gaussians2D, tile_rect

ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


def composite_dense(g: Gaussians2D, height: int, width: int,
                    bg: torch.Tensor, tile: int | None = 16):
    """Composite every gaussian over every pixel in depth order; with
    `tile`, only pixels whose tile lies in the gaussian's tile rectangle.
    Returns (image (3, H, W), final transmittance (H, W))."""
    dev = g.means2d.device
    inf = torch.full_like(g.depths, float("inf"))
    order = torch.argsort(torch.where(g.mask, g.depths, inf), stable=True)
    means2d = g.means2d[order]
    conics = g.conics[order]
    colors = g.colors[order]
    opac = g.opacities[order]
    mask = g.mask[order]

    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([gx, gy], dim=-1).reshape(-1, 2)

    dx = means2d[None, :, 0] - pix[:, 0:1]
    dy = means2d[None, :, 1] - pix[:, 1:2]
    a, b, c = conics[:, 0], conics[:, 1], conics[:, 2]
    power = -0.5 * (a[None] * dx * dx + c[None] * dy * dy) - b[None] * dx * dy
    alpha_raw = torch.clamp_max(opac[None] * torch.exp(power), 0.99)
    skip = (power > 0.0) | (alpha_raw < ALPHA_MIN) | (~mask)[None]
    if tile is not None:
        ntx = -(-width // tile)
        nty = -(-height // tile)
        g_sorted = g._replace(means2d=means2d, radii=g.radii[order],
                              mask=mask, depths=g.depths[order],
                              conics=conics, colors=colors, opacities=opac)
        x0, y0, x1, y1 = tile_rect(g_sorted, tile, ntx, nty)
        ptx = torch.div(pix[:, 0], tile, rounding_mode="floor").to(torch.int32)
        pty = torch.div(pix[:, 1], tile, rounding_mode="floor").to(torch.int32)
        in_rect = ((x0[None] <= ptx[:, None]) & (ptx[:, None] < x1[None])
                   & (y0[None] <= pty[:, None]) & (pty[:, None] < y1[None]))
        skip = skip | ~in_rect
    alpha = torch.where(skip, torch.zeros_like(alpha_raw), alpha_raw)

    one_minus = 1.0 - alpha
    ones = torch.ones_like(alpha[:, :1])
    t_before = torch.cat([ones, torch.cumprod(one_minus[:, :-1], dim=1)],
                         dim=1)
    flag = (t_before * one_minus) >= T_EPS
    alpha_eff = alpha * flag
    w = alpha_eff * torch.cat(
        [ones, torch.cumprod(1.0 - alpha_eff[:, :-1], dim=1)], dim=1)
    color_acc = w @ colors
    t_final = torch.prod(1.0 - alpha_eff, dim=1)
    img = color_acc + t_final[:, None] * bg[None, :]
    img = img.reshape(height, width, 3).permute(2, 0, 1)
    return img, t_final.reshape(height, width)
