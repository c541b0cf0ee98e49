"""Halo exchange for strip-sharded image losses (port of
sings_tpu/dist/halo.py).

SSIM needs an 11x11 window: with the image split into horizontal strips
over the gs ranks, each rank fetches `halo` boundary rows from its
neighbours with two ppermute shifts, computes the windowed map on the
padded strip and crops back. The result equals the full-image SSIM
(the image borders see zero padding in both). The local forms return a
rank's contribution with no reduction, so that the loss can be
differentiated through the exchange (collectives.py's gradient-safety
rule); strip_ssim sums them, for values only. The functions take the gs
process group where the JAX package takes the axis name.
"""
from __future__ import annotations

import torch

from ..ops.ssim import _band_matrix, _ssim_map
from .collectives import group_size, ppermute, psum


def halo_exchange_rows(x: torch.Tensor, group, halo: int) -> torch.Tensor:
    """Pad a (C, H_strip, W) strip with `halo` rows from its neighbours
    (zeros at the image's top and bottom, as the convolution's padding).
    Returns (C, H_strip + 2 halo, W)."""
    n = group_size(group)
    # my last rows are the next rank's top halo, my first rows the
    # previous rank's bottom halo
    from_prev = ppermute(x[:, -halo:], group, [(i, i + 1)
                                               for i in range(n - 1)])
    from_next = ppermute(x[:, :halo], group, [(i + 1, i)
                                              for i in range(n - 1)])
    return torch.cat([from_prev, x, from_next], dim=1)


def _blur_fn(p: torch.Tensor, window_size: int, sigma: float):
    dev = str(p.device)
    bh = _band_matrix(p.shape[1], window_size, sigma, dev)
    bw = _band_matrix(p.shape[2], window_size, sigma, dev)
    return lambda x: bh @ x @ bw.T


def strip_ssim_local(pred: torch.Tensor, gt: torch.Tensor, group,
                     window_size: int = 11, sigma: float = 1.5):
    """This rank's contribution to the full image's mean SSIM (equal
    strip heights): the group's sum of it is ssim(pred_full, gt_full).
    No reduction inside: differentiate this, and sum after the
    gradient."""
    halo = window_size // 2
    p = halo_exchange_rows(pred, group, halo)
    g = halo_exchange_rows(gt, group, halo)
    smap = _ssim_map(_blur_fn(p, window_size, sigma), p, g)
    return smap[:, halo:-halo].mean() / group_size(group)


def halo_exchange_rows_bounded(x: torch.Tensor, group, halo: int,
                               h_own: int) -> torch.Tensor:
    """Halo exchange for balanced strips of unequal owned heights.

    x is a (C, h_max, W) window that owns only its first h_own rows. The
    next rank's rows go to row halo + h_own of the result, over the
    window's padding rows (which belong to the next rank: the overwrite
    also zeroes their cotangents, the ownership contract). Returns
    (C, h_max + 2 halo, W); rows [halo, halo + h_own) are the owned core
    with the full image's SSIM windows."""
    n = group_size(group)
    lo = max(h_own - halo, 0)
    from_prev = ppermute(x[:, lo: lo + halo], group,
                         [(i, i + 1) for i in range(n - 1)])
    from_next = ppermute(x[:, :halo], group,
                         [(i + 1, i) for i in range(n - 1)])
    buf = torch.cat([from_prev, x, torch.zeros_like(x[:, :halo])], dim=1)
    at = halo + h_own
    return torch.cat([buf[:, :at], from_next, buf[:, at + halo:]], dim=1)


def strip_ssim_local_bounded(pred: torch.Tensor, gt: torch.Tensor, group,
                             h_own: int, full_pixels: float,
                             window_size: int = 11, sigma: float = 1.5):
    """A balanced strip's contribution to the full image's mean SSIM:
    pred / gt are (C, h_max, W) windows owning rows [0, h_own);
    full_pixels is H * W of the full image. The group's sum is
    ssim(pred_full, gt_full); no reduction inside, as
    strip_ssim_local."""
    halo = window_size // 2
    p = halo_exchange_rows_bounded(pred, group, halo, h_own)
    g = halo_exchange_rows_bounded(gt, group, halo, h_own)
    smap = _ssim_map(_blur_fn(p, window_size, sigma), p, g)
    core = smap[:, halo: halo + pred.shape[1]]
    rm = (torch.arange(pred.shape[1], device=pred.device) < h_own).to(
        core.dtype)
    return torch.sum(core * rm[None, :, None]) / (core.shape[0]
                                                  * full_pixels)


def strip_ssim(pred: torch.Tensor, gt: torch.Tensor, group,
               window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM of a strip-sharded image pair, equal to the full
    image's: the group's sum of strip_ssim_local, a value (detached)."""
    return psum(strip_ssim_local(pred, gt, group, window_size, sigma),
                group)
