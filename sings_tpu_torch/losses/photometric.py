"""Photometric training losses (port of sings_tpu/losses/photometric.py).

masked L1 (sum / mask area), SSIM scaled by the mask fraction, and
patch terms (LPIPS, or the weight-free gradient pyramid) on masked
random patches composited over a random-noise background.

Every random number of the step comes from one place: draw_step_randoms
draws the background colour, the patch noise and the patch corners
from a torch.Generator, with the JAX package's distributions (corners
categorical over interior mask pixels with probability 0.9, else
uniform). photometric_loss takes the draws as an argument, so a test
can hand it JAX's own draws. The crops index on the device (no host
synchronisation).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.clip import abs as jabs
from ..ops.clip import clip
from ..ops.profiling import span
from ..ops.ssim import ssim


def masked_l1(pred: torch.Tensor, gt: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """sum |pred - gt| / sum(mask) (|x| with jnp.abs' gradient at 0)."""
    return jabs(pred - gt).sum() / torch.clamp_min(mask.sum(), 1.0)


def ssim_loss(pred: torch.Tensor, gt: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """(1 - ssim) * mask fraction."""
    frac = mask.sum() / (pred.shape[-1] * pred.shape[-2])
    return (1.0 - ssim(pred, gt)) * frac


class PhotometricWeights(NamedTuple):
    l1: float = 0.8
    ssim: float = 0.2
    lpips: float = 1.0
    num_patches: int = 4
    patch_size: int = 128
    grad_pyramid: float = 0.0
    grad_pyramid_levels: int = 3


def draw_patch_corners(generator: torch.Generator, mask: torch.Tensor, *,
                       num_patches: int, patch_size: int,
                       ratio_mask: float = 0.9):
    """(ys, xs) int64 (num_patches,) top-left corners: with probability
    ratio_mask all categorical over the pixels whose patch centre lies
    inside the mask (uniform when there are none), else all uniform."""
    h, w = mask.shape
    half = patch_size // 2
    dev = mask.device
    inner = mask[half: half + h - patch_size, half: half + w - patch_size]
    wts = (inner.reshape(-1) > 0).to(torch.float32)
    wts = torch.where(wts.sum() > 0, wts, torch.ones_like(wts))
    idx = torch.multinomial(wts, num_patches, replacement=True,
                            generator=generator)
    ys_in = torch.div(idx, w - patch_size, rounding_mode="floor")
    xs_in = idx % (w - patch_size)
    ys_un = torch.randint(0, h - patch_size, (num_patches,),
                          generator=generator, device=dev)
    xs_un = torch.randint(0, w - patch_size, (num_patches,),
                          generator=generator, device=dev)
    use_mask = torch.rand((), generator=generator, device=dev) < ratio_mask
    return (torch.where(use_mask, ys_in, ys_un),
            torch.where(use_mask, xs_in, xs_un))


def draw_step_randoms(generator: torch.Generator, mask: torch.Tensor,
                      weights: PhotometricWeights,
                      channels: int = 3) -> dict:
    """The random inputs of one training step: 'bg' (3,) uniform,
    'noise' (C, H, W) uniform patch background, 'ys'/'xs' patch corners."""
    h, w = mask.shape
    dev = mask.device
    bg = torch.rand(3, generator=generator, device=dev)
    noise = torch.rand((channels, h, w), generator=generator, device=dev)
    ys, xs = draw_patch_corners(generator, mask,
                                num_patches=weights.num_patches,
                                patch_size=weights.patch_size)
    return {"bg": bg, "noise": noise, "ys": ys, "xs": xs}


def crop_patches(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                 patch_size: int) -> torch.Tensor:
    """(C, H, W) -> (n, C, P, P) crops at the (ys, xs) corners."""
    ar = torch.arange(patch_size, device=img.device)
    rows = (ys[:, None] + ar[None, :])[:, :, None]   # (n, P, 1)
    cols = (xs[:, None] + ar[None, :])[:, None, :]   # (n, 1, P)
    return img[:, rows, cols].permute(1, 0, 2, 3)


def sample_patches(generator: torch.Generator, mask: torch.Tensor,
                   images: tuple, *, num_patches: int = 4,
                   patch_size: int = 128, ratio_mask: float = 0.9,
                   corners=None) -> tuple:
    """Aligned square patches, mostly centred inside the mask, in one
    call (the JAX package's form): corners from draw_patch_corners (or
    the given (ys, xs)), then crop_patches of each image. mask (H, W);
    images (C, H, W) each. Returns per input a stacked
    (num_patches, C, patch_size, patch_size)."""
    if corners is None:
        corners = draw_patch_corners(generator, mask,
                                     num_patches=num_patches,
                                     patch_size=patch_size,
                                     ratio_mask=ratio_mask)
    ys, xs = corners
    return tuple(crop_patches(img, ys, xs, patch_size) for img in images)


def grad_pyramid_distance(pred: torch.Tensor, gt: torch.Tensor,
                          levels: int = 3) -> torch.Tensor:
    """L1 between finite-difference image gradients over a pyramid of
    2x average-pooled scales, (B, C, P, P) -> scalar."""
    total = 0.0
    for lvl in range(levels):
        pdx = pred[..., :, 1:] - pred[..., :, :-1]
        gdx = gt[..., :, 1:] - gt[..., :, :-1]
        pdy = pred[..., 1:, :] - pred[..., :-1, :]
        gdy = gt[..., 1:, :] - gt[..., :-1, :]
        total = total + jabs(pdx - gdx).mean() + jabs(pdy - gdy).mean()
        if lvl < levels - 1:
            pred, gt = F.avg_pool2d(pred, 2), F.avg_pool2d(gt, 2)
    return total / levels


def photometric_loss(draws: dict, pred: torch.Tensor, gt_rgb: torch.Tensor,
                     mask: torch.Tensor, bg_color: torch.Tensor,
                     weights: PhotometricWeights, lpips_fn=None):
    """Full photometric objective. pred/gt_rgb (3, H, W), mask (H, W);
    draws: 'noise', 'ys', 'xs' of draw_step_randoms. Returns (total,
    {term: weighted value})."""
    m = mask[None]
    gt = gt_rgb * m + bg_color[:, None, None] * (1.0 - m)
    losses = {}
    total = 0.0
    if weights.l1 > 0:
        losses["l1"] = weights.l1 * masked_l1(pred, gt, mask)
        total = total + losses["l1"]
    if weights.ssim > 0:
        losses["ssim"] = weights.ssim * ssim_loss(pred, gt, mask)
        total = total + losses["ssim"]
    use_lpips = weights.lpips > 0 and lpips_fn is not None
    if use_lpips or weights.grad_pyramid > 0:
        noise = draws["noise"]
        pred_bg = pred * m + noise * (1.0 - m)
        gt_bg = gt * m + noise * (1.0 - m)
        pred_p = crop_patches(pred_bg, draws["ys"], draws["xs"],
                              weights.patch_size)
        gt_p = crop_patches(gt_bg, draws["ys"], draws["xs"],
                            weights.patch_size)
        if use_lpips:
            with span("losses.lpips"):
                losses["lpips_patch"] = weights.lpips * lpips_fn(
                    clip(pred_p, hi=1.0), gt_p).mean()
            total = total + losses["lpips_patch"]
        if weights.grad_pyramid > 0:
            losses["grad_pyr"] = weights.grad_pyramid * \
                grad_pyramid_distance(clip(pred_p, hi=1.0), gt_p,
                                      weights.grad_pyramid_levels)
            total = total + losses["grad_pyr"]
    return total, losses
