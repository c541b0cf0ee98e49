"""SSIM with an 11x11 Gaussian window (port of sings_tpu/ops/ssim.py).

The separable blur is two band-matrix products (B_H @ img @ B_W^T),
equal to a zero-padded SAME convolution, in full float32: the variance
terms E[x^2] - mu^2 cancel, and TF32 would lose them (device.py turns
it off).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _band_matrix_np(n: int, window_size: int, sigma: float) -> np.ndarray:
    """(n, n) banded matrix equivalent to zero-padded SAME 1D conv."""
    win = _gaussian_window(window_size, sigma)
    half = window_size // 2
    m = np.zeros((n, n), np.float32)
    for t, wv in enumerate(win):
        off = t - half
        idx = np.arange(max(0, -off), min(n, n - off))
        m[idx, idx + off] = wv
    return m


@functools.lru_cache(maxsize=16)
def _band_matrix(n: int, window_size: int, sigma: float,
                 device: str) -> torch.Tensor:
    """The band matrix on `device`, built once per size (no host copy on
    every call)."""
    return torch.as_tensor(_band_matrix_np(n, window_size, sigma),
                           device=device)


def _ssim_map(blur_fn, img1: torch.Tensor, img2: torch.Tensor):
    """Per-pixel SSIM map; the variance floor and the detached
    Cauchy-Schwarz bound on the covariance are the JAX package's."""
    mu1, mu2 = blur_fn(img1), blur_fn(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = torch.clamp_min(blur_fn(img1 * img1) - mu1_sq, 0.0)
    s2 = torch.clamp_min(blur_fn(img2 * img2) - mu2_sq, 0.0)
    s12 = blur_fn(img1 * img2) - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    lim = (torch.sqrt(torch.clamp_min(s1 * s2, 0.0)) + c2).detach()
    s12 = torch.minimum(torch.maximum(s12, -lim), lim)
    return ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over a (C, H, W) image pair or a (B, C, H, W) batch."""
    if img1.ndim == 4:
        return torch.stack([ssim(a, b, window_size, sigma)
                            for a, b in zip(img1, img2)]).mean()
    _, h, w = img1.shape
    dev = str(img1.device)
    bh = _band_matrix(h, window_size, sigma, dev)
    bw = _band_matrix(w, window_size, sigma, dev)
    return _ssim_map(lambda x: bh @ x @ bw.T, img1, img2).mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(mse, 1e-12)))
