"""LPIPS perceptual distance (VGG16 backbone) (port of
sings_tpu/losses/lpips.py).

VGG16 conv features at relu{1_2, 2_2, 3_3, 4_3, 5_3}, per-channel unit
normalisation, squared difference, 1x1 linear heads, spatial and layer
means, with the lpips package's input shift and scale. The JAX package
runs it with lax.conv (no Pallas kernel), so the port uses
torch.nn.functional.conv2d; device.py turns TF32 off for cuDNN, so the
convolutions run in float32 as the reference's HIGHEST precision does.

Weights keep the JAX layout: conv w (3, 3, cin, cout) HWIO, b (cout,).
load_weights(path) reads an .npz export of the official weights (keys
conv{i}_w, conv{i}_b, lin{j}_w); init_random(generator) draws
deterministic random features from a torch.Generator (the JAX package's
distribution, not its bits; lpips_params_from_numpy carries JAX's own
draws over for the tests). Validation reports the distance as a
metric; with human.loss.lpips_w > 0 it is also a training loss
(train/step.py), at lpips_w * tpu.random_lpips_factor with random
features. Its gradient is autograd's through conv2d, relu and
max_pool2d: max_pool2d passes a window's cotangent to its first
maximum, as JAX's reduce_window max does, so flat (clipped) patches
get the same gradient; relu's derivative is 0 at 0 in both.
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 conv plan: (out_channels, pool_before)
_VGG_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
_SLICE_ENDS = {1, 3, 6, 9, 12}
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_LIN_DIMS = (64, 128, 256, 512, 512)


class LPIPSParams(NamedTuple):
    convs: tuple      # ((w (3, 3, cin, cout), b (cout,)), ...)
    lins: tuple       # ((cout,) per slice)
    pretrained: bool


def init_random(generator: torch.Generator, device="cpu") -> LPIPSParams:
    """He-normal conv weights, zero biases, uniform 1/C heads."""
    convs = []
    cin = 3
    for cout, _ in _VGG_PLAN:
        std = float(np.sqrt(2.0 / (9 * cin)))
        w = torch.randn((3, 3, cin, cout), generator=generator) * std
        convs.append((w.to(device), torch.zeros(cout, device=device)))
        cin = cout
    lins = tuple(torch.full((d,), 1.0 / d, device=device) for d in _LIN_DIMS)
    return LPIPSParams(convs=tuple(convs), lins=lins, pretrained=False)


def lpips_params_from_numpy(convs, lins, pretrained: bool,
                            device="cpu") -> LPIPSParams:
    """LPIPSParams from numpy arrays in the JAX layout (a JAX
    LPIPSParams' leaves, np.asarray-ed)."""
    t = lambda x: torch.as_tensor(np.array(x, np.float32), device=device)  # noqa: E731
    return LPIPSParams(convs=tuple((t(w), t(b)) for w, b in convs),
                       lins=tuple(t(x).reshape(-1) for x in lins),
                       pretrained=bool(pretrained))


def load_weights(path: str, device="cpu") -> LPIPSParams:
    data = np.load(path)
    return lpips_params_from_numpy(
        [(data[f"conv{i}_w"], data[f"conv{i}_b"])
         for i in range(len(_VGG_PLAN))],
        [data[f"lin{j}_w"] for j in range(5)], True, device)


def get_lpips(weights_path: str | None = None, seed: int = 0,
              device="cpu") -> LPIPSParams:
    if weights_path and os.path.exists(weights_path):
        return load_weights(weights_path, device)
    return init_random(torch.Generator().manual_seed(int(seed)), device)


@functools.lru_cache(maxsize=None)
def _input_norm(device: torch.device, dtype: torch.dtype) -> tuple:
    """The input shift and scale as (1, 3, 1, 1) tensors, made once per
    device and dtype: a tensor made from host data is a copy to the
    card, which makes the host wait for the card's queue."""
    return tuple(torch.tensor(v, dtype=dtype, device=device)[None, :, None,
                                                            None]
                 for v in (_SHIFT, _SCALE))


def _vgg_slices(params: LPIPSParams, x: torch.Tensor) -> list:
    """x: (B, 3, H, W) in [0, 1] -> the 5 feature maps (B, C, h, w)."""
    shift, scale = _input_norm(x.device, x.dtype)
    x = ((x - 0.5) * 2.0 - shift) / scale
    feats = []
    for i, ((w, b), (_, pool)) in enumerate(zip(params.convs, _VGG_PLAN)):
        if pool:
            x = F.max_pool2d(x, 2, 2)
        x = F.conv2d(x, w.permute(3, 2, 0, 1), padding=1)
        x = torch.relu(x + b[None, :, None, None])
        if i in _SLICE_ENDS:
            feats.append(x)
    return feats


def lpips_distance(params: LPIPSParams, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) pairs in [0, 1] -> (B,) perceptual distances."""
    total = 0.0
    for fa, fb, lin in zip(_vgg_slices(params, x), _vgg_slices(params, y),
                           params.lins):
        na = fa / torch.sqrt(torch.sum(fa ** 2, dim=1, keepdim=True) + 1e-10)
        nb = fb / torch.sqrt(torch.sum(fb ** 2, dim=1, keepdim=True) + 1e-10)
        weighted = torch.einsum("bchw,c->bhw", (na - nb) ** 2, lin)
        total = total + weighted.mean(dim=(1, 2))
    return total
