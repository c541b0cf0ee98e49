"""LPIPS perceptual distance with a VGG16 backbone (port of
sings_tpu/losses/lpips.py; Zhang et al., arXiv:1801.03924).

VGG16's 13 3x3 convolutions to relu5_3 (4 max-pools), features at
relu{1_2, 2_2, 3_3, 4_3, 5_3}, per-channel unit normalisation, squared
difference, 1x1 linear heads, spatial and layer means, with the lpips
package's input shift and scale. Weights in the JAX layout: conv w
(3, 3, cin, cout) HWIO, b (cout,); heads (C,). The caller gives the
weights (the benchmark's seeded features, which the program gets too); no
initialiser or loader is copied. float32 throughout: the caller turns
TF32 off for cuDNN.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

# VGG16 conv plan: (out_channels, pool_before)
VGG_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
SLICE_ENDS = {1, 3, 6, 9, 12}
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPSParams(NamedTuple):
    convs: tuple      # ((w (3, 3, cin, cout), b (cout,)), ...)
    lins: tuple       # ((cout,) per slice)


def vgg_slices(params: LPIPSParams, x: torch.Tensor) -> list:
    """x: (B, 3, H, W) in [0, 1] -> the 5 feature maps (B, C, h, w)."""
    shift = x.new_tensor(_SHIFT)[None, :, None, None]
    scale = x.new_tensor(_SCALE)[None, :, None, None]
    x = ((x - 0.5) * 2.0 - shift) / scale
    feats = []
    for i, ((w, b), (_, pool)) in enumerate(zip(params.convs, VGG_PLAN)):
        if pool:
            x = F.max_pool2d(x, 2, 2)
        x = F.conv2d(x, w.permute(3, 2, 0, 1), padding=1)
        x = torch.relu(x + b[None, :, None, None])
        if i in SLICE_ENDS:
            feats.append(x)
    return feats


def lpips_distance(params: LPIPSParams, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) pairs in [0, 1] -> (B,) perceptual distances."""
    total = 0.0
    for fa, fb, lin in zip(vgg_slices(params, x), vgg_slices(params, y),
                           params.lins):
        na = fa / torch.sqrt(torch.sum(fa ** 2, dim=1, keepdim=True) + 1e-10)
        nb = fb / torch.sqrt(torch.sum(fb ** 2, dim=1, keepdim=True) + 1e-10)
        weighted = torch.einsum("bchw,c->bhw", (na - nb) ** 2, lin)
        total = total + weighted.mean(dim=(1, 2))
    return total
