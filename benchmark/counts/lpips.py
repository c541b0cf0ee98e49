"""Analytic float32 operations of the LPIPS-VGG16 term of a training
step: VGG16's 13 3x3 convolutions to relu5_3 (reference/plain/losses/
lpips.py's plan; 4 max-pools halve the side before convolutions 3, 5, 8
and 11), counted as torch.utils.flop_counter counts a convolution, 2
operations a multiply-add: 2 * H * W * 9 * C_in * C_out at the
convolution's side. At a 128x128 patch that is 5.01e9 multiply-adds.

A step runs the forward of both sides' patches (the predicted and the
target ones) and the backward of the predicted ones to their input
(the features are constants, so no weight gradient): each input
gradient costs its forward's operations, convolution 1's included (the
patches are the render's). The pools, the ReLUs, the normalisation and
the 1x1 heads (~2e6 multiply-adds a patch) are left out.
"""
from __future__ import annotations

# (C_out, a pool before) per convolution, VGG16's
VGG_PLAN = ((64, False), (64, False), (128, True), (128, False),
            (256, True), (256, False), (256, False), (512, True),
            (512, False), (512, False), (512, True), (512, False),
            (512, False))


def conv_ops(size: int) -> list:
    """Each convolution's forward operations on one size x size image."""
    out, cin, side = [], 3, size
    for cout, pool in VGG_PLAN:
        if pool:
            side //= 2
        out.append(2 * side * side * 9 * cin * cout)
        cin = cout
    return out


def step_ops(patches: int, size: int) -> int:
    """A step's LPIPS operations: the forward of 2 * patches images and
    the input gradient of `patches`."""
    return 3 * patches * sum(conv_ops(size))
