"""Real spherical harmonics evaluation (degrees 0..3) in PyTorch.

Port of sings_tpu/ops/sh.py; constants of the 3DGS CUDA rasterizer.
"""
from __future__ import annotations

import torch

from .clip import clip

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sh (..., K, C) with K >= (deg+1)^2, dirs (..., 3) unit -> (..., C)."""
    result = C0 * sh[..., 0, :]
    if deg > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = (result - C1 * y * sh[..., 1, :] + C1 * z * sh[..., 2, :]
                  - C1 * x * sh[..., 3, :])
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + C2[0] * xy * sh[..., 4, :]
                      + C2[1] * yz * sh[..., 5, :]
                      + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                      + C2[3] * xz * sh[..., 7, :]
                      + C2[4] * (xx - yy) * sh[..., 8, :])
            if deg > 2:
                result = (result
                          + C3[0] * y * (3 * xx - yy) * sh[..., 9, :]
                          + C3[1] * xy * z * sh[..., 10, :]
                          + C3[2] * y * (4 * zz - xx - yy) * sh[..., 11, :]
                          + C3[3] * z * (2 * zz - 3 * xx - 3 * yy)
                          * sh[..., 12, :]
                          + C3[4] * x * (4 * zz - xx - yy) * sh[..., 13, :]
                          + C3[5] * z * (xx - yy) * sh[..., 14, :]
                          + C3[6] * x * (xx - 3 * yy) * sh[..., 15, :])
    return result


def sh_to_rgb(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH -> RGB as the 3DGS rasterizer does: eval + 0.5, clamped at 0
    with jnp.maximum's gradient (half the cotangent at exactly 0)."""
    return clip(eval_sh(deg, sh, dirs) + 0.5, lo=0.0)


def rgb2sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / C0


def sh2rgb(sh: torch.Tensor) -> torch.Tensor:
    return sh * C0 + 0.5


def sh_basis(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """The (deg + 1)^2 real SH basis values of eval_sh at unit dirs
    (..., 3): eval_sh(deg, sh, dirs) = sum_k basis[..., k] * sh[..., k, :]
    (up to rounding)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, C0)]
    if deg > 0:
        out += [-C1 * y, C1 * z, -C1 * x]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        out += [C2[0] * x * y, C2[1] * y * z,
                C2[2] * (2.0 * zz - xx - yy), C2[3] * x * z,
                C2[4] * (xx - yy)]
    if deg > 2:
        out += [C3[0] * y * (3 * xx - yy), C3[1] * x * y * z,
                C3[2] * y * (4 * zz - xx - yy),
                C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                C3[4] * x * (4 * zz - xx - yy), C3[5] * z * (xx - yy),
                C3[6] * x * (xx - 3 * yy)]
    return torch.stack(out, dim=-1)


def sh_basis_jacobian(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """d basis[..., k] / d dirs: (..., (deg + 1)^2, 3)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    o = torch.zeros_like(x)
    rows = [(o, o, o)]
    if deg > 0:
        c = torch.full_like(x, C1)
        rows += [(o, -c, o), (o, o, c), (-c, o, o)]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        rows += [(C2[0] * y, C2[0] * x, o), (o, C2[1] * z, C2[1] * y),
                 (-2.0 * C2[2] * x, -2.0 * C2[2] * y, 4.0 * C2[2] * z),
                 (C2[3] * z, o, C2[3] * x),
                 (2.0 * C2[4] * x, -2.0 * C2[4] * y, o)]
    if deg > 2:
        rows += [
            (C3[0] * 6 * x * y, C3[0] * (3 * xx - 3 * yy), o),
            (C3[1] * y * z, C3[1] * x * z, C3[1] * x * y),
            (-2 * C3[2] * x * y, C3[2] * (4 * zz - xx - 3 * yy),
             8 * C3[2] * y * z),
            (-6 * C3[3] * x * z, -6 * C3[3] * y * z,
             C3[3] * (6 * zz - 3 * xx - 3 * yy)),
            (C3[4] * (4 * zz - 3 * xx - yy), -2 * C3[4] * x * y,
             8 * C3[4] * x * z),
            (2 * C3[5] * x * z, -2 * C3[5] * y * z, C3[5] * (xx - yy)),
            (C3[6] * (3 * xx - 3 * yy), -6 * C3[6] * x * y, o)]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
