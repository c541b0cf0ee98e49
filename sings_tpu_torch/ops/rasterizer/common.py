"""Gaussian-splatting screen-space preprocess (port of
sings_tpu/ops/rasterizer/common.py).

Every rule of the CUDA diff-gaussian-rasterization preprocess that the
JAX package reproduces: perspective projection with p_w = 1/(w+1e-7),
the z > 0.2 frustum cull, EWA 2D covariance with the 1.3*tan view-space
clamp and the 0.3-pixel dilation, radius ceil(3*sqrt(lam1)) with the 0.1
floor under the discriminant root, SH-to-RGB with clamping, and the
getRect zero-area cull (floor for negative coordinates).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..clip import clip
from ..graphics import Camera
from ..rotations import quaternion_to_matrix
from ..sh import sh_to_rgb


class Gaussians2D(NamedTuple):
    means2d: torch.Tensor    # (N, 2) pixel coords
    depths: torch.Tensor     # (N,) camera-space z
    conics: torch.Tensor     # (N, 3) inverse 2D covariance (a, b, c)
    colors: torch.Tensor     # (N, 3)
    opacities: torch.Tensor  # (N,)
    radii: torch.Tensor      # (N,) int32, 0 => invisible
    mask: torch.Tensor       # (N,) bool


def build_covariance_3d(scales: torch.Tensor, quats: torch.Tensor):
    """Sigma = R S S^T R^T. scales (N,3), quats (N,4) -> (N,3,3)."""
    R = quaternion_to_matrix(quats)
    M = R * scales[:, None, :]
    return M @ M.transpose(1, 2)


def project_cov3d_to_2d(cov3d: torch.Tensor, p_view: torch.Tensor,
                        camera: Camera) -> torch.Tensor:
    """CUDA computeCov2D: clamped tangents, focal-scaled Jacobian,
    +0.3 dilation. Returns (N, 3) = (cov_xx, cov_xy, cov_yy)."""
    focal_x = camera.width / (2.0 * camera.tan_fovx)
    focal_y = camera.height / (2.0 * camera.tan_fovy)
    z = p_view[:, 2]
    limx = 1.3 * (camera.tan_fovx if camera.clamp_tan_fovx is None
                  else camera.clamp_tan_fovx)
    limy = 1.3 * (camera.tan_fovy if camera.clamp_tan_fovy is None
                  else camera.clamp_tan_fovy)
    txtz = clip(p_view[:, 0] / z, -limx, limx)
    tytz = clip(p_view[:, 1] / z, -limy, limy)
    tx = txtz * z
    ty = tytz * z
    j00 = focal_x / z
    j02 = -(focal_x * tx) / (z * z)
    j11 = focal_y / z
    j12 = -(focal_y * ty) / (z * z)

    W = camera.view[:3, :3].T.to(cov3d)
    cov_cam = torch.einsum("ij,njk,lk->nil", W, cov3d, W)
    c00 = cov_cam[:, 0, 0]
    c01 = cov_cam[:, 0, 1]
    c02 = cov_cam[:, 0, 2]
    c11 = cov_cam[:, 1, 1]
    c12 = cov_cam[:, 1, 2]
    c22 = cov_cam[:, 2, 2]
    a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22)
    b = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22)
    return torch.stack([a + 0.3, b, c + 0.3], dim=-1)


def _tile_bounds(means2d, r, tile, ntx, nty):
    """getRect: floor for the low corner, truncation for the high one."""
    x0 = torch.clamp(torch.floor((means2d[:, 0] - r) / tile), 0, ntx)
    y0 = torch.clamp(torch.floor((means2d[:, 1] - r) / tile), 0, nty)
    x1 = torch.clamp(torch.trunc((means2d[:, 0] + r + tile - 1) / tile),
                     0, ntx)
    y1 = torch.clamp(torch.trunc((means2d[:, 1] + r + tile - 1) / tile),
                     0, nty)
    return x0, y0, x1, y1


def preprocess(means3d, scales, quats, opacities, features, camera: Camera,
               *, sh_degree: int = 0, scale_modifier: float = 1.0,
               alive=None, tile: int = 16) -> Gaussians2D:
    """Project gaussians into screen space.

    means3d (N, 3), scales (N, 3) activated, quats (N, 4) scalar-first,
    opacities (N,) or (N, 1), features (N, K, 3) SH or (N, 3) RGB,
    alive: optional (N,) bool mask for padded buffers.
    """
    camera = camera.to(means3d.device)
    n = means3d.shape[0]
    if opacities.ndim == 2:
        opacities = opacities[:, 0]
    p_hom4 = torch.cat([means3d, means3d.new_ones((n, 1))], dim=1)
    p_view = p_hom4 @ camera.view
    p_clip = p_hom4 @ camera.proj
    p_w = 1.0 / (p_clip[:, 3] + 1e-7)
    ndc = p_clip[:, :3] * p_w[:, None]
    in_front = p_view[:, 2] > 0.2

    cov3d = build_covariance_3d(scales * scale_modifier, quats)
    cov2d = project_cov3d_to_2d(cov3d, p_view[:, :3], camera)
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    det_ok = det != 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    conics = torch.stack([cov2d[:, 2], -cov2d[:, 1], cov2d[:, 0]],
                         dim=-1) / det_safe[:, None]
    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam1, 0.0)))

    means2d = torch.stack([
        ((ndc[:, 0] + 1.0) * camera.width - 1.0) * 0.5,
        ((ndc[:, 1] + 1.0) * camera.height - 1.0) * 0.5,
    ], dim=-1)

    if features.ndim == 3:
        dirs = means3d - camera.cam_center[None, :]
        dirs = dirs / torch.linalg.norm(dirs, dim=-1,
                                        keepdim=True).clamp_min(1e-12)
        colors = sh_to_rgb(sh_degree, features, dirs)
    else:
        colors = features

    mask = in_front & det_ok
    if alive is not None:
        mask = mask & alive
    radii = torch.where(mask, radius_f, torch.zeros_like(radius_f)).to(
        torch.int32)
    mask = mask & (radii > 0)
    ntx = -(-camera.width // tile)
    nty = -(-camera.height // tile)
    r = radii.to(means2d.dtype)
    x0 = torch.clamp(torch.floor((means2d[:, 0] - r) / tile), 0, ntx)
    y0 = torch.clamp(torch.floor((means2d[:, 1] - r) / tile), 0, nty)
    x1 = torch.clamp(torch.floor((means2d[:, 0] + r + tile - 1) / tile),
                     0, ntx)
    y1 = torch.clamp(torch.floor((means2d[:, 1] + r + tile - 1) / tile),
                     0, nty)
    mask = mask & ((x1 - x0) * (y1 - y0) > 0)
    radii = torch.where(mask, radii, torch.zeros_like(radii))
    return Gaussians2D(means2d=means2d, depths=p_view[:, 2], conics=conics,
                       colors=colors, opacities=opacities, radii=radii,
                       mask=mask)


def tile_rect(g: Gaussians2D, tile: int, n_tiles_x: int, n_tiles_y: int):
    """Per-gaussian tile rectangle, CUDA getRect semantics: int32
    (x0, y0, x1, y1); x0/y0 floor negative coordinates, x1/y1 truncate."""
    r = g.radii.to(torch.float32)
    x0, y0, x1, y1 = _tile_bounds(g.means2d, r, tile, n_tiles_x, n_tiles_y)
    return (x0.to(torch.int32), y0.to(torch.int32), x1.to(torch.int32),
            y1.to(torch.int32))
