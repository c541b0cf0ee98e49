"""Camera / projection math (3DGS OpenGL-style conventions).

Port of sings_tpu/ops/graphics.py. Row-vector convention: matrices are
stored transposed so points transform as ``p_hom @ M``; projection maps
camera z in [znear, zfar] to NDC with w = z. Matrices are built in
numpy float32 exactly like the JAX package and held as torch tensors.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Camera(NamedTuple):
    """Per-frame camera. view/proj (4, 4) row-vector world-to-camera and
    world-to-clip, cam_center (3,), python-int height/width."""

    view: torch.Tensor
    proj: torch.Tensor
    cam_center: torch.Tensor
    height: int
    width: int
    tan_fovx: float
    tan_fovy: float
    clamp_tan_fovx: float | None = None
    clamp_tan_fovy: float | None = None

    def to(self, device) -> "Camera":
        return self._replace(view=self.view.to(device),
                             proj=self.proj.to(device),
                             cam_center=self.cam_center.to(device))


def projection_matrix(znear, zfar, fovx, fovy) -> np.ndarray:
    """Centered perspective projection (column-vector convention)."""
    t = math.tan(fovy / 2) * znear
    r = math.tan(fovx / 2) * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / r
    P[1, 1] = znear / t
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def projection_matrix_center(znear, zfar, fx, fy, cx, cy, width,
                             height) -> np.ndarray:
    """Principal-point-offset projection."""
    cx = width - cx
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * fx / width
    P[1, 1] = 2.0 * fy / height
    P[0, 2] = 1.0 - 2.0 * cx / width
    P[1, 2] = 2.0 * cy / height - 1.0
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def make_camera(
    extrinsic_w2c: np.ndarray,
    height: int,
    width: int,
    *,
    fovx: float | None = None,
    fovy: float | None = None,
    K: np.ndarray | None = None,
    znear: float = 0.01,
    zfar: float = 100.0,
    device: str | torch.device = "cpu",
) -> Camera:
    """Camera from a world-to-camera 4x4 and intrinsics (K, or fovx/fovy).
    A non-centered principal point in K gets the offset projection."""
    w2c = np.asarray(extrinsic_w2c, dtype=np.float32)
    if K is not None:
        K = np.asarray(K, dtype=np.float32)
        non_centered = (
            abs(height // 2 - K[1, 2]) > 1.0 or abs(width // 2 - K[0, 2]) > 1.0
        )
        fov_left = math.atan(K[0, 2] / K[0, 0])
        fov_right = math.atan((width - K[0, 2]) / K[0, 0])
        fov_top = math.atan(K[1, 2] / K[1, 1])
        fov_bottom = math.atan((height - K[1, 2]) / K[1, 1])
        fovx = fov_left + fov_right
        fovy = fov_top + fov_bottom
        if non_centered:
            P = projection_matrix_center(
                znear, zfar, K[0, 0], K[1, 1], K[0, 2], K[1, 2], width, height
            )
        else:
            fovx = 2 * math.atan(width / (2 * K[0, 0]))
            fovy = 2 * math.atan(height / (2 * K[1, 1]))
            P = projection_matrix(znear, zfar, fovx, fovy)
    else:
        assert fovx is not None and fovy is not None
        P = projection_matrix(znear, zfar, fovx, fovy)

    view = w2c.T
    proj = view @ P.T
    cam_center = np.linalg.inv(view)[3, :3]
    return Camera(
        view=torch.as_tensor(np.ascontiguousarray(view), device=device),
        proj=torch.as_tensor(np.ascontiguousarray(proj), device=device),
        cam_center=torch.as_tensor(np.ascontiguousarray(cam_center),
                                   device=device),
        height=int(height),
        width=int(width),
        tan_fovx=float(math.tan(fovx * 0.5)),
        tan_fovy=float(math.tan(fovy * 0.5)),
    )
