"""3D <-> 2D point projection (port of sings_tpu/ops/projection.py;
reference sings/rec/utils/geometry/pcd_projector.py:40-225), used by the
keypoint-reprojection losses of the preprocess refiner.
"""
from __future__ import annotations

import torch


def project_points(points: torch.Tensor, K: torch.Tensor,
                   extrinsic: torch.Tensor | None = None) -> torch.Tensor:
    """(N, 3) world points -> (N, 3) [u, v, depth] pixel coords.

    K: (3, 3) intrinsics; extrinsic: optional (4, 4) world-to-camera.
    """
    if extrinsic is not None:
        p = points @ extrinsic[:3, :3].T + extrinsic[:3, 3]
    else:
        p = points
    uvw = p @ K.T
    z = uvw[:, 2:3]
    uv = uvw[:, :2] / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9),
                                  z)
    return torch.cat([uv, z], dim=1)


def unproject_points(uvd: torch.Tensor, K: torch.Tensor,
                     c2w: torch.Tensor | None = None) -> torch.Tensor:
    """(N, 3) [u, v, depth] -> (N, 3) points (camera or world frame)."""
    uv1 = torch.cat([uvd[:, :2], torch.ones_like(uvd[:, :1])], dim=1)
    rays = uv1 @ torch.linalg.inv(K).T
    p_cam = rays * uvd[:, 2:3]
    if c2w is not None:
        p_cam = p_cam @ c2w[:3, :3].T + c2w[:3, 3]
    return p_cam
