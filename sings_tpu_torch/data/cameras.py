"""Camera and static SMPL-parameter factories (port of
sings_tpu/data/cameras.py; reference sings/rec/datasets/utils.py)."""
from __future__ import annotations

import math

import numpy as np

from ..kinematics.poses import predefined_pose
from ..ops.graphics import Camera, make_camera


def _rot_z(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    # (the reference's rot_z is a rotation about +y; reproduced)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def get_static_camera(img_size: int = 512, fov: float = 0.4,
                      znear: float = 0.01, zfar: float = 100.0,
                      device="cpu") -> Camera:
    return make_camera(np.eye(4, dtype=np.float32), img_size, img_size,
                       fovx=fov, fovy=fov, znear=znear, zfar=zfar,
                       device=device)


def get_rotating_cameras(img_size=512, fov: float = 0.4, dist: float = 5.0,
                         nframes: int = 40, angle_limit: float = 2 * math.pi,
                         znear: float = 0.01, zfar: float = 100.0,
                         device="cpu") -> list[Camera]:
    """Turntable rig orbiting the origin."""
    if isinstance(img_size, int):
        img_size = (img_size, img_size)
    cams = []
    for azim in np.linspace(0, angle_limit, nframes):
        t = _rot_z(-azim) @ np.array([0.0, -0.25, dist], np.float32)
        r = _rot_z(azim).copy()
        r[1:3, :] *= -1  # flip y/z rows like the reference
        rt = np.eye(4, dtype=np.float32)
        rt[:3, :3] = r.T
        rt[:3, 3] = t
        cams.append(make_camera(np.linalg.inv(rt), img_size[0], img_size[1],
                                fovx=fov, fovy=fov, znear=znear, zfar=zfar,
                                device=device))
    return cams


def get_smpl_static_params(betas: np.ndarray,
                           pose_type: str = "da_pose") -> dict:
    return {
        "betas": np.asarray(betas, np.float32).reshape(-1),
        "global_orient": np.zeros(3, np.float32),
        "body_pose": predefined_pose(pose_type),
        "transl": np.zeros(3, np.float32),
        "smpl_scale": np.ones(1, np.float32),
    }


def get_anim_camera(render_size=(512, 512), fx: float = 5000.0,
                    fy: float = 5000.0, znear: float = 0.01,
                    zfar: float = 100.0, device="cpu") -> Camera:
    """Fixed synthetic animation camera (identity extrinsic)."""
    h, w = render_size
    K = np.array([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]], np.float32)
    return make_camera(np.eye(4, dtype=np.float32), h, w, K=K, znear=znear,
                       zfar=zfar, device=device)
