"""Camera and static SMPL-parameter factories (port of
sings_tpu/data/cameras.py; reference sings/rec/datasets/utils.py)."""
from __future__ import annotations


import numpy as np

from ..ops.graphics import Camera, make_camera


def get_anim_camera(render_size=(512, 512), fx: float = 5000.0,
                    fy: float = 5000.0, znear: float = 0.01,
                    zfar: float = 100.0, device="cpu") -> Camera:
    """Fixed synthetic animation camera (identity extrinsic)."""
    h, w = render_size
    K = np.array([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]], np.float32)
    return make_camera(np.eye(4, dtype=np.float32), h, w, K=K, znear=znear,
                       zfar=zfar, device=device)
