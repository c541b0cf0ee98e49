"""Animation dataset (port of sings_tpu/data/anim.py).

Loads AMASS or custom motions, rebases to the first frame, and serves
fixed-size chunks for the batched animation forward.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from ..kinematics.amass import euler_to_matrix, load_motion, manual_alignment
from ..ops.graphics import Camera
from .cameras import get_anim_camera


class AnimDataset(NamedTuple):
    smpl: dict               # global_orient/body_pose/transl (F, ...)
    camera: Camera
    ext_trans: np.ndarray    # (3,)
    ext_rotmat: np.ndarray   # (3, 3)
    ext_scale: np.ndarray    # (1,)
    motion_name: str

    @property
    def num_frames(self):
        return self.smpl["body_pose"].shape[0]

    def get_chunk(self, start: int, end: int):
        end = min(end, self.num_frames)
        idx = np.arange(start, end)
        b = len(idx)
        return {
            "global_orient": self.smpl["global_orient"][idx],
            "body_pose": self.smpl["body_pose"][idx],
            "transl": self.smpl["transl"][idx],
            "smpl_scale": np.ones((b, 1), np.float32),
            "ext_tfs": (
                np.tile(self.ext_trans[None], (b, 1)),
                np.tile(self.ext_rotmat[None], (b, 1, 1)),
                np.tile(self.ext_scale[None], (b, 1)),
            ),
        }


def load_anim_dataset(motion_src: str, motion_type: str = "custom",
                      motion_start: int = 0, motion_end: int = -1,
                      motion_skip: int = 1, render_size=(512, 512),
                      rebase: bool | None = None, fx: float = 5000.0,
                      fy: float = 5000.0, image_zoom_ratio: float = 1.0,
                      device="cpu") -> AnimDataset:
    """rebase None: True for 'custom', False for 'AMASS' (the JAX
    package's documented deviation, so AMASS motions land in frame)."""
    if rebase is None:
        rebase = motion_type != "AMASS"
    smpl = load_motion(motion_src, motion_type, motion_start, motion_end,
                       motion_skip, rebase=rebase)
    trans, rot, scale = manual_alignment(motion_type)
    rotmat = euler_to_matrix(*rot)
    downscale = 1.0 / image_zoom_ratio
    if downscale > 1:
        render_size = (int(render_size[0] / downscale),
                       int(render_size[1] / downscale))
        fx, fy = fx / downscale, fy / downscale
    return AnimDataset(
        smpl=smpl,
        camera=get_anim_camera(render_size, fx=fx, fy=fy, device=device),
        ext_trans=trans,
        ext_rotmat=rotmat,
        ext_scale=np.array([scale], np.float32),
        motion_name=os.path.basename(motion_src).split(".")[0],
    )
