"""AMASS / custom motion ingestion (port of sings_tpu/kinematics/amass.py).

Host-side numpy; the rotations of rebase_motion use the port's float32
torch Rodrigues on the CPU, the same arithmetic as the JAX version.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.rotations import axis_angle_to_matrix

# map AMASS 156-d smplh pose vector -> 24-joint (72-d) smpl pose
AMASS_SMPLH_TO_SMPL_JOINTS = np.arange(0, 156).reshape((-1, 3))[[
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
    11, 12, 13, 14, 15, 16, 17, 18,
    19, 20, 21, 22, 37,
]].reshape(-1)


def manual_alignment(motion_type: str):
    """Per-motion-type world alignment (trans, euler rot, scale)."""
    if motion_type == "AMASS":
        trans = np.array([0.0, 0.0, 10.0])
        rot = np.array([90.0, 0.0, 0.0]) / 180 * np.pi
        scale = 0.5
    elif motion_type == "custom":
        trans = np.zeros(3)
        rot = np.array([-0.5, 0.0, 0.0]) / 180 * np.pi
        scale = 1.0
    else:
        trans = np.zeros(3)
        rot = np.zeros(3)
        scale = 0.5
    return trans.astype(np.float32), rot.astype(np.float32), float(scale)


def euler_to_matrix(rx, ry, rz):
    """XYZ-order ('sxyz') euler angles -> 3x3."""
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (mx @ my @ mz).astype(np.float32)


def _aa_to_matrix_np(aa: np.ndarray) -> np.ndarray:
    return axis_angle_to_matrix(
        torch.as_tensor(np.asarray(aa, np.float32))).numpy()


def rebase_motion(poses: np.ndarray, transl: np.ndarray):
    """Re-root a motion at its first frame facing the camera. poses
    (N, 72), transl (N, 3). Like the reference, only the translation
    track is rotated (and pushed z + 20); the global orient is kept."""
    mats = _aa_to_matrix_np(poses[:, :3])
    mat0_inv = np.linalg.inv(mats[0])
    mat_target = _aa_to_matrix_np(np.array([np.pi, 0.0, 0.0]))
    t = (mat_target @ mat0_inv @ transl.reshape(-1, 3, 1).astype(np.float32))
    t = t[:, :, 0]
    t = t - t[0]
    t[:, -1] += 20.0
    return poses, t.astype(np.float32)


def load_motion(path: str, motion_type: str = "custom", start: int = 0,
                end: int = -1, skip: int = 1, rebase: bool = True):
    """Load a motion file into {'global_orient','body_pose','transl'}."""
    data = np.load(path)
    if motion_type == "AMASS":
        poses = data["poses"][start:end:skip][:, AMASS_SMPLH_TO_SMPL_JOINTS]
        transl = data["trans"][start:end:skip]
    else:
        poses = data["body_pose"][start:end:skip]
        transl = data["transl"][start:end:skip]
    poses = poses.astype(np.float32)
    transl = transl.astype(np.float32)
    if rebase:
        poses, transl = rebase_motion(poses, transl)
    return {
        "global_orient": poses[:, :3],
        "body_pose": poses[:, 3:],
        "transl": transl.reshape(-1, 3),
    }
