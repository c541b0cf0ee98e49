"""Predefined body poses (reference sings/rec/datasets/utils.py:123-157).

Poses are 69-d SMPL body_pose vectors (23 joints x 3 axis-angle); the
SMPLH path slices the first 63 entries (21 body joints) exactly like the
reference does (sings_hybrid.py:387-388).
"""
from __future__ import annotations

import numpy as np

_POSES = {
    "da_pose": {2: 1.0, 5: -1.0},
    "a_pose": {2: 0.2, 5: -0.2, 47: -0.8, 50: 0.8},
    "little_a_pose": {2: 0.1, 5: -0.1, 47: -0.8, 50: 0.8},
    "little_little_a_pose": {2: 0.02, 5: -0.02, 47: -0.9, 50: 0.9},
    "t_pose": {},
}


def predefined_pose(pose_type: str) -> np.ndarray:
    if pose_type not in _POSES:
        raise ValueError(f"Unknown pose type: {pose_type}")
    pose = np.zeros(69, dtype=np.float32)
    for idx, val in _POSES[pose_type].items():
        pose[idx] = val
    return pose
