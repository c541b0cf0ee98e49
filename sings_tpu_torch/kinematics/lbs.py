"""Linear blend skinning in PyTorch (port of sings_tpu/kinematics/lbs.py).

Blend shapes, joint regression, the kinematic-chain rigid transform,
full-model LBS, and lbs_extra: given per-joint transforms applied to
arbitrary points with given skinning weights (the canonical -> posed
gaussian deformation). Batched (B, ...) throughout.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.rotations import axis_angle_to_matrix


def blend_shapes(betas: torch.Tensor, shape_dirs: torch.Tensor):
    """(B, nb) x (V, 3, nb) -> (B, V, 3)."""
    return torch.einsum("bl,vcl->bvc", betas, shape_dirs)


def vertices2joints(j_regressor: torch.Tensor, vertices: torch.Tensor):
    """(J, V) x (B, V, 3) -> (B, J, 3)."""
    return torch.einsum("jv,bvc->bjc", j_regressor, vertices)


def shaped_joints(template, betas: torch.Tensor) -> torch.Tensor:
    """The joints (J, 3) of betas (nb,) for a template with v_template,
    shapedirs and j_regressor: J_reg (v_template + shapedirs betas), the
    ops and shapes of lbs', so the same bits as smpl_forward's joints."""
    v_shaped = template.v_template[None] + blend_shapes(
        betas.reshape(1, -1), template.shapedirs)
    return vertices2joints(template.j_regressor, v_shaped)[0]


def batch_rodrigues(pose: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3)."""
    return axis_angle_to_matrix(pose)


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                          parents: np.ndarray):
    """Kinematic-chain forward. rot_mats (B, J, 3, 3), joints (B, J, 3),
    parents numpy (J,) with parents[0] == -1.
    Returns (posed joints (B, J, 3), rel transforms A (B, J, 4, 4))."""
    parents = np.asarray(parents)
    b, j, _ = joints.shape
    has_parent = torch.as_tensor(parents >= 0, device=joints.device)
    par = torch.as_tensor(np.clip(parents, 0, None), device=joints.device)
    rel_joints = joints - torch.where(has_parent[None, :, None],
                                      joints[:, par],
                                      torch.zeros_like(joints))
    t = torch.cat([rot_mats, rel_joints[..., None]], dim=-1)  # (B,J,3,4)
    bottom = torch.tensor([0.0, 0, 0, 1.0], dtype=joints.dtype,
                          device=joints.device).expand(b, j, 1, 4)
    local = torch.cat([t, bottom], dim=-2)
    world = [local[:, 0]]
    for i in range(1, j):
        world.append(world[int(parents[i])] @ local[:, i])
    transforms = torch.stack(world, dim=1)
    posed_joints = transforms[..., :3, 3]
    joints_hom = torch.cat([joints, joints.new_zeros((b, j, 1))], dim=-1)
    correction = torch.einsum("bjxy,bjy->bjx", transforms, joints_hom)
    rel = transforms - torch.nn.functional.pad(correction[..., None],
                                               (3, 0))
    return posed_joints, rel


class LBSOutput(NamedTuple):
    verts: torch.Tensor
    joints: torch.Tensor
    A: torch.Tensor
    T: torch.Tensor
    v_posed: torch.Tensor
    v_shaped: torch.Tensor
    shape_offsets: torch.Tensor
    pose_offsets: torch.Tensor


def pose_feature_and_rotmats(pose: torch.Tensor, pose2rot: bool,
                             batch_size: int):
    ident = torch.eye(3, dtype=pose.dtype, device=pose.device)
    if pose2rot:
        rot_mats = axis_angle_to_matrix(pose.reshape(batch_size, -1, 3))
    else:
        rot_mats = pose.reshape(batch_size, -1, 3, 3)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(batch_size, -1)
    return pose_feature, rot_mats


def skinning_transforms(A: torch.Tensor, lbs_weights: torch.Tensor):
    """T = W A: (B, J, 4, 4) x (V, J) -> (B, V, 4, 4)."""
    b, j = A.shape[0], A.shape[1]
    t = lbs_weights @ A.reshape(b, j, 16)
    return t.reshape(b, -1, 4, 4)


def apply_transforms(T: torch.Tensor, points: torch.Tensor):
    """(B, V, 4, 4) x (B, V, 3) -> (B, V, 3) homogeneous transform."""
    return (torch.einsum("bvxy,bvy->bvx", T[..., :3, :3], points)
            + T[..., :3, 3])


def lbs(betas, pose, v_template, shapedirs, posedirs, j_regressor, parents,
        lbs_weights, *, pose2rot: bool = True, disable_posedirs: bool = False,
        vert_offsets=None) -> LBSOutput:
    """Full SMPL-style LBS."""
    batch_size = max(betas.shape[0], pose.shape[0])
    shape_offsets = blend_shapes(betas, shapedirs)
    v_shaped = v_template[None] + shape_offsets
    joints = vertices2joints(j_regressor, v_shaped)
    pose_feature, rot_mats = pose_feature_and_rotmats(pose, pose2rot,
                                                      batch_size)
    if disable_posedirs or posedirs is None:
        pose_offsets = torch.zeros_like(v_shaped)
    else:
        pose_offsets = (pose_feature @ posedirs).reshape(batch_size, -1, 3)
    v_posed = v_shaped + pose_offsets
    if vert_offsets is not None:
        v_posed = v_posed + vert_offsets
    posed_joints, A = batch_rigid_transform(rot_mats, joints, parents)
    T = skinning_transforms(A, lbs_weights)
    verts = apply_transforms(T, v_posed)
    return LBSOutput(verts=verts, joints=posed_joints, A=A, T=T,
                     v_posed=v_posed, v_shaped=v_shaped,
                     shape_offsets=shape_offsets, pose_offsets=pose_offsets)


def lbs_extra(A, v_shaped, lbs_weights, pose=None, posedirs=None, *,
              disable_posedirs: bool = True, pose2rot: bool = True):
    """Apply given per-joint transforms A (B, J, 4, 4) to points
    (B, V, 3) with weights (V, J). Returns (verts (B,V,3), T (B,V,4,4))."""
    batch_size = A.shape[0]
    if disable_posedirs or posedirs is None:
        v_posed = v_shaped
    else:
        pose_feature, _ = pose_feature_and_rotmats(pose, pose2rot, batch_size)
        v_posed = v_shaped + (pose_feature @ posedirs).reshape(
            batch_size, -1, 3)
    T = skinning_transforms(A, lbs_weights)
    verts = apply_transforms(T, v_posed)
    return verts, T
