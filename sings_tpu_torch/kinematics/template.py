"""Posable body template on the device: SMPL forward + canonical-pose
cache (port of sings_tpu/kinematics/template.py)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .body_model import BodyTemplate
from .lbs import LBSOutput, lbs
from .poses import predefined_pose


def _t(x, device):
    return None if x is None else torch.as_tensor(np.asarray(x),
                                                  device=device)


class DeviceTemplate(NamedTuple):
    """BodyTemplate arrays as tensors + python metadata."""

    v_template: torch.Tensor
    shapedirs: torch.Tensor
    posedirs: torch.Tensor | None
    j_regressor: torch.Tensor
    parents: np.ndarray       # host-side: the chain is unrolled in python
    lbs_weights: torch.Tensor
    faces: torch.Tensor
    num_body_joints: int
    hands_components: torch.Tensor | None = None
    hands_mean: torch.Tensor | None = None

    @classmethod
    def from_host(cls, tpl: BodyTemplate, device="cpu") -> "DeviceTemplate":
        nbj = 23 if tpl.num_joints == 24 else 21
        return cls(
            v_template=_t(tpl.v_template, device),
            shapedirs=_t(tpl.shapedirs, device),
            posedirs=_t(tpl.posedirs, device),
            j_regressor=_t(tpl.j_regressor, device),
            parents=np.asarray(tpl.parents),
            lbs_weights=_t(tpl.lbs_weights, device),
            faces=_t(tpl.faces, device),
            num_body_joints=nbj,
            hands_components=_t(getattr(tpl, "hands_components", None),
                                device),
            hands_mean=_t(getattr(tpl, "hands_mean", None), device),
        )


def full_pose(tpl: DeviceTemplate, global_orient, body_pose,
              left_hand_pose=None, right_hand_pose=None,
              num_pca_comps: int = 6) -> torch.Tensor:
    """(B, J*3) full pose: root + body (+ MANO hand PCA with the
    non-flat hand mean; zeros for templates without MANO data)."""
    b = body_pose.shape[0]
    nj = tpl.parents.shape[0]
    body = body_pose[:, : tpl.num_body_joints * 3]
    rest = nj - 1 - tpl.num_body_joints
    parts = [global_orient.reshape(b, 3), body]
    if rest > 0:
        if tpl.hands_components is not None and rest == 30:
            comps = tpl.hands_components[:, :num_pca_comps]
            for side, coeff in enumerate((left_hand_pose, right_hand_pose)):
                base = tpl.hands_mean[side][None].expand(b, 45).to(
                    body_pose.dtype)
                if coeff is not None:
                    base = base + torch.einsum(
                        "bi,ij->bj", coeff.reshape(b, -1),
                        comps[side][: coeff.shape[-1]])
                parts.append(base)
        else:
            parts.append(body_pose.new_zeros((b, rest * 3)))
    return torch.cat(parts, dim=1)


def smpl_forward(tpl: DeviceTemplate, betas, body_pose, global_orient=None,
                 *, disable_posedirs: bool = False, left_hand_pose=None,
                 right_hand_pose=None) -> LBSOutput:
    """Pose the template. betas (B, nb) or (nb,), body_pose (B, 69/63)
    or 1-D, global_orient (B, 3), (3,) or None."""
    if betas.ndim == 1:
        betas = betas[None]
    if body_pose.ndim == 1:
        body_pose = body_pose[None]
    b = max(betas.shape[0], body_pose.shape[0])
    if betas.shape[0] != b:
        betas = betas.expand(b, betas.shape[-1])
    if body_pose.shape[0] != b:
        body_pose = body_pose.expand(b, body_pose.shape[-1])
    if global_orient is None:
        global_orient = body_pose.new_zeros((b, 3))
    elif global_orient.ndim == 1:
        global_orient = global_orient[None].expand(b, 3)
    pose = full_pose(tpl, global_orient, body_pose,
                     left_hand_pose=left_hand_pose,
                     right_hand_pose=right_hand_pose)
    return lbs(betas, pose, tpl.v_template, tpl.shapedirs, tpl.posedirs,
               tpl.j_regressor, tpl.parents, tpl.lbs_weights,
               pose2rot=True, disable_posedirs=disable_posedirs)


class CanonicalCache(NamedTuple):
    canonical_verts: torch.Tensor   # (V, 3)
    A_t2cano: torch.Tensor          # (J, 4, 4)
    inv_A_t2cano: torch.Tensor      # (J, 4, 4)
    canonical_offsets: torch.Tensor  # (V, 3)


def canonical_pose_cache(tpl: DeviceTemplate, betas: torch.Tensor,
                         pose_type: str = "da_pose") -> CanonicalCache:
    body_pose = torch.as_tensor(predefined_pose(pose_type),
                                device=betas.device)[None]
    out = smpl_forward(tpl, betas.reshape(1, -1), body_pose,
                       disable_posedirs=False)
    return CanonicalCache(
        canonical_verts=out.verts[0],
        A_t2cano=out.A[0],
        inv_A_t2cano=torch.linalg.inv(out.A[0]),
        canonical_offsets=(out.shape_offsets + out.pose_offsets)[0],
    )
