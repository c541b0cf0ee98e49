"""Mesh-anchored gaussian avatar: state + forward (port of
sings_tpu/model/avatar.py, the animation subset).

Per-gaussian arrays live in fixed-capacity buffers with an `alive` mask,
exactly as in the JAX package, so a JAX checkpoint maps leaf for leaf.
get_gs_attrs decodes the canonical attributes once; avatar_forward_chunk
poses B frames with batched LBS.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..fields.decoders import (
    DecoderConfig, appearance_decoder, geometry_decoder,
    init_appearance_decoder, init_geometry_decoder,
)
from ..fields.triplane import TriplaneConfig, init_triplane, triplane_features
from ..kinematics.body_model import BodyTemplate
from ..kinematics.lbs import lbs_extra
from ..kinematics.template import CanonicalCache, DeviceTemplate, smpl_forward
from ..mesh.ops import vertex_normals
from ..ops.rotations import (
    axis_angle_to_rotation_6d, matrix_to_quaternion, quaternion_multiply,
    rotation_6d_to_axis_angle, rotation_6d_to_matrix,
)


class AvatarConfig(NamedTuple):
    capacity: int
    face_capacity: int
    edge_capacity: int
    num_frames: int
    num_betas: int = 10
    sh_degree: int = 3
    isotropic: bool = True
    fixed_opacity: bool = False
    init_opacity: float = 0.8
    init_scale_multiplier: float = 0.25
    thickness_factor: float = 1.0
    disable_posedirs: bool = True
    canonical_pose: str = "da_pose"
    body_template: str = "smplh"
    triplane: TriplaneConfig = TriplaneConfig()
    decoder: DecoderConfig = DecoderConfig()
    offset_clamp: float = 0.0
    scale_clamp: float = 0.0


class AvatarParams(NamedTuple):
    """Trainable parameters; field order is the checkpoint leaf order."""

    xyz: torch.Tensor            # (C, 3)
    triplane: Any                # {"grids": [[(C,H,W) x3] per scale]}
    geometry_dec: Any
    appearance_dec: Any
    global_orient: torch.Tensor  # (F, 6)
    body_pose: torch.Tensor      # (F, 23*6)
    transl: torch.Tensor         # (F, 3)
    betas: torch.Tensor          # (num_betas,)


class AvatarBuffers(NamedTuple):
    """Non-trainable per-gaussian + topology state (static shapes)."""

    alive: torch.Tensor               # (C,) float 0/1
    scaling_multiplier: torch.Tensor  # (C, 1)
    opacity_offset: torch.Tensor      # (C, 1)
    lbs_weights: torch.Tensor         # (C, J)
    vertex_label: torch.Tensor        # (C,) int32
    anchor_normals: torch.Tensor      # (C, 3)
    faces: torch.Tensor               # (Fc, 3) int32
    face_valid: torch.Tensor          # (Fc,)
    edges: torch.Tensor               # (Ec, 2) int32
    edge_valid: torch.Tensor          # (Ec,)
    num_level0: torch.Tensor          # () int32
    max_radii2d: torch.Tensor         # (C,)
    xyz_grad_accum: torch.Tensor      # (C,)
    grad_denom: torch.Tensor          # (C,)


class AvatarState(NamedTuple):
    params: AvatarParams
    buffers: AvatarBuffers
    active_sh_degree: int


def _aa_to_6d_np(aa: np.ndarray) -> np.ndarray:
    return axis_angle_to_rotation_6d(
        torch.as_tensor(np.asarray(aa, np.float32))).numpy()


def init_avatar(generator: torch.Generator, cfg: AvatarConfig,
                tpl: BodyTemplate, cache: CanonicalCache,
                smpl_params: dict | None = None,
                device="cpu") -> AvatarState:
    """Initial state from the (subdivided) body template: anchors at the
    canonical-pose vertices, random triplane/decoders from `generator`."""
    c = cfg.capacity
    n = tpl.num_verts
    assert n <= c, f"capacity {c} < template verts {n}"

    canon = cache.canonical_verts.detach().cpu().numpy()
    xyz = np.zeros((c, 3), np.float32)
    xyz[:n] = canon

    if smpl_params is not None:
        f = smpl_params["body_pose"].shape[0]
        go6 = _aa_to_6d_np(smpl_params["global_orient"].reshape(-1, 3)
                           ).reshape(f, 6)
        bp = smpl_params["body_pose"].reshape(f, -1, 3)[:, :23]
        bp6 = _aa_to_6d_np(bp.reshape(-1, 3)).reshape(f, 23 * 6)
        transl = smpl_params["transl"].astype(np.float32)
        betas = smpl_params["betas"].reshape(-1)[: cfg.num_betas].astype(
            np.float32)
    else:
        f = max(cfg.num_frames, 1)
        ident6 = _aa_to_6d_np(np.zeros((1, 3)))
        go6 = np.tile(ident6, (f, 1))
        bp6 = np.tile(ident6, (f, 23)).reshape(f, 23 * 6)
        transl = np.zeros((f, 3), np.float32)
        betas = np.zeros(cfg.num_betas, np.float32)

    def t(x):
        return torch.as_tensor(np.array(x), device=device)

    params = AvatarParams(
        xyz=t(xyz),
        triplane=init_triplane(generator, cfg.triplane, device),
        geometry_dec=init_geometry_decoder(generator, cfg.decoder, device),
        appearance_dec=init_appearance_decoder(generator, cfg.decoder,
                                               device),
        global_orient=t(go6.astype(np.float32)),
        body_pose=t(bp6.astype(np.float32)),
        transl=t(transl),
        betas=t(betas),
    )

    nj = tpl.lbs_weights.shape[1]
    lbsw = np.zeros((c, nj), np.float32)
    lbsw[:n] = tpl.lbs_weights
    lbsw[n:, 0] = 1.0  # dead slots ride the root joint
    labels = np.full(c, -1, np.int32)
    labels[:n] = tpl.vertex_label
    normals = np.zeros((c, 3), np.float32)
    normals[:n] = vertex_normals(canon, tpl.faces)
    fc, ec = cfg.face_capacity, cfg.edge_capacity
    assert len(tpl.faces) <= fc and len(tpl.edges) <= ec
    faces = np.zeros((fc, 3), np.int32)
    faces[: len(tpl.faces)] = tpl.faces
    fvalid = np.zeros(fc, np.float32)
    fvalid[: len(tpl.faces)] = 1.0
    edges = np.zeros((ec, 2), np.int32)
    edges[: len(tpl.edges)] = tpl.edges
    evalid = np.zeros(ec, np.float32)
    evalid[: len(tpl.edges)] = 1.0
    alive = np.zeros(c, np.float32)
    alive[:n] = 1.0

    buffers = AvatarBuffers(
        alive=t(alive),
        scaling_multiplier=t(np.ones((c, 1), np.float32)),
        opacity_offset=t(np.zeros((c, 1), np.float32)),
        lbs_weights=t(lbsw),
        vertex_label=t(labels),
        anchor_normals=t(normals),
        faces=t(faces),
        face_valid=t(fvalid),
        edges=t(edges),
        edge_valid=t(evalid),
        num_level0=t(np.asarray(n, np.int32)),
        max_radii2d=t(np.zeros(c, np.float32)),
        xyz_grad_accum=t(np.zeros(c, np.float32)),
        grad_denom=t(np.zeros(c, np.float32)),
    )
    return AvatarState(params=params, buffers=buffers, active_sh_degree=0)


def get_gs_attrs(params: AvatarParams, buffers: AvatarBuffers,
                 cfg: AvatarConfig) -> dict:
    """Triplane -> decoders -> canonical gaussian attributes."""
    feats = triplane_features(params.triplane, params.xyz, cfg.triplane)
    geo = geometry_decoder(params.geometry_dec, feats, cfg.decoder)
    app = appearance_decoder(params.appearance_dec, feats, cfg.decoder,
                             opacity_offset=buffers.opacity_offset)
    scales = geo["scales"]
    thick = torch.ones(3, dtype=scales.dtype, device=scales.device)
    thick[-1] = cfg.thickness_factor
    scales = scales * thick * buffers.scaling_multiplier
    if cfg.scale_clamp > 0:
        # leaky ceiling, slope 0.05 above the clamp
        c = cfg.scale_clamp
        scales = torch.where(scales > c, c + 0.05 * (scales - c), scales)
    offsets = geo["xyz_offsets"]
    if cfg.offset_clamp > 0:
        offsets = cfg.offset_clamp * torch.tanh(offsets / cfg.offset_clamp)
    return {
        "xyz_canon": params.xyz + offsets,
        "xyz_offsets": offsets,
        "rot6d_canon": geo["rotations"],
        "scales_aux": geo["scales_aux"],
        "scales": scales,
        "opacity": app["opacity"],
        "shs": app["shs"],
    }


def _canon_rotations(gs_attrs: dict, cfg: AvatarConfig, n: int, like):
    if cfg.isotropic:
        rotmat = torch.eye(3, dtype=like.dtype,
                           device=like.device).expand(n, 3, 3)
        rotq = like.new_zeros((n, 4))
        rotq[:, 0] = 1.0
    else:
        rotmat = rotation_6d_to_matrix(gs_attrs["rot6d_canon"])
        rotq = matrix_to_quaternion(rotmat)
    return rotmat, rotq


def avatar_forward(params: AvatarParams, buffers: AvatarBuffers,
                   cfg: AvatarConfig, template: DeviceTemplate,
                   cache: CanonicalCache, *, global_orient=None,
                   body_pose=None, betas=None, transl=None, smpl_scale=None,
                   dataset_idx: int = 0, ext_tfs=None,
                   gs_attrs: dict | None = None,
                   active_sh_degree: int = 0) -> dict:
    """Single-frame forward; explicit SMPL args override the learned
    per-frame parameters of frame `dataset_idx`."""
    if gs_attrs is None:
        gs_attrs = get_gs_attrs(params, buffers, cfg)
    xyz_canon = gs_attrs["xyz_canon"]
    n = xyz_canon.shape[0]
    rotmat_canon, rotq_canon = _canon_rotations(gs_attrs, cfg, n, xyz_canon)

    if global_orient is None:
        global_orient = rotation_6d_to_axis_angle(
            params.global_orient[dataset_idx].reshape(1, 6)).reshape(3)
    if body_pose is None:
        body_pose = rotation_6d_to_axis_angle(
            params.body_pose[dataset_idx].reshape(-1, 6)).reshape(-1)
    if betas is None:
        betas = params.betas
    if transl is None:
        transl = params.transl[dataset_idx]

    smpl_out = smpl_forward(template, betas.reshape(1, -1),
                            body_pose.reshape(1, -1),
                            global_orient.reshape(1, 3),
                            disable_posedirs=False)
    a_cano2pose = smpl_out.A[0] @ cache.inv_A_t2cano
    xyz_def, lbs_t = lbs_extra(a_cano2pose[None], xyz_canon[None],
                               buffers.lbs_weights,
                               disable_posedirs=cfg.disable_posedirs)
    xyz_def = xyz_def[0]
    lbs_t = lbs_t[0]
    scales = gs_attrs["scales"]
    if smpl_scale is not None:
        s = smpl_scale.reshape(-1)[0]
        xyz_def = xyz_def * s
        scales = scales * s
    xyz_def = xyz_def + transl.reshape(1, 3)
    rotq_def = matrix_to_quaternion(lbs_t[:, :3, :3] @ rotmat_canon)
    if ext_tfs is not None:
        etrans, erot, escale = ext_tfs
        erot = erot.reshape(3, 3)
        escale = escale.reshape(-1)[0]
        xyz_def = etrans.reshape(1, 3) + escale * (xyz_def @ erot.T)
        scales = escale * scales
        rotq_def = quaternion_multiply(matrix_to_quaternion(erot)[None],
                                       rotq_def)
    return {
        "xyz": xyz_def, "xyz_canon": xyz_canon, "scales": scales,
        "rotq": rotq_def, "rotq_canon": rotq_canon,
        "shs": gs_attrs["shs"], "opacity": gs_attrs["opacity"],
        "active_sh_degree": active_sh_degree, "alive": buffers.alive,
    }


def avatar_forward_chunk(params: AvatarParams, buffers: AvatarBuffers,
                         cfg: AvatarConfig, template: DeviceTemplate,
                         cache: CanonicalCache, gs_attrs: dict, *,
                         global_orient, body_pose, betas, transl,
                         smpl_scale=None, ext_tfs=None,
                         active_sh_degree: int = 0) -> dict:
    """Batched animation forward: decode once (gs_attrs), pose B frames.
    shs and opacity are broadcast views over B (.expand), not copies."""
    b = body_pose.shape[0]
    xyz_canon = gs_attrs["xyz_canon"]
    n = xyz_canon.shape[0]
    rotmat_canon, _ = _canon_rotations(gs_attrs, cfg, n, xyz_canon)

    smpl_out = smpl_forward(
        template, betas.reshape(1, -1).expand(b, betas.shape[-1]),
        body_pose, global_orient, disable_posedirs=False)
    a_cano2pose = smpl_out.A @ cache.inv_A_t2cano[None]
    xyz_def, lbs_t = lbs_extra(a_cano2pose, xyz_canon[None].expand(b, n, 3),
                               buffers.lbs_weights,
                               disable_posedirs=cfg.disable_posedirs)
    scales = gs_attrs["scales"][None].expand(b, n, 3)
    if smpl_scale is not None:
        xyz_def = xyz_def * smpl_scale[:, None, :]
        scales = scales * smpl_scale[:, None, :]
    xyz_def = xyz_def + transl[:, None, :]
    rotq_def = matrix_to_quaternion(lbs_t[..., :3, :3] @ rotmat_canon[None])
    if ext_tfs is not None:
        etrans, erot, escale = ext_tfs
        xyz_def = etrans[:, None, :] + escale[:, None, :] * torch.einsum(
            "bxy,bny->bnx", erot, xyz_def)
        scales = escale[:, None, :] * scales
        rotq_def = quaternion_multiply(matrix_to_quaternion(erot)[:, None, :],
                                       rotq_def)
    return {
        "xyz": xyz_def,
        "scales": scales,
        "rotq": rotq_def,
        "shs": gs_attrs["shs"][None].expand((b,) + gs_attrs["shs"].shape),
        "opacity": gs_attrs["opacity"][None].expand(
            (b,) + gs_attrs["opacity"].shape),
        "active_sh_degree": active_sh_degree,
        "alive": buffers.alive,
    }
