"""Mesh-anchored gaussian avatar: state + forward (port of
sings_tpu/model/avatar.py).

Per-gaussian arrays live in fixed-capacity buffers with an `alive` mask,
exactly as in the JAX package, so a JAX checkpoint maps leaf for leaf.
get_gs_attrs decodes the canonical attributes; avatar_forward poses one
frame with every output the training step reads; avatar_forward_chunk
poses B frames with batched LBS; initial_attr_targets and
fit_initial_attrs pre-fit the decoders before training.
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
    axis_angle_to_rotation_6d, matrix_to_quaternion, matrix_to_rotation_6d,
    quaternion_multiply, rotation_6d_to_axis_angle, rotation_6d_to_matrix,
    rotation_matrix_from_vectors,
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
                 cfg: AvatarConfig, *, opt_geo: bool = True,
                 opt_app: bool = True) -> dict:
    """Triplane -> decoders -> canonical gaussian attributes. opt_geo /
    opt_app False detach the geometry / appearance decoder outputs."""
    feats = triplane_features(params.triplane, params.xyz, cfg.triplane)
    geo = geometry_decoder(params.geometry_dec, feats, cfg.decoder)
    app = appearance_decoder(params.appearance_dec, feats, cfg.decoder,
                             opacity_offset=buffers.opacity_offset)
    if not opt_geo:
        geo = {k: None if v is None else v.detach() for k, v in geo.items()}
    if not opt_app:
        app = {k: v.detach() for k, v in app.items()}
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


def get_canon_xyz(params: AvatarParams, buffers: AvatarBuffers,
                  cfg: AvatarConfig) -> torch.Tensor:
    """Canonical gaussian centres only (triplane + geometry decoder): the
    input of the chunk-head KNN edge statistic."""
    feats = triplane_features(params.triplane, params.xyz, cfg.triplane)
    offsets = geometry_decoder(params.geometry_dec, feats,
                               cfg.decoder)["xyz_offsets"]
    if cfg.offset_clamp > 0:
        offsets = cfg.offset_clamp * torch.tanh(offsets / cfg.offset_clamp)
    return params.xyz + offsets


def _frame_row(x: torch.Tensor, idx) -> torch.Tensor:
    """x[idx] for a Python int or a tensor index (index_select keeps a
    device index on the device)."""
    if isinstance(idx, torch.Tensor):
        return x.index_select(0, idx.reshape(1).to(x.device))[0]
    return x[idx]


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
                   dataset_idx=0, ext_tfs=None, opt_geo: bool = True,
                   opt_app: bool = True, eval_mode: bool = False,
                   gs_attrs: dict | None = None,
                   active_sh_degree: int = 0) -> dict:
    """Single-frame forward; explicit SMPL args override the learned
    per-frame parameters of frame `dataset_idx` (an int or a 0-d
    tensor). Outside eval_mode it adds the laplacian anchors
    xyz_anchor_canon."""
    if gs_attrs is None:
        gs_attrs = get_gs_attrs(params, buffers, cfg, opt_geo=opt_geo,
                                opt_app=opt_app)
    xyz_canon = gs_attrs["xyz_canon"]
    n = xyz_canon.shape[0]
    rotmat_canon, rotq_canon = _canon_rotations(gs_attrs, cfg, n, xyz_canon)

    if global_orient is None:
        global_orient = rotation_6d_to_axis_angle(_frame_row(
            params.global_orient, dataset_idx).reshape(1, 6)).reshape(3)
    if body_pose is None:
        body_pose = rotation_6d_to_axis_angle(_frame_row(
            params.body_pose, dataset_idx).reshape(-1, 6)).reshape(-1)
    if betas is None:
        betas = params.betas
    if transl is None:
        transl = _frame_row(params.transl, dataset_idx)

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
    out = {
        "xyz": xyz_def, "xyz_canon": xyz_canon,
        "xyz_offsets": gs_attrs["xyz_offsets"], "scales": scales,
        "scales_canon": gs_attrs["scales"],
        "scales_aux": gs_attrs["scales_aux"],
        "rotq": rotq_def, "rotq_canon": rotq_canon,
        "rotmat_canon": rotmat_canon,
        "shs": gs_attrs["shs"], "opacity": gs_attrs["opacity"],
        "active_sh_degree": active_sh_degree, "alive": buffers.alive,
    }
    if not eval_mode:
        # laplacian anchors: gaussians pushed along the canonical vertex
        # normals by half their mean (posed) scale
        mean_scales = scales.mean(dim=-1, keepdim=True)
        out["xyz_anchor_canon"] = (xyz_canon + mean_scales
                                   * buffers.anchor_normals / 2.0)
    return out


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


def initial_attr_targets(cfg: AvatarConfig, tpl: BodyTemplate,
                         cache: CanonicalCache, device="cpu") -> dict:
    """Regression targets of the decoder pre-fit: scale = longest
    incident edge * init_scale_multiplier, dc colour 0.5, rotation
    aligning +z to the canonical normal, opacity init_opacity."""
    c = cfg.capacity
    n = tpl.num_verts
    canon = cache.canonical_verts.detach().cpu().numpy()
    edges = tpl.edges
    el = np.linalg.norm(canon[edges[:, 0]] - canon[edges[:, 1]], axis=1)
    max_len = np.zeros(n, np.float32)
    np.maximum.at(max_len, edges[:, 0], el)
    np.maximum.at(max_len, edges[:, 1], el)
    scales_t = np.zeros((c, 3), np.float32)
    scales_t[:n] = (max_len * cfg.init_scale_multiplier)[:, None]
    scales_t[:n, 2] *= cfg.thickness_factor
    scales_t = np.maximum(scales_t, 1e-5)
    scales_aux_t = np.log(np.expm1(np.maximum(scales_t, 1e-6)))

    shs_t = np.zeros((c, 16, 3), np.float32)
    shs_t[:n, 0, :] = 0.5

    normals = vertex_normals(canon, tpl.faces)
    z = np.zeros((n, 3), np.float32)
    z[:, 2] = 1.0
    rot = rotation_matrix_from_vectors(torch.as_tensor(z),
                                       torch.as_tensor(normals))
    rot6d_t = np.zeros((c, 6), np.float32)
    rot6d_t[:n] = matrix_to_rotation_6d(rot).numpy()

    opacity_t = np.zeros((c, 1), np.float32)
    opacity_t[:n] = cfg.init_opacity

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return {
        "xyz_offsets": torch.zeros((c, 3), device=device),
        "scales": t(scales_t),
        "scales_aux": t(scales_aux_t),
        "rot6d_canon": t(rot6d_t),
        "shs": t(shs_t),
        "opacity": t(opacity_t),
    }


def fit_initial_attrs(params: AvatarParams, buffers: AvatarBuffers,
                      cfg: AvatarConfig, targets: dict, *, steps: int = 500,
                      lr: float = 1e-3):
    """Pre-fit triplane and decoders to the geometric targets: `steps`
    Adam(lr, eps 1e-15) steps on sum over targets of
    mean(((pred - target) * alive)^2). Returns (params, (steps,) losses)."""
    from ..train.optim import adam_directions, adam_init
    from ..tree import tree_leaves, tree_map

    fields = ("triplane", "geometry_dec", "appearance_dec")
    trainable = {f: getattr(params, f) for f in fields}
    state = adam_init(trainable)
    alive = buffers.alive[:, None]
    losses = []
    for _ in range(steps):
        tr = tree_map(lambda x: x.detach().requires_grad_(True), trainable)
        out = get_gs_attrs(params._replace(**tr), buffers, cfg)
        total = 0.0
        for k, tgt in targets.items():
            if out.get(k) is None:
                continue
            pred = out[k]
            m = alive.reshape((-1,) + (1,) * (pred.ndim - 1))
            total = total + torch.mean(((pred - tgt) * m) ** 2)
        leaves = tree_leaves(tr)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        it = iter([torch.zeros_like(x) if g is None else g
                   for x, g in zip(leaves, grads)])
        grad_tree = tree_map(lambda _: next(it), tr)
        direction, state = adam_directions(grad_tree, state)
        trainable = tree_map(lambda p, d: (p + (-lr) * d).detach(),
                             trainable, direction)
        losses.append(total.detach())
    losses = torch.stack(losses) if losses else buffers.alive.new_zeros(0)
    return params._replace(**trainable), losses
