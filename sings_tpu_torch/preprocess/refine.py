"""SMPL pose refinement from 2D keypoints + silhouettes (port of
sings_tpu/preprocess/refine.py; reference
preprocess/utils/ooptimize_smpl.py / ooptimize_smplh.py:263-455).

White opacity splats on the SMPL vertices render a soft silhouette
through the port's rasterizer (the composite kernels on the card, their
plain versions on the CPU); its MSE against the SAM2 mask, with a
joint-reprojection term, drives Adam over (global_orient, body_pose,
transl[, betas]). fit_skeleton is the keypoint-only stage before it.

Deviations from the JAX package:
  * the frames of a refine step go through one batched LBS and then one
    rasterize call each (JAX vmaps the frames through both);
  * the steps run as a host loop with no device-fault retry: every
    exception propagates (RefineConfig keeps scan_chunk and max_retries
    so the config surface matches; they are unused);
  * each step's loss (and px_err) stays on the device and is read once
    at the end.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kinematics.lbs import batch_rigid_transform, shaped_joints
from ..kinematics.template import DeviceTemplate, full_pose, smpl_forward
from ..ops.graphics import Camera, make_camera
from ..ops.rasterizer.api import rasterize
from ..ops.rotations import axis_angle_to_matrix
from ..train.optim import adam_directions, adam_init

# optax.adam's defaults (the JAX package's fit and refine optimizer)
ADAM_EPS = 1e-8


def coco17_to_smpl(coco2d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """COCO-17 keypoints -> SMPL 24-joint targets + validity mask
    (reference ooptimize_smpl.coco_to_smpl:36-56)."""
    assert coco2d.shape[-2:] == (17, 2)
    out = np.zeros(coco2d.shape[:-2] + (24, 2), np.float32)
    valid = np.zeros(coco2d.shape[:-2] + (24,), np.float32)
    pairs = [(1, 11), (2, 12), (4, 13), (5, 14), (7, 15), (8, 16),
             (16, 5), (17, 6), (18, 7), (19, 8), (20, 9), (21, 10)]
    for smpl_j, coco_j in pairs:
        out[..., smpl_j, :] = coco2d[..., coco_j, :]
        valid[..., smpl_j] = 1.0
    return out, valid


def coco133_to_smpl(coco2d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """COCO-133 (sapiens) -> SMPL joints for limb/feet refinement
    (reference ooptimize_smpl.coco133_to_smpl:64-101). Foot keypoints
    (toes/heels) are mapped onto the ankle/foot joints."""
    assert coco2d.shape[-2:] == (133, 2)
    out = np.zeros(coco2d.shape[:-2] + (24, 2), np.float32)
    valid = np.zeros(coco2d.shape[:-2] + (24,), np.float32)
    pairs = [(18, 7), (19, 8), (20, 9), (21, 10), (4, 13), (5, 14),
             (7, 15), (8, 16), (10, 17), (11, 20)]
    for smpl_j, coco_j in pairs:
        out[..., smpl_j, :] = coco2d[..., coco_j, :]
        valid[..., smpl_j] = 1.0
    return out, valid


# full-body COCO-133 -> SMPL-24 joint correspondence (reference body
# rows from ooptimize_smplh.coco17_to_smpl/coco133_to_smplh:33-117;
# feet via the big-toe keypoints)
_COCO133_SMPL_PAIRS = (
    (1, 11), (2, 12),      # hips
    (4, 13), (5, 14),      # knees
    (7, 15), (8, 16),      # ankles
    (10, 17), (11, 20),    # feet (big toes)
    (16, 5), (17, 6),      # shoulders
    (18, 7), (19, 8),      # elbows
    (20, 9), (21, 10),     # wrists
)


def coco133_body_targets(
    kp: np.ndarray, scores: np.ndarray, thresh: float = 0.8,
) -> tuple[np.ndarray, np.ndarray]:
    """Score-weighted full-body SMPL-24 keypoint targets.

    kp (F, 133, 2), scores (F, 133) -> targets (F, 24, 2) + weights
    (F, 24). Detections below `thresh` are discarded like the
    reference (ooptimize_smplh.py:334: joints_target[score < 0.8] = 0);
    the head joint is anchored at the ear midpoint."""
    assert kp.shape[-2:] == (133, 2)
    f = kp.shape[0]
    out = np.zeros((f, 24, 2), np.float32)
    w = np.zeros((f, 24), np.float32)
    for sj, cj in _COCO133_SMPL_PAIRS:
        out[:, sj] = kp[:, cj]
        w[:, sj] = np.where(scores[:, cj] >= thresh,
                            np.minimum(scores[:, cj], 1.0), 0.0)
    ear_ok = (scores[:, 3] >= thresh) & (scores[:, 4] >= thresh)
    out[:, 15] = 0.5 * (kp[:, 3] + kp[:, 4])
    w[:, 15] = np.where(ear_ok, 1.0, 0.0)
    return out, w


# COCO-133 face-anchor keypoints: nose, left eye, right eye, left ear,
# right ear, modelled as RIGID offsets in the head joint's local frame,
# shared by all frames and fit with the poses, so that the per-frame
# head rotation follows the detected face (2D joint positions alone
# cannot constrain it: the ear midpoint is yaw-invariant)
FACE_ANCHOR_COCO = (0, 1, 2, 3, 4)
FACE_ANCHOR_INIT = np.array(
    [[0.000, 0.060, 0.100],    # nose
     [0.033, 0.090, 0.090],    # left eye
     [-0.033, 0.090, 0.090],   # right eye
     [0.070, 0.060, 0.010],    # left ear
     [-0.070, 0.060, 0.010]],  # right ear
    np.float32)


def face_anchor_targets(
    kp: np.ndarray, scores: np.ndarray, thresh: float = 0.8,
) -> tuple[np.ndarray, np.ndarray]:
    """(F, 133, 2) sapiens keypoints -> (F, 5, 2) face-anchor targets
    + (F, 5) score weights (0 below `thresh` — back views have no
    face detections and contribute nothing)."""
    assert kp.shape[-2:] == (133, 2)
    idx = list(FACE_ANCHOR_COCO)
    t = kp[:, idx].astype(np.float32)
    s = scores[:, idx]
    w = np.where(s >= thresh, np.minimum(s, 1.0), 0.0).astype(np.float32)
    return t, w


class SkeletonFitConfig(NamedTuple):
    steps: int = 500
    lr: float = 0.02
    huber_px: float = 10.0        # robust width of the reprojection loss
    w_pose_prior: float = 1.0     # rad^2 toward the kit's initial poses
    # strong separate prior on global_orient: 2D keypoints cannot tell
    # a pitched body with stretched bones from an upright one, nor front
    # from back on profile frames; the kit's orientations are 3D-aware
    # (see the JAX package's SkeletonFitConfig for the sweep)
    w_orient_prior: float = 600.0
    w_beta_prior: float = 0.05
    w_temporal: float = 10.0      # adjacent-frame pose/transl smoothness
    w_face: float = 1.0           # face-anchor reprojection (head rot)
    w_face_offset_prior: float = 100.0  # m^2; keep offsets head-sized
    optimize_betas: bool = True


def posed_smpl_joints(template: DeviceTemplate, params: dict,
                      return_head_rot: bool = False):
    """(F, 24, 3) posed joint positions — the joints-only LBS prefix
    (blend shapes -> regressor -> kinematic chain), skipping the
    per-vertex skinning. return_head_rot: also the head joint's global
    rotation (F, 3, 3) for the rigid face-anchor reprojection."""
    f = params["body_pose"].shape[0]
    joints = shaped_joints(template, params["betas"])[None]  # (1, J, 3)
    pose = full_pose(template, params["global_orient"], params["body_pose"])
    rot = axis_angle_to_matrix(pose.reshape(f, -1, 3))
    posed, transforms = batch_rigid_transform(
        rot, joints.expand(f, -1, -1), template.parents)
    out = posed[:, :24] + params["transl"][:, None, :]
    if return_head_rot:
        # the world transforms carry the accumulated chain rotation; the
        # rest-joint correction only touches the translation
        return out, transforms[:, 15, :3, :3]
    return out


def project_px(points: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera-frame points -> (..., 2) pixel coords."""
    uvw = torch.einsum("...c,kc->...k", points, K)
    z = uvw[..., 2:]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    return uvw[..., :2] / z


def _huber_px(e: torch.Tensor, d: float) -> torch.Tensor:
    return torch.where(e <= d, 0.5 * e * e / d, e - 0.5 * d)


def _tensor(x, device) -> torch.Tensor:
    """A float32 copy on `device` (never a view of the caller's array)."""
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _tensors(arrays: dict, keys, device) -> dict:
    return {k: _tensor(arrays[k], device) for k in keys}


def _adam_step(params: dict, grads: dict, state, lr: float,
               frozen: tuple = ()):
    """optax.adam(lr) (eps 1e-8), with a zero update for `frozen` keys
    (optax.masked(scale(0)) in the JAX package): the moments still
    move."""
    direction, state = adam_directions(grads, state, eps=ADAM_EPS)
    new = {k: (p if k in frozen else p + (-lr) * direction[k]).detach()
           for k, p in params.items()}
    return new, state


def _grads(loss, params: dict) -> dict:
    leaves = list(params.values())
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), gs)}


def fit_skeleton(
    template: DeviceTemplate,
    K: np.ndarray,
    smpl_init: dict,
    kp_targets: np.ndarray,
    kp_weights: np.ndarray,
    cfg: SkeletonFitConfig = SkeletonFitConfig(),
    beta_mask: np.ndarray | None = None,
    face_targets: np.ndarray | None = None,
    face_weights: np.ndarray | None = None,
) -> dict:
    """Stage-A geometric alignment: keypoints only, no rendering.

    Jointly fits shared betas (the synthetic template's bone-proportion
    dims included) and per-frame pose/orient/transl to the sapiens 2D
    keypoints, on the template's device. Returns refined {betas,
    global_orient, body_pose, transl[, face_offsets], losses, px_err
    (mean weighted px error per step)} as numpy.

    beta_mask: optional (nb,) 0/1 — only masked-in beta dims receive
    gradient (the others stay exactly as given).
    """
    dev = template.v_template.device
    Kj = _tensor(K, dev)
    kp_t = _tensor(kp_targets, dev)
    kp_w = _tensor(kp_weights, dev)
    b_mask = None if beta_mask is None else _tensor(beta_mask, dev)
    use_face = (face_targets is not None and cfg.w_face > 0
                and float(np.sum(face_weights)) > 0)

    params = _tensors(smpl_init, ("global_orient", "body_pose", "transl",
                                  "betas"), dev)
    if use_face:
        face_t = _tensor(face_targets, dev)
        face_w = _tensor(face_weights, dev)
        params["face_offsets"] = _tensor(FACE_ANCHOR_INIT, dev)
    prior = {k: v.clone() for k, v in params.items()}

    def loss_fn(params):
        if b_mask is not None:
            params = dict(params)
            params["betas"] = (params["betas"] * b_mask
                               + params["betas"].detach() * (1 - b_mask))
        joints, head_rot = posed_smpl_joints(template, params,
                                             return_head_rot=True)
        uv = project_px(joints, Kj)
        e = torch.sqrt(torch.sum((uv - kp_t) ** 2, dim=-1) + 1e-8)  # px
        hub = _huber_px(e, cfg.huber_px)
        px_err = (e * kp_w).sum() / torch.clamp_min(kp_w.sum(), 1.0)
        l_kp = (hub * kp_w).sum() / torch.clamp_min(kp_w.sum(), 1.0)
        l_prior = torch.mean((params["body_pose"] - prior["body_pose"]) ** 2)
        l_orient = torch.mean(
            (params["global_orient"] - prior["global_orient"]) ** 2)
        l_beta = torch.mean(params["betas"] ** 2)
        l_temp = sum(torch.mean(torch.diff(params[k], dim=0) ** 2)
                     for k in ("body_pose", "global_orient", "transl"))
        total = (l_kp + cfg.w_pose_prior * l_prior
                 + cfg.w_orient_prior * l_orient
                 + cfg.w_beta_prior * l_beta + cfg.w_temporal * l_temp)
        if use_face:
            anchors = (joints[:, 15][:, None, :]
                       + torch.einsum("fxy,ay->fax", head_rot,
                                      params["face_offsets"]))
            fe = torch.sqrt(torch.sum(
                (project_px(anchors, Kj) - face_t) ** 2, dim=-1) + 1e-8)
            l_face = (_huber_px(fe, cfg.huber_px) * face_w).sum() \
                / torch.clamp_min(face_w.sum(), 1.0)
            l_off = torch.mean(
                (params["face_offsets"] - prior["face_offsets"]) ** 2)
            total = total + cfg.w_face * l_face \
                + cfg.w_face_offset_prior * l_off
        return total, px_err

    frozen = () if cfg.optimize_betas else ("betas",)
    state = adam_init(params)
    losses, pxs = [], []
    for _ in range(cfg.steps):
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        loss, px = loss_fn(leaves)
        grads = _grads(loss, leaves)
        params, state = _adam_step(params, grads, state, cfg.lr, frozen)
        losses.append(loss.detach())
        pxs.append(px.detach())
    out = {k: v.cpu().numpy() for k, v in params.items()}
    out["losses"] = torch.stack(losses).cpu().numpy() if losses else \
        np.zeros(0, np.float32)
    out["px_err"] = torch.stack(pxs).cpu().numpy() if pxs else \
        np.zeros(0, np.float32)
    return out


class RefineConfig(NamedTuple):
    steps: int = 300
    lr: float = 0.005
    w_silhouette: float = 1.0
    w_keypoints: float = 1e-4
    w_face: float = 1e-4          # face anchors (head rot), fixed offsets
    w_prior: float = 0.1          # stay close to the initial estimate
    w_orient_prior: float = 60.0  # see SkeletonFitConfig.w_orient_prior
    # silhouette splat size (m); None = auto, ~1.7x the template's
    # median vertex spacing (auto_splat_scale)
    splat_scale: float | None = None
    splat_opacity: float = 0.7
    optimize_betas: bool = False
    render_downscale: int = 4     # silhouettes at reduced resolution
    batch_frames: int = 8         # frames per step
    # the JAX package's steps per device dispatch and device-fault
    # retries; kept for the config surface, unused here: the port runs a
    # host loop and lets every exception propagate
    scan_chunk: int = 64
    max_retries: int = 4


def auto_splat_scale(template: DeviceTemplate) -> float:
    """~1.7x the template's median edge length — splats that tile the
    surface without fattening the silhouette (see RefineConfig)."""
    v = template.v_template.detach().cpu().numpy()
    f = template.faces.cpu().numpy()
    e = np.linalg.norm(v[f[:, 0]] - v[f[:, 1]], axis=-1)
    return float(np.clip(1.7 * np.median(e), 1e-4, 0.05))


def _silhouette(verts: torch.Tensor, camera: Camera, cfg: RefineConfig,
                raster_kw: dict) -> torch.Tensor:
    """Render a soft silhouette of a vertex cloud: (H, W) in [0, 1]."""
    n = verts.shape[0]
    scales = verts.new_full((n, 3), cfg.splat_scale)
    quats = verts.new_zeros((n, 4))
    quats[:, 0] = 1.0
    opac = verts.new_full((n,), cfg.splat_opacity)
    rgb = verts.new_ones((n, 3))
    pkg = rasterize(verts, scales, quats, opac, rgb, camera,
                    bg=verts.new_zeros(3), backend="pallas", **raster_kw)
    return torch.clamp(pkg["render"][0], 0.0, 1.0)


def default_refine_raster_kw(device: torch.device) -> dict:
    """The JAX package's refine raster settings: chunk 128 on the
    accelerator, 8 on the CPU (where JAX runs the kernels interpreted)."""
    chunk = 128 if device.type == "cuda" else 8
    return dict(tile=16, chunk=chunk, max_span=3)


def refine_objective(
    template: DeviceTemplate,
    camera: Camera,
    K: np.ndarray,
    smpl_init: dict,
    masks: np.ndarray,
    keypoints2d: np.ndarray | None = None,
    keypoint_valid: np.ndarray | None = None,
    cfg: RefineConfig = RefineConfig(),
    raster_kw: dict | None = None,
    face_targets: np.ndarray | None = None,
    face_weights: np.ndarray | None = None,
    face_offsets: np.ndarray | None = None,
):
    """refine_smpl's problem: (the initial parameters as tensors on the
    template's device, total_loss(params, step_i)), the loss of step
    step_i."""
    dev = template.v_template.device
    f = smpl_init["body_pose"].shape[0]
    d = cfg.render_downscale
    masks = np.asarray(masks)
    if d > 1:
        masks_lr = masks[:, ::d, ::d]
        Kd = np.array(K, copy=True)
        Kd[:2] /= d
        cam_lr = make_camera(np.eye(4, dtype=np.float32), masks_lr.shape[1],
                             masks_lr.shape[2], K=Kd, device=dev)
    else:
        masks_lr = masks
        cam_lr = camera.to(dev)
    if raster_kw is None:
        raster_kw = default_refine_raster_kw(dev)

    masks_d = _tensor(masks_lr, dev)
    kp = None if keypoints2d is None else _tensor(keypoints2d, dev)
    kp_valid = (None if keypoint_valid is None
                else _tensor(keypoint_valid, dev))
    Kj = _tensor(K, dev)

    params = _tensors(smpl_init, ("global_orient", "body_pose", "transl",
                                  "betas"), dev)
    prior = {k: v.clone() for k, v in params.items()}

    if cfg.splat_scale is None:
        cfg = cfg._replace(splat_scale=auto_splat_scale(template))

    use_sil = cfg.w_silhouette > 0.0
    use_kp = kp is not None and cfg.w_keypoints > 0.0
    use_face = (face_targets is not None and face_offsets is not None
                and cfg.w_face > 0.0 and float(np.sum(face_weights)) > 0)
    if use_face:
        face_t = _tensor(face_targets, dev)
        face_w = _tensor(face_weights, dev)
        face_o = _tensor(face_offsets, dev)  # calibrated in stage A, fixed

    nb = min(cfg.batch_frames, f)

    def sil_losses(params, idx):
        # one LBS for the step's frames, then one render each
        sel = torch.as_tensor(idx, device=dev)
        out = smpl_forward(template, params["betas"].reshape(1, -1),
                           params["body_pose"][sel],
                           params["global_orient"][sel],
                           disable_posedirs=template.posedirs is None)
        verts = out.verts + params["transl"][sel][:, None]
        return torch.stack([
            torch.mean((_silhouette(verts[j], cam_lr, cfg, raster_kw)
                        - masks_d[i]) ** 2) for j, i in enumerate(idx)])

    def total_loss(params, step_i):
        # zero-weight terms are left out, as in the JAX package (0 * inf
        # would be nan, and a disabled silhouette would still render)
        l = 0.0
        if use_kp or use_face:
            # keypoints + prior over all frames every step (joints only)
            joints, head_rot = posed_smpl_joints(template, params,
                                                 return_head_rot=True)
        if use_kp:
            uv = project_px(joints, Kj)
            e = torch.sqrt(torch.sum((uv - kp) ** 2, dim=-1) + 1e-8)
            hub = _huber_px(e, 10.0)
            if kp_valid is not None:
                l_kp = (hub * kp_valid).sum() / torch.clamp_min(
                    kp_valid.sum(), 1.0)
            else:
                l_kp = hub.mean()
            l = l + cfg.w_keypoints * l_kp
        if use_face:
            anchors = (joints[:, 15][:, None, :]
                       + torch.einsum("fxy,ay->fax", head_rot, face_o))
            fe = torch.sqrt(torch.sum(
                (project_px(anchors, Kj) - face_t) ** 2, dim=-1) + 1e-8)
            l_face = (_huber_px(fe, 10.0) * face_w).sum() \
                / torch.clamp_min(face_w.sum(), 1.0)
            l = l + cfg.w_face * l_face
        if use_sil:
            # a deterministic round-robin frame batch
            idx = [(step_i * nb + j) % f for j in range(nb)]
            l = l + cfg.w_silhouette * sil_losses(params, idx).mean()
        l_prior = sum(torch.mean((params[k] - prior[k]) ** 2)
                      for k in ("body_pose", "transl"))
        l_orient = torch.mean(
            (params["global_orient"] - prior["global_orient"]) ** 2)
        return l + cfg.w_prior * l_prior + cfg.w_orient_prior * l_orient

    return params, total_loss


def refine_smpl(
    template: DeviceTemplate,
    camera: Camera,
    K: np.ndarray,
    smpl_init: dict,
    masks: np.ndarray,
    keypoints2d: np.ndarray | None = None,
    keypoint_valid: np.ndarray | None = None,
    cfg: RefineConfig = RefineConfig(),
    raster_kw: dict | None = None,
    face_targets: np.ndarray | None = None,
    face_weights: np.ndarray | None = None,
    face_offsets: np.ndarray | None = None,
) -> dict:
    """Jointly refine per-frame SMPL parameters on the template's device.

    smpl_init: {'betas' (nb,), 'global_orient' (F,3),
                'body_pose' (F,69), 'transl' (F,3)} axis-angle.
    masks: (F, H, W) float; keypoints2d: (F, 24, 2) pixel coords.
    Returns the same dict with refined values as numpy, plus 'losses'
    (poses_optimized contract, reference ooptimize_smplh.py:445-455).
    """
    params, total_loss = refine_objective(
        template, camera, K, smpl_init, masks, keypoints2d, keypoint_valid,
        cfg, raster_kw, face_targets, face_weights, face_offsets)
    frozen = () if cfg.optimize_betas else ("betas",)
    state = adam_init(params)
    losses = []
    for step_i in range(cfg.steps):
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        loss = total_loss(leaves, step_i)
        grads = _grads(loss, leaves)
        # a non-finite gradient zeroes every gradient of the step (the
        # trainer has the same guard); Adam still runs, so the moments
        # decay and the parameters move by momentum
        finite = torch.stack([torch.isfinite(g).all()
                              for g in grads.values()]).all()
        grads = {k: torch.where(finite, g, torch.zeros_like(g))
                 for k, g in grads.items()}
        params, state = _adam_step(params, grads, state, cfg.lr, frozen)
        losses.append(loss.detach())
    out = {k: v.cpu().numpy() for k, v in params.items()}
    out["losses"] = torch.stack(losses).cpu().numpy() if losses else \
        np.zeros(0, np.float32)
    return out
