"""Posing an avatar's gaussians for B frames: the skeleton and linear
blend skinning (what sings_tpu/model/avatar.py's avatar_forward and
avatar_forward_chunk read of sings_tpu/kinematics/lbs.py and
ops/rotations.py).

pose_gaussians(template, inv_a, ...) -> (xyz, rotq, scales), each (B, N, .):
  * the skeleton: each frame's pose rows (6D rows through the JAX
    package's round trip rotation_6d_to_axis_angle, or axis-angle), the
    joints past the body at the template's rest pose (full_pose), the
    joints of betas (lbs.shaped_joints: smpl_forward's own regression of
    the shaped template, its bits), the kinematic chain, and
    A @ inv_A_t2cano. No template vertex is posed: of smpl_forward,
    avatar_forward reads only A and the joints.
  * the skinning: each gaussian's blended transform, its posed centre
    (smpl_scale, transl, ext_tfs), its rotation T[:3, :3] @ rotmat_canon
    (rotmat None: the identity, an isotropic avatar) as a quaternion, its
    scales (smpl_scale and ext_tfs' scale).
  * CUDA tensors: csrc/pose.cu through one autograd Function (_Pose):
    pose_skeleton_fwd then pose_skin_fwd; in its backward pose_skin_bwd
    (each CTA's sums of the transforms' and the frame terms' gradients)
    then pose_skeleton_bwd (their reduction, the chain in reverse, the
    pose rows' and the joints' gradients, in double). The kernels take
    axis-angle rows: learned 6D rows go through rotation_6d_to_axis_angle's
    torch ops first, and the kernels round as the plain version's torch
    ops do, so that a training frame's outputs are its bits on an H100
    (csrc/pose.cu). float32 tensors only; no host wait. A CUDA input that
    the kernels do not take raises. LAUNCHES counts each kernel's
    launches.
  * CPU tensors: skeleton_plain and skin_plain, torch ops under autograd.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..ops import cuda_build
from ..ops.rotations import (
    axis_angle_to_matrix, matrix_to_quaternion, quaternion_multiply,
    rotation_6d_to_axis_angle,
)
from .lbs import batch_rigid_transform, lbs_extra, shaped_joints

# launches of the CUDA kernels, never of the plain version
LAUNCHES = {"pose_skeleton_fwd": 0, "pose_skeleton_bwd": 0,
            "pose_skin_fwd": 0, "pose_skin_bwd": 0}

MAX_JOINTS = 64    # csrc/pose.cu's kMaxJoints
FRAME = 24         # its kFrame: a frame's terms
EXTRA = 21         # its kExtra: their gradient's slots
FWD_THREADS, BWD_THREADS = 128, 256


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class Frames(NamedTuple):
    """B frames' inputs. go (B, 6) 6D rows (go6) or (B, 3) axis-angle;
    bp (B, L) the body pose, 6D rows (bp6) or axis-angle triples, of
    which the first num_body_joints rows are read; transl (B, 3);
    smpl_scale (B,) or None; ext_tfs (etrans (B, 3), erot (B, 3, 3),
    escale (B,)) or None."""

    go: torch.Tensor
    bp: torch.Tensor
    go6: bool
    bp6: bool
    betas: torch.Tensor
    transl: torch.Tensor
    smpl_scale: torch.Tensor | None = None
    ext_tfs: tuple | None = None


def pose_gaussians(template, inv_a: torch.Tensor, frames: Frames,
                   xyz: torch.Tensor, scales: torch.Tensor,
                   rotmat: torch.Tensor | None, lbs_weights: torch.Tensor):
    """The gaussians (xyz (N, 3), scales (N, 3), rotmat (N, 3, 3) or
    None, lbs_weights (N, J)) posed in each frame: xyz (B, N, 3), rotq
    (B, N, 4), scales (B, N, 3). inv_a: the canonical cache's
    inv_A_t2cano (J, 4, 4)."""
    if xyz.is_cuda:
        ext = frames.ext_tfs or (None, None, None)
        go, bp = axis_angle_rows(frames)
        return _Pose.apply(_Static(template, inv_a, lbs_weights), go, bp,
                           shaped_joints(template, frames.betas), xyz,
                           scales, rotmat, frames.transl, frames.smpl_scale,
                           *ext)
    a = skeleton_plain(template, inv_a, frames)
    return skin_plain(a, frames, xyz, scales, rotmat, lbs_weights)


def axis_angle_rows(frames: Frames) -> tuple:
    """The frames' go (B, 3) and bp (B, L) as axis-angle: 6D rows through
    rotation_6d_to_axis_angle in one call over the root's and the body's
    rows (each row its own torch ops: on the card the same bits as the
    reference's two calls)."""
    b = frames.go.shape[0]
    go, bp = frames.go, frames.bp
    rows = ([go.reshape(b, 1, 6)] if frames.go6 else []) + (
        [bp.reshape(b, -1, 6)] if frames.bp6 else [])
    if rows:
        aa = rotation_6d_to_axis_angle(torch.cat(rows, dim=1))
        if frames.go6:
            go, aa = aa[:, 0], aa[:, 1:]
        if frames.bp6:
            bp = aa.reshape(b, -1)
    return go, bp


# the plain version

def skeleton_plain(template, inv_a: torch.Tensor, frames: Frames):
    """A @ inv_A_t2cano (B, J, 4, 4) in torch ops: the pose rows through
    axis_angle_rows and axis_angle_to_matrix, full_pose's rest rows,
    batch_rigid_transform at the regressed joints."""
    b = frames.go.shape[0]
    nbj = template.num_body_joints
    go, bp = axis_angle_rows(frames)
    rest = template.rest_pose.reshape(1, -1).expand(b, -1)
    pose = torch.cat([go, bp[:, : nbj * 3], rest], dim=1)
    rot = axis_angle_to_matrix(pose.reshape(b, -1, 3))
    joints = shaped_joints(template, frames.betas)
    _, a = batch_rigid_transform(rot, joints[None].expand(b, -1, 3),
                                 template.parents)
    return a @ inv_a


def skin_plain(a: torch.Tensor, frames: Frames, xyz, scales, rotmat,
               lbs_weights):
    """The skinning in torch ops: lbs_extra's blend and transform, then
    smpl_scale, transl and ext_tfs as avatar_forward_chunk applies them,
    matrix_to_quaternion of T[:3, :3] @ rotmat. a (B, J, 4, 4)."""
    b, n = a.shape[0], xyz.shape[0]
    posed, t = lbs_extra(a, xyz[None].expand(b, n, 3), lbs_weights)
    sc = scales[None].expand(b, n, 3)
    if frames.smpl_scale is not None:
        s = frames.smpl_scale[:, None, None]
        posed = posed * s
        sc = sc * s
    posed = posed + frames.transl[:, None, :]
    rot = t[..., :3, :3]
    rotq = matrix_to_quaternion(rot if rotmat is None else rot @ rotmat[None])
    if frames.ext_tfs is not None:
        etrans, erot, escale = frames.ext_tfs
        posed = etrans[:, None, :] + escale[:, None, None] * torch.einsum(
            "bxy,bny->bnx", erot, posed)
        sc = escale[:, None, None] * sc
        rotq = quaternion_multiply(matrix_to_quaternion(erot)[:, None, :],
                                   rotq)
    return posed, rotq, sc


# the CUDA path

_P, _L = ctypes.c_void_p, ctypes.c_longlong


class _Args(ctypes.Structure):
    """csrc/pose.cu's PoseArgs, every field 8 bytes."""

    _fields_ = [
        ("go", _P), ("bp", _P), ("joints", _P),
        ("parents", _P), ("rest", _P), ("inv", _P), ("transl", _P),
        ("sscale", _P), ("etrans", _P), ("erot", _P), ("escale", _P),
        ("b", _L), ("j", _L), ("nbj", _L), ("bp_len", _L), ("scaled", _L),
        ("ext", _L),
        ("xyz", _P), ("scales", _P), ("rotmat", _P), ("w", _P),
        ("n", _L), ("ctas", _L),
        ("a", _P), ("frame", _P),
        ("out_xyz", _P), ("out_rotq", _P), ("out_scales", _P),
        ("g_xyz", _P), ("g_rotq", _P), ("g_scales", _P),
        ("partial", _P),
        ("d_xyz", _P), ("d_scales", _P), ("d_rotmat", _P), ("d_go", _P),
        ("d_bp", _P), ("d_joints", _P), ("d_transl", _P), ("d_sscale", _P),
        ("d_etrans", _P), ("d_erot", _P), ("d_escale", _P)]


_LAUNCHERS = ("pose_skeleton_fwd", "pose_skin_fwd", "pose_skin_bwd",
              "pose_skeleton_bwd")


def _lib():
    lib = cuda_build.load("pose")
    if lib.pose_skin_fwd.argtypes is None:
        for name in _LAUNCHERS:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(_Args), _P]
            fn.restype = ctypes.c_int
    return lib


_SMS: dict = {}


def _sm_count(dev) -> int:
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


class _Static(NamedTuple):
    """What the Function holds that is no differentiable input."""

    template: object
    inv_a: torch.Tensor
    lbs_weights: torch.Tensor


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(st: _Static, go, bp, joints, xyz, scales, rotmat, transl, sscale,
           etrans, erot, escale) -> None:
    """What the kernels take, on the gaussians' device: float32 tensors
    (contiguous where the caller passes them on), go (B, 3) and bp
    (B, L) axis-angle with L >= 3 x the body's joints, joints (J, 3), xyz
    and scales (N, 3), rotmat (N, 3, 3) or None, lbs_weights (N, J),
    transl (B, 3), smpl_scale (B,) or None, ext_tfs
    all or none; the template's joint tables (J <= 64, parents[j] < j)
    and inv_a (J, 4, 4). Raises ValueError."""
    tpl = st.template
    dev = xyz.device
    if getattr(tpl, "parent_index", None) is None:
        raise ValueError("pose: the template has no joint tables (build it "
                         "with DeviceTemplate.from_host)")
    nj = tpl.parent_index.shape[0]
    b = go.shape[0] if go.dim() == 2 else 0
    n = xyz.shape[0] if xyz.dim() == 2 else 0
    nbj = tpl.num_body_joints
    blen = bp.shape[1] if bp.dim() == 2 else 0
    if not 1 <= nj <= MAX_JOINTS:
        raise ValueError(f"pose: {nj} joints, the kernels take 1..64")
    if b < 1 or n < 1:
        raise ValueError(f"pose: {b} frames of {n} gaussians")
    if (etrans is None) != (erot is None) or (etrans is None) != (
            escale is None):
        raise ValueError("pose: ext_tfs needs etrans, erot and escale")
    want = [("go", go, (b, 3)),
            ("body_pose", bp, (b, blen)),
            ("joints", joints, (nj, 3)), ("xyz", xyz, (n, 3)),
            ("scales", scales, (n, 3)), ("rotmat", rotmat, (n, 3, 3)),
            ("lbs_weights", st.lbs_weights, (n, nj)),
            ("transl", transl, (b, 3)), ("smpl_scale", sscale, (b,)),
            ("etrans", etrans, (b, 3)), ("erot", erot, (b, 3, 3)),
            ("escale", escale, (b,)), ("inv_a", st.inv_a, (nj, 4, 4)),
            ("rest_pose", tpl.rest_pose, ((nj - 1 - nbj) * 3,))]
    for name, v, shape in want:
        if v is None and name in ("rotmat", "smpl_scale", "etrans", "erot",
                                  "escale"):
            continue
        if (not isinstance(v, torch.Tensor) or v.dtype != torch.float32
                or tuple(v.shape) != shape or v.device != dev):
            raise ValueError(
                f"pose: {name} must be a float32 tensor of shape {shape} "
                f"on {dev}, got {getattr(v, 'dtype', type(v).__name__)} "
                f"{tuple(getattr(v, 'shape', ()))} on "
                f"{getattr(v, 'device', None)}")
    if tpl.parent_index.device != dev or tpl.parent_index.dtype != \
            torch.int32:
        raise ValueError(f"pose: the parents must be int32 on {dev}")
    if blen < nbj * 3:
        raise ValueError(f"pose: body_pose has {blen} entries a frame, "
                         f"{nbj} joints need more")


def _frame_args(st: _Static, go, bp, joints, transl, sscale, etrans, erot,
                escale):
    """The skeleton's fields of the launchers' argument; and the
    contiguous tensors they point at (kept by the caller until the
    launch)."""
    tpl = st.template
    held = [x if x is None else x.contiguous() for x in (
        go, bp, joints, tpl.parent_index, tpl.rest_pose if tpl.rest_pose.numel() else None,
        st.inv_a, transl, sscale, etrans, erot, escale)]
    a = _Args(*[_ptr(t) for t in held])
    a.b = go.shape[0]
    a.j = tpl.parent_index.shape[0]
    a.nbj = tpl.num_body_joints
    a.bp_len = bp.shape[1]
    a.scaled, a.ext = int(sscale is not None), int(etrans is not None)
    return a, held


def _gauss_args(a: _Args, xyz, scales, rotmat, w, keep: list, threads):
    """The gaussians' fields and the skinning's grid: a CTA a tile in the
    forward; in the backward at most two a multiprocessor, each walking
    its tiles, so that the skeleton's backward reduces few rows."""
    held = [x if x is None else x.contiguous() for x in (xyz, scales,
                                                          rotmat, w)]
    keep += held
    a.xyz, a.scales, a.rotmat, a.w = [_ptr(t) for t in held]
    a.n = xyz.shape[0]
    tiles = -(-a.n // threads)
    a.ctas = (tiles if threads == FWD_THREADS
              else min(tiles, 2 * _sm_count(xyz.device)))


def _launch(lib, name: str, a: _Args, dev) -> None:
    err = getattr(lib, name)(ctypes.byref(a),
                             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def skeleton_fwd_cuda(st: _Static, go, bp, joints, transl, sscale=None,
                      etrans=None, erot=None, escale=None):
    """csrc/pose.cu's skeleton forward, one launch: (a (B, J, 12), rows
    0-2 of A @ inv_A_t2cano (skeleton_plain's [..., :3, :]), and the
    frames' terms (B, 24))."""
    dev = go.device
    if not go.is_cuda:
        raise ValueError("skeleton_fwd_cuda needs CUDA tensors")
    a, keep = _frame_args(st, go, bp, joints, transl, sscale, etrans, erot,
                          escale)
    out = (torch.empty((a.b, a.j, 12), dtype=torch.float32, device=dev),
           torch.empty((a.b, FRAME), dtype=torch.float32, device=dev))
    a.a, a.frame = [_ptr(t) for t in out]
    _launch(_lib(), "pose_skeleton_fwd", a, dev)
    del keep
    return out


def skin_fwd_cuda(st: _Static, a_rows, frame, xyz, scales, rotmat,
                  scaled: bool, ext: bool):
    """csrc/pose.cu's skinning forward, one launch, from the skeleton's
    (a, frame): skin_plain's (xyz, rotq, scales). scaled / ext: whether
    smpl_scale / ext_tfs are applied."""
    dev = xyz.device
    if not xyz.is_cuda:
        raise ValueError("skin_fwd_cuda needs CUDA tensors")
    b, nj = a_rows.shape[:2]
    n = xyz.shape[0]
    a = _Args()
    a.b, a.j = b, nj
    keep = [a_rows.contiguous(), frame.contiguous()]
    a.a, a.frame = [_ptr(t) for t in keep]
    _gauss_args(a, xyz, scales, rotmat, st.lbs_weights, keep, FWD_THREADS)
    a.scaled, a.ext = int(scaled), int(ext)
    out = (torch.empty((b, n, 3), dtype=torch.float32, device=dev),
           torch.empty((b, n, 4), dtype=torch.float32, device=dev),
           torch.empty((b, n, 3), dtype=torch.float32, device=dev))
    a.out_xyz, a.out_rotq, a.out_scales = [_ptr(t) for t in out]
    _launch(_lib(), "pose_skin_fwd", a, dev)
    del keep
    return out


def skin_bwd_cuda(st: _Static, a_rows, frame, xyz, scales, rotmat,
                  scaled: bool, ext: bool, g_xyz=None, g_rotq=None,
                  g_scales=None, want=(True, True, True)):
    """csrc/pose.cu's skinning backward, one launch: (d_xyz, d_scales,
    d_rotmat) (None where `want` says no, d_rotmat None without rotmat)
    and partial (ctas, B, J * 12 + 21), each CTA's sums of the gradients
    of the transforms' rows 0-2 and of the frames' terms."""
    dev = xyz.device
    if not xyz.is_cuda:
        raise ValueError("skin_bwd_cuda needs CUDA tensors")
    b, nj = a_rows.shape[:2]
    n = xyz.shape[0]
    a = _Args()
    a.b, a.j = b, nj
    keep = [a_rows.contiguous(), frame.contiguous()]
    a.a, a.frame = [_ptr(t) for t in keep]
    _gauss_args(a, xyz, scales, rotmat, st.lbs_weights, keep, BWD_THREADS)
    a.scaled, a.ext = int(scaled), int(ext)
    cots = [None if g is None else g.contiguous()
            for g in (g_xyz, g_rotq, g_scales)]
    for g, shape in zip(cots, ((b, n, 3), (b, n, 4), (b, n, 3))):
        if g is not None and (g.dtype != torch.float32 or g.device != dev
                              or tuple(g.shape) != shape):
            raise ValueError(f"pose: a cotangent must be float32 {shape} "
                             f"on {dev}")
    keep += cots
    a.g_xyz, a.g_rotq, a.g_scales = [_ptr(t) for t in cots]
    grads = tuple(
        torch.empty(shape, dtype=torch.float32, device=dev) if ok else None
        for ok, shape in zip((want[0], want[1], want[2] and rotmat is not
                              None), ((n, 3), (n, 3), (n, 3, 3))))
    a.d_xyz, a.d_scales, a.d_rotmat = [_ptr(t) for t in grads]
    partial = torch.empty((a.ctas, b, nj * 12 + EXTRA), dtype=torch.float32,
                          device=dev)
    a.partial = partial.data_ptr()
    _launch(_lib(), "pose_skin_bwd", a, dev)
    del keep
    return grads + (partial,)


def skeleton_bwd_cuda(st: _Static, partial, go, bp, joints, transl,
                      sscale=None, etrans=None, erot=None, escale=None,
                      want=None):
    """csrc/pose.cu's skeleton backward, one launch, from skin_bwd_cuda's
    partial: the gradients of (go, bp, joints, transl, smpl_scale, etrans,
    erot, escale), None where the input is None or `want` (8 bools) says
    no."""
    dev = go.device
    if not go.is_cuda:
        raise ValueError("skeleton_bwd_cuda needs CUDA tensors")
    a, keep = _frame_args(st, go, bp, joints, transl, sscale, etrans, erot,
                          escale)
    ins = (go, bp, joints, transl, sscale, etrans, erot, escale)
    want = want or (True,) * len(ins)
    grads = [torch.empty(x.shape, dtype=torch.float32, device=dev)
             if x is not None and ok else None for x, ok in zip(ins, want)]
    (a.d_go, a.d_bp, a.d_joints, a.d_transl, a.d_sscale, a.d_etrans,
     a.d_erot, a.d_escale) = [_ptr(t) for t in grads]
    keep.append(partial.contiguous())
    a.partial = keep[-1].data_ptr()
    a.ctas = partial.shape[0]
    _launch(_lib(), "pose_skeleton_bwd", a, dev)
    del keep
    return tuple(grads)


class _Pose(torch.autograd.Function):
    """(xyz, rotq, scales) (B, N, .) of the frames' pose rows, joints, the
    gaussians and the frame terms, on the card. The backward recomputes
    from the saved inputs and the skeleton's output."""

    @staticmethod
    def forward(ctx, st, go, bp, joints, xyz, scales, rotmat, transl, sscale,
                etrans, erot, escale):
        frame_in = (go, bp, joints, transl, sscale, etrans, erot, escale)
        _check(st, go, bp, joints, xyz, scales, rotmat, transl, sscale,
               etrans, erot, escale)
        a_rows, frame = skeleton_fwd_cuda(st, *frame_in)
        out = skin_fwd_cuda(st, a_rows, frame, xyz, scales, rotmat,
                            sscale is not None, etrans is not None)
        ctx.st = st
        ctx.save_for_backward(go, bp, joints, xyz, scales, rotmat, transl,
                              sscale, etrans, erot, escale, a_rows, frame)
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, g_xyz, g_rotq, g_scales):
        (go, bp, joints, xyz, scales, rotmat, transl, sscale, etrans, erot,
         escale, a_rows, frame) = ctx.saved_tensors
        st = ctx.st
        need = ctx.needs_input_grad
        d_xyz, d_scales, d_rotmat, partial = skin_bwd_cuda(
            st, a_rows, frame, xyz, scales, rotmat, sscale is not None,
            etrans is not None, g_xyz, g_rotq, g_scales,
            want=(need[4], need[5], need[6]))
        (d_go, d_bp, d_joints, d_transl, d_sscale, d_etrans, d_erot,
         d_escale) = skeleton_bwd_cuda(
            st, partial, go, bp, joints, transl, sscale, etrans, erot,
            escale, want=(need[1], need[2], need[3], need[7], need[8],
                          need[9], need[10], need[11]))
        return (None, d_go, d_bp, d_joints, d_xyz, d_scales, d_rotmat,
                d_transl, d_sscale, d_etrans, d_erot, d_escale)
