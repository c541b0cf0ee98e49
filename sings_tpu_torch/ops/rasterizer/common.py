"""Gaussian-splatting screen-space preprocess (port of
sings_tpu/ops/rasterizer/common.py).

Every rule of the CUDA diff-gaussian-rasterization preprocess that the
JAX package reproduces: perspective projection with p_w = 1/(w+1e-7),
the z > 0.2 frustum cull, EWA 2D covariance with the 1.3*tan view-space
clamp and the 0.3-pixel dilation, radius ceil(3*sqrt(lam1)) with the 0.1
floor under the discriminant root, SH-to-RGB with clamping, and the
getRect zero-area cull (floor for negative coordinates).

preprocess is one autograd Function (_Preprocess) over means3d, scales,
quats and SH features (RGB features and opacities pass through):
  * CUDA tensors: csrc/preprocess.cu (built with nvcc for sm_90a, called
    through ctypes; float32 only; raises on any failure), one forward
    kernel (preprocess_fwd_cuda) and one backward kernel
    (preprocess_bwd_cuda), no host wait; the forward's fields are the
    plain version's on the same CUDA inputs. LAUNCHES counts each
    kernel's launches.
  * CPU tensors: preprocess_fwd_plain, the torch ops below, and
    preprocess_bwd_plain, their derivation by hand in torch ops (the
    backward kernel's arithmetic), with autograd's and JAX's tie rules.
Under no_grad, or with no input that requires grad, the forward runs
alone and nothing is saved.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import cuda_build
from ..clip import clip, clip_factor
from ..graphics import Camera
from ..rotations import quaternion_to_matrix
from ..sh import eval_sh, sh_basis, sh_basis_jacobian, sh_to_rgb

# launches of the CUDA kernels, never of the plain version
LAUNCHES = {"preprocess_fwd": 0, "preprocess_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class Gaussians2D(NamedTuple):
    means2d: torch.Tensor    # (N, 2) pixel coords
    depths: torch.Tensor     # (N,) camera-space z
    conics: torch.Tensor     # (N, 3) inverse 2D covariance (a, b, c)
    colors: torch.Tensor     # (N, 3)
    opacities: torch.Tensor  # (N,)
    radii: torch.Tensor      # (N,) int32, 0 => invisible
    mask: torch.Tensor       # (N,) bool


def build_covariance_3d(scales: torch.Tensor, quats: torch.Tensor):
    """Sigma = R S S^T R^T. scales (N,3), quats (N,4) -> (N,3,3)."""
    R = quaternion_to_matrix(quats)
    M = R * scales[:, None, :]
    return M @ M.transpose(1, 2)


def project_cov3d_to_2d(cov3d: torch.Tensor, p_view: torch.Tensor,
                        camera: Camera) -> torch.Tensor:
    """CUDA computeCov2D: clamped tangents, focal-scaled Jacobian,
    +0.3 dilation. Returns (N, 3) = (cov_xx, cov_xy, cov_yy)."""
    focal_x = camera.width / (2.0 * camera.tan_fovx)
    focal_y = camera.height / (2.0 * camera.tan_fovy)
    z = p_view[:, 2]
    limx = 1.3 * (camera.tan_fovx if camera.clamp_tan_fovx is None
                  else camera.clamp_tan_fovx)
    limy = 1.3 * (camera.tan_fovy if camera.clamp_tan_fovy is None
                  else camera.clamp_tan_fovy)
    txtz = clip(p_view[:, 0] / z, -limx, limx)
    tytz = clip(p_view[:, 1] / z, -limy, limy)
    tx = txtz * z
    ty = tytz * z
    j00 = focal_x / z
    j02 = -(focal_x * tx) / (z * z)
    j11 = focal_y / z
    j12 = -(focal_y * ty) / (z * z)

    W = camera.view[:3, :3].T.to(cov3d)
    cov_cam = torch.einsum("ij,njk,lk->nil", W, cov3d, W)
    c00 = cov_cam[:, 0, 0]
    c01 = cov_cam[:, 0, 1]
    c02 = cov_cam[:, 0, 2]
    c11 = cov_cam[:, 1, 1]
    c12 = cov_cam[:, 1, 2]
    c22 = cov_cam[:, 2, 2]
    a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22)
    b = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22)
    return torch.stack([a + 0.3, b, c + 0.3], dim=-1)


def _tile_bounds(means2d, r, tile, ntx, nty):
    """getRect: floor for the low corner, truncation for the high one."""
    x0 = torch.clamp(torch.floor((means2d[:, 0] - r) / tile), 0, ntx)
    y0 = torch.clamp(torch.floor((means2d[:, 1] - r) / tile), 0, nty)
    x1 = torch.clamp(torch.trunc((means2d[:, 0] + r + tile - 1) / tile),
                     0, ntx)
    y1 = torch.clamp(torch.trunc((means2d[:, 1] + r + tile - 1) / tile),
                     0, nty)
    return x0, y0, x1, y1


class Projection(NamedTuple):
    """What preprocess's Function takes besides its tensors."""
    camera: Camera          # on the inputs' device
    sh_degree: int
    scale_modifier: float
    tile: int


def preprocess(means3d, scales, quats, opacities, features, camera: Camera,
               *, sh_degree: int = 0, scale_modifier: float = 1.0,
               alive=None, tile: int = 16) -> Gaussians2D:
    """Project gaussians into screen space.

    means3d (N, 3), scales (N, 3) activated, quats (N, 4) scalar-first,
    opacities (N,) or (N, 1), features (N, K, 3) SH or (N, 3) RGB,
    alive: optional (N,) bool mask for padded buffers. Differentiable in
    means3d, scales, quats and features (not in the camera, whose tensors
    must not require grad).
    """
    camera = camera.to(means3d.device)
    for name in ("view", "proj", "cam_center"):
        if getattr(camera, name).requires_grad:
            raise ValueError(f"preprocess: camera.{name} requires grad; the "
                             "camera is not differentiated")
    if opacities.ndim == 2:
        opacities = opacities[:, 0]
    sh = features if features.ndim == 3 else None
    spec = Projection(camera, sh_degree, scale_modifier, tile)
    args = (means3d, scales, quats, sh)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in args):
        out = _Preprocess.apply(spec, *args, alive)
    elif means3d.is_cuda:
        out = preprocess_fwd_cuda(spec, *args, alive)
    else:
        out = preprocess_fwd_plain(spec, *args, alive)
    means2d, depths, conics, colors, radii, mask = out
    return Gaussians2D(means2d=means2d, depths=depths, conics=conics,
                       colors=features if sh is None else colors,
                       opacities=opacities, radii=radii, mask=mask)


class _Preprocess(torch.autograd.Function):
    """(means2d, depths, conics, colors, radii, mask) of means3d, scales,
    quats and SH features (None: RGB, colors None); radii and mask carry
    no gradient. The backward recomputes from the saved inputs."""

    @staticmethod
    def forward(ctx, spec, means3d, scales, quats, sh, alive):
        fwd = preprocess_fwd_cuda if means3d.is_cuda else \
            preprocess_fwd_plain
        out = fwd(spec, means3d, scales, quats, sh, alive)
        ctx.spec = spec
        ctx.save_for_backward(means3d, scales, quats, sh)
        ctx.mark_non_differentiable(out[4], out[5])
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, g_means2d, g_depths, g_conics, g_colors, _r, _m):
        means3d, scales, quats, sh = ctx.saved_tensors
        bwd = preprocess_bwd_cuda if means3d.is_cuda else \
            preprocess_bwd_plain
        grads = bwd(ctx.spec, means3d, scales, quats, sh, g_means2d,
                    g_depths, g_conics, g_colors,
                    want_sh=sh is not None and ctx.needs_input_grad[4])
        return (None, *grads, None)


def _limits(camera: Camera) -> tuple:
    """The tangent clamps 1.3 * tan(fov / 2) (or the clamp fields)."""
    return (1.3 * (camera.tan_fovx if camera.clamp_tan_fovx is None
                   else camera.clamp_tan_fovx),
            1.3 * (camera.tan_fovy if camera.clamp_tan_fovy is None
                   else camera.clamp_tan_fovy))


def preprocess_fwd_plain(spec: Projection, means3d, scales, quats, sh,
                         alive):
    """preprocess's fields in torch ops, on any device and dtype (the
    CUDA kernel's reference on the card): (means2d, depths, conics,
    colors (None without sh), radii, mask)."""
    camera, tile = spec.camera, spec.tile
    n = means3d.shape[0]
    p_hom4 = torch.cat([means3d, means3d.new_ones((n, 1))], dim=1)
    p_view = p_hom4 @ camera.view
    p_clip = p_hom4 @ camera.proj
    p_w = 1.0 / (p_clip[:, 3] + 1e-7)
    ndc = p_clip[:, :3] * p_w[:, None]
    in_front = p_view[:, 2] > 0.2

    cov3d = build_covariance_3d(scales * spec.scale_modifier, quats)
    cov2d = project_cov3d_to_2d(cov3d, p_view[:, :3], camera)
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    det_ok = det != 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    conics = torch.stack([cov2d[:, 2], -cov2d[:, 1], cov2d[:, 0]],
                         dim=-1) / det_safe[:, None]
    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam1, 0.0)))

    means2d = torch.stack([
        ((ndc[:, 0] + 1.0) * camera.width - 1.0) * 0.5,
        ((ndc[:, 1] + 1.0) * camera.height - 1.0) * 0.5,
    ], dim=-1)

    colors = None
    if sh is not None:
        dirs = means3d - camera.cam_center[None, :]
        dirs = dirs / torch.linalg.norm(dirs, dim=-1,
                                        keepdim=True).clamp_min(1e-12)
        colors = sh_to_rgb(spec.sh_degree, sh, dirs)

    mask = in_front & det_ok
    if alive is not None:
        mask = mask & alive
    radii = torch.where(mask, radius_f, torch.zeros_like(radius_f)).to(
        torch.int32)
    mask = mask & (radii > 0)
    ntx = -(-camera.width // tile)
    nty = -(-camera.height // tile)
    r = radii.to(means2d.dtype)
    x0 = torch.clamp(torch.floor((means2d[:, 0] - r) / tile), 0, ntx)
    y0 = torch.clamp(torch.floor((means2d[:, 1] - r) / tile), 0, nty)
    x1 = torch.clamp(torch.floor((means2d[:, 0] + r + tile - 1) / tile),
                     0, ntx)
    y1 = torch.clamp(torch.floor((means2d[:, 1] + r + tile - 1) / tile),
                     0, nty)
    mask = mask & ((x1 - x0) * (y1 - y0) > 0)
    radii = torch.where(mask, radii, torch.zeros_like(radii))
    return means2d, p_view[:, 2], conics, colors, radii, mask


def preprocess_bwd_plain(spec: Projection, means3d, scales, quats, sh,
                         g_means2d=None, g_depths=None, g_conics=None,
                         g_colors=None, want_sh: bool = True):
    """The gradients of preprocess_fwd_plain's means2d, depths, conics and
    colors with respect to means3d, scales, quats and sh (None without sh
    or want_sh), derived by hand in torch ops on any device and dtype:
    the backward kernel's arithmetic, the CUDA path's reference on the
    card. A cotangent of None is zero. Autograd's rules at the ties: half
    the cotangent at a tangent on its clamp bound, at an SH colour of
    exactly 0 and at the quaternion norm's 1e-12 floor (ops/clip.py, as
    JAX); all of it at the direction norm's floor (torch.clamp_min); none
    through a norm of 0."""
    cam = spec.camera
    dt = means3d.dtype
    V, P = cam.view.to(dt), cam.proj.to(dt)
    n = means3d.shape[0]
    zero = means3d.new_zeros(n)

    def cols(g, k):
        return [zero] * k if g is None else list(g.unbind(-1))

    gm0, gm1 = cols(g_means2d, 2)
    gk0, gk1, gk2 = cols(g_conics, 3)
    g_dep = zero if g_depths is None else g_depths

    p_hom4 = torch.cat([means3d, means3d.new_ones((n, 1))], dim=1)
    pv = p_hom4 @ V
    pc = p_hom4 @ P
    pw = 1.0 / (pc[:, 3] + 1e-7)
    # means2d = ((p_clip[:, :2] * p_w + 1) * size - 1) / 2
    g_ndc0 = gm0 * (0.5 * cam.width)
    g_ndc1 = gm1 * (0.5 * cam.height)
    g_pw = g_ndc0 * pc[:, 0] + g_ndc1 * pc[:, 1]
    g_pc = torch.stack([g_ndc0 * pw, g_ndc1 * pw, zero, -g_pw * pw * pw], 1)

    # the covariance, as the forward computes it
    ss = scales * spec.scale_modifier
    nrm = torch.linalg.norm(quats, dim=-1)
    nq = torch.clamp_min(nrm, 1e-12)
    w, x, y, z = (quats / nq[:, None]).unbind(-1)
    R = quaternion_to_matrix(quats)
    M = R * ss[:, None, :]
    Sig = M @ M.transpose(1, 2)
    limx, limy = _limits(cam)
    fx = cam.width / (2.0 * cam.tan_fovx)
    fy = cam.height / (2.0 * cam.tan_fovy)
    zc = pv[:, 2]
    rx, ry = pv[:, 0] / zc, pv[:, 1] / zc
    txtz, tytz = rx.clamp(-limx, limx), ry.clamp(-limy, limy)
    tx, ty = txtz * zc, tytz * zc
    rz = 1.0 / zc
    z2 = zc * zc
    j00, j11 = rz * fx, rz * fy
    j02, j12 = -(fx * tx) / z2, -(fy * ty) / z2
    Wm = V[:3, :3].T
    C = torch.einsum("ij,njk,lk->nil", Wm, Sig, Wm)
    c00, c01, c02 = C[:, 0, 0], C[:, 0, 1], C[:, 0, 2]
    c11, c12, c22 = C[:, 1, 1], C[:, 1, 2], C[:, 2, 2]
    # a = j00 u0 + j02 u1, b = j00 v0 + j02 v1, c = j11 w0 + j12 v1
    u0, u1 = j00 * c00 + j02 * c02, j00 * c02 + j02 * c22
    v0, v1 = j11 * c01 + j12 * c02, j11 * c12 + j12 * c22
    w0 = j11 * c11 + j12 * c12
    A = j00 * u0 + j02 * u1 + 0.3
    B = j00 * v0 + j02 * v1
    Cc = j11 * w0 + j12 * v1 + 0.3
    det = A * Cc - B * B
    ok = det != 0.0
    ds = torch.where(ok, det, torch.ones_like(det))

    # conics = (C, -B, A) / det (where det != 0)
    gA, gB, gC = gk2 / ds, -gk1 / ds, gk0 / ds
    g_det = torch.where(ok, -(gk0 * Cc - gk1 * B + gk2 * A) / (ds * ds),
                        zero)
    gA = gA + g_det * Cc
    gC = gC + g_det * A
    gB = gB - 2.0 * g_det * B
    # the Jacobian's entries, and S = gcov + gcov^T of cov_cam's upper
    # triangle (the entries the forward reads)
    g_j00 = 2.0 * gA * u0 + gB * v0
    g_j02 = 2.0 * gA * u1 + gB * v1
    g_j11 = gB * (j00 * c01 + j02 * c12) + 2.0 * gC * w0
    g_j12 = gB * u1 + 2.0 * gC * v1
    s00 = 2.0 * gA * j00 * j00
    s11 = 2.0 * gC * j11 * j11
    s22 = 2.0 * (gA * j02 * j02 + gB * j02 * j12 + gC * j12 * j12)
    s01 = gB * j00 * j11
    s02 = 2.0 * gA * j00 * j02 + gB * j00 * j12
    s12 = gB * j02 * j11 + 2.0 * gC * j11 * j12
    S = torch.stack([s00, s01, s02, s01, s11, s12, s02, s12, s22],
                    -1).reshape(n, 3, 3)
    # Sigma = M M^T: gM = (gSigma + gSigma^T) M, gSigma = W^T gcov W
    gM = (Wm.T @ S @ Wm) @ M
    gR = gM * ss[:, None, :]
    g_scales = (gM * R).sum(1) * spec.scale_modifier
    r = gR.reshape(n, 9)
    gq = 2.0 * torch.stack([
        -z * r[:, 1] + y * r[:, 2] + z * r[:, 3] - x * r[:, 5]
        - y * r[:, 6] + x * r[:, 7],
        y * r[:, 1] + z * r[:, 2] + y * r[:, 3] - 2.0 * x * r[:, 4]
        - w * r[:, 5] + z * r[:, 6] + w * r[:, 7] - 2.0 * x * r[:, 8],
        -2.0 * y * r[:, 0] + x * r[:, 1] + w * r[:, 2] + x * r[:, 3]
        + z * r[:, 5] - w * r[:, 6] + z * r[:, 7] - 2.0 * y * r[:, 8],
        -2.0 * z * r[:, 0] - w * r[:, 1] + x * r[:, 2] + w * r[:, 3]
        - 2.0 * z * r[:, 4] + y * r[:, 5] + x * r[:, 6] + y * r[:, 7],
    ], -1)
    # q / clip(|q|, 1e-12)
    g_nrm = (-(gq * quats).sum(-1) / (nq * nq)
             * clip_factor(nrm, 1e-12, None))
    radial = torch.where(nrm == 0, zero, g_nrm / nrm)
    g_quats = gq / nq[:, None] + quats * radial[:, None]

    # the Jacobian -> z and the clamped tangents
    g_tx = -g_j02 * fx / z2
    g_ty = -g_j12 * fy / z2
    g_z = (-(g_j00 * fx + g_j11 * fy) * rz * rz
           + 2.0 * (g_j02 * fx * tx + g_j12 * fy * ty) / (z2 * zc))
    g_z = g_z + g_tx * txtz + g_ty * tytz
    g_rx = g_tx * zc * clip_factor(rx, -limx, limx)
    g_ry = g_ty * zc * clip_factor(ry, -limy, limy)
    g_z = g_z - (g_rx * rx + g_ry * ry) / zc
    g_pv = torch.stack([g_rx / zc, g_ry / zc, g_dep + g_z, zero], 1)
    g_means = g_pv @ V[:3].T + g_pc @ P[:3].T

    g_sh = None
    if sh is not None and g_colors is not None:
        deg = spec.sh_degree
        nb = (deg + 1) ** 2
        d = means3d - cam.cam_center.to(dt)[None, :]
        dn = torch.linalg.norm(d, dim=-1)
        dnc = torch.clamp_min(dn, 1e-12)
        dirs = d / dnc[:, None]
        # clip(eval_sh + 0.5, 0)
        gv = g_colors * clip_factor(eval_sh(deg, sh, dirs) + 0.5, 0.0, None)
        s = (sh[:, :nb] * gv[:, None, :]).sum(-1)
        g_dir = (s[:, :, None] * sh_basis_jacobian(deg, dirs)).sum(1)
        g_dn = torch.where(dn >= 1e-12,
                           -(g_dir * d).sum(-1) / (dnc * dnc), zero)
        radial = torch.where(dn == 0, zero, g_dn / dn)
        g_means = g_means + g_dir / dnc[:, None] + d * radial[:, None]
        if want_sh:
            g_sh = torch.zeros_like(sh)
            g_sh[:, :nb] = sh_basis(deg, dirs)[:, :, None] * gv[:, None, :]
    elif sh is not None and want_sh:
        g_sh = torch.zeros_like(sh)
    return g_means, g_scales, g_quats, g_sh


# the CUDA path

# csrc/preprocess.cu's PreprocessArgs, every field 8 bytes
_P, _L, _D = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double


class _Args(ctypes.Structure):
    _fields_ = [
        ("means", _P), ("scales", _P), ("quats", _P), ("sh", _P),
        ("alive", _P), ("view", _P), ("proj", _P), ("cam", _P),
        ("n", _L), ("k", _L), ("deg", _L), ("tile", _L), ("ntx", _L),
        ("nty", _L), ("smod", _D), ("fx", _D), ("fy", _D), ("limx", _D),
        ("limy", _D), ("width", _D), ("height", _D),
        ("means2d", _P), ("depths", _P), ("conics", _P), ("colors", _P),
        ("radii", _P), ("mask", _P),
        ("g_means2d", _P), ("gm_s0", _L), ("gm_s1", _L),
        ("g_depths", _P), ("gd_s", _L),
        ("g_conics", _P), ("gk_s0", _L), ("gk_s1", _L),
        ("g_colors", _P), ("gc_s0", _L), ("gc_s1", _L),
        ("d_means", _P), ("d_scales", _P), ("d_quats", _P), ("d_sh", _P)]


def _lib():
    lib = cuda_build.load("preprocess")
    if lib.preprocess_fwd.argtypes is None:
        for fn in (lib.preprocess_fwd, lib.preprocess_bwd):
            fn.argtypes = [ctypes.POINTER(_Args), _P]
            fn.restype = ctypes.c_int
    return lib


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _check_pre(spec: Projection, means3d, scales, quats, sh, alive) -> None:
    """What the kernels take: float32 means3d (N, 3), scales (N, 3),
    quats (N, 4) and sh (N, K, 3) with K >= (sh_degree + 1)^2 or None;
    alive None or a bool (N,); N >= 1; the camera's view and proj (4, 4)
    and cam_center (3,) float32; all on the means' device; sh_degree an
    int in 0..3, tile a positive int. Raises ValueError."""
    dev = means3d.device
    n = means3d.shape[0] if means3d.dim() == 2 else 0
    deg = spec.sh_degree
    if not _is_int(deg) or not 0 <= deg <= 3:
        raise ValueError(f"preprocess: sh_degree must be an int in 0..3, "
                         f"got {deg!r}")
    if not _is_int(spec.tile) or spec.tile < 1:
        raise ValueError(f"preprocess: tile must be a positive int, got "
                         f"{spec.tile!r}")
    k = sh.shape[1] if sh is not None and sh.dim() == 3 else 0
    cam = spec.camera
    want = [("means3d", means3d, (n, 3), torch.float32),
            ("scales", scales, (n, 3), torch.float32),
            ("quats", quats, (n, 4), torch.float32),
            ("camera.view", cam.view, (4, 4), torch.float32),
            ("camera.proj", cam.proj, (4, 4), torch.float32),
            ("camera.cam_center", cam.cam_center, (3,), torch.float32)]
    if sh is not None:
        want.append(("features", sh, (n, max(k, (deg + 1) ** 2), 3),
                     torch.float32))
    if alive is not None:
        want.append(("alive", alive, (n,), torch.bool))
    for name, v, shape, dtype in want:
        if (not isinstance(v, torch.Tensor) or v.dtype != dtype
                or tuple(v.shape) != shape or v.device != dev):
            raise ValueError(f"preprocess: {name} must be a {dtype} tensor "
                             f"of shape {shape} on {dev}, got "
                             f"{getattr(v, 'dtype', type(v).__name__)} "
                             f"{tuple(getattr(v, 'shape', ()))}")
    if n < 1:
        raise ValueError("preprocess: no gaussians")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _args(spec: Projection, means3d, scales, quats, sh, alive) -> tuple:
    """The kernels' shared fields, with the python scalars rounded to
    float32 as torch rounds them; and the contiguous tensors they point
    at (kept alive by the caller until the launch)."""
    cam = spec.camera
    f32 = np.float32
    limx, limy = _limits(cam)
    held = [x.contiguous() if x is not None else None for x in (
        means3d, scales, quats, sh, alive, cam.view, cam.proj,
        cam.cam_center)]
    a = _Args(*[_ptr(t) for t in held])
    a.n = means3d.shape[0]
    a.k = 0 if sh is None else sh.shape[1]
    a.deg, a.tile = spec.sh_degree, spec.tile
    a.ntx = -(-cam.width // spec.tile)
    a.nty = -(-cam.height // spec.tile)
    for name, v in (("smod", spec.scale_modifier),
                    ("fx", cam.width / (2.0 * cam.tan_fovx)),
                    ("fy", cam.height / (2.0 * cam.tan_fovy)),
                    ("limx", limx), ("limy", limy), ("width", cam.width),
                    ("height", cam.height)):
        setattr(a, name, float(f32(v)))
    return a, held


def preprocess_fwd_cuda(spec: Projection, means3d, scales, quats, sh,
                        alive):
    """preprocess_fwd_plain on the card: the arguments checked
    (_check_pre), then csrc/preprocess.cu's forward kernel on the current
    stream, one launch, no host wait. Returns the plain version's fields
    (contiguous)."""
    if not means3d.is_cuda:
        raise ValueError("preprocess_fwd_cuda needs CUDA tensors")
    _check_pre(spec, means3d, scales, quats, sh, alive)
    lib = _lib()
    dev = means3d.device
    n = means3d.shape[0]
    # keep: what `a` points at (contiguous copies too), alive until the
    # launch is queued
    a, keep = _args(spec, means3d, scales, quats, sh, alive)
    out = (torch.empty((n, 2), dtype=torch.float32, device=dev),
           torch.empty(n, dtype=torch.float32, device=dev),
           torch.empty((n, 3), dtype=torch.float32, device=dev),
           None if sh is None else torch.empty((n, 3), dtype=torch.float32,
                                               device=dev),
           torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(n, dtype=torch.bool, device=dev))
    (a.means2d, a.depths, a.conics, a.colors, a.radii,
     a.mask) = [_ptr(t) for t in out]
    err = lib.preprocess_fwd(ctypes.byref(a),
                             torch.cuda.current_stream(dev).cuda_stream)
    del keep
    if err != 0:
        raise RuntimeError(f"preprocess forward launch failed: cudaError "
                           f"{err}")
    LAUNCHES["preprocess_fwd"] += 1
    return out


def preprocess_bwd_cuda(spec: Projection, means3d, scales, quats, sh,
                        g_means2d=None, g_depths=None, g_conics=None,
                        g_colors=None, want_sh: bool = True):
    """preprocess_bwd_plain on the card: csrc/preprocess.cu's backward
    kernel on the current stream, one launch, no atomics, no host wait;
    the cotangents at any strides (None: zero)."""
    if not means3d.is_cuda:
        raise ValueError("preprocess_bwd_cuda needs CUDA tensors")
    _check_pre(spec, means3d, scales, quats, sh, None)
    dev = means3d.device
    n = means3d.shape[0]
    cots = (("g_means2d", g_means2d, (n, 2)), ("g_depths", g_depths, (n,)),
            ("g_conics", g_conics, (n, 3)), ("g_colors", g_colors, (n, 3)))
    for name, g, shape in cots:
        if g is not None and (g.dtype != torch.float32 or g.device != dev
                              or tuple(g.shape) != shape):
            raise ValueError(f"preprocess: cotangent {name} must be a "
                             f"float32 tensor of shape {shape} on {dev}")
    lib = _lib()
    a, keep = _args(spec, means3d, scales, quats, sh, None)
    a.g_means2d = _ptr(g_means2d)
    if g_means2d is not None:
        a.gm_s0, a.gm_s1 = g_means2d.stride()
    a.g_depths = _ptr(g_depths)
    if g_depths is not None:
        a.gd_s = g_depths.stride(0)
    a.g_conics = _ptr(g_conics)
    if g_conics is not None:
        a.gk_s0, a.gk_s1 = g_conics.stride()
    a.g_colors = _ptr(g_colors)
    if g_colors is not None:
        a.gc_s0, a.gc_s1 = g_colors.stride()
    out = (torch.empty((n, 3), dtype=torch.float32, device=dev),
           torch.empty((n, 3), dtype=torch.float32, device=dev),
           torch.empty((n, 4), dtype=torch.float32, device=dev),
           torch.empty(sh.shape, dtype=torch.float32, device=dev)
           if sh is not None and want_sh else None)
    a.d_means, a.d_scales, a.d_quats, a.d_sh = [_ptr(t) for t in out]
    err = lib.preprocess_bwd(ctypes.byref(a),
                             torch.cuda.current_stream(dev).cuda_stream)
    del keep
    if err != 0:
        raise RuntimeError(f"preprocess backward launch failed: cudaError "
                           f"{err}")
    LAUNCHES["preprocess_bwd"] += 1
    return out


def tile_rect(g: Gaussians2D, tile: int, n_tiles_x: int, n_tiles_y: int):
    """Per-gaussian tile rectangle, CUDA getRect semantics: int32
    (x0, y0, x1, y1); x0/y0 floor negative coordinates, x1/y1 truncate."""
    r = g.radii.to(torch.float32)
    x0, y0, x1, y1 = _tile_bounds(g.means2d, r, tile, n_tiles_x, n_tiles_y)
    return (x0.to(torch.int32), y0.to(torch.int32), x1.to(torch.int32),
            y1.to(torch.int32))
