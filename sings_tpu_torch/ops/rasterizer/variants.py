"""Formulas of the tile-compositing backward held beside composite_bwd:
the CUDA kernels and their plain versions.

Counterparts of the experiment kernels that chose composite_bwd's
design on the TPU:
  * composite_bwd_moments (scripts/exp_bwd_moments.py:199, body
    _bwd_kernel_moments :40): the five quadratic reductions as moments
    of dl_dpow against the pixel basis [1, px, py, px^2, px py, py^2],
    combined per pair; colour gradients as sums of w g_k; dl_dop =
    M00 / op where op > 1e-12, else 0;
  * run_bwd (scripts/exp_bwd_variants.py:259, body bwd_kernel :72), by
    variant:
      v1  three per-channel inclusive cumsums, 9 per-pixel reductions;
      v3  one cotangent-weighted cumsum, the same 9 reductions (no CSE);
      v4  v3's cumsum with moment reductions, dl_dop = M00 / max(op,
          1e-6);
      v2  v4 with gc from a K=3 matmul on the TPU. On the card gc is
          three multiply-adds either way: v2 launches v4's code and
          counts its own launches.
The frozen JAX script wrote the pre-relayout buffer; these write the
current one: composite_bwd's arguments (tiled layout) and output, a
zeroed (9, grad_cap) buffer at grad_offsets[t] + c * chunk.

The kernels are one templated CUDA kernel, csrc/composite_bwd_variants.cu,
built with nvcc for sm_90a and called through ctypes. It walks,
terminates and exits where csrc/composite_bwd.cu does (the walk pieces
of composite_common.cuh). The plain versions run kernels.py's
_walk_windows and keep only their own accumulation and reduction,
copied from the JAX body they name; where the JAX body takes a matmul
(the cumsums, the moments, the colour sums of the moment forms) they
take it in float64 and round once, as _tri_sum does.

Each public function dispatches on the tensors' device: CUDA tensors
launch the kernel (or raise), CPU tensors run the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_build
from .kernels import N_USED, _check_bwd, _tri, _tri_sum, _walk_windows

VARIANTS = ("v1", "v3", "v4", "v2")

# Template arguments of csrc/composite_bwd_variants.cu by launch form:
# (per-channel cumsums, moment reductions, row 5's dl_dop guard). v2
# runs v4's form.
FORMS = {"moments": (0, False, True, True), "v1": (1, True, False, False),
         "v3": (2, False, False, False), "v4": (3, False, True, False),
         "v2": (3, False, True, False)}

# launches through each wrapper, never through the plain version
LAUNCHES = {"composite_bwd_moments": 0, "composite_bwd_v1": 0,
            "composite_bwd_v3": 0, "composite_bwd_v4": 0,
            "composite_bwd_v2": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_name(form: str) -> str:
    return "composite_bwd_moments" if form == "moments" else \
        f"composite_bwd_{form}"


def moment_basis(tile: int, device=None) -> torch.Tensor:
    """(tile*tile, 8) pixel basis [1, px, py, px^2, px py, py^2, 0, 0]
    in tile-local coordinates: the `poly` of exp_bwd_moments.py and the
    _moment_basis that exp_bwd_variants.py expects."""
    p = torch.arange(tile * tile, device=device)
    px = (p % tile).to(torch.float32)
    py = (p // tile).to(torch.float32)
    zero = torch.zeros_like(px)
    return torch.stack([torch.ones_like(px), px, py, px * px, px * py,
                        py * py, zero, zero], dim=1)


def _f64_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.double(), b.double()).float()


def _plain(feats, offsets, grad_offsets, fwd_out, gout, *, form: str,
           tile: int, chunk: int, n_tiles_x: int, n_tiles_y: int,
           grad_cap: int) -> torch.Tensor:
    _, per_channel, moments, row5_guard = FORMS[form]
    dev = feats.device
    goffs = grad_offsets.to(torch.int64)
    linc = _tri(chunk, dev, strict=False)
    sub = torch.arange(chunk, device=dev)
    basis = moment_basis(tile, dev)

    cf = fwd_out[:, 0:3]
    g_rgb = gout[:, 0:3]                                    # (T, 3, npx)
    g_r, g_g, g_b = g_rgb[:, 0:1], g_rgb[:, 1:2], g_rgb[:, 2:3]
    cfg = torch.sum(g_rgb * cf, dim=1, keepdim=True)
    gtf = gout[:, 3:4] * fwd_out[:, 3:4]
    grads = feats.new_zeros((N_USED, grad_cap))
    cp = torch.zeros((n_tiles_x * n_tiles_y, 3 if per_channel else 1,
                      tile * tile), device=dev)
    for win in _walk_windows(feats, offsets, tile=tile, chunk=chunk,
                             n_tiles_x=n_tiles_x, n_tiles_y=n_tiles_y):
        f, dx, dy, gv, t_bef = win.f, win.dx, win.dy, win.gv, win.t_bef
        aeff = torch.where(win.flag, win.alpha, torch.zeros_like(win.alpha))
        w = aeff * t_bef
        inv1m = 1.0 / (1.0 - aeff)
        if per_channel:
            up_r = cp[:, 0:1] + _tri_sum(linc, w * f[5])
            up_g = cp[:, 1:2] + _tri_sum(linc, w * f[6])
            up_b = cp[:, 2:3] + _tri_sum(linc, w * f[7])
            dl_da = (g_r * (f[5] * t_bef - (cf[:, 0:1] - up_r) * inv1m)
                     + g_g * (f[6] * t_bef - (cf[:, 1:2] - up_g) * inv1m)
                     + g_b * (f[7] * t_bef - (cf[:, 2:3] - up_b) * inv1m)
                     - gtf * inv1m)
            cp = torch.cat([up_r[:, chunk - 1:chunk], up_g[:, chunk - 1:chunk],
                            up_b[:, chunk - 1:chunk]], dim=1)
        else:
            gc = f[5] * g_r + f[6] * g_g + f[7] * g_b
            upg = cp + _tri_sum(linc, w * gc)
            dl_da = t_bef * gc - inv1m * ((cfg - upg) + gtf)
            cp = upg[:, chunk - 1:chunk]
        dl_da = torch.where(aeff > 0.0, dl_da, torch.zeros_like(dl_da))
        ca, cb, cc, op = f[2], f[3], f[4], f[8]            # (T, chunk, 1)
        if moments:
            dl_dpow = op * dl_da * gv
            md = _f64_dot(dl_dpow, basis)                  # (T, chunk, 8)
            mw = _f64_dot(w, g_rgb.transpose(1, 2))        # (T, chunk, 3)
            m00, m10, m01 = md[..., 0:1], md[..., 1:2], md[..., 2:3]
            m20, m11, m02 = md[..., 3:4], md[..., 4:5], md[..., 5:6]
            # the tile-local mean: dx at pixel 0, which sits at (0, 0)
            mx, my = dx[..., 0:1], dy[..., 0:1]
            ex = mx * m00 - m10
            ey = my * m00 - m01
            if row5_guard:
                dl_dop = torch.where(op > 1e-12,
                                     m00 / torch.clamp_min(op, 1e-12),
                                     torch.zeros_like(op))
            else:
                dl_dop = m00 / torch.clamp_min(op, 1e-6)
            rows = [-(ca * ex + cb * ey), -(cc * ey + cb * ex),
                    -0.5 * (mx * mx * m00 - 2.0 * mx * m10 + m20),
                    -(mx * my * m00 - mx * m01 - my * m10 + m11),
                    -0.5 * (my * my * m00 - 2.0 * my * m01 + m02),
                    mw[..., 0:1], mw[..., 1:2], mw[..., 2:3], dl_dop]
            block = torch.stack([r[..., 0] for r in rows])
        else:
            dl_dg = op * dl_da
            dl_dpow = dl_dg * gv
            block = torch.stack([
                torch.sum(dl_dpow * -(ca * dx + cb * dy), dim=2),
                torch.sum(dl_dpow * -(cc * dy + cb * dx), dim=2),
                torch.sum(dl_dpow * (-0.5 * dx * dx), dim=2),
                torch.sum(dl_dpow * (-dx * dy), dim=2),
                torch.sum(dl_dpow * (-0.5 * dy * dy), dim=2),
                torch.sum(g_r * w, dim=2), torch.sum(g_g * w, dim=2),
                torch.sum(g_b * w, dim=2), torch.sum(gv * dl_da, dim=2)])
        slots = goffs[:-1, None] + win.c * chunk + sub[None, :]  # (T, chunk)
        grads[:, slots[win.walking]] = block[:, win.walking]
    return grads


_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


def _lib():
    fn = cuda_build.load("composite_bwd_variants").composite_bwd_variants_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _cuda(feats, offsets, grad_offsets, fwd_out, gout, *, form: str,
          tile: int, chunk: int, n_tiles_x: int, n_tiles_y: int,
          grad_cap: int) -> torch.Tensor:
    name = launch_name(form)
    _check_bwd(name, feats, offsets, grad_offsets, fwd_out, gout, tile=tile,
               chunk=chunk, n_tiles_x=n_tiles_x, n_tiles_y=n_tiles_y,
               grad_cap=grad_cap)
    fn = _lib()
    grads = torch.zeros((N_USED, grad_cap), dtype=torch.float32,
                        device=feats.device)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    err = fn(feats.data_ptr(), feats.stride(0), offsets.data_ptr(),
             grad_offsets.data_ptr(), fwd_out.data_ptr(), gout.data_ptr(),
             grads.data_ptr(), grad_cap, n_tiles_y, n_tiles_x, tile, chunk,
             FORMS[form][0], stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return grads


def _dispatch(args, kw, form: str) -> torch.Tensor:
    if args[0].is_cuda:
        return _cuda(*args, form=form, **kw)
    if args[0].device.type == "cpu":
        return _plain(*args, form=form, **kw)
    raise ValueError(f"{launch_name(form)}: unsupported device "
                     f"{args[0].device}")


def _variant(variant: str) -> str:
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    return variant


def composite_bwd_moments_plain(feats, offsets, grad_offsets, fwd_out, gout,
                                **kw) -> torch.Tensor:
    """Plain PyTorch row 5, vectorised over tiles."""
    return _plain(feats, offsets, grad_offsets, fwd_out, gout,
                  form="moments", **kw)


def composite_bwd_moments_cuda(feats, offsets, grad_offsets, fwd_out, gout,
                               **kw) -> torch.Tensor:
    """Launch row 5's form of csrc/composite_bwd_variants.cu."""
    return _cuda(feats, offsets, grad_offsets, fwd_out, gout,
                 form="moments", **kw)


def composite_bwd_moments(feats, offsets, grad_offsets, fwd_out, gout, *,
                          tile: int, chunk: int, n_tiles_x: int,
                          n_tiles_y: int, grad_cap: int) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    kw = dict(tile=tile, chunk=chunk, n_tiles_x=n_tiles_x,
              n_tiles_y=n_tiles_y, grad_cap=grad_cap)
    return _dispatch((feats, offsets, grad_offsets, fwd_out, gout), kw,
                     "moments")


def composite_bwd_variant_plain(feats, offsets, grad_offsets, fwd_out, gout,
                                *, variant: str, **kw) -> torch.Tensor:
    """Plain PyTorch row 7 in the given variant."""
    return _plain(feats, offsets, grad_offsets, fwd_out, gout,
                  form=_variant(variant), **kw)


def composite_bwd_variant_cuda(feats, offsets, grad_offsets, fwd_out, gout,
                               *, variant: str, **kw) -> torch.Tensor:
    """Launch the variant's form of csrc/composite_bwd_variants.cu."""
    return _cuda(feats, offsets, grad_offsets, fwd_out, gout,
                 form=_variant(variant), **kw)


def composite_bwd_variant(feats, offsets, grad_offsets, fwd_out, gout, *,
                          variant: str, tile: int, chunk: int,
                          n_tiles_x: int, n_tiles_y: int,
                          grad_cap: int) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    kw = dict(tile=tile, chunk=chunk, n_tiles_x=n_tiles_x,
              n_tiles_y=n_tiles_y, grad_cap=grad_cap)
    return _dispatch((feats, offsets, grad_offsets, fwd_out, gout), kw,
                     _variant(variant))
