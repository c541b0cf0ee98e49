"""Tile compositing forward: the CUDA kernel and its plain version.

Counterpart of composite_fwd in sings_tpu/ops/rasterizer/pallas_kernels.py
(:873, body _fwd_kernel :133). The kernel is csrc/composite_fwd.cu, built
with nvcc for sm_90a and called through ctypes; composite_fwd_plain is
the same function in PyTorch, chunk by chunk over all tiles at once.

composite_fwd dispatches on the tensors' device: CUDA tensors launch
the kernel (or raise), CPU tensors run the plain version. Nothing else.

Pair features: (NFEAT=16, PK + chunk) float32, pair-minor rows
  0 mean_x | 1 mean_y | 2 conic_a | 3 conic_b | 4 conic_c |
  5 r | 6 g | 7 b | 8 opacity | 9..15 zero
Output: (T, 8, tile*tile): rows 0-2 colour (no background), row 3 final
transmittance, rows 4-7 zero.
"""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_build

ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
NFEAT = 16
N_USED = 9

# launches of each kernel through its wrapper (never the plain version)
LAUNCHES = {"composite_fwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _pixel_coords_local(tile: int, device):
    p = torch.arange(tile * tile, device=device)
    return ((p % tile).to(torch.float32)[None, None, :],
            (p // tile).to(torch.float32)[None, None, :])


def composite_fwd_plain(feats: torch.Tensor, offsets: torch.Tensor, *,
                        tile: int, chunk: int, n_tiles_x: int,
                        n_tiles_y: int, return_walked: bool = False):
    """Plain PyTorch composite, vectorised over tiles.

    Step c handles every tile's c-th chunk-aligned window as one
    (T, chunk, npx) block, with the TPU kernel's arithmetic: alpha from
    tile-local coordinates, the exclusive cumsum of log1p(-alpha) as a
    strictly-lower-triangular matmul, the T * (1 - alpha) >= 1e-4 flag
    and the carried transmittance. Tiles whose every pixel has
    T < 1e-4 stop there, as the kernel's per-tile exit does; later
    windows could change nothing for them anyway.

    return_walked: also return the number of pairs walked before each
    tile's exit, summed (the data-dependent work of this input).
    """
    dev = feats.device
    n_tiles = n_tiles_x * n_tiles_y
    npx = tile * tile
    width = feats.shape[1]
    offs = offsets.to(torch.int64)
    start, end = offs[:-1], offs[1:]
    base = torch.div(start, chunk, rounding_mode="floor") * chunk
    nchunks = torch.div(end - base + chunk - 1, chunk, rounding_mode="floor")
    px_x, px_y = _pixel_coords_local(tile, dev)
    tid = torch.arange(n_tiles, device=dev)
    ox = ((tid % n_tiles_x).to(torch.float32) * tile)[:, None, None]
    oy = ((tid // n_tiles_x).to(torch.float32) * tile)[:, None, None]
    ltri = torch.tril(torch.ones((chunk, chunk), device=dev), diagonal=-1)
    sub = torch.arange(chunk, device=dev)

    t_carry = torch.ones((n_tiles, 1, npx), device=dev)
    acc = torch.zeros((n_tiles, 3, npx), device=dev)
    walking = torch.ones(n_tiles, dtype=torch.bool, device=dev)
    walked = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    max_chunks = int(nchunks.max()) if n_tiles else 0
    for c in range(max_chunks):
        walking = walking & (c < nchunks) & (
            t_carry.amax(dim=(1, 2)) >= T_EPS)
        if not bool(walking.any()):
            break
        gidx = base[:, None] + c * chunk + sub[None, :]        # (T, chunk)
        f = feats[:N_USED, gidx.clamp(max=width - 1)]          # (9, T, chunk)
        f = f[..., None]                                       # (9,T,chunk,1)
        pair_ok = ((gidx >= start[:, None]) & (gidx < end[:, None])
                   & walking[:, None])[..., None]
        walked += ((torch.minimum(end, base + (c + 1) * chunk)
                    - torch.maximum(start, base + c * chunk)).clamp_min(0)
                   * walking)
        mx = f[0] - ox
        my = f[1] - oy
        ca, cb, cc, op = f[2], f[3], f[4], f[8]
        dx = mx - px_x
        dy = my - px_y
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp_max(op * torch.exp(power), 0.99)
        alpha = torch.where((power > 0.0) | (alpha < ALPHA_MIN) | ~pair_ok,
                            torch.zeros_like(alpha), alpha)
        la = torch.log1p(-alpha)
        excl = torch.matmul(ltri, la)
        t_bef = t_carry * torch.exp(excl)
        flag = (t_bef * (1.0 - alpha)) >= T_EPS
        w = torch.where(flag, alpha, torch.zeros_like(alpha)) * t_bef
        acc[:, 0:1] += torch.sum(w * f[5], dim=1, keepdim=True)
        acc[:, 1:2] += torch.sum(w * f[6], dim=1, keepdim=True)
        acc[:, 2:3] += torch.sum(w * f[7], dim=1, keepdim=True)
        la_eff = torch.where(flag, la, torch.zeros_like(la))
        t_carry = t_carry * torch.exp(torch.sum(la_eff, dim=1, keepdim=True))
    out = torch.cat([acc, t_carry,
                     torch.zeros((n_tiles, 4, npx), device=dev)], dim=1)
    if return_walked:
        return out, int(walked.sum())
    return out


_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]


def _lib():
    lib = cuda_build.load("composite_fwd")
    fn = lib.composite_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(feats, offsets, tile, chunk, n_tiles):
    if feats.dtype != torch.float32 or offsets.dtype != torch.int32:
        raise TypeError(f"feats f32 / offsets int32 expected, got "
                        f"{feats.dtype} / {offsets.dtype}")
    if feats.ndim != 2 or feats.shape[0] != NFEAT:
        raise ValueError(f"feats must be ({NFEAT}, PK + chunk), got "
                         f"{tuple(feats.shape)}")
    if offsets.shape != (n_tiles + 1,):
        raise ValueError(f"offsets must be ({n_tiles + 1},), got "
                         f"{tuple(offsets.shape)}")
    if feats.stride(1) != 1 or not offsets.is_contiguous():
        raise ValueError("feats rows and offsets must be contiguous")
    if not 1 <= tile * tile <= 1024:
        raise ValueError(f"tile {tile}: tile*tile threads must be <= 1024")
    if chunk <= 0:
        raise ValueError(f"chunk {chunk} must be positive")


def composite_fwd_cuda(feats: torch.Tensor, offsets: torch.Tensor, *,
                       tile: int, chunk: int, n_tiles_x: int,
                       n_tiles_y: int) -> torch.Tensor:
    """Launch csrc/composite_fwd.cu on the current stream."""
    n_tiles = n_tiles_x * n_tiles_y
    if not (feats.is_cuda and offsets.is_cuda
            and feats.device == offsets.device):
        raise ValueError("composite_fwd_cuda needs both tensors on one "
                         "CUDA device")
    _check(feats, offsets, tile, chunk, n_tiles)
    fn = _lib()
    out = torch.empty((n_tiles, 8, tile * tile), dtype=torch.float32,
                      device=feats.device)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    err = fn(feats.data_ptr(), feats.stride(0), offsets.data_ptr(),
             out.data_ptr(), n_tiles, tile, chunk, n_tiles_x, stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd launch failed: cudaError {err}")
    LAUNCHES["composite_fwd"] += 1
    return out


def composite_fwd(feats: torch.Tensor, offsets: torch.Tensor, *, tile: int,
                  chunk: int, n_tiles_x: int, n_tiles_y: int) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    kw = dict(tile=tile, chunk=chunk, n_tiles_x=n_tiles_x,
              n_tiles_y=n_tiles_y)
    if feats.is_cuda:
        return composite_fwd_cuda(feats, offsets, **kw)
    if feats.device.type == "cpu":
        return composite_fwd_plain(feats, offsets, **kw)
    raise ValueError(f"composite_fwd: unsupported device {feats.device}")
