"""Tile compositing, forward and backward, in two output layouts: the
CUDA kernels and their plain versions.

Counterparts of composite_fwd, composite_bwd, composite_fwd_panel and
composite_bwd_panel in sings_tpu/ops/rasterizer/pallas_kernels.py
(:873, body _fwd_kernel :133; :912, body _bwd_kernel :218; :789, body
_fwd_kernel_panel :474; :827, body _bwd_kernel_panel :582). The kernels
are csrc/composite_fwd.cu and csrc/composite_bwd.cu, one per direction
for both layouts, built with nvcc for sm_90a and called through ctypes;
the *_plain functions are the same functions in PyTorch, chunk by chunk
over all tiles at once. Every function takes pw=None for the tiled
layout and pw = panel_width(tile) for the panel planes; the plain
versions relay the tiled result out, so the two layouts share one walk
(_walk_windows) as the kernels share csrc/composite_common.cuh.

Each public function dispatches on the tensors' device: CUDA tensors
launch the kernel (or raise), CPU tensors run the plain version.
Nothing else.

Pair features: (NFEAT=16, PK + chunk) float32, pair-minor rows
  0 mean_x | 1 mean_y | 2 conic_a | 3 conic_b | 4 conic_c |
  5 r | 6 g | 7 b | 8 opacity | 9..15 zero
Forward output: (T, 8, tile*tile): rows 0-2 colour (no background), row
3 final transmittance, rows 4-7 zero. Panel layout: (4, Hp, Wp) image
planes of the same rows 0-3, Hp = n_tiles_y * tile, Wp = ceil(n_tiles_x
/ pw) * pw * tile with pw = max(1, 128 // tile) (the TPU's 128-px
panels); the sub-tiles past the last tile column hold colour 0, T = 1.
Window-entry state (composite_fwd with grad_offsets and grad_cap, the
backward's input): (grad_cap // chunk, 4, tile*tile) f32, row (g, 0..3)
the T and colour sums (r, g, b) of each pixel at the top of window c of
tile t, g = grad_offsets[t] // chunk + c (the gradient buffer's window
numbering); zero for the windows a tile's walk never reached, which the
backward therefore skips. The rows from grad_offsets[T] // chunk on
belong to no tile and are never read: the kernel leaves them unwritten
(its buffer is not zero-filled), the plain version zero. The state
makes the windows independent: the forward kernel walks a tile's
windows on separate CTAs that hand each other their entry through it
(so it needs grad_offsets and grad_cap on every call, and writes into
scratch of the same layout when the caller does not keep the state:
return_state=False), and composite_bwd walks them in parallel from it
instead of re-walking each tile's segment.
Backward output: (9, grad_cap) per-pair gradients in JAX's row order
(d mean_x, d mean_y, d conic a, b, c, d r, g, b, d opacity), the first 9
of JAX's 16 rows, at grad_offsets[t] + (i - base_t) for sorted pair i of
tile t. The buffer starts zeroed: every slot the kernel does not write
(pairs outside a segment, windows after a tile's exit, the spare window
[grad_cap - chunk, grad_cap)) reads zero, as the TPU kernel's explicit
zero stores make it there.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import cuda_build

ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
NFEAT = 16
N_USED = 9

# launches through each wrapper, by layout (the *_panel keys: pw given),
# never through the plain version
LAUNCHES = {"composite_fwd": 0, "composite_bwd": 0,
            "composite_fwd_panel": 0, "composite_bwd_panel": 0}
# of those, the forward launches that wrote the window-entry state
STATE_WRITES = {"composite_fwd": 0, "composite_fwd_panel": 0}


def reset_launches() -> None:
    for d in (LAUNCHES, STATE_WRITES):
        for k in d:
            d[k] = 0


def _tri(chunk: int, device, strict: bool) -> torch.Tensor:
    """(chunk, chunk) lower-triangular ones, strict or inclusive: the
    TPU kernels' _tri_strict / _tri_incl cumsum matrices."""
    return torch.tril(torch.ones((chunk, chunk), device=device,
                                 dtype=torch.float64),
                      diagonal=-1 if strict else 0)


# The plain versions compute the transcendental functions and the
# windows' sums in float64 and round once to float32. On the CPU,
# PyTorch's float32 exp/log1p (vectorised or scalar, by where the
# threads split the work) and its summation order change with the
# number of threads a process gets, and a 1-ulp change in T flips a
# termination test near 1e-4; rounded from float64 the results are the
# same in every process.
def _exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.double()).float()


def _log1p(x: torch.Tensor) -> torch.Tensor:
    return torch.log1p(x.double()).float()


def _tri_sum(tri: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """tri @ x: the windows' cumulative sums."""
    return torch.matmul(tri, x.double()).float()


class _Window(NamedTuple):
    """One chunk-aligned window of every tile, as _walk_windows yields it.

    f: (9, T, chunk, 1) used feature rows; dx, dy, gv, alpha, t_bef,
    flag: (T, chunk, npx); entered: (T,) tiles whose walk reached the top
    of this window; walking: (T,) those with a pixel at T >= 1e-4 there;
    n_walked: (T,) pairs of the tile's segment in this window (0 unless
    walking); t_entry, t_after: (T, 1, npx) transmittance before and
    after the window; entry: (T, 4, npx) the window's rows of the entry
    state (None without one).
    """
    c: int
    f: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    gv: torch.Tensor
    alpha: torch.Tensor
    t_bef: torch.Tensor
    flag: torch.Tensor
    entered: torch.Tensor
    walking: torch.Tensor
    n_walked: torch.Tensor
    t_entry: torch.Tensor
    t_after: torch.Tensor
    entry: torch.Tensor | None


def state_shape(*, grad_cap: int, chunk: int, tile: int) -> tuple:
    """The window-entry state's shape: (grad_cap // chunk, 4, npx)."""
    return grad_cap // chunk, 4, tile * tile


def _walk_windows(feats: torch.Tensor, offsets: torch.Tensor, *, tile: int,
                  chunk: int, n_tiles_x: int, n_tiles_y: int,
                  entry: tuple | None = None):
    """The front-to-back walk that both plain versions share, as
    csrc/composite_common.cuh is shared by both kernels.

    Window c of every tile at once, with the TPU kernels' arithmetic:
    alpha from tile-local coordinates (zero where the pair is skipped or
    outside the segment), the exclusive cumsum of log1p(-alpha) as a
    strictly-lower-triangular matmul (_tri_sum), the T * (1 - alpha) >=
    1e-4 flag and the carried transmittance. Tiles whose every pixel has
    T < 1e-4 at a window's top stop there, as the kernels' per-tile exit
    does; that window is still yielded (entered, not walking) for the
    forward's state.

    entry: (state, grad_offsets), the backward's case: each window's T
    comes from the state instead of the previous window, so the windows
    do not depend on each other, and windows where no tile walks are not
    yielded.
    """
    dev = feats.device
    n_tiles = n_tiles_x * n_tiles_y
    npx = tile * tile
    width = feats.shape[1]
    offs = offsets.to(torch.int64)
    start, end = offs[:-1], offs[1:]
    base = torch.div(start, chunk, rounding_mode="floor") * chunk
    nchunks = torch.div(end - base + chunk - 1, chunk, rounding_mode="floor")
    p = torch.arange(npx, device=dev)
    px_x = (p % tile).to(torch.float32)[None, None, :]
    px_y = (p // tile).to(torch.float32)[None, None, :]
    tid = torch.arange(n_tiles, device=dev)
    ox = ((tid % n_tiles_x).to(torch.float32) * tile)[:, None, None]
    oy = ((tid // n_tiles_x).to(torch.float32) * tile)[:, None, None]
    ltri = _tri(chunk, dev, strict=True)
    sub = torch.arange(chunk, device=dev)
    if entry is not None:
        state, goffs = entry
        win0 = torch.div(goffs[:-1].to(torch.int64), chunk,
                         rounding_mode="floor")

    t_carry = torch.ones((n_tiles, 1, npx), device=dev)
    walking = torch.ones(n_tiles, dtype=torch.bool, device=dev)
    max_chunks = int(nchunks.max()) if n_tiles else 0
    for c in range(max_chunks):
        rows = None
        if entry is None:
            entered = walking & (c < nchunks)
            if not bool(entered.any()):
                return
        else:
            entered = c < nchunks
            g = torch.where(entered, win0 + c, torch.zeros_like(win0))
            rows = state[g] * entered[:, None, None]       # (T, 4, npx)
            t_carry = rows[:, 0:1]
        walking = entered & (t_carry.amax(dim=(1, 2)) >= T_EPS)
        if entry is not None and not bool(walking.any()):
            continue
        gidx = base[:, None] + c * chunk + sub[None, :]        # (T, chunk)
        f = feats[:N_USED, gidx.clamp(max=width - 1)][..., None]
        pair_ok = ((gidx >= start[:, None]) & (gidx < end[:, None])
                   & walking[:, None])[..., None]
        n_walked = ((torch.minimum(end, base + (c + 1) * chunk)
                     - torch.maximum(start, base + c * chunk)).clamp_min(0)
                    * walking)
        ca, cb, cc, op = f[2], f[3], f[4], f[8]
        dx = (f[0] - ox) - px_x
        dy = (f[1] - oy) - px_y
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        gv = _exp(power)
        alpha = torch.clamp_max(op * gv, 0.99)
        alpha = torch.where((power > 0.0) | (alpha < ALPHA_MIN) | ~pair_ok,
                            torch.zeros_like(alpha), alpha)
        la = _log1p(-alpha)
        t_bef = t_carry * _exp(_tri_sum(ltri, la))
        flag = (t_bef * (1.0 - alpha)) >= T_EPS
        la_eff = torch.where(flag, la, torch.zeros_like(la))
        t_after = t_carry * _exp(torch.sum(la_eff.double(), dim=1,
                                           keepdim=True).float())
        yield _Window(c, f, dx, dy, gv, alpha, t_bef, flag, entered, walking,
                      n_walked, t_carry, t_after, rows)
        t_carry = t_after


# ---------------------------------------------------------------------------
# the panel layout: the same compositing in (4, Hp, Wp) image planes


def panel_width(tile: int) -> int:
    """Sub-tiles per 128-px panel (RasterConfig.panel_width)."""
    return max(1, 128 // tile)


def panel_shape(*, tile: int, n_tiles_x: int, n_tiles_y: int,
                pw: int) -> tuple[int, int]:
    """(Hp, Wp) of the panel planes."""
    return n_tiles_y * tile, -(-n_tiles_x // pw) * pw * tile


def tiles_to_planes(out: torch.Tensor, *, tile: int, n_tiles_x: int,
                    n_tiles_y: int, pw: int) -> torch.Tensor:
    """(T, 8, npx) tile rows -> (4, Hp, Wp) planes of rows 0-3; the
    padding sub-tiles get colour 0 and T = 1."""
    hp, wp = panel_shape(tile=tile, n_tiles_x=n_tiles_x,
                         n_tiles_y=n_tiles_y, pw=pw)
    planes = out.new_zeros((4, hp, wp))
    planes[3] = 1.0
    img = out[:, :4].reshape(n_tiles_y, n_tiles_x, 4, tile, tile)
    planes[:, :, : n_tiles_x * tile] = img.permute(2, 0, 3, 1, 4).reshape(
        4, hp, n_tiles_x * tile)
    return planes


def planes_to_tiles(planes: torch.Tensor, *, tile: int, n_tiles_x: int,
                    n_tiles_y: int) -> torch.Tensor:
    """(4, Hp, Wp) planes -> (T, 8, npx) tile rows (rows 4-7 zero); the
    padding sub-tiles are dropped."""
    x = planes[:, :, : n_tiles_x * tile].reshape(4, n_tiles_y, tile,
                                                 n_tiles_x, tile)
    tiles = x.permute(1, 3, 0, 2, 4).reshape(n_tiles_y * n_tiles_x, 4,
                                             tile * tile)
    return torch.cat([tiles, torch.zeros_like(tiles)], dim=1)


def out_shape(*, tile: int, n_tiles_x: int, n_tiles_y: int,
              pw: int | None = None) -> tuple[int, ...]:
    """The forward output's shape: (T, 8, npx) tile rows, or with pw the
    (4, Hp, Wp) panel planes."""
    if pw is None:
        return n_tiles_x * n_tiles_y, 8, tile * tile
    return (4,) + panel_shape(tile=tile, n_tiles_x=n_tiles_x,
                              n_tiles_y=n_tiles_y, pw=pw)


def composite_fwd_plain(feats: torch.Tensor, offsets: torch.Tensor, *,
                        tile: int, chunk: int, n_tiles_x: int,
                        n_tiles_y: int, pw: int | None = None,
                        grad_offsets: torch.Tensor | None = None,
                        grad_cap: int | None = None,
                        return_state: bool = True,
                        return_walked: bool = False):
    """Plain PyTorch composite, vectorised over tiles: the colour sums
    of _walk_windows' compositing pairs and the last transmittance, in
    tile rows or, with pw, relaid out to the panel planes.

    grad_offsets, grad_cap: also return the window-entry state (see the
    module docstring): (out, state), unless return_state is False.
    return_walked: also return the number of pairs walked before each
    tile's exit, summed (the data-dependent work of this input), last.
    """
    n_tiles = n_tiles_x * n_tiles_y
    npx = tile * tile
    dev = feats.device
    t_final = torch.ones((n_tiles, 1, npx), device=dev)
    acc = torch.zeros((n_tiles, 3, npx), device=dev)
    state = None
    if grad_offsets is not None and return_state:
        state = feats.new_zeros(state_shape(grad_cap=grad_cap, chunk=chunk,
                                            tile=tile))
        win0 = torch.div(grad_offsets[:-1].to(torch.int64), chunk,
                         rounding_mode="floor")
    walked = 0
    for win in _walk_windows(feats, offsets, tile=tile, chunk=chunk,
                             n_tiles_x=n_tiles_x, n_tiles_y=n_tiles_y):
        if state is not None:
            state[win0[win.entered] + win.c] = torch.cat(
                [win.t_entry, acc], dim=1)[win.entered]
        f = win.f
        w = torch.where(win.flag, win.alpha,
                        torch.zeros_like(win.alpha)) * win.t_bef
        acc[:, 0:1] += torch.sum(w * f[5], dim=1, keepdim=True)
        acc[:, 1:2] += torch.sum(w * f[6], dim=1, keepdim=True)
        acc[:, 2:3] += torch.sum(w * f[7], dim=1, keepdim=True)
        walked += int(win.n_walked.sum())
        t_final = win.t_after
    out = torch.cat([acc, t_final,
                     torch.zeros((n_tiles, 4, npx), device=dev)], dim=1)
    if pw is not None:
        out = tiles_to_planes(out, tile=tile, n_tiles_x=n_tiles_x,
                              n_tiles_y=n_tiles_y, pw=pw)
    res = (out,) + ((state,) if state is not None else ()) + (
        (walked,) if return_walked else ())
    return res[0] if len(res) == 1 else res


_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]


def _lib(name: str = "composite_fwd", argtypes=_ARGTYPES):
    fn = getattr(cuda_build.load(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
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
    if not 1 <= tile * tile <= 1024 or (tile * tile) % 32:
        raise ValueError(f"tile {tile}: tile*tile threads must be a "
                         "multiple of 32 and <= 1024")
    if chunk <= 0:
        raise ValueError(f"chunk {chunk} must be positive")


def _check_grad_offsets(grad_offsets, n_tiles, grad_cap, chunk, device):
    if (grad_offsets.dtype != torch.int32
            or grad_offsets.shape != (n_tiles + 1,)
            or not grad_offsets.is_contiguous()
            or grad_offsets.device != device):
        raise ValueError("grad_offsets must be contiguous int32 "
                         f"({n_tiles + 1},) on {device}")
    if grad_cap is None or grad_cap < chunk or grad_cap % chunk:
        raise ValueError(f"grad_cap {grad_cap} must be a positive multiple "
                         f"of chunk {chunk}")


def _check_staging(feats, chunk):
    if feats.data_ptr() % 16 or feats.stride(0) % 4 or chunk % 4:
        raise ValueError("the kernels stage feats in 16-byte copies: "
                         "feats 16-byte aligned, its row stride and chunk "
                         "multiples of 4")


def _row_tiles(shape, tile: int, pw: int | None) -> int:
    """The launchers' layout argument: 0 for tile rows, else the tiles
    of a padded tile row of the panel planes."""
    return 0 if pw is None else shape[2] // tile


def composite_fwd_cuda(feats: torch.Tensor, offsets: torch.Tensor, *,
                       tile: int, chunk: int, n_tiles_x: int,
                       n_tiles_y: int, pw: int | None = None,
                       grad_offsets: torch.Tensor | None = None,
                       grad_cap: int | None = None,
                       return_state: bool = True):
    """Launch csrc/composite_fwd.cu on the current stream: tile rows, or
    with pw the panel planes (counted as composite_fwd_panel). Needs
    grad_offsets and grad_cap: the kernel's windows hand each other their
    entry in the window-entry state's layout. Returns (out, state), or
    with return_state=False out alone (the state then lives in scratch
    that is dropped)."""
    name = "composite_fwd" if pw is None else "composite_fwd_panel"
    if grad_offsets is None or grad_cap is None:
        raise ValueError(f"{name}: the CUDA kernel needs grad_offsets and "
                         "grad_cap (its windows hand on their entry state)")
    if not (feats.is_cuda and offsets.is_cuda
            and feats.device == offsets.device):
        raise ValueError(f"{name} needs both tensors on one CUDA device")
    n_tiles = n_tiles_x * n_tiles_y
    _check(feats, offsets, tile, chunk, n_tiles)
    _check_grad_offsets(grad_offsets, n_tiles, grad_cap, chunk, feats.device)
    _check_staging(feats, chunk)
    shape = out_shape(tile=tile, n_tiles_x=n_tiles_x, n_tiles_y=n_tiles_y,
                      pw=pw)
    fn = _lib()
    state = torch.empty(state_shape(grad_cap=grad_cap, chunk=chunk,
                                    tile=tile),
                        dtype=torch.float32, device=feats.device)
    # the ticket, then one hand-off flag per window
    sync = torch.zeros(grad_cap // chunk + 1, dtype=torch.int32,
                       device=feats.device)
    out = torch.empty(shape, dtype=torch.float32, device=feats.device)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    err = fn(feats.data_ptr(), feats.stride(0), feats.shape[1],
             offsets.data_ptr(), grad_offsets.data_ptr(), state.data_ptr(),
             sync.data_ptr(), out.data_ptr(), grad_cap // chunk, n_tiles_y,
             n_tiles_x, tile, chunk, _row_tiles(shape, tile, pw), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    if not return_state:
        return out
    STATE_WRITES[name] += 1
    return out, state


def composite_fwd(feats: torch.Tensor, offsets: torch.Tensor, *, tile: int,
                  chunk: int, n_tiles_x: int, n_tiles_y: int,
                  pw: int | None = None,
                  grad_offsets: torch.Tensor | None = None,
                  grad_cap: int | None = None, return_state: bool = True):
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    kw = dict(tile=tile, chunk=chunk, n_tiles_x=n_tiles_x,
              n_tiles_y=n_tiles_y, pw=pw, grad_offsets=grad_offsets,
              grad_cap=grad_cap, return_state=return_state)
    if feats.is_cuda:
        return composite_fwd_cuda(feats, offsets, **kw)
    if feats.device.type == "cpu":
        return composite_fwd_plain(feats, offsets, **kw)
    raise ValueError(f"composite_fwd: unsupported device {feats.device}")


def composite_bwd_plain(feats: torch.Tensor, offsets: torch.Tensor,
                        grad_offsets: torch.Tensor, fwd_out: torch.Tensor,
                        gout: torch.Tensor, state: torch.Tensor, *,
                        tile: int, chunk: int, n_tiles_x: int,
                        n_tiles_y: int, grad_cap: int,
                        pw: int | None = None, return_counts: bool = False):
    """Plain PyTorch backward, vectorised over tiles.

    The TPU kernel's arithmetic on _walk_windows' windows, each started
    from the window-entry state: T from row 0, the cumsum carry
    cpg = g_r acc_r + g_g acc_g + g_b acc_b from rows 1-3; the inclusive
    cumsum of w * gc as a triangular matmul, the closed form dC/dalpha
    and the pixel reductions. Writes each walking tile's window into a
    zeroed (9, grad_cap) buffer at grad_offsets[t] + c * chunk. With pw,
    fwd_out and gout are panel planes, relaid out to tile rows first.

    return_counts: also return the pairs walked before each tile's exit
    and the pair-pixels that composite, each summed (the data-dependent
    work of this input).
    """
    if pw is not None:
        lay = dict(tile=tile, n_tiles_x=n_tiles_x, n_tiles_y=n_tiles_y)
        fwd_out = planes_to_tiles(fwd_out, **lay)
        gout = planes_to_tiles(gout, **lay)
    dev = feats.device
    goffs = grad_offsets.to(torch.int64)
    linc = _tri(chunk, dev, strict=False)
    sub = torch.arange(chunk, device=dev)

    g_rgb = gout[:, 0:3]                                    # (T, 3, npx)
    cfg = torch.sum(g_rgb * fwd_out[:, 0:3], dim=1, keepdim=True)
    gtf = gout[:, 3:4] * fwd_out[:, 3:4]                    # (T, 1, npx)
    grads = feats.new_zeros((N_USED, grad_cap))
    walked = composited = 0
    for win in _walk_windows(feats, offsets, tile=tile, chunk=chunk,
                             n_tiles_x=n_tiles_x, n_tiles_y=n_tiles_y,
                             entry=(state, grad_offsets)):
        f, dx, dy, gv, t_bef = win.f, win.dx, win.dy, win.gv, win.t_bef
        aeff = torch.where(win.flag, win.alpha, torch.zeros_like(win.alpha))
        w = aeff * t_bef
        gc = f[5] * g_rgb[:, 0:1] + f[6] * g_rgb[:, 1:2] + f[7] * g_rgb[:, 2:3]
        cpg = (g_rgb[:, 0:1] * win.entry[:, 1:2]
               + g_rgb[:, 1:2] * win.entry[:, 2:3]
               + g_rgb[:, 2:3] * win.entry[:, 3:4])
        upg = cpg + _tri_sum(linc, w * gc)
        dl_da = t_bef * gc - ((cfg - upg) + gtf) / (1.0 - aeff)
        dl_da = torch.where(aeff > 0.0, dl_da, torch.zeros_like(dl_da))
        # the derivative as if alpha = op * G, clamp or not (TPU quirk)
        dl_dpow = f[8] * dl_da * gv
        u = dl_dpow * dx
        v = dl_dpow * dy
        su = u.sum(dim=2)
        sv = v.sum(dim=2)
        ca, cb, cc = f[2, ..., 0], f[3, ..., 0], f[4, ..., 0]
        block = torch.stack([
            -(ca * su + cb * sv), -(cc * sv + cb * su),
            -0.5 * (u * dx).sum(dim=2), -(u * dy).sum(dim=2),
            -0.5 * (v * dy).sum(dim=2),
            (g_rgb[:, 0:1] * w).sum(dim=2), (g_rgb[:, 1:2] * w).sum(dim=2),
            (g_rgb[:, 2:3] * w).sum(dim=2), (gv * dl_da).sum(dim=2)])
        slots = goffs[:-1, None] + win.c * chunk + sub[None, :]  # (T, chunk)
        grads[:, slots[win.walking]] = block[:, win.walking]
        if return_counts:
            walked += int(win.n_walked.sum())
            composited += int((aeff > 0.0).sum())
    if return_counts:
        return grads, walked, composited
    return grads


_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _check_bwd(name, feats, offsets, grad_offsets, fwd_out, gout, state, *,
               tile, chunk, n_tiles_x, n_tiles_y, grad_cap, pw=None) -> tuple:
    """A backward launcher's argument checks; returns the layout's shape
    of fwd_out and gout."""
    n_tiles = n_tiles_x * n_tiles_y
    tensors = (feats, offsets, grad_offsets, fwd_out, gout, state)
    if not all(x.is_cuda and x.device == feats.device for x in tensors):
        raise ValueError(f"{name} needs every tensor on one CUDA device")
    _check(feats, offsets, tile, chunk, n_tiles)
    _check_grad_offsets(grad_offsets, n_tiles, grad_cap, chunk, feats.device)
    _check_staging(feats, chunk)
    shape = out_shape(tile=tile, n_tiles_x=n_tiles_x, n_tiles_y=n_tiles_y,
                      pw=pw)
    st = state_shape(grad_cap=grad_cap, chunk=chunk, tile=tile)
    for arg, x, want in (("fwd_out", fwd_out, shape), ("gout", gout, shape),
                         ("state", state, st)):
        if (x.dtype != torch.float32 or x.shape != want
                or not x.is_contiguous()):
            raise ValueError(f"{arg} must be contiguous f32 {want}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    return shape


def bwd_launch_args(feats, offsets, grad_offsets, fwd_out, gout, state,
                    grads, *, tile, chunk, n_tiles_x, n_tiles_y,
                    grad_cap) -> tuple:
    """The leading arguments of the backward launchers (composite_bwd.cu,
    composite_bwd_variants.cu), up to and including chunk."""
    return (feats.data_ptr(), feats.stride(0), feats.shape[1],
            offsets.data_ptr(), grad_offsets.data_ptr(), fwd_out.data_ptr(),
            gout.data_ptr(), state.data_ptr(), grads.data_ptr(), grad_cap,
            n_tiles_y, n_tiles_x, tile, chunk)


def composite_bwd_cuda(feats: torch.Tensor, offsets: torch.Tensor,
                       grad_offsets: torch.Tensor, fwd_out: torch.Tensor,
                       gout: torch.Tensor, state: torch.Tensor, *,
                       tile: int, chunk: int, n_tiles_x: int,
                       n_tiles_y: int, grad_cap: int,
                       pw: int | None = None) -> torch.Tensor:
    """Launch csrc/composite_bwd.cu on the current stream into a zeroed
    (9, grad_cap) buffer; fwd_out and gout in tile rows, or with pw in
    panel planes (counted as composite_bwd_panel); state from
    composite_fwd(grad_offsets=, grad_cap=) on the same inputs."""
    name = "composite_bwd" if pw is None else "composite_bwd_panel"
    kw = dict(tile=tile, chunk=chunk, n_tiles_x=n_tiles_x,
              n_tiles_y=n_tiles_y, grad_cap=grad_cap)
    args = (feats, offsets, grad_offsets, fwd_out, gout, state)
    shape = _check_bwd(name, *args, pw=pw, **kw)
    fn = _lib("composite_bwd", _BWD_ARGTYPES)
    grads = torch.zeros((N_USED, grad_cap), dtype=torch.float32,
                        device=feats.device)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    err = fn(*bwd_launch_args(*args, grads, **kw),
             _row_tiles(shape, tile, pw), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return grads


def composite_bwd(feats: torch.Tensor, offsets: torch.Tensor,
                  grad_offsets: torch.Tensor, fwd_out: torch.Tensor,
                  gout: torch.Tensor, state: torch.Tensor, *, tile: int,
                  chunk: int, n_tiles_x: int, n_tiles_y: int, grad_cap: int,
                  pw: int | None = None) -> torch.Tensor:
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    kw = dict(tile=tile, chunk=chunk, n_tiles_x=n_tiles_x,
              n_tiles_y=n_tiles_y, grad_cap=grad_cap, pw=pw)
    args = (feats, offsets, grad_offsets, fwd_out, gout, state)
    if feats.is_cuda:
        return composite_bwd_cuda(*args, **kw)
    if feats.device.type == "cpu":
        return composite_bwd_plain(*args, **kw)
    raise ValueError(f"composite_bwd: unsupported device {feats.device}")
