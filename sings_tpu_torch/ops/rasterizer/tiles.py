"""Tile binning: static-shape pair expansion (port of
sings_tpu/ops/rasterizer/tiles.py, forward fields).

  1. one stable depth argsort ranks gaussians front to back (equal
     depths keep index order, like the CUDA radix sort);
  2. each gaussian emits up to max_span^2 (tile, rank) pairs from its
     center-cropped tile rectangle, culled per pair when its peak alpha
     over the tile cannot reach 1/255, optionally compacted to the
     first pair_cap survivors;
  3. one sort over key = tile * N + rank groups pairs by tile in depth
     order; invalid keys sort last; the prefix is cut to the capacity
     PK (rounded up to `align`, padded with invalid keys);
  4. per-tile offsets come from one searchsorted(side="left");
  5. the backward-glue tables map each original (gaussian, j) pair to
     its slot in the gradient buffer that composite_bwd writes: tile t's
     window c lands at grad_offsets[t] + c * align, so sorted pair i of
     tile t sits at i + grad_offsets[t] - base_t. main_slot holds the
     first main_width pairs of every gaussian, tail_slot the rest of
     the gaussians that span more, compacted to tail_capacity rows;
     invalid pairs point at the spare slot grad_capacity - 1.

Every field equals JAX's integer for integer, tail overflow included.

bin_gaussians dispatches on the device:
  * CUDA tensors: csrc/bin_tiles.cu (built with nvcc for sm_90a, called
    through ctypes; raises on any failure), bin_tiles_cuda: one emit
    kernel, one stable key sort (torch.sort), one tile scan and one slot
    kernel, with static shapes and no host wait; every field equals the
    plain version's on the same CUDA inputs. LAUNCHES["bin_tiles"]
    counts its calls.
  * CPU tensors: bin_gaussians_plain, the torch ops above.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import cuda_build
from .common import Gaussians2D, tile_rect

INVALID = 2**31 - 1

# calls of the CUDA path, never of the plain version
LAUNCHES = {"bin_tiles": 0}


def reset_launches() -> None:
    LAUNCHES["bin_tiles"] = 0


class TileBinning(NamedTuple):
    sorted_gauss: torch.Tensor  # (PK,) int32 gaussian per sorted pair, -1
    tile_offsets: torch.Tensor  # (T + 1,) int32 unaligned segment offsets
    grad_offsets: torch.Tensor  # (T + 1,) int32 aligned grad-buffer offsets
    main_slot: torch.Tensor     # (N, main_width) int32 grad-buffer slots
    tail_slot: torch.Tensor     # (TC, cap - main_width) int32, (0, 0) if none
    tail_of_gauss: torch.Tensor  # (N,) int32 tail row, TC = no tail
    num_pairs: torch.Tensor     # () int32 valid pairs before truncation
    overflow: torch.Tensor      # () int32 dropped pairs
    pair_slot_capacity: int = 0  # grad-buffer slots (grad_capacity)


def grad_capacity(max_pairs: int, n_tiles: int, align: int) -> int:
    """Gradient-buffer slots: every tile's region rounded out to whole
    align-wide windows, plus a spare window [pg - align, pg) whose last
    slot is the one invalid pairs gather from."""
    used = -(-max_pairs // align) * align + 2 * align * n_tiles
    return used + align


def bin_gaussians(g: Gaussians2D, *, tile: int, n_tiles_x: int,
                  n_tiles_y: int, max_span: int = 3, align: int = 128,
                  max_pairs: int | None = None, main_width: int = 6,
                  tail_capacity: int | None = None, cull: bool = True,
                  pair_cap: int | None = None,
                  valid_tiles_y: torch.Tensor | None = None) -> TileBinning:
    """Depth-ordered, tile-grouped pair lists (see module docstring).
    Every output shape is static. On the card (bin_tiles_cuda) the host
    never waits; the plain version waits four times a call: the
    boolean-mask indexings starts[keep], deltas[keep] (the slot shifts)
    and sf[real], slot[real] (the pair-slot inverse) each run a nonzero
    whose size the host reads back."""
    kw = dict(tile=tile, n_tiles_x=n_tiles_x, n_tiles_y=n_tiles_y,
              max_span=max_span, align=align, max_pairs=max_pairs,
              main_width=main_width, tail_capacity=tail_capacity,
              cull=cull, pair_cap=pair_cap, valid_tiles_y=valid_tiles_y)
    if g.means2d.is_cuda:
        return bin_tiles_cuda(g, **kw)
    return bin_gaussians_plain(g, **kw)


def bin_gaussians_plain(g: Gaussians2D, *, tile: int, n_tiles_x: int,
                        n_tiles_y: int, max_span: int = 3, align: int = 128,
                        max_pairs: int | None = None, main_width: int = 6,
                        tail_capacity: int | None = None, cull: bool = True,
                        pair_cap: int | None = None,
                        valid_tiles_y: torch.Tensor | None = None
                        ) -> TileBinning:
    """bin_gaussians in torch ops, on any device (the CUDA path's
    reference on the card)."""
    dev = g.means2d.device
    i64 = torch.int64
    n = g.means2d.shape[0]
    n_tiles = n_tiles_x * n_tiles_y
    cap = max_span * max_span

    depth_key = torch.where(g.mask, g.depths,
                            torch.full_like(g.depths, float("inf")))
    order = torch.argsort(depth_key, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)

    x0, y0, x1, y1 = (v.to(i64) for v in tile_rect(g, tile, n_tiles_x,
                                                   n_tiles_y))
    w = x1 - x0
    h = y1 - y0
    cx = torch.div(g.means2d[:, 0], tile, rounding_mode="floor").to(
        torch.int32).to(i64).clamp(0, n_tiles_x - 1)
    cy = torch.div(g.means2d[:, 1], tile, rounding_mode="floor").to(
        torch.int32).to(i64).clamp(0, n_tiles_y - 1)
    x0c = torch.where(w > max_span,
                      torch.minimum(torch.maximum(cx - max_span // 2, x0),
                                    x1 - max_span), x0)
    y0c = torch.where(h > max_span,
                      torch.minimum(torch.maximum(cy - max_span // 2, y0),
                                    y1 - max_span), y0)
    wc = torch.clamp_max(w, max_span)
    hc = torch.clamp_max(h, max_span)
    mask_i = g.mask.to(i64)
    overflow = torch.sum((w * h - wc * hc) * mask_i)

    j = torch.arange(cap, dtype=i64, device=dev)
    wc_safe = torch.clamp_min(wc, 1)[:, None]
    dx = j[None, :] % wc_safe
    dy = j[None, :] // wc_safe
    span = torch.where(g.mask & (w > 0) & (h > 0), wc * hc,
                       torch.zeros_like(wc))
    valid = j[None, :] < span[:, None]
    tile_id = (y0c[:, None] + dy) * n_tiles_x + (x0c[:, None] + dx)

    if cull:
        # keep a pair only if the peak alpha over the tile's pixel box can
        # reach 1/255: minimise the conic quadratic over the box edges
        a_ = g.conics[:, 0:1]
        b_ = g.conics[:, 1:2]
        c_ = g.conics[:, 2:3]
        a_s = torch.clamp_min(a_, 1e-12)
        c_s = torch.clamp_min(c_, 1e-12)
        bx0 = (x0c[:, None] + dx).to(torch.float32) * tile - g.means2d[:, 0:1]
        by0 = (y0c[:, None] + dy).to(torch.float32) * tile - g.means2d[:, 1:2]
        bx1 = bx0 + (tile - 1)
        by1 = by0 + (tile - 1)

        def _clip(v, lo, hi):
            return torch.minimum(torch.maximum(v, lo), hi)

        def _qx(x):
            yy = _clip(-b_ * x / c_s, by0, by1)
            return (0.5 * a_ * x + b_ * yy) * x + 0.5 * c_ * yy * yy

        def _qy(y):
            xx = _clip(-b_ * y / a_s, bx0, bx1)
            return (0.5 * c_ * y + b_ * xx) * y + 0.5 * a_ * xx * xx

        inside = (bx0 <= 0) & (bx1 >= 0) & (by0 <= 0) & (by1 >= 0)
        q_min = torch.minimum(torch.minimum(_qx(bx0), _qx(bx1)),
                              torch.minimum(_qy(by0), _qy(by1)))
        q_min = torch.where(inside, torch.zeros_like(q_min), q_min)
        reach = q_min <= torch.log(
            torch.clamp_min(g.opacities[:, None], 1e-12) * 255.0)
        valid = valid & reach

    if valid_tiles_y is not None:
        valid = valid & ((y0c[:, None] + dy) < valid_tiles_y)

    if pair_cap is not None and pair_cap < cap:
        skey = torch.where(valid, j[None, :], cap + j[None, :])
        sidx = torch.argsort(skey, dim=1, stable=True)[:, :pair_cap]
        nvalid = valid.sum(dim=1)
        overflow = overflow + torch.clamp_min(nvalid - pair_cap, 0).sum()
        dx = torch.gather(dx, 1, sidx)
        dy = torch.gather(dy, 1, sidx)
        tile_id = (y0c[:, None] + dy) * n_tiles_x + (x0c[:, None] + dx)
        cap = pair_cap
        j = torch.arange(cap, dtype=i64, device=dev)
        span = torch.clamp_max(nvalid, cap)
        valid = j[None, :] < span[:, None]
    elif cull or valid_tiles_y is not None:
        span = torch.where(valid, j[None, :] + 1,
                           torch.zeros_like(dx)).amax(dim=1)

    assert n_tiles * n < 2**31 - 1, "int32 sort key overflow"
    key = torch.where(valid, tile_id * n + rank[:, None],
                      torch.full_like(tile_id, INVALID)).reshape(-1)
    p = n * cap
    sorted_key, sorted_flat = torch.sort(key, stable=True)

    if max_pairs is None:
        max_pairs = p
    # pk rounded UP to align and padded with invalid keys: the composite
    # reads align-wide windows of the (NFEAT, pk + align) feats
    pk = min(max_pairs, p)
    pk = -(-pk // align) * align
    take = min(pk, p)
    sk = sorted_key[:take]
    sf = sorted_flat[:take]
    if pk > take:
        sk = torch.cat([sk, torch.full((pk - take,), INVALID, dtype=i64,
                                       device=dev)])
        sf = torch.cat([sf, p + torch.arange(pk - take, dtype=i64,
                                             device=dev)])
    is_valid = sk != INVALID
    num_pairs = (sorted_key != INVALID).sum()
    overflow = overflow + torch.clamp_min(num_pairs - pk, 0)
    sorted_gauss = torch.where(is_valid, sf // cap, torch.full_like(sf, -1))
    sorted_tile = torch.where(is_valid, sk // n, torch.full_like(sk, n_tiles))
    offsets = torch.searchsorted(
        sorted_tile, torch.arange(n_tiles + 1, dtype=i64, device=dev),
        side="left")

    # grad regions: each tile's [aligned floor, end) rounded up to align
    counts = offsets[1:] - offsets[:-1]
    seg_base = torch.div(offsets[:-1], align, rounding_mode="floor") * align
    head = offsets[:-1] - seg_base
    padded = torch.div(head + counts + align - 1, align,
                       rounding_mode="floor") * align
    grad_offsets = torch.cat([offsets.new_zeros(1), torch.cumsum(padded, 0)])
    pg = grad_capacity(pk, n_tiles, align)
    spare = pg - 1

    # slot of sorted pair i: i + shift[tile_i], shift[t] = grad_offsets[t]
    # - base_t, piecewise constant over the tile-grouped order: deltas at
    # segment starts (starts == pk, of truncated tiles, dropped), cumsum
    shift = grad_offsets[:-1] - seg_base
    deltas = torch.diff(shift, prepend=shift.new_zeros(1))
    starts = offsets[:-1]
    keep = starts < pk
    seg_delta = torch.zeros(pk, dtype=i64, device=dev).index_add_(
        0, starts[keep], deltas[keep])
    slot = torch.arange(pk, dtype=i64, device=dev) + torch.cumsum(seg_delta, 0)
    slot = torch.where(is_valid & (slot < pg - 1), slot,
                       torch.full_like(slot, spare))

    # invert to original (gaussian, j) order; fake alignment ids >= p and
    # pairs cut by the capacity keep the spare slot
    pair_slot = torch.full((p,), spare, dtype=i64, device=dev)
    real = sf < p
    pair_slot[sf[real]] = slot[real]
    ps = pair_slot.reshape(n, cap)

    mw = min(main_width, cap)
    main_slot = ps[:, :mw]
    if cap > mw:
        tail_slot, tail_of_gauss, tail_over = _tail_tables(
            ps, span, mw, tail_capacity, align, spare)
        overflow = overflow + tail_over
    else:
        tail_of_gauss = torch.zeros(n, dtype=i64, device=dev)
        tail_slot = torch.zeros((0, 0), dtype=i64, device=dev)

    i32 = torch.int32
    return TileBinning(
        sorted_gauss=sorted_gauss.to(i32),
        tile_offsets=offsets.to(i32),
        grad_offsets=grad_offsets.to(i32),
        main_slot=main_slot.to(i32),
        tail_slot=tail_slot.to(i32),
        tail_of_gauss=tail_of_gauss.to(i32),
        num_pairs=num_pairs.to(i32),
        overflow=overflow.to(i32),
        pair_slot_capacity=pg,
    )


def _tail_tables(ps: torch.Tensor, span: torch.Tensor, mw: int,
                 tail_capacity: int | None, align: int, spare: int):
    """The tail table over gaussians spanning more than mw pairs, from
    the (N, cap) pair-slot table and each gaussian's span (both paths):
    (tail_slot, tail_of_gauss, the overflow of gaussians past its
    capacity). Its shapes depend on the arguments alone; no host wait."""
    n = ps.shape[0]
    dev = ps.device
    i64 = torch.int64
    tc = tail_capacity
    if tc is None:
        tc = max(align, -(-n // 16 // align) * align)
    tc = min(tc, n)
    big = span > mw
    nbig = big.sum()
    border = torch.argsort((~big).to(torch.int32), stable=True)
    tail_rows = border[:tc]
    row_ok = torch.arange(tc, device=dev) < nbig
    tail_slot = torch.where(row_ok[:, None], ps[tail_rows, mw:],
                            torch.full_like(ps[tail_rows, mw:], spare))
    brank = torch.cumsum(big.to(i64), 0) - 1
    tail_of_gauss = torch.where(big & (brank < tc), brank,
                                torch.full_like(brank, tc))
    tail_over = torch.where(big & (brank >= tc), span - mw,
                            torch.zeros_like(span)).sum()
    return tail_slot, tail_of_gauss, tail_over


# the CUDA path

# csrc/bin_tiles.cu's BinEmitArgs and BinFinishArgs, every field 8 bytes
_P, _L = ctypes.c_void_p, ctypes.c_longlong


class _EmitArgs(ctypes.Structure):
    _fields_ = [
        ("means", _P), ("means_s0", _L), ("means_s1", _L),
        ("depths", _P), ("depths_s", _L),
        ("conics", _P), ("conics_s0", _L), ("conics_s1", _L),
        ("thr", _P), ("radii", _P), ("radii_s", _L),
        ("mask", _P), ("mask_s", _L), ("vty_dev", _P), ("vty", _L),
        ("n", _L), ("tile", _L), ("ntx", _L), ("nty", _L),
        ("max_span", _L), ("cap", _L), ("compact", _L), ("spare", _L),
        ("keys", _P), ("pair_slot", _P), ("span", _P),
        ("tail_of_gauss", _P), ("overflow", _P)]


class _FinishArgs(ctypes.Structure):
    _fields_ = [
        ("sorted_key", _P), ("sorted_flat", _P), ("p", _L), ("take", _L),
        ("pk", _L), ("cap", _L), ("n_tiles", _L), ("align", _L),
        ("pg", _L), ("overflow", _P), ("tile_offsets", _P),
        ("grad_offsets", _P), ("shift", _P), ("num_pairs", _P),
        ("overflow_out", _P), ("sorted_gauss", _P), ("pair_slot", _P)]


def _lib():
    lib = cuda_build.load("bin_tiles")
    if lib.bin_tiles_emit.argtypes is None:
        lib.bin_tiles_emit.argtypes = [ctypes.POINTER(_EmitArgs), _P]
        lib.bin_tiles_emit.restype = ctypes.c_int
        lib.bin_tiles_finish.argtypes = [ctypes.POINTER(_FinishArgs), _P]
        lib.bin_tiles_finish.restype = ctypes.c_int
    return lib


# (field, dtype, trailing shape) of the Gaussians2D fields the kernel reads
_FIELDS = (("means2d", torch.float32, (2,)), ("depths", torch.float32, ()),
           ("conics", torch.float32, (3,)),
           ("opacities", torch.float32, ()), ("radii", torch.int32, ()),
           ("mask", torch.bool, ()))


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _check_bin(g: Gaussians2D, *, tile, n_tiles_x, n_tiles_y, max_span,
               align, max_pairs, main_width, tail_capacity, pair_cap,
               valid_tiles_y) -> tuple:
    """What the kernels take: the fields of _FIELDS with their dtypes,
    N >= 1 rows each, all on the means' device; positive int tile, grid,
    max_span and align; pair_cap None or a positive int; max_pairs and
    tail_capacity None or ints >= 0; main_width an int >= 0; pairs,
    tiles and gradient slots under 2^31; valid_tiles_y None, an int or a
    one-element int32 tensor on the same device. Raises ValueError.
    Returns the sizes the kernels run at: (slots a gaussian, whether
    pair_cap compacts, the sorted prefix pk, the gradient slots)."""
    dev = g.means2d.device
    n = g.means2d.shape[0] if g.means2d.dim() == 2 else 0
    for name, dtype, tail in _FIELDS:
        v = getattr(g, name)
        if (not isinstance(v, torch.Tensor) or v.dtype != dtype
                or tuple(v.shape) != (n,) + tail or v.device != dev):
            raise ValueError(f"bin_gaussians: {name} must be a {dtype} "
                             f"tensor of shape {(n,) + tail} on {dev}, got "
                             f"{getattr(v, 'dtype', type(v).__name__)} "
                             f"{tuple(getattr(v, 'shape', ()))}")
    if n < 1:
        raise ValueError("bin_gaussians: no gaussians")
    for name, v in (("tile", tile), ("n_tiles_x", n_tiles_x),
                    ("n_tiles_y", n_tiles_y), ("max_span", max_span),
                    ("align", align)):
        if not _is_int(v) or v < 1:
            raise ValueError(f"bin_gaussians: {name} must be a positive "
                             f"int, got {v!r}")
    for name, v, least in (("pair_cap", pair_cap, 1),
                           ("max_pairs", max_pairs, 0),
                           ("tail_capacity", tail_capacity, 0)):
        if v is not None and (not _is_int(v) or v < least):
            raise ValueError(f"bin_gaussians: {name} must be None or an int "
                             f">= {least}, got {v!r}")
    if not _is_int(main_width) or main_width < 0:
        raise ValueError(f"bin_gaussians: main_width must be an int >= 0, "
                         f"got {main_width!r}")
    vty = valid_tiles_y
    if vty is not None and not _is_int(vty) and not (
            isinstance(vty, torch.Tensor) and vty.dtype == torch.int32
            and vty.numel() == 1 and vty.device == dev):
        raise ValueError(f"bin_gaussians: valid_tiles_y must be None, an int "
                         f"or a one-element int32 tensor on {dev}")
    cap = max_span * max_span
    compact = pair_cap is not None and pair_cap < cap
    if compact:
        cap = pair_cap
    pk = n * cap if max_pairs is None else min(max_pairs, n * cap)
    pk = -(-pk // align) * align
    pg = grad_capacity(pk, n_tiles_x * n_tiles_y, align)
    if n_tiles_x * n_tiles_y >= 2**31 - 1 or n * cap >= 2**31 or pg >= 2**31:
        raise ValueError("bin_gaussians: pairs, tiles or gradient slots "
                         "past int32")
    return cap, compact, pk, pg


def bin_tiles_cuda(g: Gaussians2D, *, tile: int, n_tiles_x: int,
                   n_tiles_y: int, max_span: int = 3, align: int = 128,
                   max_pairs: int | None = None, main_width: int = 6,
                   tail_capacity: int | None = None, cull: bool = True,
                   pair_cap: int | None = None,
                   valid_tiles_y=None) -> TileBinning:
    """bin_gaussians on the card: the arguments checked (_check_bin),
    then csrc/bin_tiles.cu on the current stream (the emit kernel, the
    keys' stable torch.sort, the tile scan and slot kernels), and the
    tail table by _tail_tables where the slots outnumber main_width. The
    cull's threshold log(max(opacity, 1e-12) * 255) is torch's, so that
    the kernel decides each pair on the plain version's bits. No host
    wait. Returns the plain version's fields, integer for integer."""
    if not g.means2d.is_cuda:
        raise ValueError("bin_tiles_cuda needs CUDA tensors")
    cap, compact, pk, pg = _check_bin(
        g, tile=tile, n_tiles_x=n_tiles_x, n_tiles_y=n_tiles_y,
        max_span=max_span, align=align, max_pairs=max_pairs,
        main_width=main_width, tail_capacity=tail_capacity,
        pair_cap=pair_cap, valid_tiles_y=valid_tiles_y)
    lib = _lib()
    dev = g.means2d.device
    i32 = torch.int32
    n = g.means2d.shape[0]
    n_tiles = n_tiles_x * n_tiles_y
    p = n * cap
    mw = min(main_width, cap)
    tail = cap > mw
    stream = torch.cuda.current_stream(dev).cuda_stream

    thr = (torch.clamp_min(g.opacities, 1e-12).mul_(255.0).log_() if cull
           else None)
    keys = torch.empty(p, dtype=torch.int64, device=dev)
    ps = torch.empty((n, cap), dtype=i32, device=dev)
    span = torch.empty(n, dtype=i32, device=dev) if tail else None
    tail_of_gauss = None if tail else torch.empty(n, dtype=i32, device=dev)
    over_part = torch.empty(1, dtype=torch.int64, device=dev)
    vty = valid_tiles_y
    vty_dev = vty if isinstance(vty, torch.Tensor) else None
    means, conics = g.means2d, g.conics

    def ptr(t):
        return None if t is None else t.data_ptr()

    emit = _EmitArgs(
        ptr(means), means.stride(0), means.stride(1), ptr(g.depths),
        g.depths.stride(0), ptr(conics), conics.stride(0), conics.stride(1),
        ptr(thr), ptr(g.radii), g.radii.stride(0), ptr(g.mask),
        g.mask.stride(0), ptr(vty_dev),
        2**62 if vty is None or vty_dev is not None else vty, n, tile,
        n_tiles_x, n_tiles_y, max_span, cap, int(compact), pg - 1,
        ptr(keys), ptr(ps), ptr(span), ptr(tail_of_gauss), ptr(over_part))
    err = lib.bin_tiles_emit(ctypes.byref(emit), stream)
    if err != 0:
        raise RuntimeError(f"bin_tiles emit launch failed: cudaError {err}")
    sorted_key, sorted_flat = torch.sort(keys, stable=True)

    tile_offsets = torch.empty(n_tiles + 1, dtype=i32, device=dev)
    grad_offsets = torch.empty(n_tiles + 1, dtype=i32, device=dev)
    shift = torch.empty(n_tiles, dtype=i32, device=dev)
    num_pairs = torch.empty((), dtype=i32, device=dev)
    overflow = torch.empty((), dtype=i32, device=dev)
    sorted_gauss = torch.empty(pk, dtype=i32, device=dev)
    fin = _FinishArgs(
        ptr(sorted_key), ptr(sorted_flat), p, min(pk, p), pk, cap, n_tiles,
        align, pg, ptr(over_part), ptr(tile_offsets), ptr(grad_offsets),
        ptr(shift), ptr(num_pairs), ptr(overflow), ptr(sorted_gauss),
        ptr(ps))
    err = lib.bin_tiles_finish(ctypes.byref(fin), stream)
    if err != 0:
        raise RuntimeError(f"bin_tiles launch failed: cudaError {err}")
    LAUNCHES["bin_tiles"] += 1

    if tail:
        tail_slot, tail_of_gauss, tail_over = _tail_tables(
            ps, span, mw, tail_capacity, align, pg - 1)
        main_slot = ps[:, :mw].contiguous()
        tail_of_gauss = tail_of_gauss.to(i32)
        overflow = (overflow + tail_over).to(i32)
    else:
        tail_slot = torch.zeros((0, 0), dtype=i32, device=dev)
        main_slot = ps
    return TileBinning(
        sorted_gauss=sorted_gauss, tile_offsets=tile_offsets,
        grad_offsets=grad_offsets, main_slot=main_slot, tail_slot=tail_slot,
        tail_of_gauss=tail_of_gauss, num_pairs=num_pairs, overflow=overflow,
        pair_slot_capacity=pg)
