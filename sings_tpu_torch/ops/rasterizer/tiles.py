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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .common import Gaussians2D, tile_rect

INVALID = 2**31 - 1


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
    Every output shape is static, but the host waits for the card four
    times a call: the boolean-mask indexings starts[keep], deltas[keep]
    (the slot shifts) and sf[real], slot[real] (the pair-slot inverse)
    each run a nonzero whose size the host reads back. The benchmark's
    host_syncs_per_frame.anim counts them."""
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
    tw = cap - mw
    if tw > 0:
        # tail table over gaussians spanning more than main_width pairs;
        # its overflow is counted
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
        overflow = overflow + torch.where(big & (brank >= tc), span - mw,
                                          torch.zeros_like(span)).sum()
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
