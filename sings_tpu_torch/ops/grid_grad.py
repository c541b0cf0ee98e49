"""The backward of bilinear sampling and of the triplane: the grid
gradients (per-cell sums of weight x cotangent, then the corner
unstack) and the coordinate gradients, as one CUDA kernel and its plain
version.

Counterpart of the JAX package's custom backwards
sings_tpu/ops/sampling.py::_sample_bwd (:129),
sings_tpu/fields/triplane.py::_triplane_fused_bwd (:179) and
_triplane_nested_bwd (:378): the product rule over each scale's
Hadamard product, the coordinate gradient through each plane's weight
path (jax.vjp there), and the grid gradients from lax.sort_key_val to
the returned (C, H, W) gradients. JAX sums the rows w_k(tx, ty) * g (one
(4C,) row per query and plane) by cell with a blocked cumsum, a
searchsorted and a boundary difference, then adds the four corner
blocks back onto the grid with dense slices. Here the cell sums are
direct sums in float64, rounded once to float32 (no difference of
running totals), and the unstack adds the same four corners in JAX's
order.

triplane_backward(meta, q, grids, saved, gout, product) is the one
entry: the sort of each group's keys (glue, torch.sort, stable, as
lax.sort_key_val sits outside any kernel in JAX), then for CUDA tensors
csrc/triplane_bwd.cu (built with nvcc for sm_90a, called through
ctypes; raises on any failure) and for CPU tensors the plain version,
plane_cotangents + coord_grads + grid_grad_plain. Nothing else.

Layout: the planes, scale-major like the JAX package's flat plane tuple,
and the groups of planes that share one sort:
  * "cells": the group's planes (consecutive global indices) stacked
    plane-major, key = the plane's cell base within the group + its
    row-major cell id (one combined sort, as _triplane_fused_bwd;
    one plane for _sample_bwd);
  * "morton": one plane orientation of the nested triplane, key = the
    fine Morton code interleave(x0f) | interleave(y0f) << 1; a plane at
    level shift s reads the same sorted rows with key >> 2s, its cell
    (Morton ranges nest: sings_tpu/fields/triplane.py::_morton_static).
meta: (axis_a, axis_b, H, W) per plane; q (N, >= 2) the coordinates the
planes read columns a, b of; gout (N, S*C) with the product rule (plane
3s + k's cotangent is gout[:, sC:(s+1)C] times the scale's other two
samples), (N, C) for one plane without it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import cuda_build
from .bilinear import _coord_grad, _corner_coords, _corner_table

# launches through the wrapper, never through the plain version
LAUNCHES = {"triplane_bwd": 0}

# the kernel's constants (csrc/triplane_bwd.cu): sorted rows per block,
# the problem and plane tables' capacities, its largest C and its
# launches per call
BLOCK_ROWS = 128
MAX_PROBLEMS = 16
MAX_PLANES = 16
MAX_CHANNELS = 32
KERNEL_LAUNCHES = 5


def reset_launches() -> None:
    LAUNCHES["triplane_bwd"] = 0


class Group(NamedTuple):
    kind: str                 # "cells" or "morton"
    planes: tuple             # global plane indices
    shifts: tuple = ()        # morton: each plane's level shift


class Layout(NamedTuple):
    planes: tuple             # (H, W) grid points per global plane
    groups: tuple             # Group, each plane in exactly one


class Saved(NamedTuple):
    """What a sampling or triplane forward keeps for triplane_backward:
    the per-plane samples (N, C) for the product rule ([] without one),
    each sort group's keys and the layout. No corner rows or weights:
    the kernel gathers the corners from the planes, the plain version
    repeats the forward's own gather."""
    samples: list
    keys: list
    layout: Layout


def cell_bases(layout: Layout) -> list:
    """Global cell index of each plane's cell 0, and the total."""
    bases = [0]
    for h, w in layout.planes:
        bases.append(bases[-1] + (h - 1) * (w - 1))
    return bases


def _interleave16(v: torch.Tensor) -> torch.Tensor:
    """int values < 2^16 -> bits spread to even positions."""
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def _compact16(v: torch.Tensor) -> torch.Tensor:
    """The inverse of _interleave16 on the even bits."""
    v = v & 0x55555555
    v = (v | (v >> 1)) & 0x33333333
    v = (v | (v >> 2)) & 0x0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF
    v = (v | (v >> 8)) & 0x0000FFFF
    return v


def morton_codes(x0: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """(N,) int32 fine Morton codes of base corners (x0, y0)."""
    return (_interleave16(x0) | (_interleave16(y0) << 1)).to(torch.int32)


def sort_keys(keys: list) -> tuple:
    """Each group's keys sorted (stable): (sorted keys, order)."""
    pairs = [torch.sort(k, stable=True) for k in keys]
    return [p.values for p in pairs], [p.indices for p in pairs]


def problems(layout: Layout) -> list:
    """The segment reductions of a layout, one per plane of a morton
    group and one per cells group: (group, plane0, shift2, morton, cx,
    cell_base). A sorted row j of the group's order belongs to plane
    plane0 + j // N, query j % N."""
    bases = cell_bases(layout)
    out = []
    for gi, g in enumerate(layout.groups):
        if g.kind == "cells":
            if list(g.planes) != list(range(g.planes[0],
                                            g.planes[0] + len(g.planes))):
                raise ValueError(f"cells group planes {g.planes} are not "
                                 "consecutive")
            out.append((gi, g.planes[0], 0, 0, 0, bases[g.planes[0]]))
        elif g.kind == "morton":
            if len(g.shifts) != len(g.planes):
                raise ValueError("morton group needs one shift per plane")
            for p, s in zip(g.planes, g.shifts):
                out.append((gi, p, 2 * s, 1, layout.planes[p][1] - 1,
                            bases[p]))
        else:
            raise ValueError(f"unknown group kind {g.kind!r}")
    return out


def _check(skeys, orders, tx, ty, gout, layout: Layout) -> None:
    if gout.dim() != 3 or tx.shape != gout.shape[:2] or \
            ty.shape != gout.shape[:2]:
        raise ValueError(f"tx {tuple(tx.shape)}, ty {tuple(ty.shape)} must "
                         f"be gout's (P, N) of {tuple(gout.shape)}")
    p, n, _ = gout.shape
    if p != len(layout.planes):
        raise ValueError(f"{p} planes of cotangents, layout has "
                         f"{len(layout.planes)}")
    if len(skeys) != len(layout.groups) or len(orders) != len(skeys):
        raise ValueError("one sorted key and order tensor per group")
    for g, k, o in zip(layout.groups, skeys, orders):
        rows = len(g.planes) * n if g.kind == "cells" else n
        if k.shape != (rows,) or o.shape != (rows,):
            raise ValueError(f"group {g}: keys {tuple(k.shape)}, order "
                             f"{tuple(o.shape)}, expected ({rows},)")
    if any(h < 2 or w < 2 for h, w in layout.planes):
        raise ValueError("planes need h, w >= 2")
    if sorted(q for g in layout.groups for q in g.planes) != list(
            range(p)):
        raise ValueError("each plane must be in exactly one group")


def _decode(seg: torch.Tensor, morton: int, cx: int) -> torch.Tensor:
    if not morton:
        return seg
    return _compact16(seg >> 1) * cx + _compact16(seg)


def cell_rows(skeys, orders, tx, ty, gout, layout: Layout) -> list:
    """Each problem's rows w_k * g (float32, as JAX forms them) in
    sorted order, with their global cells: [(cells (M,), rows (M, 4C))].
    What the kernel forms on the fly and never writes."""
    _check(skeys, orders, tx, ty, gout, layout)
    _, n, c = gout.shape
    txf, tyf, gf = tx.reshape(-1), ty.reshape(-1), gout.reshape(-1, c)
    out = []
    for gi, plane0, shift2, morton, cx, base in problems(layout):
        j = orders[gi].long()
        src = (plane0 + j // n) * n + j % n
        seg = skeys[gi].long() >> shift2
        t_x, t_y = txf[src], tyf[src]
        w = torch.stack([(1 - t_x) * (1 - t_y), t_x * (1 - t_y),
                         (1 - t_x) * t_y, t_x * t_y], dim=1)
        out.append((base + _decode(seg, morton, cx),
                    (w[:, :, None] * gf[src][:, None, :]).reshape(-1, 4 * c)))
    return out


def grid_grad_plain(skeys, orders, tx, ty, gout, layout: Layout) -> list:
    """Plain PyTorch version of the grid gradients: cell_rows
    index_add_-ed in float64, rounded once to float32, then the four
    corner slice-adds in JAX's order. Returns each plane's (C, H, W)
    gradient."""
    c = gout.shape[2]
    bases = cell_bases(layout)
    acc = torch.zeros((bases[-1], 4 * c), dtype=torch.float64,
                      device=gout.device)
    for cells, rows in cell_rows(skeys, orders, tx, ty, gout, layout):
        acc.index_add_(0, cells, rows.double())
    cellsum = acc.float()
    outs = []
    for q, (h, w) in enumerate(layout.planes):
        g4 = cellsum[bases[q]:bases[q + 1]].reshape(h - 1, w - 1, 4, c)
        gg = torch.zeros((h, w, c), dtype=gout.dtype, device=gout.device)
        gg[:-1, :-1] += g4[:, :, 0]
        gg[:-1, 1:] += g4[:, :, 1]
        gg[1:, :-1] += g4[:, :, 2]
        gg[1:, 1:] += g4[:, :, 3]
        outs.append(gg.permute(2, 0, 1).contiguous())
    return outs


def plane_cotangents(gout: torch.Tensor, samples: list) -> torch.Tensor:
    """(P, N, C) cotangents of the per-plane samples: the product rule
    over each scale's Hadamard product, in JAX's order."""
    n_planes = len(samples)
    n, c = samples[0].shape
    gouts = torch.empty((n_planes, n, c), dtype=gout.dtype,
                        device=gout.device)
    for s in range(n_planes // 3):
        g_s = gout[:, s * c:(s + 1) * c]
        v0, v1, v2 = samples[3 * s], samples[3 * s + 1], samples[3 * s + 2]
        torch.mul(g_s * v1, v2, out=gouts[3 * s])
        torch.mul(g_s * v0, v2, out=gouts[3 * s + 1])
        torch.mul(g_s * v0, v1, out=gouts[3 * s + 2])
    return gouts


def plane_inputs(meta: tuple, q: torch.Tensor, grids, keys: list,
                 layout: Layout) -> tuple:
    """Each plane's tx, ty (P, N) and corner rows (N, 4, C) as the
    forward formed them: the cell decoded from its group's key, tx and
    ty from the plane's own _corner_coords."""
    n = q.shape[0]
    bases = cell_bases(layout)
    cells = [None] * len(meta)
    for gi, plane0, shift2, morton, cx, _ in problems(layout):
        k = keys[gi].long()
        if morton:
            cells[plane0] = _decode(k >> shift2, 1, cx)
            continue
        for j, p in enumerate(layout.groups[gi].planes):
            cells[p] = k[j * n:(j + 1) * n] - (bases[p] - bases[plane0])
    txs, tys, corners = [], [], []
    for (a, b, h, w), grid, cell in zip(meta, grids, cells):
        _, _, tx, ty = _corner_coords(q[:, (a, b)], h, w)
        txs.append(tx)
        tys.append(ty)
        corners.append(_corner_table(grid)[cell].reshape(n, 4, -1))
    return torch.stack(txs), torch.stack(tys), corners


def coord_grads(meta: tuple, q: torch.Tensor, txs, tys, corners,
                gouts: torch.Tensor) -> torch.Tensor:
    """d q, each plane's weight path added in plane order."""
    dq = torch.zeros_like(q)
    for i, (a, b, h, w) in enumerate(meta):
        d = _coord_grad(q[:, (a, b)], h, w, txs[i], tys[i], corners[i],
                        gouts[i])
        dq[:, a] += d[:, 0]
        dq[:, b] += d[:, 1]
    return dq


def triplane_bwd_plain(meta, q, grids, saved: Saved, skeys, orders, gout,
                       product: bool) -> tuple:
    """Plain PyTorch version: the product rule (plane_cotangents), the
    coordinate gradient (coord_grads) and the grid gradients
    (grid_grad_plain). Returns (dq, [(C, H, W) per plane])."""
    txs, tys, corners = plane_inputs(meta, q, grids, saved.keys,
                                     saved.layout)
    gouts = plane_cotangents(gout, saved.samples) if product \
        else gout[None]
    dq = coord_grads(meta, q, txs, tys, corners, gouts)
    return dq, grid_grad_plain(skeys, orders, txs, tys, gouts, saved.layout)


# ---------------------------------------------------------------------------
# the kernel

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_void_p]
# the pointer table's slots: 8 fixed, then (sorted key, order) per
# group, then (grid, gradient, sample) per plane
_FIXED = ("q", "gout", "dq", "cellsum", "flag", "part", "part_cell",
          "dterm")
_GROUP0 = len(_FIXED)
_PLANE0 = _GROUP0 + 2 * MAX_PROBLEMS
_N_PTRS = _PLANE0 + 3 * MAX_PLANES


def _lib():
    fn = cuda_build.load("triplane_bwd").triplane_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _aligned(nbytes: int) -> int:
    return -(-nbytes // 256) * 256


class _Static(NamedTuple):
    prob_tab: np.ndarray      # (problems, 9) int64
    plane_tab: np.ndarray     # (planes, 10) int64
    n_blocks: int
    cells: int
    scratch: dict             # name -> (byte offset, bytes)
    scratch_bytes: int
    out_offsets: tuple        # each plane's gradient's offset (floats)
    out_floats: int


@functools.lru_cache(maxsize=32)
def _static(meta: tuple, layout: Layout, n: int, c: int,
            product: bool) -> _Static:
    """The kernel's problem and plane tables and its scratch layout: built
    once per layout and size, never per call."""
    probs = problems(layout)
    bases = cell_bases(layout)
    n_planes = len(meta)
    prob_tab = np.zeros((len(probs), 9), np.int64)
    n_blocks = 0
    for i, (gi, plane0, shift2, morton, cx, base) in enumerate(probs):
        rows = len(layout.groups[gi].planes) * n if not morton else n
        prob_tab[i] = (gi, rows, shift2, plane0, morton, cx, base,
                       n_blocks, 0)
        n_blocks += -(-rows // BLOCK_ROWS)
    plane_tab = np.zeros((n_planes, 10), np.int64)
    out_offsets, total = [], 0
    for p, (a, b, h, w) in enumerate(meta):
        s = p // 3
        others = [3 * s + k for k in range(3) if 3 * s + k != p] \
            if product else [-1, -1]
        plane_tab[p] = (h, w, a, b, bases[p], s * c if product else 0,
                        others[0], others[1], 0, 0)
        out_offsets.append(total)
        total += c * h * w
    sizes = {"cellsum": bases[-1] * 4 * c * 4,
             "part": 2 * n_blocks * 4 * c * 8,
             "part_cell": 2 * n_blocks * 8,
             "dterm": n_planes * n * 2 * 4,
             "flag": bases[-1]}
    scratch, off = {}, 0
    for name, nbytes in sizes.items():
        scratch[name] = (off, nbytes)
        off += _aligned(max(nbytes, 1))
    for t in (prob_tab, plane_tab):
        t.flags.writeable = False
    return _Static(prob_tab, plane_tab, n_blocks, bases[-1], scratch, off,
                   tuple(out_offsets), total)


def _check_cuda(meta, q, grids, saved: Saved, skeys, orders, gout,
                product: bool) -> None:
    dev = gout.device
    layout = saved.layout
    n = q.shape[0]
    n_planes = len(meta)
    if not gout.is_cuda:
        raise ValueError("triplane_bwd_cuda needs CUDA tensors")
    if len(grids) != n_planes or tuple(
            (h, w) for (_a, _b, h, w) in meta) != tuple(layout.planes):
        raise ValueError("meta, grids and layout disagree on the planes")
    c = grids[0].shape[0]
    if c > MAX_CHANNELS:
        raise ValueError(f"C {c} > {MAX_CHANNELS}: the kernel keeps one "
                         "channel per lane")
    if n_planes > MAX_PLANES or len(problems(layout)) > MAX_PROBLEMS:
        raise ValueError(f"{n_planes} planes or the layout's problems "
                         f"exceed {MAX_PLANES} / {MAX_PROBLEMS}")
    if n_planes * n >= 2 ** 31 or n * gout.shape[1] >= 2 ** 31:
        raise ValueError(f"{n_planes} x {n} rows or gout's {n} x "
                         f"{gout.shape[1]} exceed int32 offsets")
    want_g = (n, (n_planes // 3) * c if product else c)
    if product and (n_planes % 3 or len(saved.samples) != n_planes):
        raise ValueError("the product rule needs 3 planes a scale and one "
                         "sample each")
    if not product and n_planes != 1:
        raise ValueError("without the product rule the backward takes one "
                         "plane")
    tensors = [("q", q, (n, q.shape[1])), ("gout", gout, want_g)]
    tensors += [(f"grid {p}", g, (c, h, w))
                for p, (g, (_a, _b, h, w)) in enumerate(zip(grids, meta))]
    tensors += [(f"sample {p}", s, (n, c))
                for p, s in enumerate(saved.samples if product else [])]
    for name, t, shape in tensors:
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if q.dim() != 2 or q.shape[1] > 3 or any(
            max(a, b) >= q.shape[1] for (a, b, _h, _w) in meta):
        raise ValueError("q must be (N, 2) or (N, 3) with every plane's "
                         "columns")
    if not len(skeys) == len(orders) == len(saved.keys) == len(
            layout.groups):
        raise ValueError("one key, sorted key and order tensor per group")
    for g, key, k, o in zip(layout.groups, saved.keys, skeys, orders):
        rows = len(g.planes) * n if g.kind == "cells" else n
        for t, dt in ((key, torch.int32), (k, torch.int32),
                      (o, torch.int64)):
            if (t.device != dev or t.dtype != dt or not t.is_contiguous()
                    or t.shape != (rows,)):
                raise ValueError(f"group {g}: keys and sorted keys must be "
                                 f"contiguous int32, orders int64, "
                                 f"({rows},) on {dev}")


def triplane_bwd_cuda(meta, q, grids, saved: Saved, skeys, orders, gout,
                      product: bool) -> tuple:
    """Launch csrc/triplane_bwd.cu on the current stream (its header
    names the passes). Returns (dq, [(C, H, W) per plane])."""
    _check_cuda(meta, q, grids, saved, skeys, orders, gout, product)
    dev = gout.device
    n, c = q.shape[0], grids[0].shape[0]
    st = _static(tuple(meta), saved.layout, n, c, product)
    out = torch.empty((st.out_floats,), dtype=torch.float32, device=dev)
    dq = torch.empty_like(q)
    scratch = torch.empty((st.scratch_bytes,), dtype=torch.uint8,
                          device=dev)
    ptrs = np.zeros((_N_PTRS,), np.int64)
    base = scratch.data_ptr()
    for name, (off, _nbytes) in st.scratch.items():
        ptrs[_FIXED.index(name)] = base + off
    ptrs[0], ptrs[1], ptrs[2] = q.data_ptr(), gout.data_ptr(), dq.data_ptr()
    for gi, (k, o) in enumerate(zip(skeys, orders)):
        ptrs[_GROUP0 + 2 * gi] = k.data_ptr()
        ptrs[_GROUP0 + 2 * gi + 1] = o.data_ptr()
    grads = []
    out_base = out.data_ptr()
    for p, ((_a, _b, h, w), grid) in enumerate(zip(meta, grids)):
        ptrs[_PLANE0 + 3 * p] = grid.data_ptr()
        ptrs[_PLANE0 + 3 * p + 1] = out_base + 4 * st.out_offsets[p]
        if product:
            ptrs[_PLANE0 + 3 * p + 2] = saved.samples[p].data_ptr()
        grads.append(out[st.out_offsets[p]:st.out_offsets[p] + c * h * w]
                     .view(c, h, w))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(st.prob_tab.ctypes.data, len(st.prob_tab),
                 st.plane_tab.ctypes.data, len(st.plane_tab),
                 ptrs.ctypes.data, n, c, q.shape[1], gout.shape[1],
                 BLOCK_ROWS, st.n_blocks, st.cells, stream)
    if err != 0:
        raise RuntimeError(f"triplane_bwd launch failed: cudaError {err}")
    LAUNCHES["triplane_bwd"] += 1
    return dq, grads


def triplane_backward(meta, q, grids, saved: Saved, gout,
                      product: bool = True) -> tuple:
    """The backward of a sampling or triplane forward: each group's keys
    sorted (glue), then the kernel for CUDA tensors, the plain version
    for CPU tensors. Returns (dq, [(C, H, W) per plane])."""
    skeys, orders = sort_keys(saved.keys)
    args = (meta, q.contiguous(), [g.contiguous() for g in grids], saved,
            skeys, orders, gout.contiguous(), product)
    if gout.is_cuda:
        return triplane_bwd_cuda(*args)
    if gout.device.type == "cpu":
        return triplane_bwd_plain(*args)
    raise ValueError(f"triplane_backward: unsupported device {gout.device}")
