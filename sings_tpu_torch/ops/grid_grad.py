"""Grid gradients of bilinear sampling: per-cell sums of weight x
cotangent, then the corner unstack. The CUDA kernel and its plain
version.

Counterpart of the grid-gradient half of the JAX package's custom
backwards: sings_tpu/ops/sampling.py::_sample_bwd (:129),
sings_tpu/fields/triplane.py::_triplane_fused_bwd (:179) and
_triplane_nested_bwd (:378), from their lax.sort_key_val to the returned
(C, H, W) gradients. JAX sums the rows w_k(tx, ty) * g (one (4C,) row
per query and plane) by cell with a blocked cumsum, a searchsorted and
a boundary difference, then adds the four corner blocks back onto the
grid with dense slices. Here the cell sums are direct sums in float64,
rounded once to float32 (no difference of running totals), and the
unstack adds the same four corners in JAX's order.

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
Inputs per plane p: tx, ty (P, N) and the cotangents gout (P, N, C).

The kernel is csrc/grid_grad.cu (built with nvcc for sm_90a, called
through ctypes). The sort is glue (torch.sort, stable), as
lax.sort_key_val sits outside any kernel in JAX. CUDA tensors launch the
kernel (or raise), CPU tensors run the plain version. Nothing else.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import cuda_build

# launches through the wrapper, never through the plain version
LAUNCHES = {"grid_grad": 0}

# the kernel's constants (csrc/grid_grad.cu): sorted rows per block,
# the problem and plane tables' capacities
BLOCK_ROWS = 256
MAX_PROBLEMS = 16
MAX_PLANES = 16


def reset_launches() -> None:
    LAUNCHES["grid_grad"] = 0


class Group(NamedTuple):
    kind: str                 # "cells" or "morton"
    planes: tuple             # global plane indices
    shifts: tuple = ()        # morton: each plane's level shift


class Layout(NamedTuple):
    planes: tuple             # (H, W) grid points per global plane
    groups: tuple             # Group, each plane in exactly one


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
    """Plain PyTorch version: cell_rows index_add_-ed in float64,
    rounded once to float32, then the four corner slice-adds in JAX's
    order. Returns each plane's (C, H, W) gradient."""
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


def _lib():
    fn = cuda_build.load("grid_grad").grid_grad_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def grid_grad_cuda(skeys, orders, tx, ty, gout, layout: Layout) -> list:
    """Launch csrc/grid_grad.cu on the current stream: the segment pass,
    the partials pass and the unstack. Returns each plane's (C, H, W)
    gradient."""
    _check(skeys, orders, tx, ty, gout, layout)
    dev = gout.device
    if not gout.is_cuda:
        raise ValueError("grid_grad_cuda needs CUDA tensors")
    for name, t, dt in (("tx", tx, torch.float32), ("ty", ty, torch.float32),
                        ("gout", gout, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} on {dev}")
    for k, o in zip(skeys, orders):
        if (k.device != dev or k.dtype != torch.int32 or o.device != dev
                or o.dtype != torch.int64 or not k.is_contiguous()
                or not o.is_contiguous()):
            raise ValueError("sorted keys must be contiguous int32 and "
                             "orders contiguous int64 on the cotangents' "
                             "device")
    p_, n, c = gout.shape
    probs = problems(layout)
    if len(probs) > MAX_PROBLEMS or p_ > MAX_PLANES:
        raise ValueError(f"{len(probs)} problems / {p_} planes exceed "
                         f"{MAX_PROBLEMS} / {MAX_PLANES}")
    if p_ * n >= 2 ** 31:
        raise ValueError(f"{p_} x {n} rows exceed int32 row indices")
    bases = cell_bases(layout)
    outs = [torch.empty((c, h, w), dtype=torch.float32, device=dev)
            for h, w in layout.planes]
    prob_tab = np.zeros((len(probs), 9), np.int64)
    n_blocks = 0
    for i, (gi, plane0, shift2, morton, cx, base) in enumerate(probs):
        rows = skeys[gi].numel()
        prob_tab[i] = (skeys[gi].data_ptr(), orders[gi].data_ptr(), rows,
                       shift2, plane0, morton, cx, base, n_blocks)
        n_blocks += -(-rows // BLOCK_ROWS)
    plane_tab = np.zeros((p_, 4), np.int64)
    for q, ((h, w), out) in enumerate(zip(layout.planes, outs)):
        plane_tab[q] = (h, w, bases[q], out.data_ptr())
    cellsum = torch.empty((bases[-1], 4 * c), dtype=torch.float32,
                          device=dev)
    flag = torch.empty((bases[-1],), dtype=torch.uint8, device=dev)
    part = torch.empty((2 * n_blocks, 4 * c), dtype=torch.float64,
                       device=dev)
    part_cell = torch.empty((2 * n_blocks,), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(prob_tab.ctypes.data, len(probs), plane_tab.ctypes.data,
                 p_, tx.data_ptr(), ty.data_ptr(), gout.data_ptr(), n, c,
                 cellsum.data_ptr(), flag.data_ptr(), part.data_ptr(),
                 part_cell.data_ptr(), n_blocks, stream)
    if err != 0:
        raise RuntimeError(f"grid_grad launch failed: cudaError {err}")
    LAUNCHES["grid_grad"] += 1
    return outs


def grid_grad(skeys, orders, tx, ty, gout, layout: Layout) -> list:
    """Kernel for CUDA tensors, plain version for CPU tensors."""
    if gout.is_cuda:
        return grid_grad_cuda(skeys, orders, tx, ty, gout, layout)
    if gout.device.type == "cpu":
        return grid_grad_plain(skeys, orders, tx, ty, gout, layout)
    raise ValueError(f"grid_grad: unsupported device {gout.device}")


def segment_grads(keys, tx, ty, gout, layout: Layout) -> list:
    """Each group's keys sorted (glue), then grid_grad."""
    skeys, orders = sort_keys(keys)
    return grid_grad(skeys, orders, tx, ty, gout, layout)
