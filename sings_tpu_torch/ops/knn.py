"""K nearest neighbours (port of sings_tpu/ops/knn.py).

knn: the k nearest valid points of every point, self included, exact.
knn_rows: the same for a range of query rows (the gs-sharded step's
split of the statistic); its rows equal knn's.

Both check their arguments (_check_knn), then:
  * CUDA tensors: csrc/knn_topk.cu (built with nvcc for sm_90a, called
    through ctypes; raises on any failure), which walks the valid
    candidates along a Morton curve, skips the tiles of them that cannot
    hold a row's nearest, and keeps each row's k smallest squared
    distances beside the walk; no distance block is written and the host
    never waits. knn_topk_cuda is the launcher, LAUNCHES["knn_topk"]
    counts its calls.
  * CPU tensors: the plain version, a blocked |a|^2 + |b|^2 - 2 a.b
    distance matrix with one matmul and one torch.topk per block of
    query rows (_block_topk). The JAX package's approx=True asks the
    TPU's approximate top-k; on other backends JAX computes the exact
    top-k, and so does the port.
Both round the distance alike ((sq_i + sq_j) - 2 dot, sq from
_sum_squares) and clamp it at 0. Ties: the kernel keeps the lower index;
torch.topk's order among equal distances is its own.

knn_window_stat: the KNN edge statistic over Morton-curve candidate
windows, O(N (window + block)) instead of O(N^2), approximate (a curve
discontinuity can hide a true neighbour, so the statistic never
underestimates the exact one). The codes are JAX's bit for bit
(morton3d quantises in its float order and truncates to int32) and the
sort is stable as jnp.argsort is, so both packages search the same
windows. It keeps its own torch path on every device.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

# launches through the wrapper, never through the plain version
LAUNCHES = {"knn_topk": 0}

# the kernel's longest list (csrc/knn_topk.cu, kMaxK; lists of 1, 4, 9
# and 16 are compiled): k is bounded so on every device, so that a call
# that runs on the CPU runs on the card
MAX_K = 16


def reset_launches() -> None:
    LAUNCHES["knn_topk"] = 0


def _sum_squares(p: torch.Tensor) -> torch.Tensor:
    """sum(p * p, -1) over 3 components in XLA's order, a chain of fused
    multiply-adds (each product exact in float64, one rounding per
    step), so that the distances cancel as in the JAX package."""
    d = p.double()
    acc = (p[:, 0] * p[:, 0]).double()
    for i in (1, 2):
        acc = (acc + d[:, i] * d[:, i]).float().double()
    return acc.float()


def _check_knn(points, k, valid, row_start: int = 0,
               rows: int | None = None) -> None:
    """What knn and knn_rows take on every device, checked before the
    device is: (N, 3) contiguous float32 points, valid None or a
    contiguous (N,) bool mask on the points' device, 1 <= k <=
    min(N, MAX_K), and query rows [row_start, row_start + rows) inside
    [0, N) (rows None: all). Raises ValueError."""
    if not isinstance(points, torch.Tensor) or points.dtype != torch.float32:
        raise ValueError("knn: points must be a float32 tensor")
    if points.dim() != 2 or points.shape[1] != 3 or points.shape[0] < 1:
        raise ValueError(f"knn: points must be (N, 3) with N >= 1, got "
                         f"{tuple(points.shape)}")
    if not points.is_contiguous():
        raise ValueError("knn: points must be contiguous")
    n = points.shape[0]
    rows = n if rows is None else rows
    if valid is not None and (
            not isinstance(valid, torch.Tensor) or valid.dtype != torch.bool
            or tuple(valid.shape) != (n,) or not valid.is_contiguous()
            or valid.device != points.device):
        raise ValueError(f"knn: valid must be a contiguous ({n},) bool "
                         f"tensor on {points.device}")
    if isinstance(k, bool) or not isinstance(k, int) or not (
            1 <= k <= min(n, MAX_K)):
        raise ValueError(f"knn: k must be an int in [1, min(N, {MAX_K})] = "
                         f"[1, {min(n, MAX_K)}], got {k!r}")
    if not (0 <= row_start and 1 <= rows and row_start + rows <= n):
        raise ValueError(f"knn: query rows [{row_start}, {row_start + rows}) "
                         f"are not inside [0, {n})")


# the kernel

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _lib():
    lib = cuda_build.load("knn_topk")
    if lib.knn_topk_launch.argtypes is None:
        lib.knn_topk_launch.argtypes = _ARGTYPES
        lib.knn_topk_launch.restype = ctypes.c_int
        lib.knn_topk_codes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_longlong, ctypes.c_void_p,
                                       ctypes.c_void_p]
        lib.knn_topk_codes.restype = ctypes.c_int
        lib.knn_topk_scratch_bytes.argtypes = [ctypes.c_longlong,
                                               ctypes.c_longlong]
        lib.knn_topk_scratch_bytes.restype = ctypes.c_longlong
    return lib


def knn_topk_cuda(points: torch.Tensor, k: int, valid: torch.Tensor | None,
                  row_start: int, rows: int):
    """Launch csrc/knn_topk.cu on the current stream for the query rows
    [row_start, row_start + rows) (arguments as _check_knn takes them):
    the slots' Morton codes, their stable sort (torch.sort: the walk's
    order, glue), then the kernels. Returns (rows, k) squared distances,
    ascending and unclamped, and their int64 indices; a row with fewer
    than k valid candidates reads +inf and -1 in its tail."""
    if not points.is_cuda:
        raise ValueError("knn_topk_cuda needs CUDA tensors")
    n = points.shape[0]
    dev = points.device
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    lohi = torch.stack(torch.aminmax(points, dim=0))
    codes = torch.empty((n,), dtype=torch.int32, device=dev)
    err = lib.knn_topk_codes(points.data_ptr(), lohi.data_ptr(), n,
                             codes.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn_topk codes launch failed: cudaError {err}")
    order = torch.sort(codes, stable=True).indices
    sq = _sum_squares(points)
    scratch = torch.empty((lib.knn_topk_scratch_bytes(n, rows),),
                          dtype=torch.uint8, device=dev)
    out_d = torch.empty((rows, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((rows, k), dtype=torch.int64, device=dev)
    err = lib.knn_topk_launch(
        points.data_ptr(), sq.data_ptr(),
        None if valid is None else valid.data_ptr(), order.data_ptr(), n,
        row_start, rows, k, scratch.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn_topk launch failed: cudaError {err}")
    LAUNCHES["knn_topk"] += 1
    return out_d, out_i


# the plain version

def _block_topk(points: torch.Tensor, sq: torch.Tensor, qi, k: int,
                valid: torch.Tensor | None):
    """torch.topk of the distances from the query rows qi (a slice or an
    index tensor) to every point, invalid points at +inf."""
    d2 = sq[qi, None] + sq[None, :] - 2.0 * (points[qi] @ points.T)
    if valid is not None:
        d2 = torch.where(valid[None, :], d2,
                         torch.full((), float("inf"), device=points.device))
    return torch.topk(d2, k, dim=1, largest=False, sorted=True)


def _plain_device(points: torch.Tensor, name: str) -> None:
    if points.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {points.device}")


def knn(points: torch.Tensor, k: int, *, valid: torch.Tensor | None = None,
        block: int = 4096):
    """K nearest neighbours of each point among all points, self
    included; invalid points (valid False) are never neighbours.
    Returns (squared distances ascending, clamped at 0; indices), both
    (N, k)."""
    _check_knn(points, k, valid)
    n = points.shape[0]
    if points.is_cuda:
        d, i = knn_topk_cuda(points, k, valid, 0, n)
        return torch.clamp_min(d, 0.0), i
    _plain_device(points, "knn")
    sq = _sum_squares(points)
    dists, idx = [], []
    for s in range(0, n, block):
        d, i = _block_topk(points, sq, slice(s, s + block), k, valid)
        dists.append(d)
        idx.append(i)
    return torch.clamp_min(torch.cat(dists), 0.0), torch.cat(idx)


def knn_rows(points: torch.Tensor, k: int, *, row_start: int, rows: int,
             valid: torch.Tensor | None = None, block: int = 4096):
    """knn restricted to the queries [row_start, row_start + rows); the
    candidates are still all points. The plain version pads the query
    range up to a whole number of min(block, rows)-row blocks by a
    clamped row gather (the pad rows are dropped), as in the JAX
    package. Returns (rows, k) squared distances and indices, equal to
    knn's rows."""
    _check_knn(points, k, valid, row_start, rows)
    if points.is_cuda:
        d, i = knn_topk_cuda(points, k, valid, row_start, rows)
        return torch.clamp_min(d, 0.0), i
    _plain_device(points, "knn_rows")
    n = points.shape[0]
    sq = _sum_squares(points)
    bl = min(block, rows)
    nblocks = -(-rows // bl)
    dists, idx = [], []
    for b in range(nblocks):
        qi = torch.clamp(row_start + b * bl + torch.arange(
            bl, device=points.device), 0, n - 1)
        d, i = _block_topk(points, sq, qi, k, valid)
        dists.append(d)
        idx.append(i)
    return (torch.clamp_min(torch.cat(dists)[:rows], 0.0),
            torch.cat(idx)[:rows])


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd bit (Morton interleave helper)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton3d(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N, 3) -> (N,) int32 30-bit Morton codes over the valid points'
    bounding box, in uniform cells (the largest extent over 1023);
    invalid points get INT32_MAX so that they sort to the end."""
    big = 3.0e38
    v = valid[:, None]
    lo = torch.where(v, points, torch.full_like(points, big)).amin(dim=0)
    hi = torch.where(v, points, torch.full_like(points, -big)).amax(dim=0)
    ext = torch.clamp_min((hi - lo).max(), 1e-9)
    q = torch.clamp((points - lo) / ext * 1023.0, 0.0, 1023.0).to(
        torch.int32)
    code = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
            | (_spread3(q[:, 2]) << 2))
    return torch.where(valid, code, torch.full_like(code, 2 ** 31 - 1))


# blocks of knn_window_stat that share one batched matmul and top-k
# (memory only: every block's arithmetic is its own)
BLOCKS_PER_PASS = 64


@torch.no_grad()
def knn_window_stat(points: torch.Tensor, k: int, *,
                    valid: torch.Tensor | None = None, window: int = 256,
                    block: int = 256) -> torch.Tensor:
    """Mean distance to the K-1 nearest neighbours (self among the k, as
    in knn), per point, over Morton-curve candidate windows: after a
    stable sort along the curve, each block of `block` sorted points
    searches the `block + window` sorted positions around it. Returns
    (N,) in the original point order; invalid points get 0."""
    n = points.shape[0]
    assert n % block == 0, (n, block)
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=points.device)
    order = torch.sort(morton3d(points, valid), stable=True).indices
    ps = points[order]
    pv = valid[order]
    sq = _sum_squares(ps)
    cand = min(block + window, n)
    nblocks = n // block
    starts = torch.arange(nblocks, device=points.device) * block
    cstarts = torch.clamp(starts - window // 2, 0, max(n - cand, 0))
    ar = torch.arange(cand, device=points.device)
    out = []
    for b0 in range(0, nblocks, BLOCKS_PER_PASS):
        cidx = cstarts[b0: b0 + BLOCKS_PER_PASS, None] + ar   # (b, cand)
        q = ps[b0 * block: (b0 + cidx.shape[0]) * block].reshape(
            -1, block, 3)
        qsq = sq[b0 * block: (b0 + cidx.shape[0]) * block].reshape(
            -1, block)
        d2 = qsq[:, :, None] + sq[cidx][:, None, :] - 2.0 * torch.bmm(
            q, ps[cidx].transpose(1, 2))
        d2 = torch.where(pv[cidx][:, None, :], d2,
                         torch.full_like(d2, float("inf")))
        d = torch.topk(d2, k, dim=2, largest=False, sorted=True).values
        out.append(torch.sqrt(torch.clamp_min(d[..., 1:], 1e-24)).mean(
            dim=2).reshape(-1))
    stat_sorted = torch.where(pv, torch.cat(out), torch.zeros_like(sq))
    stat = torch.empty_like(stat_sorted)
    stat[order] = stat_sorted
    return stat
