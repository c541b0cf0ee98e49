"""The in-window prefix-sum micro-benchmark: the CUDA kernel and its
plain versions.

Counterpart of the kernel of scripts/exp_cumsum_kernel.py (run :70,
body make_kernel :35), which compared ways to take the composite
kernels' prefix sums over a window's 128 pairs: for each of `steps`
steps, la = x * (1 + c * 1e-9) over one (128, 256) block, its exclusive
prefix sum down the rows, summed over the rows and accumulated into a
(1, 256) row. Modes:
  tri     the strictly lower-triangular matmul L @ la;
  cumsum  cumsum(la) - la;
  shift   seven masked shift-adds (Hillis-Steele), then minus la;
  tri3    one L @ [la, 2 la, 3 la] product, the three parts summed.
The kernel is csrc/chunk_scan_bench.cu, one CTA of 256 threads, built
with nvcc for sm_90a and called through ctypes. CUDA tensors launch it
(or raise), CPU tensors run the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

CHUNK, NPX = 128, 256
MODES = ("tri", "cumsum", "shift", "tri3")
STEPS = 4096
_BLOCK = 256  # steps the plain version holds at once (32 MB on the card)

# launches through the wrapper, never through the plain version: in
# all, and by mode
LAUNCHES = {"chunk_scan_bench": 0}
MODE_LAUNCHES = {m: 0 for m in MODES}


def reset_launches() -> None:
    LAUNCHES["chunk_scan_bench"] = 0
    for m in MODES:
        MODE_LAUNCHES[m] = 0


def _mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    return mode


def _excl(la: torch.Tensor, mode: str) -> torch.Tensor:
    """(B, CHUNK, NPX) -> the exclusive prefix sums down dim 1."""
    if mode == "cumsum":
        return torch.cumsum(la, dim=1) - la
    if mode == "shift":
        s = la
        k = 1
        while k < CHUNK:
            shifted = torch.zeros_like(s)
            shifted[:, k:] = s[:, :-k]
            s = s + shifted
            k *= 2
        return s - la
    tri = torch.tril(torch.ones((CHUNK, CHUNK), device=la.device),
                     diagonal=-1)
    if mode == "tri":
        return torch.matmul(tri, la)
    r = torch.matmul(tri, torch.cat([la, la * 2, la * 3], dim=2))
    return r[..., :NPX] + r[..., NPX:2 * NPX] + r[..., 2 * NPX:]


def chunk_scan_bench_plain(x: torch.Tensor, *, mode: str,
                           steps: int = STEPS) -> torch.Tensor:
    """Plain PyTorch version, _BLOCK steps at a time: (1, NPX). The
    steps' row sums join the accumulator one step after another, as in
    the kernels: over 4096 steps a float32 sum in another order moves
    the result by up to ~1e-4 of it."""
    mode = _mode(mode)
    factors = 1.0 + torch.arange(steps, device=x.device,
                                 dtype=torch.float32) * 1e-9
    acc = torch.zeros((1, NPX), device=x.device)
    for s0 in range(0, steps, _BLOCK):
        la = x[None] * factors[s0:s0 + _BLOCK, None, None]
        for colsum in _excl(la, mode).sum(dim=1, keepdim=True):
            acc = acc + colsum
    return acc


def _lib():
    fn = cuda_build.load("chunk_scan_bench").chunk_scan_bench_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def chunk_scan_bench_cuda(x: torch.Tensor, *, mode: str,
                          steps: int = STEPS) -> torch.Tensor:
    """Launch csrc/chunk_scan_bench.cu (one CTA) on the current stream."""
    mode = _mode(mode)
    if not x.is_cuda:
        raise ValueError("chunk_scan_bench needs a CUDA tensor")
    if (x.dtype != torch.float32 or x.shape != (CHUNK, NPX)
            or not x.is_contiguous()):
        raise ValueError(f"x must be contiguous f32 ({CHUNK}, {NPX}), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if steps < 0:
        raise ValueError(f"steps {steps} < 0")
    fn = _lib()
    out = torch.empty((1, NPX), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), out.data_ptr(), steps, MODES.index(mode), stream)
    if err != 0:
        raise RuntimeError(f"chunk_scan_bench {mode} launch failed: "
                           f"cudaError {err}")
    LAUNCHES["chunk_scan_bench"] += 1
    MODE_LAUNCHES[mode] += 1
    return out


def chunk_scan_bench(x: torch.Tensor, *, mode: str,
                     steps: int = STEPS) -> torch.Tensor:
    """Kernel for a CUDA tensor, plain version for a CPU tensor."""
    if x.is_cuda:
        return chunk_scan_bench_cuda(x, mode=mode, steps=steps)
    if x.device.type == "cpu":
        return chunk_scan_bench_plain(x, mode=mode, steps=steps)
    raise ValueError(f"chunk_scan_bench: unsupported device {x.device}")
