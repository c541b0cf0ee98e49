"""Build and load the hand-written CUDA kernels of csrc/.

Each csrc/<name>.cu has a plain C interface. It is compiled with nvcc
for sm_90a into build/lib<name>-<hash>.so at first use (the hash covers
the source, the shared csrc/*.cuh headers and the flags, so an edited
source or header rebuilds) and loaded with ctypes. Nothing is compiled
when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or CUDA_HOME)")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: list[str]) -> dict[str, ctypes.CDLL]:
    """Compile every missing library, all nvcc processes started
    together, then load them. Raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.time()
    for name in names:
        if name in _LIBS:
            continue
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.time() - t0, "log": log}
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
    for name in names:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return {n: _LIBS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build([name])
    return _LIBS[name]
