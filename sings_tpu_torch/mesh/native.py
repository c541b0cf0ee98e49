"""Native (C++) edge collapse for density control (port of
sings_tpu/native/__init__.py).

csrc/mesh_native.cpp (the greedy longest-edge collapse with adjacency
lists and a lazy max-heap, O(deg log E) per collapse) is host code: it
is compiled with g++ at first use into build/libmesh_native-<hash>.so,
hashed over the source and the flags as ops/cuda_build.py hashes the
CUDA kernels, and loaded with ctypes. As in the JAX package, the numpy
collapse_edges of mesh/ops.py runs when the library does not build;
COLLAPSE_RUNS counts which of the two ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from ..ops.cuda_build import BUILD_DIR, CSRC
from .ops import collapse_edges

GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
COLLAPSE_RUNS = {"native": 0, "numpy": 0}

_lib = None
_tried = False


def _target():
    src = (CSRC / "mesh_native.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libmesh_native-{digest[:12]}.so"


def get_lib():
    """The loaded library (built if missing), or None when g++ is
    missing or fails."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    out = _target()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            res = subprocess.run(
                ["g++", *GXX_FLAGS, str(CSRC / "mesh_native.cpp"), "-o",
                 str(tmp)], capture_output=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if res.returncode != 0:
            return None
        os.replace(tmp, out)
    try:
        lib = ctypes.CDLL(str(out))
    except OSError:
        return None
    lib.collapse_edges_native.restype = ctypes.c_int32
    lib.collapse_edges_native.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_double,
    ]
    _lib = lib
    return _lib


def _cptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def collapse_edges_fast(verts: np.ndarray, verts_attr: np.ndarray,
                        selected_edges: np.ndarray, faces: np.ndarray,
                        collapse_rate: float = 0.5):
    """Native-or-numpy greedy edge collapse, with mesh.ops.collapse_edges'
    contract: (new_verts, new_faces (local ids), new_verts_attr,
    prune_mask)."""
    lib = get_lib()
    if lib is None:
        COLLAPSE_RUNS["numpy"] += 1
        return collapse_edges(verts, verts_attr, selected_edges, faces,
                              collapse_rate)
    COLLAPSE_RUNS["native"] += 1
    v = np.ascontiguousarray(verts, np.float32).copy()
    a = np.ascontiguousarray(verts_attr, np.float32).copy()
    a2 = a.reshape(len(v), -1)
    e = np.ascontiguousarray(selected_edges, np.int32)
    f = np.ascontiguousarray(faces, np.int32).copy()
    face_keep = np.zeros(len(f), np.uint8)
    vert_keep = np.zeros(len(v), np.uint8)
    lib.collapse_edges_native(
        _cptr(v, ctypes.c_float), len(v),
        _cptr(a2, ctypes.c_float), a2.shape[1],
        _cptr(e, ctypes.c_int32), len(e),
        _cptr(f, ctypes.c_int32), len(f),
        _cptr(face_keep, ctypes.c_uint8), _cptr(vert_keep, ctypes.c_uint8),
        float(collapse_rate),
    )
    keep_mask = vert_keep.astype(bool)
    kept = np.where(keep_mask)[0]
    inverse = np.full(len(v), -1, np.int64)
    inverse[kept] = np.arange(len(kept))
    new_faces = inverse[f[face_keep.astype(bool)]]
    new_attr = a2[keep_mask].reshape((len(kept),) + verts_attr.shape[1:])
    return v[keep_mask], new_faces, new_attr, ~keep_mask
