"""3DGS-format .ply and antimatter15 .splat export (port of
sings_tpu/export/ply.py; numpy only, no PLY library).

Binary writers with no plyfile/open3d dependency. Field layout matches
the reference exactly (vis.py:22-61: x y z nx ny nz f_dc_{0..2}
f_rest_{0..44} opacity scale_{0..2} rot_{0..3}, opacity stored as
inverse sigmoid, scales as log) so exported avatars load in standard
3DGS viewers. The .splat converter mirrors playground/display/convert.py
(sort by scale*opacity, quantized color+rotation).
"""
from __future__ import annotations

import os

import numpy as np


def _inverse_sigmoid(x):
    x = np.clip(x, 1e-6, 1 - 1e-6)
    return np.log(x / (1 - x))


def save_ply(out: dict, path: str, pose: str = "canonical",
             alive: np.ndarray | None = None):
    """Write gaussians to a 3DGS .ply.

    out: forward-output dict with numpy-able entries xyz / xyz_canon,
    shs (N,16,3), opacity (N,1), scales_canon or scales, rotq_canon.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    key = "xyz_canon" if pose == "canonical" else "xyz"
    xyz = np.asarray(out[key], np.float32)
    shs = np.asarray(out["shs"], np.float32)
    opacity = np.asarray(out["opacity"], np.float32).reshape(-1, 1)
    scales = np.asarray(
        out.get("scales_canon", out.get("scales")), np.float32)
    rotq = np.asarray(out.get("rotq_canon", out.get("rotq")), np.float32)

    if alive is not None:
        m = np.asarray(alive) > 0.5
        xyz, shs, opacity, scales, rotq = (
            a[m] for a in (xyz, shs, opacity, scales, rotq))

    n = len(xyz)
    f_dc = shs[:, :1].transpose(0, 2, 1).reshape(n, -1)
    f_rest = shs[:, 1:].transpose(0, 2, 1).reshape(n, -1)
    normals = np.zeros_like(xyz)
    attrs = np.concatenate(
        [xyz, normals, f_dc, f_rest, _inverse_sigmoid(opacity),
         np.log(np.maximum(scales, 1e-9)), rotq], axis=1
    ).astype("<f4")

    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(45)]
             + ["opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    assert attrs.shape[1] == len(names)

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {nm}" for nm in names]
    header.append("end_header")
    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        fh.write(attrs.tobytes())


def save_splat(out: dict, path: str, pose: str = "deformed",
               alive: np.ndarray | None = None):
    """antimatter15 .splat: 32 bytes per gaussian
    (pos f32x3, scale f32x3, rgba u8x4, rot u8x4)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    key = "xyz_canon" if pose == "canonical" else "xyz"
    xyz = np.asarray(out[key], np.float32)
    shs = np.asarray(out["shs"], np.float32)
    opacity = np.asarray(out["opacity"], np.float32).reshape(-1)
    scales = np.asarray(
        out.get("scales_canon", out.get("scales")), np.float32)
    rotq = np.asarray(out.get("rotq_canon", out.get("rotq")), np.float32)
    if alive is not None:
        m = np.asarray(alive) > 0.5
        xyz, shs, opacity, scales, rotq = (
            a[m] for a in (xyz, shs, opacity, scales, rotq))

    from ..ops.sh import C0

    order = np.argsort(-scales.prod(axis=1) * opacity)
    rgb = np.clip(shs[:, 0] * C0 + 0.5, 0, 1)
    rgba = np.concatenate(
        [rgb, np.clip(opacity, 0, 1)[:, None]], axis=1)
    rgba8 = (rgba * 255).astype(np.uint8)
    rotq = rotq / np.maximum(
        np.linalg.norm(rotq, axis=1, keepdims=True), 1e-9)
    rot8 = ((rotq * 128) + 128).clip(0, 255).astype(np.uint8)

    # one structured array: the same 32 bytes per gaussian, in `order`,
    # as the JAX package's per-gaussian writes
    rec = np.zeros(len(order), dtype=[("xyz", "<f4", 3), ("scale", "<f4", 3),
                                      ("rgba", "u1", 4), ("rot", "u1", 4)])
    rec["xyz"] = xyz[order]
    rec["scale"] = scales[order]
    rec["rgba"] = rgba8[order]
    rec["rot"] = rot8[order]
    with open(path, "wb") as fh:
        fh.write(rec.tobytes())


def load_ply(path: str) -> dict:
    """Read back a 3DGS .ply written by save_ply (round-trip testing)."""
    with open(path, "rb") as fh:
        header = []
        while True:
            line = fh.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = next(int(h.split()[-1]) for h in header
                 if h.startswith("element vertex"))
        names = [h.split()[-1] for h in header
                 if h.startswith("property float")]
        data = np.frombuffer(fh.read(), dtype="<f4").reshape(n, len(names))
    cols = {nm: data[:, i] for i, nm in enumerate(names)}
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], 1)
    f_dc = np.stack([cols[f"f_dc_{i}"] for i in range(3)], 1)
    f_rest = np.stack([cols[f"f_rest_{i}"] for i in range(45)], 1)
    shs = np.concatenate(
        [f_dc.reshape(n, 3, 1), f_rest.reshape(n, 3, 15)], axis=2
    ).transpose(0, 2, 1)
    opacity = 1.0 / (1.0 + np.exp(-cols["opacity"]))
    scales = np.exp(np.stack([cols[f"scale_{i}"] for i in range(3)], 1))
    rotq = np.stack([cols[f"rot_{i}"] for i in range(4)], 1)
    return {"xyz": xyz, "shs": shs, "opacity": opacity[:, None],
            "scales": scales, "rotq": rotq}


# icosahedron for ellipsoid visualization meshes
_ICO_T = (1.0 + 5.0**0.5) / 2.0
_ICO_VERTS = np.array([
    [-1, _ICO_T, 0], [1, _ICO_T, 0], [-1, -_ICO_T, 0], [1, -_ICO_T, 0],
    [0, -1, _ICO_T], [0, 1, _ICO_T], [0, -1, -_ICO_T], [0, 1, -_ICO_T],
    [_ICO_T, 0, -1], [_ICO_T, 0, 1], [-_ICO_T, 0, -1], [-_ICO_T, 0, 1],
], np.float32)
_ICO_VERTS /= np.linalg.norm(_ICO_VERTS, axis=1, keepdims=True)
_ICO_FACES = np.array([
    [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
    [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
    [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
    [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
], np.int32)


def save_ellipsoid_mesh(out: dict, path: str, pose: str = "deformed",
                        alive: np.ndarray | None = None,
                        max_gaussians: int = 20000):
    """Instanced icosphere mesh of the gaussian ellipsoids with vertex
    colors (reference save_ellipsoid_meshes, vis.py:92-119, minus the
    open3d dependency). Writes a colored binary .ply."""
    import torch

    from ..ops.rotations import quaternion_to_matrix

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    key = "xyz_canon" if pose == "canonical" else "xyz"
    xyz = np.asarray(out[key], np.float32)
    shs = np.asarray(out["shs"], np.float32)
    opacity = np.asarray(out["opacity"], np.float32).reshape(-1)
    scales = np.asarray(out.get("scales_canon", out.get("scales")),
                        np.float32)
    rotq = np.asarray(out.get("rotq_canon", out.get("rotq")), np.float32)
    if alive is not None:
        m = np.asarray(alive) > 0.5
        xyz, shs, opacity, scales, rotq = (
            a[m] for a in (xyz, shs, opacity, scales, rotq))
    if len(xyz) > max_gaussians:
        sel = np.random.RandomState(0).choice(len(xyz), max_gaussians,
                                              replace=False)
        xyz, shs, opacity, scales, rotq = (
            a[sel] for a in (xyz, shs, opacity, scales, rotq))

    from ..ops.sh import C0

    n = len(xyz)
    R = quaternion_to_matrix(torch.as_tensor(rotq)).numpy()
    # (N, 12, 3): ellipsoid verts = R @ diag(s) @ ico + center
    verts = np.einsum("nij,vj->nvi", R * scales[:, None, :], _ICO_VERTS)
    verts = (verts + xyz[:, None, :]).reshape(-1, 3)
    faces = (_ICO_FACES[None] + 12 * np.arange(n)[:, None, None]).reshape(
        -1, 3)
    rgb = np.clip(shs[:, 0] * C0 + 0.5, 0, 1)
    colors = np.repeat((rgb * 255).astype(np.uint8), 12, axis=0)

    header = [
        "ply", "format binary_little_endian 1.0",
        f"element vertex {len(verts)}",
        "property float x", "property float y", "property float z",
        "property uchar red", "property uchar green", "property uchar blue",
        f"element face {len(faces)}",
        "property list uchar int vertex_indices", "end_header",
    ]
    vdata = np.zeros(len(verts), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    vdata["xyz"] = verts
    vdata["rgb"] = colors
    fdata = np.zeros(len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)])
    fdata["n"] = 3
    fdata["idx"] = faces
    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        fh.write(vdata.tobytes())
        fh.write(fdata.tobytes())
