"""Host-side mesh topology operations (numpy).

Topology mutation is inherently sequential and happens ~10 times per
training run (density control) plus once at template construction, so it
runs on host and re-uploads padded device buffers — the TPU never traces
dynamic shapes. Functional equivalents of the reference's
sings/rec/utils/geometry_ops.py (subdivide_meshes :8-76) and the trimesh
helpers it leans on; edge collapse is not copied.
"""
from __future__ import annotations

import numpy as np


def unique_edges(faces: np.ndarray) -> np.ndarray:
    """Sorted unique undirected edges of a triangle mesh. (F,3) -> (E,2)."""
    e = faces[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2)
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals. (V,3),(F,3) -> (V,3) unit vectors."""
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)  # area-weighted
    n = np.zeros_like(vertices)
    for i in range(3):
        np.add.at(n, faces[:, i], fn)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(norm, 1e-12)


def subdivide(
    vertices: np.ndarray,
    faces: np.ndarray,
    face_index: np.ndarray | None = None,
    vertex_attributes: dict[str, np.ndarray] | None = None,
):
    """Selective midpoint subdivision with attribute interpolation.

    Matches reference geometry_ops.subdivide_meshes: each selected face
    splits 4-way on its edge midpoints; new-vertex attributes are the
    mean of the edge endpoints, except integer labels ('vertex_label',
    'vertex_id') which copy the first endpoint.

    Returns (new_vertices, new_faces, new_attributes).
    """
    if face_index is None:
        face_mask = np.ones(len(faces), dtype=bool)
    else:
        face_mask = np.zeros(len(faces), dtype=bool)
        face_mask[face_index] = True

    faces_subset = faces[face_mask]
    edges = np.sort(
        faces_subset[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2), axis=1
    )
    uniq, inverse = np.unique(edges, axis=0, return_inverse=True)

    mid = vertices[uniq].mean(axis=1)
    mid_idx = inverse.reshape(-1, 3) + len(vertices)

    f = np.column_stack([
        faces_subset[:, 0], mid_idx[:, 0], mid_idx[:, 2],
        mid_idx[:, 0], faces_subset[:, 1], mid_idx[:, 1],
        mid_idx[:, 2], mid_idx[:, 1], faces_subset[:, 2],
        mid_idx[:, 0], mid_idx[:, 1], mid_idx[:, 2],
    ]).reshape(-1, 3)

    new_faces = np.vstack([faces[~face_mask], f])
    new_vertices = np.vstack([vertices, mid])

    new_attributes = {}
    if vertex_attributes is not None:
        for key, values in vertex_attributes.items():
            if key in ("vertex_id", "vertex_label"):
                attr_mid = values[uniq[:, 0]]
            else:
                attr_mid = values[uniq].mean(axis=1)
            new_attributes[key] = np.concatenate([values, attr_mid])

    return new_vertices, new_faces, new_attributes


def smooth_taubin(vertices: np.ndarray, faces: np.ndarray,
                  lamb: float = 0.5, mu: float = -0.53,
                  iterations: int = 5) -> np.ndarray:
    """Taubin lambda/mu smoothing (volume-preserving-ish).

    Stand-in for trimesh.smoothing.filter_mut_dif_laplacian used on the
    subdivided SMPL template (reference smpl_layer.py:322-331): smooths
    the midpoint-subdivided surface without the shrinkage of plain
    Laplacian smoothing.
    """
    edges = unique_edges(faces)
    n = len(vertices)
    deg = np.zeros(n)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    deg = np.maximum(deg, 1)[:, None]
    v = vertices.astype(np.float64).copy()
    for _ in range(iterations):
        for factor in (lamb, mu):
            acc = np.zeros_like(v)
            np.add.at(acc, edges[:, 0], v[edges[:, 1]])
            np.add.at(acc, edges[:, 1], v[edges[:, 0]])
            v = v + factor * (acc / deg - v)
    return v.astype(vertices.dtype)
