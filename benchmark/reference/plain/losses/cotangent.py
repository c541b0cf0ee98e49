"""The cotangent region laplacian (laplacian.type: cotangent; port of
sings_tpu/losses/regularizers.py's CotRegionLaplacian and
build_cot_region_laplacian).

Region partitions overlap (every vertex of a face that touches the
region), so a boundary vertex owns one row per adjacent region. Row r
of Lx = sum_j cot_w(r, j) x_j with a zero diagonal (pytorch3d's
cot_laplacian weights, applied raw), its weights built on the host at
the anchors' positions and frozen. The adjoint keeps the JAX package's
custom form, as the port does: a gather over the host-built transposed
table, never a scatter. The losses' region sums are the frozen copy's
regularizers._region_sums. The one departure: the build takes no
pad_rows_to (the port's grow-only row count across rebuilds; the
benchmark builds once, where the port passes none).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .regularizers import _region_sums


class _WeightedNeighborSum(torch.autograd.Function):
    """y_r = sum_d w[r, d] x[nb[r, d]]; the adjoint is the transposed
    gather gx_v = sum_d wt[v, d] g[nbt[v, d]]."""

    @staticmethod
    def forward(ctx, nb, w, nbt, wt, x):
        ctx.save_for_backward(nbt, wt)
        return torch.einsum("rd,rdf->rf", w, x[nb.long()])

    @staticmethod
    def backward(ctx, g):
        nbt, wt = ctx.saved_tensors
        return None, None, None, None, torch.einsum(
            "vd,vdf->vf", wt, g[nbt.long()])


class CotRegionLaplacian(NamedTuple):
    """Padded cotangent laplacian rows over (region, vertex) memberships.

      neighbors/nbr_w: (R, D) gather table and cotangent weights per row
      t_neighbors/t_w: (C, Dt) the transposed table, for the adjoint
      label:           (R,) region id per row
      row_w:           (R,) 1 / |partition of the row's region|
      weights:         (15,) region weights
    """

    neighbors: torch.Tensor
    nbr_w: torch.Tensor
    t_neighbors: torch.Tensor
    t_w: torch.Tensor
    label: torch.Tensor
    row_w: torch.Tensor
    weights: torch.Tensor

    def loss_fused(self, terms):
        """Several laplacian losses with one gather. terms: list of
        (x (C, F), region_weights | None, regions | None)."""
        xcat = torch.cat([t[0] for t in terms], dim=-1)
        lx = _WeightedNeighborSum.apply(self.neighbors, self.nbr_w,
                                        self.t_neighbors, self.t_w, xcat)
        return _region_sums(lx, terms, self.label.long(), self.weights,
                            row_w=self.row_w)


def cot_edge_weights(verts: np.ndarray, faces: np.ndarray,
                     eps: float = 1e-12):
    """Symmetric cotangent weights per directed face edge: the cotangent
    of the angle opposite each edge, (B2 + C2 - A2) / (4 S), from every
    face that holds it. Returns (rows, cols, w) COO triplets, both
    directions."""
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    a = np.linalg.norm(v1 - v2, axis=1)
    b = np.linalg.norm(v0 - v2, axis=1)
    c = np.linalg.norm(v0 - v1, axis=1)
    s = 0.5 * (a + b + c)
    area = np.sqrt(np.clip(s * (s - a) * (s - b) * (s - c), eps, None))
    a2, b2, c2 = a * a, b * b, c * c
    cota = (b2 + c2 - a2) / (4.0 * area)   # at v0, opposite edge a
    cotb = (a2 + c2 - b2) / (4.0 * area)   # at v1
    cotc = (a2 + b2 - c2) / (4.0 * area)   # at v2
    # edge (v1, v2) gets cota, (v2, v0) cotb, (v0, v1) cotc
    ii = faces[:, [1, 2, 0]].reshape(-1)
    jj = faces[:, [2, 0, 1]].reshape(-1)
    ww = np.stack([cota, cotb, cotc], axis=1).reshape(-1)
    return (np.concatenate([ii, jj]), np.concatenate([jj, ii]),
            np.concatenate([ww, ww]))


def _pad_table(src, dst, val, c_rows, pad_to=None):
    """COO (src -> dst, val) to padded (rows, Dmax) gather tables."""
    order = np.argsort(src, kind="stable")
    src, dst, val = src[order], dst[order], val[order]
    deg = np.bincount(src, minlength=c_rows)
    dmax = max(int(deg.max()) if len(src) else 1, 1)
    if pad_to is not None:
        dmax = max(dmax, pad_to)
    offs = np.zeros(c_rows + 1, np.int64)
    np.cumsum(deg, out=offs[1:])
    col = np.arange(len(src)) - offs[src]
    nb = np.zeros((c_rows, dmax), np.int32)
    nw = np.zeros((c_rows, dmax), np.float32)
    nb[src, col] = dst.astype(np.int32)
    nw[src, col] = val.astype(np.float32)
    return nb, nw


def build_cot_region_laplacian(verts: np.ndarray, faces: np.ndarray,
                               vertex_label: np.ndarray,
                               region_weights: np.ndarray,
                               num_regions: int = 15,
                               pad_width_to: int | None = None,
                               device="cpu") -> CotRegionLaplacian:
    """Per region r: the faces with any vertex labelled r, the partition
    = their vertices, cotangent weights from those faces only, at the
    given positions. pad_width_to: least table width."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces)
    labels = np.asarray(vertex_label).astype(np.int64)
    c = labels.shape[0]

    row_src, row_dst, row_val, row_lbl = [], [], [], []
    part_sizes = np.ones(num_regions)
    row0 = 0
    rows_of_region = []
    for r in range(num_regions):
        fsel = faces[np.any(labels[faces] == r, axis=1)]
        part = np.unique(fsel)
        part_sizes[r] = max(len(part), 1)
        v2row = np.full(c, -1, np.int64)
        v2row[part] = row0 + np.arange(len(part))
        if len(fsel):
            rr, cc, ww = cot_edge_weights(verts, fsel)
            row_src.append(v2row[rr])
            row_dst.append(cc)
            row_val.append(ww)
        rows_of_region.append((row0, len(part)))
        row_lbl.append(np.full(len(part), r, np.int64))
        row0 += len(part)

    n_rows = row0
    src = np.concatenate(row_src) if row_src else np.zeros(0, np.int64)
    dst = np.concatenate(row_dst) if row_dst else np.zeros(0, np.int64)
    val = np.concatenate(row_val) if row_val else np.zeros(0)
    # an edge shared by two faces accumulates both weights
    key = src * c + dst
    uk, inv = np.unique(key, return_inverse=True)
    acc = np.zeros(len(uk))
    np.add.at(acc, inv, val)
    src, dst, val = uk // c, uk % c, acc
    lbl = (np.concatenate(row_lbl) if row_lbl
           else np.zeros(n_rows, np.int64))

    nb, nw = _pad_table(src, dst, val, n_rows, pad_to=pad_width_to)
    nbt, nwt = _pad_table(dst, src, val, c, pad_to=pad_width_to)

    row_w = np.zeros(n_rows, np.float32)
    for r, (r0, ln) in enumerate(rows_of_region):
        row_w[r0: r0 + ln] = 1.0 / part_sizes[r]

    def t(x):
        return torch.as_tensor(x, device=device)

    return CotRegionLaplacian(
        neighbors=t(nb), nbr_w=t(nw), t_neighbors=t(nbt), t_w=t(nwt),
        label=t(lbl.astype(np.int32)), row_w=t(row_w),
        weights=t(np.asarray(region_weights, np.float32)))
