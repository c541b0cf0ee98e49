"""Regularisation losses (port of sings_tpu/losses/regularizers.py).

Every term works on the padded static buffers with an `alive` mask:
  * l2_norm_loss: xyz-offset norm, scale spread, above-threshold scales,
    below-threshold opacity;
  * edge_stat / gaussians_edge_loss{,_from_stat,_rows}: scale against
    the mean distance to the K-1 nearest neighbours (a detached
    statistic; _rows is one gs rank's range of query rows);
  * mesh_edge_loss: mean squared edge length;
  * RegionLaplacian: the per-region uniform graph laplacian of the
    anchor mesh as one padded neighbour table (build_region_laplacian
    runs on the host after each topology change);
  * CotRegionLaplacian: the cotangent laplacian over overlapping
    region partitions, weights frozen at the build;
  * ShardedRegionLaplacian: the uniform laplacian's rows split over the
    gs ranks (shard_region_laplacian), each rank's term a local
    contribution whose rank-sum is the full term.

The uniform laplacian's "gather" backend: the forward is a neighbour
gather and its gradient is PyTorch's autograd of it (a scatter-add,
where JAX uses a custom transposed gather; the same sums in another
order). The cotangent and sharded laplacians keep the JAX package's
custom adjoint as an autograd Function: a gather over a host-built
transposed table.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.knn import knn, knn_rows, knn_window_stat
from ..ops.profiling import span


def _masked_norm(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """||x * mask||_2 with a floor under the root."""
    return torch.sqrt(torch.clamp_min(torch.sum((x * mask) ** 2), 1e-24))


class L2NormConfig(NamedTuple):
    lambda_xyz_offsets: float = 0.005
    lambda_scales_diff: float = 0.005
    lambda_max_scale: float = 0.001
    max_scale_threshold: float = 0.008
    lambda_min_opacity: float = 0.0001
    min_opacity_threshold: float = 0.2


def l2_norm_loss(cfg: L2NormConfig, xyz_offsets: torch.Tensor,
                 scales: torch.Tensor, opacity: torch.Tensor | None,
                 alive: torch.Tensor) -> torch.Tensor:
    n_alive = torch.clamp_min(alive.sum(), 1.0)
    a1 = alive[:, None]
    s0 = scales[:, 0]
    mean_s = torch.sum(s0 * alive) / n_alive
    scales_diff = (s0 - mean_s) * alive
    over = ((s0 > cfg.max_scale_threshold) & (alive > 0)).to(s0.dtype)
    loss = (
        cfg.lambda_xyz_offsets * _masked_norm(xyz_offsets, a1)
        + cfg.lambda_scales_diff * torch.sqrt(
            torch.clamp_min(torch.sum(scales_diff ** 2), 1e-24))
        + cfg.lambda_max_scale * _masked_norm(s0[:, None], over[:, None])
    )
    if opacity is not None:
        op = opacity.reshape(-1)
        under = ((op < cfg.min_opacity_threshold) & (alive > 0)).to(op.dtype)
        loss = loss + cfg.lambda_min_opacity * _masked_norm(
            (0.5 - op)[:, None], under[:, None])
    return loss


@torch.no_grad()
def edge_stat(xyz_canon: torch.Tensor, alive: torch.Tensor, k: int = 9,
              backend: str = "dense") -> torch.Tensor:
    """Per-gaussian mean distance to its K-1 nearest live neighbours,
    (N,), detached. backend "dense": the exact KNN (idx 0 is the point
    itself); "window": Morton-curve candidate windows (approximate)."""
    if backend == "window":
        with span("losses.knn_window"):
            return knn_window_stat(xyz_canon, k, valid=alive > 0)
    if backend != "dense":
        raise ValueError(f"edge_stat backend {backend!r}")
    with span("losses.knn_exact"):
        dists, _ = knn(xyz_canon.contiguous(), k, valid=alive > 0)
        return torch.sqrt(torch.clamp_min(dists[:, 1:], 1e-24)).mean(dim=1)


def gaussians_edge_loss_from_stat(stat: torch.Tensor, scales: torch.Tensor,
                                  alive: torch.Tensor) -> torch.Tensor:
    """mean (scale_i - stat_i)^2 over alive gaussians."""
    err = (scales[:, 0] - stat) ** 2 * alive
    return err.sum() / torch.clamp_min(alive.sum(), 1.0)


def gaussians_edge_loss(xyz_canon: torch.Tensor, scales: torch.Tensor,
                        alive: torch.Tensor, k: int = 9,
                        backend: str = "dense") -> torch.Tensor:
    """mean (scale_i - mean KNN edge length)^2, the KNN by `backend`
    (edge_stat)."""
    return gaussians_edge_loss_from_stat(
        edge_stat(xyz_canon, alive, k=k, backend=backend), scales, alive)


def gaussians_edge_loss_rows(xyz_canon: torch.Tensor, scales: torch.Tensor,
                             alive: torch.Tensor, row_start: int, rows: int,
                             k: int = 9) -> torch.Tensor:
    """gaussians_edge_loss restricted to the query rows [row_start,
    row_start + rows): one gs rank's local contribution, whose rank-sum
    is gaussians_edge_loss (the same candidates, all points, and the
    same global alive normaliser). The JAX package's default approx=True
    computes the exact top-k off the TPU, as the port does."""
    with torch.no_grad():
        dists, _ = knn_rows(xyz_canon.contiguous(), k, row_start=row_start,
                            rows=rows, valid=alive > 0)
        edge_len = torch.sqrt(torch.clamp_min(dists[:, 1:], 1e-24)).mean(
            dim=1)
    s_loc = scales[row_start: row_start + rows, 0]
    a_loc = alive[row_start: row_start + rows]
    err = (s_loc - edge_len) ** 2 * a_loc
    return err.sum() / torch.clamp_min(alive.sum(), 1.0)


def mesh_edge_loss(verts: torch.Tensor, edges: torch.Tensor,
                   edge_valid: torch.Tensor) -> torch.Tensor:
    """mean squared edge length over valid (non-padded) edges."""
    e = edges.long()
    d = verts[e[:, 0]] - verts[e[:, 1]]
    sq = torch.sum(d * d, dim=1) * edge_valid
    return sq.sum() / torch.clamp_min(edge_valid.sum(), 1.0)


def _region_sums(lx, terms, label, weights, *, row_mask=None, row_w=None,
                 inv_count=None):
    """The per-term losses of loss_fused from the laplacian rows lx, in
    the JAX package's order of operations: sum over rows of
    |lx_row|^2 (* row_mask) * (w (* inv_count))[label] (* row_w) / F, w
    the term's region weights, masked to `regions` when given."""
    outs = []
    f0 = 0
    for x, region_weights, regions in terms:
        f = x.shape[-1]
        lxi = lx[:, f0: f0 + f]
        f0 += f
        per_row = torch.sum(lxi * lxi, dim=-1)
        if row_mask is not None:
            per_row = per_row * row_mask
        w = weights if region_weights is None else region_weights
        if inv_count is not None:
            w = w * inv_count
        wv = w[label]
        if row_w is not None:
            wv = wv * row_w
        wv = wv / f
        if regions is not None:
            sel = torch.zeros_like(label, dtype=torch.bool)
            for r in regions:
                sel = sel | (label == r)
            wv = wv * sel.to(x.dtype)
        outs.append(torch.sum(per_row * wv))
    return outs


class RegionLaplacian(NamedTuple):
    """Padded uniform laplacian over all regions at once.

      neighbors: (C, D) int32 same-region neighbour slots (self-padded)
      nbr_valid: (C, D) float 0/1
      label:     (C,) int32 region id, 0 where invalid
      vert_valid:(C,) float 1 for labelled live vertices
      inv_count: (R,) float 1 / max(|V_r|, 1)
      weights:   (R,) float region weights
    """

    neighbors: torch.Tensor
    nbr_valid: torch.Tensor
    label: torch.Tensor
    vert_valid: torch.Tensor
    inv_count: torch.Tensor
    weights: torch.Tensor

    def loss(self, x: torch.Tensor, region_weights=None,
             regions: list[int] | None = None) -> torch.Tensor:
        """sum_r w_r * mean((L_r x_r)^2)."""
        (out,) = self.loss_fused([(x, region_weights, regions)])
        return out

    def loss_fused(self, terms) -> list[torch.Tensor]:
        """Several laplacian losses with one neighbour gather.
        terms: list of (x (C, F), region_weights | None, regions | None)."""
        xcat = torch.cat([t[0] for t in terms], dim=-1)
        nb = self.neighbors.long()
        deg = torch.clamp_min(self.nbr_valid.sum(-1), 1.0)
        mean_nb = (xcat[nb] * self.nbr_valid[..., None]).sum(1) / deg[:, None]
        lx = mean_nb - xcat
        return _region_sums(lx, terms, self.label.long(), self.weights,
                            row_mask=self.vert_valid,
                            inv_count=self.inv_count)


def build_region_laplacian(edges: np.ndarray, vertex_label: np.ndarray,
                           region_weights: np.ndarray, num_regions: int = 15,
                           pad_to: int | None = None,
                           device="cpu") -> RegionLaplacian:
    """Host-side construction after every topology change: the
    same-label subgraph of `edges`, both directions, as a CSR-style
    padded table. pad_to: minimum table width D."""
    labels = np.asarray(vertex_label).astype(np.int64)
    edges = np.asarray(edges)
    c = labels.shape[0]

    in_region = (labels >= 0) & (labels < num_regions)
    edge_lbl = labels[edges]
    same = (edge_lbl[:, 0] == edge_lbl[:, 1]) & in_region[edges[:, 0]]
    sel = edges[same]

    src = np.concatenate([sel[:, 0], sel[:, 1]])
    dst = np.concatenate([sel[:, 1], sel[:, 0]])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    deg = np.bincount(src, minlength=c)
    dmax = max(int(deg.max()) if len(src) else 1, 1)
    if pad_to is not None:
        dmax = max(dmax, pad_to)
    offs = np.zeros(c + 1, np.int64)
    np.cumsum(deg, out=offs[1:])
    col = np.arange(len(src)) - offs[src]

    nb = np.tile(np.arange(c, dtype=np.int32)[:, None], (1, dmax))
    nv = np.zeros((c, dmax), np.float32)
    nb[src, col] = dst.astype(np.int32)
    nv[src, col] = 1.0

    counts = np.bincount(labels[in_region], minlength=num_regions)

    def t(x):
        return torch.as_tensor(x, device=device)

    return RegionLaplacian(
        neighbors=t(nb), nbr_valid=t(nv),
        label=t(np.where(in_region, labels, 0).astype(np.int32)),
        vert_valid=t(in_region.astype(np.float32)),
        inv_count=t((1.0 / np.maximum(counts, 1)).astype(np.float32)),
        weights=t(np.asarray(region_weights, np.float32)),
    )



# ---------------------------------------------------------------------------
# The cotangent region laplacian (laplacian.type: cotangent)


class _WeightedNeighborSum(torch.autograd.Function):
    """y_r = sum_d w[r, d] x[nb[r, d]]; the adjoint is the transposed
    gather gx_v = sum_d wt[v, d] g[nbt[v, d]] over host-built tables (no
    scatter), as the JAX package's custom VJP."""

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

    Region partitions overlap (every vertex of a face that touches the
    region), so a boundary vertex owns one row per adjacent region. Row
    r of Lx = sum_j cot_w(r, j) x_j with a zero diagonal (pytorch3d's
    cot_laplacian weights, applied raw).

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

    def loss(self, x, region_weights=None, regions=None):
        (out,) = self.loss_fused([(x, region_weights, regions)])
        return out

    def loss_fused(self, terms):
        """RegionLaplacian.loss_fused's contract, one gather."""
        xcat = torch.cat([t[0] for t in terms], dim=-1)
        lx = _WeightedNeighborSum.apply(self.neighbors, self.nbr_w,
                                        self.t_neighbors, self.t_w, xcat)
        return _region_sums(lx, terms, self.label.long(), self.weights,
                            row_w=self.row_w)


def cot_edge_weights(verts: np.ndarray, faces: np.ndarray,
                     eps: float = 1e-12):
    """Symmetric cotangent weights per directed face edge (pytorch3d's
    cot_laplacian: the cotangent of the angle opposite each edge,
    (B2 + C2 - A2) / (4 S), from every face that holds it). Returns
    (rows, cols, w) COO triplets, both directions."""
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


def _pad_table(src, dst, val, c_rows, pad_to=None, fill=0):
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
    nw = np.full((c_rows, dmax), float(fill), np.float32)
    nb[src, col] = dst.astype(np.int32)
    nw[src, col] = val.astype(np.float32)
    return nb, nw


def build_cot_region_laplacian(verts: np.ndarray, faces: np.ndarray,
                               vertex_label: np.ndarray,
                               region_weights: np.ndarray,
                               num_regions: int = 15,
                               pad_rows_to: int | None = None,
                               pad_width_to: int | None = None,
                               device="cpu") -> CotRegionLaplacian:
    """Host-side build after every topology change. Per region r: the
    faces with any vertex labelled r, the partition = their vertices,
    cotangent weights from those faces only, at the current positions
    (frozen until the next build). pad_rows_to / pad_width_to: least row
    count and table width (grow-only callers keep the shapes)."""
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

    if pad_rows_to is not None and n_rows < pad_rows_to:
        row_lbl.append(np.zeros(pad_rows_to - n_rows, np.int64))
        n_rows = pad_rows_to
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


# ---------------------------------------------------------------------------
# The uniform laplacian's rows split over the gs ranks (sharded training)


class ShardedRegionLaplacian(NamedTuple):
    """RegionLaplacian split into n_gs contiguous row ranges, one per gs
    rank, every field stacked on a leading gs axis (shard(i) keeps rank
    i's, with that axis of length 1, which loss_fused reads).

      neighbors/nbr_w: (gs, C/gs, D) local rows -> global vertex slots,
                       weight 1/deg(row)
      t_neighbors/t_w: (gs, C, Dt) transposed table: for global vertex
                       v, the local rows adjacent to it and their
                       weights, so the backward is a gather (never a
                       float scatter)
      label/vert_valid:(gs, C/gs) per local row
      inv_count/weights:(gs, R) copies
      row_start:       (gs,) int32 global index of the first local row,
                       on the host (read without a device round trip)
    """

    neighbors: torch.Tensor
    nbr_w: torch.Tensor
    t_neighbors: torch.Tensor
    t_w: torch.Tensor
    label: torch.Tensor
    vert_valid: torch.Tensor
    inv_count: torch.Tensor
    weights: torch.Tensor
    row_start: torch.Tensor

    def shard(self, i: int) -> "ShardedRegionLaplacian":
        """Rank i's row range (leading axis 1)."""
        return ShardedRegionLaplacian(*[x[i: i + 1] for x in self])

    def loss_fused(self, terms) -> list[torch.Tensor]:
        """This rank's contributions (the table of one rank, shard(i));
        their rank-sum equals RegionLaplacian.loss_fused on the full
        table. x of each term is the global (C, F) array (all-gathered);
        its gradient flows back through the transposed gather."""
        nb, w = self.neighbors[0], self.nbr_w[0]
        row0 = int(self.row_start[0])
        rows = nb.shape[0]
        xcat = torch.cat([t[0] for t in terms], dim=-1)
        mean_nb = _WeightedNeighborSum.apply(nb, w, self.t_neighbors[0],
                                             self.t_w[0], xcat)
        lx = mean_nb - xcat[row0: row0 + rows]
        return _region_sums(lx, terms, self.label[0].long(),
                            self.weights[0], row_mask=self.vert_valid[0],
                            inv_count=self.inv_count[0])


def shard_region_laplacian(rl: RegionLaplacian, n_gs: int,
                           pad_t_width_to: int | None = None,
                           ) -> ShardedRegionLaplacian:
    """Host-side split of a built RegionLaplacian into n_gs row ranges.

    The transposed tables are padded to the widest rank's width (or
    pad_t_width_to: the case pool needs one width across its cases), so
    every rank's shapes agree."""
    dev = rl.neighbors.device
    nb = rl.neighbors.cpu().numpy()
    nv = rl.nbr_valid.cpu().numpy()
    c, d = nb.shape
    assert c % n_gs == 0, "capacity must split over gs"
    rows = c // n_gs
    deg = np.maximum(nv.sum(-1), 1.0)
    w_full = (nv / deg[:, None]).astype(np.float32)

    # the full table as COO, once
    src = np.repeat(np.arange(c), d)
    dst = nb.reshape(-1)
    val = w_full.reshape(-1)
    keep = nv.reshape(-1) > 0
    src, dst, val = src[keep], dst[keep], val[keep]

    t_nb, t_w = [], []
    dt = pad_t_width_to or 1
    for r in range(n_gs):
        lo, hi = r * rows, (r + 1) * rows
        m = (src >= lo) & (src < hi)
        tnb, tw = _pad_table(dst[m], src[m] - lo, val[m], c)
        t_nb.append(tnb)
        t_w.append(tw)
        dt = max(dt, tnb.shape[1])
    t_nb = [np.pad(x, ((0, 0), (0, dt - x.shape[1]))) for x in t_nb]
    t_w = [np.pad(x, ((0, 0), (0, dt - x.shape[1]))) for x in t_w]

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    def split(x):
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
        return t(x.reshape((n_gs, rows) + x.shape[1:]))

    def rep(x):
        return t(np.tile(x.cpu().numpy()[None], (n_gs, 1)))

    return ShardedRegionLaplacian(
        neighbors=split(nb), nbr_w=split(w_full),
        t_neighbors=t(np.stack(t_nb)), t_w=t(np.stack(t_w)),
        label=split(rl.label), vert_valid=split(rl.vert_valid),
        inv_count=rep(rl.inv_count), weights=rep(rl.weights),
        row_start=torch.as_tensor(np.arange(n_gs, dtype=np.int32) * rows))
