"""Regularisation losses (port of sings_tpu/losses/regularizers.py).

Every term works on the padded static buffers with an `alive` mask:
  * l2_norm_loss: xyz-offset norm, scale spread, above-threshold scales,
    below-threshold opacity;
  * edge_stat / gaussians_edge_loss{,_from_stat}: scale against the
    mean distance to the K-1 nearest neighbours (a detached statistic);
  * mesh_edge_loss: mean squared edge length;
  * RegionLaplacian: the per-region uniform graph laplacian of the
    anchor mesh as one padded neighbour table (build_region_laplacian
    runs on the host after each topology change).

The laplacian is the JAX package's "gather" backend: the forward is a
neighbour gather and its gradient is PyTorch's autograd of it (a
scatter-add, where JAX uses a custom transposed gather; the same sums
in another order). The "banded" backend of the JAX package, a layout of
the same matvec for the TPU's matrix unit, is not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.knn import knn


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
def edge_stat(xyz_canon: torch.Tensor, alive: torch.Tensor,
              k: int = 9) -> torch.Tensor:
    """Per-gaussian mean distance to its K-1 nearest live neighbours,
    (N,), detached (dense exact KNN; idx 0 is the point itself)."""
    dists, _ = knn(xyz_canon, k, valid=alive > 0)
    return torch.sqrt(torch.clamp_min(dists[:, 1:], 1e-24)).mean(dim=1)


def gaussians_edge_loss_from_stat(stat: torch.Tensor, scales: torch.Tensor,
                                  alive: torch.Tensor) -> torch.Tensor:
    """mean (scale_i - stat_i)^2 over alive gaussians."""
    err = (scales[:, 0] - stat) ** 2 * alive
    return err.sum() / torch.clamp_min(alive.sum(), 1.0)


def gaussians_edge_loss(xyz_canon: torch.Tensor, scales: torch.Tensor,
                        alive: torch.Tensor, k: int = 9) -> torch.Tensor:
    """mean (scale_i - mean KNN edge length)^2, dense KNN."""
    return gaussians_edge_loss_from_stat(edge_stat(xyz_canon, alive, k=k),
                                         scales, alive)


def mesh_edge_loss(verts: torch.Tensor, edges: torch.Tensor,
                   edge_valid: torch.Tensor) -> torch.Tensor:
    """mean squared edge length over valid (non-padded) edges."""
    e = edges.long()
    d = verts[e[:, 0]] - verts[e[:, 1]]
    sq = torch.sum(d * d, dim=1) * edge_valid
    return sq.sum() / torch.clamp_min(edge_valid.sum(), 1.0)


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
        label = self.label.long()
        outs = []
        f0 = 0
        for x, region_weights, regions in terms:
            f = x.shape[-1]
            lxi = lx[:, f0: f0 + f]
            f0 += f
            per_v = torch.sum(lxi * lxi, dim=-1) * self.vert_valid
            w = self.weights if region_weights is None else region_weights
            wv = (w * self.inv_count)[label] / f
            if regions is not None:
                sel = torch.zeros_like(label, dtype=torch.bool)
                for r in regions:
                    sel = sel | (label == r)
                wv = wv * sel.to(x.dtype)
            outs.append(torch.sum(per_v * wv))
        return outs


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
