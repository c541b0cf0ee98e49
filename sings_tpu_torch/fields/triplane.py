"""Multi-resolution triplane feature field (port of
sings_tpu/fields/triplane.py).

3 axis-aligned planes x len(multires) scales; bilinear sampling with
border padding and align_corners=True; Hadamard product over the three
planes of a scale; concatenation over scales. Parameters are the JAX
pytree {"grids": [[plane_xy, plane_xz, plane_yz], ...]} of (C, H, W)
tensors.

Gradients are PyTorch autograd of the forward (a scatter-add into the
grids; the JAX package's custom backward is a sorted segment reduction
of the same sums). Two forward paths, as in JAX:
  * nested (cfg.nested and power-of-two cell towers): each orientation
    is located once at the finest level; level l's cell is the fine
    cell shifted right by its level shift. This is the row that JAX's
    combined corner table (_nested_gather) holds at the fine cell, read
    from the level's own corner table instead of a broadcast copy.
  * plain: one grid_sample_2d per plane.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple, Sequence

import torch

from ..ops.sampling import (
    _combine, _corner_coords, _corner_table, _weights, grid_sample_2d,
)


class TriplaneConfig(NamedTuple):
    resolution: Sequence[int] = (64, 64, 64)
    out_dim: int = 32
    multires: Sequence[int] = (1, 2, 4)
    bounds: float = 1.0
    # grids carry resolution*mult + 1 points so cells nest across scales
    nested: bool = False

    @property
    def feat_dim(self):
        return self.out_dim * len(self.multires)


# axis pairs per plane: (0,1) -> xy, (0,2) -> xz, (1,2) -> yz
COO_COMBS = list(itertools.combinations(range(3), 2))


def plane_shapes(cfg: TriplaneConfig) -> list[list[tuple]]:
    """(C, H=reso[b]*mult(+1), W=reso[a]*mult(+1)) per scale and plane."""
    extra = 1 if cfg.nested else 0
    return [[(cfg.out_dim, cfg.resolution[b] * mult + extra,
              cfg.resolution[a] * mult + extra) for (a, b) in COO_COMBS]
            for mult in cfg.multires]


def init_triplane(generator: torch.Generator, cfg: TriplaneConfig,
                  device="cpu") -> dict:
    """Uniform [0.1, 0.5) init like the reference."""
    grids = []
    for shapes in plane_shapes(cfg):
        planes = []
        for shape in shapes:
            u = torch.rand(shape, generator=generator, dtype=torch.float32)
            planes.append((0.1 + 0.4 * u).to(device))
        grids.append(planes)
    return {"grids": grids}


def normalize_aabb(pts: torch.Tensor, bounds: float) -> torch.Tensor:
    """Map [-bounds, bounds] -> [-1, 1] with the reference's aabb =
    [[b,b,b], [-b,-b,-b]] sign quirk: (pts - b) * (2 / (-2b)) - 1."""
    return (pts - bounds) * (2.0 / (-2.0 * bounds)) - 1.0


def _nestable(grids, multires) -> bool:
    """True when every plane's CELL grid is a power-of-two 2x tower."""
    def pow2(v):
        return v > 0 and (v & (v - 1)) == 0

    s = len(multires)
    if len(grids) != s or any(len(p) != 3 for p in grids):
        return False
    for o in range(3):
        cells = [(grids[l][o].shape[1] - 1, grids[l][o].shape[2] - 1)
                 for l in range(s)]
        if not all(pow2(cy) and pow2(cx) for cy, cx in cells):
            return False
        for l in range(1, s):
            if cells[l] != (2 * cells[l - 1][0], 2 * cells[l - 1][1]):
                return False
    return True


def _nested_samples(grids, q: torch.Tensor) -> list:
    """Per-plane samples, scale-major plane order."""
    s_scales = len(grids)
    samples = [None] * (3 * s_scales)
    for o, (a, b) in enumerate(COO_COMBS):
        coords = q[:, (a, b)]
        _, hf, wf = grids[-1][o].shape
        x0f, y0f, _, _ = _corner_coords(coords, hf, wf)
        for l in range(s_scales):
            plane = grids[l][o]
            c, h, w = plane.shape
            shift = ((wf - 1) // (w - 1)).bit_length() - 1
            cell = (y0f >> shift) * (w - 1) + (x0f >> shift)
            v = _corner_table(plane)[cell].reshape(-1, 4, c)
            _, _, tx, ty = _corner_coords(coords, h, w)
            samples[l * 3 + o] = _combine(v, _weights(tx, ty))
    return samples


def triplane_features(params: dict, pts: torch.Tensor,
                      cfg: TriplaneConfig) -> torch.Tensor:
    """(N, 3) points -> (N, feat_dim) features."""
    q = normalize_aabb(pts, cfg.bounds)
    grids = params["grids"]
    if cfg.nested and _nestable(grids, cfg.multires):
        samples = _nested_samples(grids, q)
        return torch.cat(
            [samples[3 * s] * samples[3 * s + 1] * samples[3 * s + 2]
             for s in range(len(grids))], dim=-1)
    outs = []
    for planes in grids:
        interp = 1.0
        for plane, (a, b) in zip(planes, COO_COMBS):
            interp = interp * grid_sample_2d(plane, q[:, (a, b)])
        outs.append(interp)
    return torch.cat(outs, dim=-1)
