"""Multi-resolution triplane feature field (port of
sings_tpu/fields/triplane.py).

3 axis-aligned planes x len(multires) scales; bilinear sampling with
border padding and align_corners=True; Hadamard product over the three
planes of a scale; concatenation over scales. Parameters are the JAX
pytree {"grids": [[plane_xy, plane_xz, plane_yz], ...]} of (C, H, W)
tensors.

Three paths, as in JAX (triplane_features(..., fused=)), each with
the JAX package's custom backward:
  * nested (fused, cfg.nested and power-of-two cell towers):
    _TriplaneNested (JAX's _triplane_nested). Each orientation is
    located once at the finest level; level l's cell is the fine cell
    shifted right by its level shift. This is the row that JAX's
    combined corner table (_nested_gather) holds at the fine cell, read
    from the level's own corner table instead of a broadcast copy. The
    grid gradients of all levels of an orientation come from one
    Morton-keyed sort (ops/grid_grad.py, "morton" groups).
  * fused (every plane h, w >= 2): _TriplaneFused (JAX's
    _triplane_fused), one combined key plane base + cell and one
    reduction over all planes ("cells" group).
  * fused=False: one grid_sample_2d per plane (its own _SampleGrid).
The fused and nested backwards are ops/grid_grad.py::triplane_backward
(the product rule over each scale's Hadamard product, the coordinate
and the grid gradients in one CUDA kernel on the card, its plain
version on the CPU). Their forwards keep q, the planes, the per-plane
samples (N, C) and the sort keys: no (N, 4, C) corner rows.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple, Sequence

import torch

from ..ops import grid_grad as GG
from ..ops.bilinear import _combine, _corner_coords, _corner_table, _weights
from ..ops.sampling import _sample_main, grid_sample_2d


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


def _fused_out(samples: list) -> torch.Tensor:
    return torch.cat([samples[3 * s] * samples[3 * s + 1] * samples[3 * s + 2]
                      for s in range(len(samples) // 3)], dim=-1)


def fused_forward(meta: tuple, q: torch.Tensor, grids) -> tuple:
    """Every plane sampled on its own (JAX's _fused_samples); one
    combined key, plane base + cell. Returns (features, GG.Saved)."""
    samples, cells = [], []
    base = 0
    for plane, (a, b, h, w) in zip(grids, meta):
        out, _v, cell, _tx, _ty = _sample_main(plane, q[:, (a, b)])
        samples.append(out)
        cells.append(cell + base)
        base += (h - 1) * (w - 1)
    layout = GG.Layout(planes=tuple((h, w) for (_a, _b, h, w) in meta),
                       groups=(GG.Group("cells", tuple(range(len(meta)))),))
    return _fused_out(samples), GG.Saved(
        samples, [torch.cat(cells).to(torch.int32)], layout)


def nested_forward(meta: tuple, q: torch.Tensor, grids) -> tuple:
    """Power-of-two cell towers: each orientation located once at the
    finest level, level l's cell the fine cell shifted; one Morton key
    per orientation. Returns (features, GG.Saved)."""
    s_scales = len(meta) // 3
    samples = [None] * len(meta)
    keys, groups = [], []
    for o in range(3):
        a, b, hf, wf = meta[(s_scales - 1) * 3 + o]
        coords = q[:, (a, b)]
        x0f, y0f, _, _ = _corner_coords(coords, hf, wf)
        shifts = []
        for l in range(s_scales):
            i = l * 3 + o
            plane = grids[i]
            c, h, w = plane.shape
            shift = ((wf - 1) // (w - 1)).bit_length() - 1
            cell = (y0f >> shift) * (w - 1) + (x0f >> shift)
            v = _corner_table(plane)[cell].reshape(-1, 4, c)
            _, _, tx, ty = _corner_coords(coords, h, w)
            samples[i] = _combine(v, _weights(tx, ty))
            shifts.append(shift)
        keys.append(GG.morton_codes(x0f, y0f))
        groups.append(GG.Group("morton", tuple(
            l * 3 + o for l in range(s_scales)), tuple(shifts)))
    layout = GG.Layout(planes=tuple((h, w) for (_a, _b, h, w) in meta),
                       groups=tuple(groups))
    return _fused_out(samples), GG.Saved(samples, keys, layout)


class _Triplane(torch.autograd.Function):
    """The fused and nested paths as custom backwards (JAX's
    _triplane_fused and _triplane_nested): apply(meta, q, *grids), meta
    = (axis_a, axis_b, H, W) per plane, scale-major."""

    @classmethod
    def forward(cls, ctx, meta, q, *grids):
        out, saved = cls.run_forward(meta, q, grids)
        ctx.meta, ctx.layout = meta, saved.layout
        ctx.save_for_backward(q, *grids, *saved.samples, *saved.keys)
        return out

    @staticmethod
    def backward(ctx, gout):
        q, *rest = ctx.saved_tensors
        p = len(ctx.meta)
        saved = GG.Saved(rest[p:2 * p], rest[2 * p:], ctx.layout)
        dq, dgrids = GG.triplane_backward(ctx.meta, q, rest[:p], saved,
                                          gout)
        needs = ctx.needs_input_grad
        return (None, dq if needs[1] else None,
                *(g if need else None for g, need in zip(dgrids, needs[2:])))


class _TriplaneFused(_Triplane):
    run_forward = staticmethod(fused_forward)


class _TriplaneNested(_Triplane):
    run_forward = staticmethod(nested_forward)


def triplane_features(params: dict, pts: torch.Tensor, cfg: TriplaneConfig,
                      *, fused: bool = True) -> torch.Tensor:
    """(N, 3) points -> (N, feat_dim) features."""
    q = normalize_aabb(pts, cfg.bounds)
    grids = params["grids"]
    meta = tuple((a, b, p.shape[1], p.shape[2])
                 for planes in grids for p, (a, b) in zip(planes, COO_COMBS))
    flat = [p for planes in grids for p in planes]
    if fused and cfg.nested and _nestable(grids, cfg.multires):
        return _TriplaneNested.apply(meta, q, *flat)
    if fused and all(h >= 2 and w >= 2 for (_a, _b, h, w) in meta):
        return _TriplaneFused.apply(meta, q, *flat)
    outs = []
    for planes in grids:
        interp = 1.0
        for plane, (a, b) in zip(planes, COO_COMBS):
            interp = interp * grid_sample_2d(plane, q[:, (a, b)])
        outs.append(interp)
    return torch.cat(outs, dim=-1)
