"""Differentiable rasterizer API (port of sings_tpu/ops/rasterizer/api.py).

rasterize() = preprocess (autograd) -> bin_gaussians -> _gather_feats ->
composite kernel -> crop -> background blend (the binning and the
composite are CUDA kernels on the card, plain versions on the CPU), each
stage in an ops/profiling.py span (raster.*).
The composite is an autograd.Function whose backward is the matching
backward kernel: it writes per-pair gradients into the aligned buffer,
and the 9 used rows are un-sorted back to gaussians with the main_slot
/ tail_slot / tail_of_gauss gathers of bin_gaussians. The forward
kernel always walks through the window-entry state (grad_cap x 32
bytes): its windows hand each other their entry in it. When a backward
can follow (grad mode on and an input that requires grad), the forward
keeps it for the backward, which starts each window from it; a render
under no_grad drops it with the forward.

Two layouts, as in the JAX package (RasterConfig.layout):
  * "tiled": composite_fwd writes (T, 8, npx) tile rows, relaid out to
    the image; the cotangents are re-tiled for composite_bwd;
  * "panel": composite_fwd(pw=panel_width) writes (4, Hp, Wp) image
    planes that are only cropped; the cotangents are zero-padded to the
    planes for composite_bwd(pw=panel_width).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..graphics import Camera
from ..profiling import span
from .common import Gaussians2D, preprocess
from .kernels import (
    N_USED, NFEAT, composite_bwd, composite_fwd, panel_width,
)
from .reference import composite_dense
from .tiles import TileBinning, bin_gaussians


class RasterConfig(NamedTuple):
    height: int
    width: int
    tile: int = 16
    chunk: int = 128
    max_span: int = 5
    max_pairs: int | None = None
    main_width: int = 6
    tail_capacity: int | None = None
    cull: bool = True
    pair_cap: int | None = None
    layout: str = "tiled"
    # the render owns only its first valid_rows pixel rows (balanced
    # strips of sharded training): tile rows past them bin no pairs
    row_limit: bool = False

    @property
    def panel_width(self) -> int:
        return panel_width(self.tile)


def _pad_tiles(cfg: RasterConfig):
    return -(-cfg.width // cfg.tile), -(-cfg.height // cfg.tile)


def _gather_feats(binning: TileBinning, means2d, conics, colors, opacities,
                  chunk: int) -> torch.Tensor:
    """Sorted-order pair features (NFEAT, PK + chunk); invalid pairs and
    the chunk-wide tail are zero."""
    sg = binning.sorted_gauss
    pk = sg.shape[0]
    idx = sg.clamp_min(0).long()
    valid = (sg >= 0)[:, None].to(means2d.dtype)
    feat = torch.cat([means2d, conics, colors, opacities[:, None]], dim=1)
    feats = means2d.new_zeros((NFEAT, pk + chunk))
    feats[:9, :pk] = (feat[idx] * valid).T
    return feats


def valid_tiles_y(cfg: RasterConfig, valid_rows):
    """The tile rows that hold owned pixel rows, ceil(valid_rows / tile),
    or None without a row limit."""
    if not cfg.row_limit:
        return None
    if isinstance(valid_rows, torch.Tensor):
        return torch.ceil(valid_rows / cfg.tile).to(torch.int32)
    return -(-int(valid_rows) // cfg.tile)


def prepare_composite(g2d: Gaussians2D, cfg: RasterConfig,
                      valid_rows=None):
    """Binning + pair features: the composite kernel's inputs."""
    ntx, nty = _pad_tiles(cfg)
    with span("raster.bin"):
        binning = bin_gaussians(
            g2d, tile=cfg.tile, n_tiles_x=ntx, n_tiles_y=nty,
            max_span=cfg.max_span, align=cfg.chunk, max_pairs=cfg.max_pairs,
            main_width=cfg.main_width, tail_capacity=cfg.tail_capacity,
            cull=cfg.cull, pair_cap=cfg.pair_cap,
            valid_tiles_y=valid_tiles_y(cfg, valid_rows))
    with span("raster.gather"):
        feats = _gather_feats(binning, g2d.means2d, g2d.conics, g2d.colors,
                              g2d.opacities, cfg.chunk)
    return feats, binning


def tiles_to_image(out: torch.Tensor, cfg: RasterConfig):
    """(T, 8, npx) -> colour (3, H, W) and transmittance (H, W)."""
    ntx, nty = _pad_tiles(cfg)
    t = cfg.tile
    color = out[:, :3, :].reshape(nty, ntx, 3, t, t).permute(2, 0, 3, 1, 4)
    color = color.reshape(3, nty * t, ntx * t)[:, : cfg.height, : cfg.width]
    t_final = out[:, 3, :].reshape(nty, ntx, t, t).permute(0, 2, 1, 3)
    t_final = t_final.reshape(nty * t, ntx * t)[: cfg.height, : cfg.width]
    return color, t_final


def image_to_tiles(g_color: torch.Tensor, g_t: torch.Tensor,
                   cfg: RasterConfig) -> torch.Tensor:
    """Inverse of tiles_to_image for cotangents: (3, H, W) and (H, W),
    zero-padded to whole tiles -> (T, 8, npx), rows 4-7 zero."""
    ntx, nty = _pad_tiles(cfg)
    t = cfg.tile
    hp, wp = nty * t, ntx * t
    g = g_color.new_zeros((4, hp, wp))
    g[:3, : cfg.height, : cfg.width] = g_color
    g[3, : cfg.height, : cfg.width] = g_t
    tiles = g.reshape(4, nty, t, ntx, t).permute(1, 3, 0, 2, 4).reshape(
        nty * ntx, 4, t * t)
    return torch.cat([tiles, tiles.new_zeros((nty * ntx, 4, t * t))], dim=1)


def unsort_pair_grads(pair_grads: torch.Tensor, binning: TileBinning,
                      n: int) -> torch.Tensor:
    """(9, grad_cap) per-slot gradients -> (n, 9) per gaussian: the sum
    over each gaussian's main_slot row plus its tail-table row (row TC
    of the tail sums is the zero row of gaussians without a tail)."""
    mw = binning.main_slot.shape[1]
    pg = pair_grads[:, binning.main_slot.reshape(-1).long()]
    pg = pg.reshape(N_USED, n, mw).sum(dim=2).T
    tc, tw = binning.tail_slot.shape
    if tw > 0:
        pgt = pair_grads[:, binning.tail_slot.reshape(-1).long()]
        tail_sums = torch.cat([pgt.reshape(N_USED, tc, tw).sum(dim=2).T,
                               pg.new_zeros((1, N_USED))])
        pg = pg + tail_sums[binning.tail_of_gauss.long()]
    return pg


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, want_state, valid_rows, means2d, conics, colors,
                opacities, depths, radii, mask):
        if cfg.layout not in ("tiled", "panel"):
            raise NotImplementedError(
                f"layout={cfg.layout!r}: the layouts are 'tiled' and "
                "'panel'")
        g2d = Gaussians2D(means2d=means2d, depths=depths, conics=conics,
                          colors=colors, opacities=opacities, radii=radii,
                          mask=mask)
        feats, binning = prepare_composite(g2d, cfg, valid_rows)
        ntx, nty = _pad_tiles(cfg)
        kw = dict(tile=cfg.tile, chunk=cfg.chunk, n_tiles_x=ntx,
                  n_tiles_y=nty,
                  pw=cfg.panel_width if cfg.layout == "panel" else None)
        with span("raster.composite_fwd"):
            # the kernel's windows hand each other their entry state
            # through the gradient buffer's window layout on every call;
            # the state is kept only for a backward
            res = composite_fwd(
                feats, binning.tile_offsets,
                grad_offsets=binning.grad_offsets,
                grad_cap=binning.pair_slot_capacity,
                return_state=want_state, **kw)
            out, state = res if want_state else (res, None)
            if cfg.layout == "panel":
                # (4, Hp, Wp) image planes: a crop, no relayout
                color = out[:3, : cfg.height, : cfg.width]
                t_final = out[3, : cfg.height, : cfg.width]
            else:
                color, t_final = tiles_to_image(out, cfg)
        ctx.cfg = cfg
        ctx.binning = binning
        ctx.has_state = want_state
        ctx.save_for_backward(feats, out, state)
        return color, t_final

    @staticmethod
    def backward(ctx, g_color, g_t):
        cfg, binning = ctx.cfg, ctx.binning
        if not ctx.has_state:
            raise RuntimeError("rasterize's composite ran without the "
                               "window-entry state: no backward expected")
        feats, out, state = ctx.saved_tensors
        ntx, nty = _pad_tiles(cfg)
        kw = dict(tile=cfg.tile, chunk=cfg.chunk, n_tiles_x=ntx,
                  n_tiles_y=nty, grad_cap=binning.pair_slot_capacity)
        args = (feats, binning.tile_offsets, binning.grad_offsets, out)
        with span("raster.composite_bwd"):
            if cfg.layout == "panel":
                gout = g_color.new_zeros(out.shape)
                gout[:3, : cfg.height, : cfg.width] = g_color
                gout[3, : cfg.height, : cfg.width] = g_t
                pair_grads = composite_bwd(*args, gout, state,
                                           pw=cfg.panel_width, **kw)
            else:
                pair_grads = composite_bwd(
                    *args, image_to_tiles(g_color, g_t, cfg), state, **kw)
        with span("raster.unsort"):
            pg = unsort_pair_grads(pair_grads, binning,
                                   binning.tail_of_gauss.shape[0])
        return (None, None, None, pg[:, 0:2], pg[:, 2:5], pg[:, 5:8],
                pg[:, 8], None, None, None)


def rasterize(means3d, scales, quats, opacities, features, camera: Camera,
              *, sh_degree: int = 0, bg: torch.Tensor | None = None,
              scale_modifier: float = 1.0, alive=None,
              screen_probe: torch.Tensor | None = None,
              backend: str = "pallas", tile: int = 16, chunk: int = 128,
              max_span: int = 5, max_pairs: int | None = None,
              main_width: int = 6, tail_capacity: int | None = None,
              cull: bool = True, pair_cap: int | None = None,
              layout: str = "tiled", valid_rows=None) -> dict:
    """Differentiable gaussian splatting to an image.

    backend "pallas" (the JAX package's name, kept so callers pass the
    same keywords): the tile composite in `layout` "tiled" or "panel",
    the CUDA kernels for CUDA tensors. "reference": the dense oracle. Returns {'render' (3, H, W)
    unclamped, 'radii', 'visibility_filter', 'transmittance', 'means2d'}.

    screen_probe: optional (N, 2) zeros added to the screen means as
    probe * (W/2, H/2); its gradient is the NDC-convention screen
    gradient that density control accumulates.

    valid_rows: the pixel rows this render owns (a balanced strip of
    sharded training), an int or a 0-d tensor: tile rows past them bin
    no pairs and render bg; the rows below are bit for bit the
    unrestricted render's.
    """
    if bg is None:
        bg = means3d.new_zeros(3)
    with span("raster.preprocess"):
        g2d = preprocess(means3d, scales, quats, opacities, features, camera,
                         sh_degree=sh_degree, scale_modifier=scale_modifier,
                         alive=alive, tile=tile)
        if screen_probe is not None:
            probe = torch.stack(
                [screen_probe[:, 0] * (0.5 * camera.width),
                 screen_probe[:, 1] * (0.5 * camera.height)], -1)
            g2d = g2d._replace(means2d=g2d.means2d + probe)
    if backend == "pallas":
        cfg = RasterConfig(
            height=camera.height, width=camera.width, tile=tile,
            chunk=chunk, max_span=max_span, max_pairs=max_pairs,
            main_width=main_width, tail_capacity=tail_capacity, cull=cull,
            pair_cap=pair_cap, layout=layout, row_limit=valid_rows is not None)
        inputs = (g2d.means2d, g2d.conics, g2d.colors, g2d.opacities)
        want_state = torch.is_grad_enabled() and any(
            x.requires_grad for x in inputs)
        color, t_final = _Composite.apply(
            cfg, want_state, valid_rows, *inputs, g2d.depths, g2d.radii,
            g2d.mask)
        image = color + t_final[None] * bg[:, None, None]
    elif backend == "reference":
        image, t_final = composite_dense(g2d, camera.height, camera.width, bg)
    else:
        raise ValueError(f"unknown backend {backend}")
    return {
        "render": image,
        "radii": g2d.radii,
        "visibility_filter": g2d.radii > 0,
        "transmittance": t_final,
        "means2d": g2d.means2d,
    }
