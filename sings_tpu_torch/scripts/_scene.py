"""The bench scene of the backward experiments (scripts/exp_bwd_moments.py
:232-262 and scripts/exp_bwd_variants.py:42-69): n gaussians in front
of an identity camera, the composite kernels' inputs and forward output.

Draws come from np.random.RandomState(seed) in the scripts' order
(means x, y, z; scales; opacities; colours; then the cotangents), so the
JAX package can build the same scene from the same draws.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.graphics import make_camera
from ..ops.rasterizer.api import _gather_feats
from ..ops.rasterizer.common import preprocess
from ..ops.rasterizer.kernels import composite_fwd
from ..ops.rasterizer.tiles import TileBinning, bin_gaussians
from ..ops.sh import rgb2sh

N, HW, TILE, CHUNK, MAX_SPAN, MAX_PAIRS = 50_000, 512, 16, 128, 3, 262_144


class BenchScene(NamedTuple):
    feats: torch.Tensor
    binning: TileBinning
    fwd_out: torch.Tensor
    gout: torch.Tensor
    kw: dict  # tile, chunk, n_tiles_x, n_tiles_y, grad_cap

    @property
    def args(self) -> tuple:
        """The backward kernels' positional arguments."""
        b = self.binning
        return (self.feats, b.tile_offsets, b.grad_offsets, self.fwd_out,
                self.gout)


def scene_draws(n: int, seed: int):
    """(means, scales, quats, opacities, shs) as float32 numpy arrays,
    and the generator, ready for the cotangents' draw."""
    rng = np.random.RandomState(seed)
    means = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n),
                      rng.uniform(2.0, 6.0, n)], -1).astype(np.float32)
    scales = rng.uniform(0.004, 0.02, (n, 3)).astype(np.float32)
    quats = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))
    opac = rng.uniform(0.2, 1.0, n).astype(np.float32)
    rgb = rng.rand(n, 3).astype(np.float32)
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0, :] = rgb2sh(torch.from_numpy(rgb)).numpy()
    return (means, scales, quats, opac, shs), rng


def bench_scene(device, *, n: int = N, hw: int = HW, seed: int = 0,
                gout: str = "rand") -> BenchScene:
    """preprocess -> bin_gaussians -> _gather_feats -> composite_fwd on
    `device`. gout "rand": rand * 0.1 with rows 4-7 zeroed
    (exp_bwd_moments.py); "ones" (exp_bwd_variants.py)."""
    arrays, rng = scene_draws(n, seed)
    ntx = nty = -(-hw // TILE)
    cam = make_camera(np.eye(4), height=hw, width=hw, fovx=0.9, fovy=0.9,
                      device=device)
    means, scales, quats, opac, shs = (torch.from_numpy(a).to(device)
                                       for a in arrays)
    g = preprocess(means, scales, quats, opac, shs, cam, sh_degree=3,
                   tile=TILE)
    b = bin_gaussians(g, tile=TILE, n_tiles_x=ntx, n_tiles_y=nty,
                      max_span=MAX_SPAN, align=CHUNK, max_pairs=MAX_PAIRS)
    feats = _gather_feats(b, g.means2d, g.conics, g.colors, g.opacities,
                          CHUNK)
    kw = dict(tile=TILE, chunk=CHUNK, n_tiles_x=ntx, n_tiles_y=nty)
    fwd = composite_fwd(feats, b.tile_offsets, **kw)
    npx = TILE * TILE
    if gout == "rand":
        g_np = rng.rand(ntx * nty, 8, npx).astype(np.float32) * 0.1
        g_np[:, 4:, :] = 0.0
    elif gout == "ones":
        g_np = np.ones((ntx * nty, 8, npx), np.float32)
    else:
        raise ValueError(f"gout {gout!r}: 'rand' or 'ones'")
    return BenchScene(feats, b, fwd, torch.from_numpy(g_np).to(device),
                      dict(kw, grad_cap=b.pair_slot_capacity))


def written_slots(binning: TileBinning) -> torch.Tensor:
    """The slots the un-sort tables read, minus the spare slot: what the
    backward kernels write (exp_bwd_moments.py:270-272)."""
    slots = torch.unique(torch.cat([binning.main_slot.reshape(-1),
                                    binning.tail_slot.reshape(-1)]).long())
    return slots[slots < binning.pair_slot_capacity - 1]
