"""The (dp, gs) rank mesh of sharded training (port of
sings_tpu/dist/shard.py).

The JAX package runs one controller over all devices of a Mesh; here,
as PyTorch does it, every rank is a process of one torch.distributed
process group and holds its own copy of the replicated state. The two
axes are the JAX package's:

  dp  independent frames: each dp rank trains on its own frame of the
      step, the gradients are averaged over dp;
  gs  the gaussian axis for decoding (each rank decodes capacity / gs
      slots, the posed gaussians meet in one all_gather) and the image
      axis for rasterisation (each rank renders a horizontal strip
      through a principal-point-shifted camera, camera_strip).

Ranks lie row-major on the mesh, as np.array(devs).reshape(dp, gs)
lays out JAX's devices. Deviations from the JAX signatures:
  * make_mesh returns a Mesh of this rank's coordinates and process
    groups; every process of the group must call it (dist.new_group is
    collective);
  * replicate(tree, mesh) broadcasts the mesh's first rank's tensors,
    and shard_batch(batch, mesh) picks this rank's frame of a
    dp-leading batch: each rank holds its own copies;
  * make_sharded_step's function takes this rank's frame.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.graphics import Camera
from ..train.step import grad_leaves, leaf_grads
from ..tree import tree_map
from .collectives import broadcast_tree, pmean, world_rank, world_size

# the step generators' seed stride between dp ranks (the JAX package
# folds the dp index into the step key)
DP_SEED_STRIDE = 7919


class Mesh(NamedTuple):
    """This rank's place on a (dp, gs) mesh of process-group ranks.

    ranks: (dp, gs) global ranks; dp_idx / gs_idx this rank's row and
    column; group all the mesh's ranks, gs_group this rank's row (the
    ranks that share its frame), dp_group its column. A group is None
    when it holds one rank (every collective then is the identity)."""

    ranks: np.ndarray
    dp_idx: int
    gs_idx: int
    group: Any
    gs_group: Any
    dp_group: Any

    @property
    def shape(self) -> dict:
        dp, gs = self.ranks.shape
        return {"dp": dp, "gs": gs}

    @property
    def dp(self) -> int:
        return self.ranks.shape[0]

    @property
    def gs(self) -> int:
        return self.ranks.shape[1]


def _new_group(ranks: list):
    """A process group over ranks (called on every process), None for
    a single rank."""
    if len(ranks) == 1:
        return None
    if len(ranks) == world_size():
        return dist.group.WORLD
    return dist.new_group(ranks)


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              ranks=None) -> Mesh | None:
    """A (dp, gs) mesh over the first n_devices ranks of the process
    group (or the given ranks); dp defaults as in the JAX package
    (half the ranks, rounded down to a divisor). Every process calls it;
    a process outside the mesh gets None."""
    n = n_devices or (len(ranks) if ranks is not None else world_size())
    ranks = list(range(n)) if ranks is None else list(ranks)
    if len(ranks) != n or max(ranks) >= world_size():
        raise ValueError(f"a mesh of {n} ranks over {ranks}: the process "
                         f"group has {world_size()}")
    if dp is None:
        dp = max(1, n // 2) if n > 1 else 1
        while n % dp:
            dp -= 1
    if n % dp:
        raise ValueError(f"dp={dp} does not divide {n} ranks")
    gs = n // dp
    grid = np.asarray(ranks, np.int64).reshape(dp, gs)
    group = _new_group(ranks)
    rows = [_new_group(grid[d].tolist()) for d in range(dp)]
    cols = [_new_group(grid[:, g].tolist()) for g in range(gs)]
    me = world_rank()
    if me not in ranks:
        return None
    d, g = (int(v[0]) for v in np.nonzero(grid == me))
    return Mesh(ranks=grid, dp_idx=d, gs_idx=g, group=group,
                gs_group=rows[d], dp_group=cols[g])


def camera_strip(camera: Camera, y0: int, h: int) -> Camera:
    """Sub-camera rendering image rows [y0, y0 + h).

    The pixel shift folds into the projection column that produces the
    clip-space y: clip_y' = a clip_y + b clip_w with a = H / h and
    b = (H - h - 2 y0) / h, so that ndc'_y maps row y0 to the strip's
    first row. The focal length in pixels stays: tan_fovy scales by
    h / H, and the projection's tangent clamps keep the full image's."""
    hh = camera.height
    a = hh / h
    b = (hh - h - 2.0 * y0) / h
    proj = camera.proj.clone()
    proj[:, 1] = a * camera.proj[:, 1] + b * camera.proj[:, 3]
    return Camera(
        view=camera.view, proj=proj, cam_center=camera.cam_center,
        height=h, width=camera.width, tan_fovx=camera.tan_fovx,
        tan_fovy=camera.tan_fovy * h / hh,
        clamp_tan_fovx=(camera.tan_fovx if camera.clamp_tan_fovx is None
                        else camera.clamp_tan_fovx),
        clamp_tan_fovy=(camera.tan_fovy if camera.clamp_tan_fovy is None
                        else camera.clamp_tan_fovy))


def make_sharded_step(mesh: Mesh, loss_strip_fn, n_strips: int):
    """Wrap a per-strip loss into a dp x gs sharded gradient step.

    loss_strip_fn(params, frame, strip_idx) -> this rank's scalar loss
    on its strip of its frame. Returns f(params, frame) -> (loss,
    grads), both averaged over the mesh (the JAX package's pmean over
    dp and gs) and equal on every rank; params is a tree of tensors."""
    if mesh.gs != n_strips:
        raise ValueError(f"{n_strips} strips on a mesh of gs={mesh.gs}")

    def step(params, frame):
        p = grad_leaves(params)
        loss = loss_strip_fn(p, frame, mesh.gs_idx)
        grad_tree, _ = leaf_grads(loss, p)
        return (pmean(loss, mesh.group),
                tree_map(lambda g: pmean(g, mesh.group), grad_tree))

    return step


def replicate(tree: Any, mesh: Mesh):
    """The mesh's first rank's tensors on every rank, bit for bit."""
    return broadcast_tree(tree, mesh.group)


def shard_batch(tree: Any, mesh: Mesh):
    """This rank's frame of a batch whose arrays lead with dp."""
    return {k: v[mesh.dp_idx] for k, v in tree.items()}


def dp_generator(seed: int, mesh: Mesh | None, device) -> torch.Generator:
    """The step generator of this rank's dp row: one per dp rank, the
    same on every gs rank of it (the seed itself at dp 0)."""
    d = 0 if mesh is None else mesh.dp_idx
    return torch.Generator(device=device).manual_seed(
        int(seed) + DP_SEED_STRIDE * d)


def balanced_strip_bounds(row_weight, n_gs: int, tile: int = 16,
                          pad_mult: float = 1.0):
    """Tile-aligned strip boundaries equalising per-rank work.

    row_weight: (H,) nonnegative per-pixel-row work proxy (the training
    masks' row sums). Greedy cuts at the k/n_gs quantiles of the
    cumulative weight, constrained so that every strip owns >= 1 tile
    row. Returns (bounds np.int32 (n_gs + 1,) pixel rows, strip_h_max)
    with strip_h_max the tallest strip rounded up to the tile (scaled by
    pad_mult headroom first)."""
    row_weight = np.asarray(row_weight, np.float64)
    h = len(row_weight)
    assert h % tile == 0, "image height must be tile-aligned"
    nt = h // tile
    assert nt >= n_gs, "fewer tile rows than ranks"
    per_tile = row_weight.reshape(nt, tile).sum(axis=1) + 1e-9
    cum = np.concatenate([[0.0], np.cumsum(per_tile)])
    total = cum[-1]
    cuts = [0]
    for k in range(1, n_gs):
        target = total * k / n_gs
        r = int(np.searchsorted(cum, target))
        # the tile-row cut whose cumulative weight is closest to the
        # quantile, leaving >= 1 tile row per strip
        best = min((max(r - 1, 1), r),
                   key=lambda c: abs(cum[min(c, nt)] - target))
        cuts.append(int(np.clip(best, cuts[-1] + 1, nt - (n_gs - k))))
    cuts.append(nt)
    bounds = np.asarray(cuts, np.int64) * tile
    heights = np.diff(bounds)
    strip_h_max = int(-(-int(heights.max() * pad_mult) // tile) * tile)
    return bounds.astype(np.int32), min(strip_h_max, h)
