"""Multi-avatar ("case") training (port of sings_tpu/dist/train_cases.py).

C independent avatars train in lockstep: every per-case quantity
(params, buffers, optimizer state, canonical-pose cache, camera, region
laplacians, frames) is stacked on a leading case axis, and one call of
the case step updates every case. The JAX package shards that axis over
a (case, gs) device mesh and runs one shard_map program; here the C
per-case steps run one after the other, and their outputs are stacked
again. There is no vmap: the composite and triplane kernels are
hand-written CUDA launches. At gs = 1 each case's step is the port's
single-card step (train/step.py) on that case's slice. At gs > 1 the
process group's gs ranks split every case's step as the sharded step
splits one frame (dist/train_sharded.py at dp 1): each rank decodes its
capacity / gs slots and renders its strip of every case's image in
turn, and the region laplacians are each rank's row range
(ShardedRegionLaplacian, one transposed-table width across cases).

As in the JAX package's case step (dist/train_sharded.py::
make_frame_loss), the KNN edge statistic is the exact one whatever the
case's tpu.knn_backend says. The restacking of the cases' outputs after
every step runs in the ops/profiling.py span pool.stack.
"""
from __future__ import annotations

import torch

from ..model.avatar import AvatarConfig
from ..ops.graphics import Camera
from ..ops.profiling import span
from ..train.step import StepConfig, make_train_step
from ..tree import tree_map
from .collectives import world_size
from .shard import Mesh, make_mesh
from .train_sharded import make_sharded_train_step


def stack_cases(trees):
    """Stack a list of per-case trees on a new leading case axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def pick_case(tree, c: int):
    """Case c's slice of a stacked tree."""
    return tree_map(lambda x: x[c], tree)


def camera_arrays(camera: Camera) -> dict:
    """The camera's array fields (height and width stay host ints).

    view, proj and cam_center are float32 as in the JAX package; the
    two tangents are float64 0-d tensors on the host, so that a case's
    rebuilt camera carries the same Python floats as the original one
    (its step equals the single-card step bit for bit) and reading them
    never waits for the card (shard_cameras keeps them there)."""
    return {
        "view": camera.view.to(torch.float32),
        "proj": camera.proj.to(torch.float32),
        "cam_center": camera.cam_center.to(torch.float32),
        "tan_fovx": torch.tensor(camera.tan_fovx, dtype=torch.float64),
        "tan_fovy": torch.tensor(camera.tan_fovy, dtype=torch.float64),
    }


def make_case_mesh(n_cases: int, gs: int = 1) -> Mesh | None:
    """The gs ranks that split every case's step: a (dp 1, gs) mesh over
    the process group, whose size must be gs (the case axis is a loop
    on every rank, not a mesh axis). Every process calls it; None at
    gs = 1."""
    if gs == 1:
        return None
    if world_size() != gs:
        raise ValueError(f"gs={gs} needs a process group of {gs} ranks "
                         f"(one per strip), it has {world_size()}")
    return make_mesh(gs, dp=1)


def shard_cases(tree, device):
    """The stacked tree on the one device (the JAX package places the
    case axis over the mesh's "case" axis)."""
    return tree_map(lambda x: x.to(device), tree)


def shard_cameras(cam_arrays: dict, device) -> dict:
    """Stacked camera_arrays for the case step: the matrices on the one
    device, the tangents left on the host, where each case step reads
    them (_case_camera) without waiting for the card."""
    return {k: v if k in ("tan_fovx", "tan_fovy") else v.to(device)
            for k, v in cam_arrays.items()}


def make_case_train_step(avatar_cfg: AvatarConfig, step_cfg: StepConfig,
                         template, height: int, width: int, tx,
                         lpips_params, raster_kw: dict, gs: int = 1,
                         mesh: Mesh | None = None):
    """Build step(params, buffers, opt_states, caches, cam_arrays, batch,
    generators, step_idx, active_sh_degree, region_lap_pos,
    region_lap_color, lap_pos_w, lap_color_w, draws=None)
      -> (params, buffers, opt_states, metrics).

    Every argument but generators, draws, step_idx, active_sh_degree and
    lap_*_w leads with the case axis (stack_cases); the outputs keep it
    and metrics are (C,) tensors. batch: 'rgb' (C, 3, H, W), 'mask'
    (C, H, W), 'idx' a sequence of C ints or a (C,) tensor, optional
    'smpl_scale' (C, 1). generators: one torch.Generator per case.
    draws: optional list of per-case draw dicts (draw_step_randoms'
    layout). The template and the laplacian weight vectors are shared.

    gs > 1: this rank's part of every case's step over the mesh's gs
    group (make_case_mesh(n_cases, gs) when mesh is None; every rank
    calls the step with the same arguments); region_lap_* are then
    stacked ShardedRegionLaplacian rows of this rank (shard(gs_idx) of
    each case's), and every output is equal on every rank.
    """
    if gs > 1:
        return _sharded_case_step(avatar_cfg, step_cfg, template, height,
                                  width, tx, lpips_params, raster_kw,
                                  mesh or make_case_mesh(0, gs), gs)
    body = make_train_step(
        avatar_cfg, step_cfg._replace(knn_backend="dense"), template, None,
        tx, lpips_params, raster_kw)

    def step(params, buffers, opt_states, caches, cam_arrays, batch,
             generators, step_idx: int, active_sh_degree: int,
             region_lap_pos, region_lap_color, lap_pos_w, lap_color_w,
             draws=None):
        outs = []
        for c in range(len(generators)):
            frame = {k: v[c] for k, v in batch.items()}
            p, b, o, m, _ = body(
                pick_case(params, c), pick_case(buffers, c),
                pick_case(opt_states, c), pick_case(caches, c), frame,
                generators[c], int(step_idx), int(active_sh_degree),
                pick_case(region_lap_pos, c), pick_case(region_lap_color, c),
                lap_pos_w, lap_color_w,
                draws=None if draws is None else draws[c],
                camera=_case_camera(cam_arrays, c, height, width))
            outs.append((p, b, o, m))
        return _restack(outs)

    return step


def _restack(outs: list) -> tuple:
    """The cases' (params, buffers, opt_state, metrics) stacked again on
    the case axis, in the pool.stack span."""
    with span("pool.stack"):
        return tuple(stack_cases([o[i] for o in outs]) for i in range(4))


def _case_camera(cam_arrays, c: int, height: int, width: int) -> Camera:
    cam = pick_case(cam_arrays, c)
    return Camera(view=cam["view"], proj=cam["proj"],
                  cam_center=cam["cam_center"], height=height, width=width,
                  tan_fovx=float(cam["tan_fovx"]),
                  tan_fovy=float(cam["tan_fovy"]))


def _sharded_case_step(avatar_cfg, step_cfg, template, height, width, tx,
                       lpips_params, raster_kw, mesh: Mesh, gs: int):
    """The case step at gs > 1: each case's sharded step at (dp 1, gs),
    one case after another."""
    if mesh.gs != gs or mesh.dp != 1:
        raise ValueError(f"a case step of gs={gs} on a mesh of "
                         f"{mesh.shape}")
    body = make_sharded_train_step(
        mesh, avatar_cfg, step_cfg, template, None, tx, lpips_params,
        raster_kw, height=height, width=width)

    def step(params, buffers, opt_states, caches, cam_arrays, batch,
             generators, step_idx: int, active_sh_degree: int,
             region_lap_pos, region_lap_color, lap_pos_w, lap_color_w,
             draws=None):
        outs = []
        for c in range(len(generators)):
            frame = {k: v[c] for k, v in batch.items()}
            outs.append(body(
                pick_case(params, c), pick_case(buffers, c),
                pick_case(opt_states, c), pick_case(caches, c), frame,
                generators[c], int(step_idx), int(active_sh_degree),
                pick_case(region_lap_pos, c), pick_case(region_lap_color, c),
                lap_pos_w, lap_color_w,
                draws=None if draws is None else draws[c],
                camera=_case_camera(cam_arrays, c, height, width)))
        return _restack(outs)

    return step
