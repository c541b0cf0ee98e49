"""Multi-avatar ("case") training on one card (port of
sings_tpu/dist/train_cases.py at gs = 1).

C independent avatars train in lockstep: every per-case quantity
(params, buffers, optimizer state, canonical-pose cache, camera, region
laplacians, frames) is stacked on a leading case axis, and one call of
the case step updates every case. The JAX package shards that axis over
a (case, gs) device mesh and runs one shard_map program; here the C
per-case steps run one after the other on the one card, each the
port's single-card step (train/step.py) on that case's slice, and their
outputs are stacked again. There is no vmap: the composite and triplane
kernels are hand-written CUDA launches.

As in the JAX package's case step (dist/train_sharded.py::
make_frame_loss), the KNN edge statistic is the exact one whatever the
case's tpu.knn_backend says. The gs axis (strips of one image over
several devices) and the region-laplacian row split are not ported:
gs > 1 raises.
"""
from __future__ import annotations

import torch

from ..model.avatar import AvatarConfig
from ..ops.graphics import Camera
from ..train.step import StepConfig, make_train_step
from ..tree import tree_map

GS_TODO = ("the case pool's gs axis (gs > 1: strips of each case's image "
           "over several devices) is not ported; it comes with queue A "
           "item 4 of ROADMAP.md (dist/shard.py, dist/halo.py, "
           "dist/train_sharded.py)")


def stack_cases(trees):
    """Stack a list of per-case trees on a new leading case axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def pick_case(tree, c: int):
    """Case c's slice of a stacked tree."""
    return tree_map(lambda x: x[c], tree)


def camera_arrays(camera: Camera) -> dict:
    """The camera's array fields (height and width stay host ints).

    view, proj and cam_center are float32 as in the JAX package; the
    two tangents are float64 0-d tensors, so that a case's rebuilt
    camera carries the same Python floats as the original one and its
    step equals the single-card step bit for bit."""
    dev = camera.view.device
    return {
        "view": camera.view.to(torch.float32),
        "proj": camera.proj.to(torch.float32),
        "cam_center": camera.cam_center.to(torch.float32),
        "tan_fovx": torch.tensor(camera.tan_fovx, dtype=torch.float64,
                                 device=dev),
        "tan_fovy": torch.tensor(camera.tan_fovy, dtype=torch.float64,
                                 device=dev),
    }


def shard_cases(tree, device):
    """The stacked tree on the one device (the JAX package places the
    case axis over the mesh's "case" axis)."""
    return tree_map(lambda x: x.to(device), tree)


def make_case_train_step(avatar_cfg: AvatarConfig, step_cfg: StepConfig,
                         template, height: int, width: int, tx,
                         lpips_params, raster_kw: dict, gs: int = 1):
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
    """
    if gs != 1:
        raise NotImplementedError(f"gs={gs}: {GS_TODO}")
    body = make_train_step(
        avatar_cfg, step_cfg._replace(knn_backend="dense"), template, None,
        tx, lpips_params, raster_kw)

    def step(params, buffers, opt_states, caches, cam_arrays, batch,
             generators, step_idx: int, active_sh_degree: int,
             region_lap_pos, region_lap_color, lap_pos_w, lap_color_w,
             draws=None):
        outs = []
        for c in range(len(generators)):
            cam = pick_case(cam_arrays, c)
            camera = Camera(
                view=cam["view"], proj=cam["proj"],
                cam_center=cam["cam_center"], height=height, width=width,
                tan_fovx=float(cam["tan_fovx"]),
                tan_fovy=float(cam["tan_fovy"]))
            frame = {k: v[c] for k, v in batch.items()}
            p, b, o, m, _ = body(
                pick_case(params, c), pick_case(buffers, c),
                pick_case(opt_states, c), pick_case(caches, c), frame,
                generators[c], int(step_idx), int(active_sh_degree),
                pick_case(region_lap_pos, c), pick_case(region_lap_color, c),
                lap_pos_w, lap_color_w,
                draws=None if draws is None else draws[c], camera=camera)
            outs.append((p, b, o, m))
        params, buffers, opt_states, metrics = (
            stack_cases([o[i] for o in outs]) for i in range(4))
        return params, buffers, opt_states, metrics

    return step
