#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (sings_tpu_torch) on one card.

    python3 chip_smoke.py [--profile DIR]

Builds the hand-written CUDA kernels from sings_tpu_torch/csrc with nvcc
(one process per source, all started together) and the native mesh
library with g++, then drives the port's main paths at the full width
of the configs/human_complex.yaml avatar (synthetic SMPL-H template at
synthetic_res 2.0, two subdivisions: 102,182 gaussians in 127,744 slots;
nested 64^3 triplane, multires [1, 2, 4]; 512x512; pair_cap 4), with
weights made from seed 0: the animation render,
Trainer(cfg, mode="anim").animate_chunk, in both raster layouts; the
training step, Trainer(cfg, mode="train").train_scan, as bench.py's
recipe benchmark drives it (8 steps a chunk); and the training entry
point, python -m sings_tpu_torch.cli.train (cli.train.main with the kit
held in memory) with tpu.raster.layout=panel, resumed from a
checkpoint; the synthetic-template calibration that a default training
run starts with (Trainer(mode="train") with tpu.auto_fit_synthetic
unset) and python -m sings_tpu_torch.cli.refine; and the kernel
experiments, python -m
sings_tpu_torch.scripts.{exp_cumsum_kernel,exp_bwd_moments,
exp_bwd_variants} at their own sizes. Phases:

  1 device      torch.cuda must be available; prints the card and limit
  2 build       nvcc for sm_90a (composite_fwd.cu and composite_bwd.cu,
                each one kernel for both layouts; composite_bwd_variants.cu
                and chunk_scan_bench.cu) and g++ (mesh_native), timed
  3 setup       config from DEFAULTS + HUMAN_COMPLEX_DOTLIST, an
                in-memory 4-frame kit, a seeded 32-frame custom motion,
                a checkpoint written from the port's init_avatar,
                Trainer(mode="anim")
  4 kernels     composite_fwd in both layouts, with and without keeping
                its window-entry state, against its plain version
                (output and state) on frame 0's real inputs and on edge
                scenes (padding tiles, empty tiles, a deep stack of one
                tile of >= 40 windows that saturates mid-segment, a
                scene of single-window tiles, a saturating stack), the
                output unchanged by keeping the state, the panel planes
                and state bit for bit the tiled ones; the panel backward
                against its plain version and the tiled one on frame 0
                and on panel edge scenes (56x40 and 600 wide: padding
                sub-tiles; the saturating stack)
  5 main        animate_chunk(16 frames a chunk, 32 frames); counts
                composite_fwd launches from 0; then the same 32 frames
                with tpu.raster.layout=panel, equal to the tiled ones
                (uint8, exact), counting composite_fwd_panel launches;
                neither animation writes the window-entry state
  6 timing      CUDA-event times of composite_fwd (in turns without and
                with keeping the state) and its plain version, and the
                least time the card could take for the same work
  7 train setup config + HUMAN_COMPLEX_TRAIN_DOTLIST (the recipe's loss,
                LR and schedule keys) + what bench.py sets, an in-memory
                9-frame 512x512 kit (8 training frames) whose masks and
                images come from the avatar's own seeded render,
                Trainer(mode="train") with a 10-step decoder pre-fit
  8 kernels     composite_bwd against its plain version on the training
                step's real frame-0 render, its window-entry state and
                the loss's own cotangents, and on edge scenes (a tile
                exit included); the tile load; then the gradients of
                rasterize with
                respect to means, scales, quats, opacities, SH features
                and screen_probe through the kernels against the same
                through the plain versions
                and the same for both panel kernels on the training
                frame, bit for bit against the tiled kernels, and the
                rasterize gradients with layout="panel"
  9 train       2 calls of train_scan (16 steps from step 2000); counts
                composite_fwd and composite_bwd launches from 0, and the
                forward launches that wrote the state (all of them)
 10 timing      composite_bwd's CUDA-event time, its plain version's,
                and its bound
 11 entry       the training entry point with layout=panel: the
                recipe's 500-step pre-fit and one 8-step chunk, saved by
                save_ckpt as the step-1990 checkpoint; then
                cli.train.main on that run directory: its Trainer
                resumes from it, train() runs to step 2014 with the
                recipe's prune at 1998, a densify at 2006, the
                validation at 2000 (60 pose-refine steps) and a
                checkpoint at 2010, and the CLI writes its config, the
                final meshes, the .splat, the animation and the a_pose /
                da_pose turntables; events, live counts, zeroed Adam
                moments, metrics, checkpoint resume, exports, the native
                collapse and the panel kernels' launch counts (train()
                and the whole CLI call) checked
 12 timing      on the trained avatar the CLI leaves (its first training
                frame, the loss's cotangents): the forward as in phase 4
                and the panel backward against its plain version and the
                tiled one; both panel kernels' and their
                CUDA-event times against their plain versions' and
                their bounds, the tiled kernels' on the same inputs, the
                forward's with the state; the tile load; the host-clock
                split of train()
 13 scan        exp_cumsum_kernel.main at 4096 steps on every SM, launches
                counted from 0; each mode's kernel against its plain
                version with the same CTA split, at the SM count and at
                one CTA; the entry point's times per step against the
                function's bound (4 operations an element at the card's
                rate) and one torch.cumsum over the (128, 256) block;
                the times at one CTA (ms_one_cta) against one SM's share
 14 experiments exp_bwd_moments.main and exp_bwd_variants.main on the
                bench scene (50,000 gaussians, 512x512), launches
                counted from 0; on each bench scene every backward form
                against its plain version and, at the scripts' 2e-4 *
                max(scale, 1), against composite_bwd; v2 bitwise equal
                to v4; the entry points' times of each form and of
                composite_bwd on the same inputs; composite_bwd's bound.
                The same five kernels also run on phase 7's training
                frame and on phase 12's trained-avatar frame (in those
                phases, with the loss's cotangents): each against its
                plain version, its gap to composite_bwd reported
 15 calibrate   the default training run's synthetic-template fit:
                phase 7's 9-frame kit (masks from its avatar's render)
                with COCO-133 keypoints at the posed joints and face
                anchors and its poses perturbed; Trainer(mode="train")
                with HUMAN_COMPLEX_DOTLIST + HUMAN_COMPLEX_TRAIN_DOTLIST
                and tpu.auto_fit_synthetic unset runs fit_skeleton (500
                steps) and refine_smpl (300 steps of 8 frames at 128x128
                through composite_fwd / composite_bwd, launches counted
                from 0: 2,400 each, no panel kernel), the px error and
                the loss must fall and synthetic_fit.npz appear; a second
                Trainer loads it with no launch; both kernels against
                their plain versions at refine's frame 0 (the MSE's
                cotangents), timed, with bounds and the tile load, and
                the stages' wall times; cli.refine.main --steps 20 on the
                same kit writes poses_optimized.npz
With --profile, stage tables and torch.profiler kernel tables of an
animation frame (after phase 6), of a training step (after phase 10) and
of the calibration's two stages (in phase 15); each profiled stage that
launches a composite kernel must show that kernel's device time. Every
failure raises; the script exits 0 only when every phase passed, and
then prints the kernels line and, last, the device line.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# The recipe values of configs/human_complex.yaml that the animation path
# reads, applied over the port's DEFAULTS (the port reads no YAML here).
HUMAN_COMPLEX_DOTLIST = [
    "bg_color=white",
    "human.sh_degree=0",
    "human.n_subdivision=2",
    "human.disable_posedirs=True",
    "human.body_template=smplh",
    "human.canon_pose_type=da_pose",
    "human.kplanes.output_coordinate_dim=32",
    "human.kplanes.resolution=[64,64,64]",
    "human.kplanes.multires=[1,2,4]",
    "human.attribute_control.isotropic=True",
    "human.attribute_control.thickness_factor=1.0",
    "human.attribute_control.init_opacity=0.8",
    "human.attribute_control.init_scale_multiplier=0.25",
    "human.attribute_control.fixed_opacity=False",
    "human.density_control.max_n_gaussians=200000",
    "tpu.synthetic_res=2.0",
    "tpu.capacity_mult=1.25",
    "tpu.raster.pair_cap=4",
    "tpu.triplane_nested=True",
]

# The recipe's training keys of configs/human_complex.yaml (loss, LR,
# decoder-warmup and density-control schedule), applied over
# HUMAN_COMPLEX_DOTLIST for the training path.
HUMAN_COMPLEX_TRAIN_DOTLIST = [
    "human.optim_pose=True",
    "human.optim_betas=False",
    "human.optim_trans=True",
    "human.opt_geo_from=300",
    "human.opt_app_from=500",
    "human.lr.position_init=0.00016",
    "human.lr.position_final=1.6e-06",
    "human.lr.position_delay_mult=0.01",
    "human.lr.position_max_steps=16000",
    "human.lr.smpl_spatial=2.0",
    "human.lr.smpl_pose=0.0001",
    "human.lr.smpl_betas=0.0001",
    "human.lr.smpl_trans=0.0001",
    "human.lr.appearance=0.0005",
    "human.lr.geometry=0.0005",
    "human.lr.vembed=0.0005",
    "human.lr.mlp_max_steps=16000",
    "human.density_control.min_n_gaussians=100000",
    "human.density_control.hybrid.densify_interval=1500",
    "human.density_control.hybrid.densify_from_iter=3999",
    "human.density_control.hybrid.densify_until_iter=10000",
    "human.density_control.hybrid.densify_grad_threshold=0.001",
    "human.density_control.hybrid.densify_scale_threshold=0.005",
    "human.density_control.hybrid.densify_render_size_threshold=20",
    "human.density_control.hybrid.prune_interval=2000",
    "human.density_control.hybrid.prune_from_iter=1998",
    "human.density_control.hybrid.prune_until_iter=12000",
    "human.density_control.hybrid.prune_opacity_threshold=0.1",
    "human.density_control.hybrid.prune_scale_threshold=0.0005",
    "human.density_control.hybrid.prune_collapse_rate=0.5",
    "human.density_control.hybrid.prune_max_n_gs_once=5000",
    "human.loss.ssim_w=0.2",
    "human.loss.l1_w=0.8",
    "human.loss.lpips_w=1.0",
    "human.loss.num_patches=4",
    "human.loss.patch_size=128",
    "human.loss.grad_pyramid_w=0.2",
    "human.loss.silhouette_w=1.0",
    "human.loss.mesh_edge=10000.0",
    "human.loss.gaussian_connect=5000.0",
    "human.loss.laplacian.type=standard",
    "human.loss.laplacian.color_strength=5.0",
    "human.loss.laplacian.position_strength=1000",
    "human.loss.laplacian.impose_from_iter=1000",
    "human.loss.l2_norm.lambda_xyz_offsets=0.001",
    "human.loss.l2_norm.lambda_scales_diff=0.005",
    "human.loss.l2_norm.max_scale_threshold=0.005",
    "human.loss.l2_norm.lambda_max_scale=0.01",
    "human.loss.l2_norm.min_opacity_threshold=0.2",
    "human.loss.l2_norm.lambda_min_opacity=0.001",
    "tpu.random_lpips_factor=0.0",
    "tpu.val_pose_refine_steps=60",
    "train.save_ckpt_interval=5000",
    "train.val_interval=3000",
    "train.viz_interval=3000",
    "train.anim_interval=3000",
]
# what bench.py's recipe benchmark sets, with a short pre-fit instead of
# its 1 step, and the recipe's 8-step chunks stated
BENCH_TRAIN_DOTLIST = ["train.init_steps=10", "tpu.auto_fit_synthetic=False",
                       "tpu.inner_steps=8"]
TRAIN_STEP0 = 2000  # both warmup gates open, laplacian ramp at 1
# the training entry point (phase 11): resume at CKPT_STEP, train to
# ENTRY_STEPS with the recipe's prune at 1998 and these moves so that
# each event fires once in the window: a densify at 2006 (the recipe's
# first is at 3999), a validation at 2000 (recipe: every 3000) and a
# checkpoint at 2010 (recipe: every 5000)
CKPT_STEP, ENTRY_STEPS = 1990, 2014
# the recipe's decoder pre-fit (train.init_steps), run before the
# checkpoint is written, so that the avatar's splats have the sizes the
# recipe starts from rather than those of BENCH_TRAIN_DOTLIST's 10 steps
RECIPE_INIT_STEPS = 500
ENTRY_DOTLIST = ["tpu.raster.layout=panel", f"train.num_steps={ENTRY_STEPS}",
                 "human.density_control.hybrid.densify_from_iter=2006",
                 "train.val_interval=2000", "train.save_ckpt_interval=2010"]
ENTRY_EVENTS = [1998, 2000, 2006, 2010]

H100_FP32_FLOPS = 67e12    # fp32 outside the tensor cores (SXM data sheet)
H100_BYTES_PER_S = 3.35e12
# fp32 operations every walked pair-pixel needs before its skip test:
# tile-local offsets (4), the conic quadratic (9), exp, opacity product,
# 0.99 clamp (3): the alpha of that pair at that pixel
OPS_PER_PAIR_PIXEL = 16
# the backward's, counted from csrc/composite_bwd.cu: at every walked
# pair-pixel the forward's 16 and the termination test (3); only where
# the pair composites, w (1), gc (5), upg (2), 1 / (1 - alpha) (1, its
# 1 - alpha shared with the test), dl_da (5), dl_dpow (2), u and v (2),
# the seven products of the nine rows (7) and the nine adds that reduce
# them over the pixels (9)
OPS_PER_PAIR_PIXEL_BWD = 19
OPS_PER_COMPOSITE_BWD = 34
# kernel vs plain version: f32 reassociation (sequential product against
# exp(cumsum(log1p(-alpha)))) stays far below ATOL; a pair whose
# T * (1 - alpha) sits within that rounding of 1e-4 can flip its
# termination test and move its pixel by up to alpha * T <= ~1e-2, so a
# few flips are allowed, none larger than FLIP_ATOL
ATOL = 1e-4
MAX_FLIP_FRACTION = 1e-5
FLIP_ATOL = 5e-2
SEED = 0
# largest kernel-vs-plain error of the forward in each layout and of the
# panel backward over every check (check_fwd, check_panel)
KERNEL_ERRS = {"composite_fwd": 0.0, "composite_fwd_panel": 0.0,
               "composite_bwd_panel": 0.0}
# the CUDA sources, each one kernel for both layouts
SOURCES = ["composite_fwd", "composite_bwd", "composite_bwd_variants",
           "chunk_scan_bench"]


def log(msg: str) -> None:
    print(msg, flush=True)


def check_close(name: str, got, want) -> float:
    err = (got - want).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    n_over = int((err > ATOL).sum())
    log(f"[kernels] {name}: max_abs_err={max_err:.3e} "
        f"elements>{ATOL:g}: {n_over}/{err.numel()}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel output not finite")
    if n_over > MAX_FLIP_FRACTION * err.numel() or max_err > FLIP_ATOL:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return max_err


def cuda_ms(fn, n: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def make_motion(path: str, frames: int = 32) -> None:
    """Seeded custom motion: arms and legs swinging, upright root."""
    rng = np.random.RandomState(SEED)
    ph = np.linspace(0, 1.5 * np.pi, frames, dtype=np.float32)
    amp = rng.uniform(0.4, 0.7, 4).astype(np.float32)
    pose = np.zeros((frames, 72), np.float32)
    pose[:, 0] = np.pi                       # root: upright in the camera
    pose[:, 3 * 1 + 0] = amp[0] * np.sin(ph)   # hips
    pose[:, 3 * 2 + 0] = -amp[0] * np.sin(ph)
    pose[:, 3 * 4 + 0] = amp[1] * np.clip(np.sin(ph), 0, None)  # knees
    pose[:, 3 * 5 + 0] = amp[1] * np.clip(-np.sin(ph), 0, None)
    pose[:, 3 * 16 + 2] = -1.0 + amp[2] * np.sin(ph)   # shoulders
    pose[:, 3 * 17 + 2] = 1.0 + amp[3] * np.sin(ph)
    transl = np.stack([0.05 * np.sin(ph), np.zeros_like(ph),
                       0.02 * np.cos(ph)], -1).astype(np.float32)
    np.savez(path, body_pose=pose, transl=transl)


def make_kit(frames: int = 4, size: int = 512):
    from sings_tpu_torch.data.kit import TrainingKit, get_data_splits
    from sings_tpu_torch.ops.graphics import make_camera

    K = np.array([[1000.0, 0, size / 2], [0, 1000.0, size / 2], [0, 0, 1]])
    smpl = {"betas": np.zeros(10, np.float32),
            "body_pose": np.zeros((frames, 69), np.float32),
            "global_orient": np.tile([[np.pi, 0, 0]], (frames, 1)).astype(
                np.float32),
            "transl": np.tile([[0, 0.2, 5.0]], (frames, 1)).astype(
                np.float32)}
    train, val = get_data_splits(frames)
    return TrainingKit(
        images=np.zeros((frames, 3, size, size), np.float32),
        masks=np.zeros((frames, size, size), np.float32), smpl=smpl,
        camera=make_camera(np.eye(4), size, size, K=K), train_split=train,
        val_split=val, name="kit")


def seeded_checkpoint(trainer, path: str) -> None:
    """Checkpoint of the port's init_avatar (seed 0), with the decoder
    heads' biases at the recipe's init targets (scale ~4 mm, opacity
    0.8), the values its init_attrs pre-fit aims at."""
    from sings_tpu_torch.train.checkpoint import save_checkpoint

    p = trainer.params
    s1 = p.geometry_dec["scales1"]
    s1["w"].mul_(0.01)
    s1["b"].fill_(math.log(math.expm1(0.004)))
    op = p.appearance_dec["opacity"]
    op["w"].mul_(0.01)
    op["b"].fill_(math.log(0.8 / 0.2))
    save_checkpoint(path, params=p, buffers=trainer.buffers, step=0,
                    active_sh_degree=0)


def random_scene(n, h, w, seed, device, z=(2.0, 6.0), spread=0.6):
    from sings_tpu_torch.ops.graphics import make_camera
    from sings_tpu_torch.ops.rotations import axis_angle_to_quaternion

    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g)  # noqa: E731
    means = torch.stack([(u(n) * 2 - 1) * spread, (u(n) * 2 - 1) * spread,
                         z[0] + u(n) * (z[1] - z[0])], -1)
    scales = 0.02 + 0.13 * u(n, 3)
    quats = axis_angle_to_quaternion(torch.randn(n, 3, generator=g) * 0.5)
    opac = 0.2 + 0.8 * u(n)
    rgb = u(n, 3)
    cam = make_camera(np.eye(4), h, w, fovx=0.9, fovy=0.9 * h / w,
                      device=device)
    return [t.to(device) for t in (means, scales, quats, opac, rgb)], cam


def composite_inputs(gauss, cam, kw):
    from sings_tpu_torch.ops.rasterizer.api import (
        RasterConfig, prepare_composite, _pad_tiles,
    )
    from sings_tpu_torch.ops.rasterizer.common import preprocess

    cfg = RasterConfig(height=cam.height, width=cam.width, **kw)
    g2d = preprocess(*gauss[:4], gauss[4], cam, sh_degree=3,
                     alive=gauss[5] if len(gauss) > 5 else None,
                     tile=cfg.tile)
    feats, binning = prepare_composite(g2d, cfg)
    ntx, nty = _pad_tiles(cfg)
    return feats, binning, dict(tile=cfg.tile, chunk=cfg.chunk,
                                n_tiles_x=ntx, n_tiles_y=nty)


def tile_load(binning, chunk: int = 128) -> str:
    """Pairs per tile of a binning: the largest segment and the mean over
    tiles that hold any (one forward CTA walks one tile's segment), and
    the gradient buffer's windows (the backward's work items)."""
    seg = binning.tile_offsets[1:] - binning.tile_offsets[:-1]
    busy = seg[seg > 0].float()
    mean = float(busy.mean()) if busy.numel() else 0.0
    wins = (binning.grad_offsets[1:] - binning.grad_offsets[:-1]) // chunk
    return (f"pairs per tile max {int(seg.max())}, mean {mean:.1f} over "
            f"{busy.numel()} non-empty tiles; {int(wins.sum())} windows, "
            f"at most {int(wins.max())} in a tile")


def used_windows(binning, chunk: int) -> int:
    """The state's rows that belong to a tile (the kernel writes those,
    the backward reads those): grad_offsets[T] // chunk."""
    return int(binning.grad_offsets[-1]) // chunk


def panel_kw(ckw: dict) -> dict:
    from sings_tpu_torch.ops.rasterizer import kernels as K

    return dict(ckw, pw=K.panel_width(ckw["tile"]))


def to_planes(tiles, ckw: dict, t_pad: float):
    """(T, 8, npx) tile rows -> (4, Hp, Wp) planes, t_pad in row 3 of the
    padding sub-tiles (1 for a forward output, 0 for cotangents)."""
    from sings_tpu_torch.ops.rasterizer import kernels as K

    planes = K.tiles_to_planes(tiles, pw=K.panel_width(ckw["tile"]),
                               **{k: ckw[k] for k in ("tile", "n_tiles_x",
                                                      "n_tiles_y")})
    planes[3, :, ckw["n_tiles_x"] * ckw["tile"]:] = t_pad
    return planes.contiguous()


def note_err(name: str, err: float) -> None:
    KERNEL_ERRS[name] = max(KERNEL_ERRS[name], err)


def check_fwd(name: str, feats, binning, ckw: dict) -> tuple:
    """composite_fwd in both layouts, with and without the window-entry
    state, against the plain versions: the output and the state's rows
    of a tile (check_close); each layout's output unchanged by keeping
    the state; the panel planes (padding sub-tiles colour 0, T = 1) and
    state bit for bit the tiled ones. Returns the tiled and the panel
    (output, state)."""
    from sings_tpu_torch.ops.rasterizer import kernels as K

    offs = binning.tile_offsets
    skw = dict(grad_offsets=binning.grad_offsets,
               grad_cap=binning.pair_slot_capacity)
    nw = used_windows(binning, ckw["chunk"])
    res = {}
    for key, kw in (("composite_fwd", ckw), ("composite_fwd_panel",
                                             panel_kw(ckw))):
        out, st = K.composite_fwd_cuda(feats, offs, **skw, **kw)
        bare = K.composite_fwd_cuda(feats, offs, return_state=False, **skw,
                                    **kw)
        torch.cuda.synchronize()
        want, want_st = K.composite_fwd_plain(feats, offs, **skw, **kw)
        note_err(key, max(check_close(f"{key} {name}", out, want),
                          check_close(f"{key} state {name}", st[:nw],
                                      want_st[:nw])))
        if not torch.equal(bare, out):
            raise AssertionError(f"{name}: keeping the state changed {key}")
        res[key] = (out, st)
    (fwd_t, st_t), (fwd_p, st_p) = res.values()
    lay = {k: ckw[k] for k in ("tile", "n_tiles_x", "n_tiles_y")}
    if not torch.equal(fwd_p, K.tiles_to_planes(
            fwd_t, pw=K.panel_width(ckw["tile"]), **lay)):
        raise AssertionError(f"{name}: composite_fwd_panel is not bitwise "
                             "equal to composite_fwd relaid out")
    if not torch.equal(st_p[:nw], st_t[:nw]):
        raise AssertionError(f"{name}: the panel forward's state is not "
                             "bitwise equal to the tiled forward's")
    log(f"[kernels] composite_fwd {name}: both layouts, with and without "
        f"the state; panel bitwise equal to tiled; {tile_load(binning)}")
    return res["composite_fwd"], res["composite_fwd_panel"]


def check_panel(name: str, feats, binning, ckw: dict, gout_planes):
    """check_fwd, then the panel backward against its plain version and
    bit for bit against the tiled backward on the same inputs relaid
    out. Returns the tiled forward's output."""
    from sings_tpu_torch.ops.rasterizer import kernels as K

    (fwd_t, st_t), (fwd_p, st_p) = check_fwd(name, feats, binning, ckw)
    pkw = panel_kw(ckw)
    lay = {k: ckw[k] for k in ("tile", "n_tiles_x", "n_tiles_y")}
    offs = binning.tile_offsets
    cap = binning.pair_slot_capacity
    # the rows past the tiles' windows are never read: poison them in
    # the tiled backward's state, which must still match the panel's
    st_t[used_windows(binning, ckw["chunk"]):] = float("nan")
    args = (feats, offs, binning.grad_offsets)
    g_p = K.composite_bwd_cuda(*args, fwd_p, gout_planes, st_p,
                               grad_cap=cap, **pkw)
    g_t = K.composite_bwd_cuda(*args, fwd_t, K.planes_to_tiles(
        gout_planes, **lay).contiguous(), st_t, grad_cap=cap, **ckw)
    torch.cuda.synchronize()
    note_err("composite_bwd_panel", check_bwd(
        f"panel {name}", g_p, K.composite_bwd_plain(
            *args, fwd_p, gout_planes, st_p, grad_cap=cap, **pkw), binning))
    if not torch.equal(g_p, g_t):
        raise AssertionError(f"{name}: composite_bwd_panel is not bitwise "
                             "equal to composite_bwd")
    log(f"[kernels] panel {name}: planes {tuple(fwd_p.shape)}, the backward "
        "bitwise equal to the tiled one")
    return fwd_t


def saturating_stack(dev, n: int = 300):
    """n opaque splats (0.95) stacked in depth over the middle of a 64x64
    camera: every pixel there saturates within the first window."""
    stack = [torch.tensor([[0.0, 0.0, 3.0]]).repeat(n, 1),
             torch.full((n, 3), 0.2),
             torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1),
             torch.full((n,), 0.95),
             torch.rand(n, 3, generator=torch.Generator().manual_seed(2))]
    stack[0][:, 2] += torch.linspace(0, 0.5, n)
    return [t.to(dev) for t in stack], random_scene(1, 64, 64, 0, dev)[1]


def deep_stack(dev, n: int = 6000):
    """n faint splats (opacity 0.005-0.008, sigma ~3 px) stacked in depth
    inside one tile of a 64x64 camera: one tile of n / 128 >= 40
    windows, whose middle pixels saturate mid-segment (alpha ~0.008:
    T reaches 1e-4 after ~1,150 pairs) while its edge pixels skip every
    pair."""
    g = torch.Generator().manual_seed(4)
    means = torch.tensor([[0.3, 0.3, 3.0]]).repeat(n, 1)
    means[:, :2] += 0.01 * torch.randn(n, 2, generator=g)
    means[:, 2] += torch.linspace(0, 0.5, n)
    stack = [means, torch.full((n, 3), 0.15),
             torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1),
             0.005 + 0.003 * torch.rand(n, generator=g),
             torch.rand(n, 3, generator=g)]
    return [t.to(dev) for t in stack], random_scene(1, 64, 64, 0, dev)[1]


def sparse_scene(dev, n: int = 4000):
    """n sub-pixel splats spread over a 512x512 camera: a few pairs in
    each tile, so nearly every busy tile is a single window."""
    g, cam = random_scene(n, 512, 512, 5, dev, spread=0.8)
    g[1] = g[1] * 0.04
    return g, cam


def panel_edge_scenes(dev, ekw) -> None:
    """56x40 (ntx 4 < pw 8) and 600x200 (ntx 38, Wp 640): padding
    sub-tiles; a 300-deep saturating stack, which must saturate."""
    for seed, (h, w) in ((21, (40, 56)), (22, (200, 600))):
        g, cam = random_scene(300, h, w, seed, dev)
        feats, b, ckw = composite_inputs(g, cam, ekw)
        gen = torch.Generator(device=dev).manual_seed(seed)
        gout = torch.randn((4,) + tuple(panel_shape(ckw)), generator=gen,
                           device=dev)
        check_panel(f"{w}x{h} padding sub-tiles", feats, b, ckw, gout)
    feats, b, ckw = composite_inputs(*saturating_stack(dev), ekw)
    gout = torch.randn((4,) + tuple(panel_shape(ckw)), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(23))
    out = check_panel("saturating stack", feats, b, ckw, gout)
    if float(out[:, 3].min()) >= 1e-3:
        raise AssertionError("saturating stack did not saturate")


def panel_shape(ckw: dict) -> tuple:
    from sings_tpu_torch.ops.rasterizer import kernels as K

    return K.panel_shape(**{k: v for k, v in panel_kw(ckw).items()
                            if k != "chunk"})


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--profile", metavar="DIR", default=None,
        help="also time each stage of a frame and trace one animation "
             "chunk with torch.profiler; tables go to DIR")
    args = parser.parse_args(argv)
    # ---- 1 device
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False; this smoke run "
            "needs an NVIDIA GPU")
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "sings_tpu_torch")):
        log("FAIL: sings_tpu_torch/ not found beside chip_smoke.py")
        return 1
    sys.path.insert(0, here)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    from sings_tpu_torch.mesh import native
    from sings_tpu_torch.ops import cuda_build

    # ---- 2 build
    t0 = time.time()
    cuda_build.build(SOURCES)
    t1 = time.time()
    if native.get_lib() is None:
        raise AssertionError("g++ build of csrc/mesh_native.cpp failed")
    log(f"[build] {', '.join(SOURCES)} built in {t1 - t0:.1f}s (one nvcc "
        f"each, started together); mesh_native in {time.time() - t1:.1f}s")
    for name, info in cuda_build.BUILD_LOG.items():
        entry = ""
        for line in info["log"].splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                log(f"[build] {name} {entry}: {line.strip()}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        return run(work, dev, smi, args.profile)


def run(work: str, dev, smi: str, profile_dir: str | None) -> int:
    from sings_tpu_torch.config.core import load_config
    from sings_tpu_torch.config.defaults import DEFAULTS
    from sings_tpu_torch.ops.rasterizer import kernels as K
    from sings_tpu_torch.ops.rasterizer.api import tiles_to_image, RasterConfig
    from sings_tpu_torch.train.trainer import Trainer, quantize

    # ---- 3 full-width setup
    t0 = time.time()
    motion = os.path.join(work, "motion.npz")
    make_motion(motion)
    anim_cfg = os.path.join(work, "anim.json")
    with open(anim_cfg, "w") as fh:
        json.dump({"motion_src": motion, "motion_type": "custom",
                   "motion_start": 0, "motion_end": None, "motion_skip": 1,
                   "render_size": [512, 512], "fx": 5000.0, "fy": 5000.0},
                  fh)
    cfg = load_config(DEFAULTS, None, HUMAN_COMPLEX_DOTLIST + [
        f"output_path={work}", "exp_name=smoke", "dataset.name=kit",
        f"anim_cfg_path={anim_cfg}", f"seed={SEED}", "eval=True",
        f"tpu.smpl_model_dir={work}/no_licensed_models"])
    kit = make_kit()
    init = Trainer(cfg, mode="anim", device=dev, kit=kit)
    seeded_checkpoint(init, os.path.join(init.logdir_ckpt, "human_final.npz"))
    del init
    trainer = Trainer(cfg, mode="anim", device=dev, kit=kit)
    acfg = trainer.avatar_cfg
    n_live = int(trainer.buffers.alive.sum())
    log(f"[setup] {n_live} live gaussians in {acfg.capacity} slots, "
        f"{trainer.tpl.num_joints} joints, {acfg.num_betas} betas, "
        f"planes {[tuple(s[0].shape) for s in trainer.params.triplane['grids']]}"
        f" feat {acfg.triplane.feat_dim}, raster {trainer.raster_kw} "
        f"({time.time() - t0:.1f}s)")
    if trainer.raster_kw["chunk"] != 128 or trainer.raster_kw["pair_cap"] != 4:
        raise AssertionError("recipe raster settings not in effect")

    # ---- 4 kernels against their plain versions
    ds = trainer.anim_dataset
    kw = {k: trainer.raster_kw[k] for k in (
        "tile", "chunk", "max_span", "max_pairs", "main_width",
        "tail_capacity", "pair_cap")}
    with torch.no_grad():
        from sings_tpu_torch.model.avatar import get_gs_attrs

        gs_attrs = get_gs_attrs(trainer.params, trainer.buffers, acfg)
        posed = trainer.pose_chunk(gs_attrs, ds.get_chunk(0, 16))
        frame0 = list(trainer.frame_gaussians(posed, 0)) + [
            trainer.buffers.alive > 0.5]
        feats, binning, ckw = composite_inputs(frame0, ds.camera, kw)
        n_pairs = int(binning.num_pairs)
        overflow = int(binning.overflow)
        log(f"[kernels] frame 0: feats {tuple(feats.shape)}, tiles "
            f"{ckw['n_tiles_x'] * ckw['n_tiles_y']}, pairs {n_pairs}, "
            f"overflow {overflow}")
        offs = binning.tile_offsets
        skw = dict(grad_offsets=binning.grad_offsets,
                   grad_cap=binning.pair_slot_capacity)
        want, walked = K.composite_fwd_plain(feats, offs,
                                             return_walked=True, **ckw)
        # both layouts, with and without the state (the training step's
        # window-entry state), on frame 0 (random cotangents for the
        # panel backward: the animation has none) and on edge scenes
        gen = torch.Generator(device=dev).manual_seed(SEED + 20)
        check_panel("full width frame 0", feats, binning, ckw, torch.randn(
            (4,) + tuple(panel_shape(ckw)), generator=gen, device=dev))
        ekw = dict(kw, max_span=8, pair_cap=None)
        empty = random_scene(200, 64, 96, 3, dev, z=(-4.0, -1.0))
        empty[0][0][:5] = torch.tensor([[0.3, 0.2, 3.0]], device=dev)
        for name, scene in (
                ("500x380 padding tiles", random_scene(400, 380, 500, 1,
                                                       dev)),
                ("empty tiles", empty), ("deep stack", deep_stack(dev)),
                ("single-window tiles", sparse_scene(dev))):
            f_, b_, c_ = composite_inputs(*scene, ekw)
            (out_t, st_t), _ = check_fwd(name, f_, b_, c_)
            wins = (b_.grad_offsets[1:] - b_.grad_offsets[:-1]) // c_["chunk"]
            if name == "empty tiles" and float(
                    out_t[:, 3].amin(dim=1).max()) != 1.0:
                raise AssertionError("empty tiles must keep T == 1")
            if name == "deep stack":
                # the deepest tile's T at each window's top, its least
                # over the pixels: saturated before its last window
                t = int(torch.argmax(wins))
                g0 = int(b_.grad_offsets[t]) // c_["chunk"]
                tops = st_t[g0:g0 + int(wins[t]), 0].amin(dim=1)
                sat = int((tops < 2e-4).nonzero()[0]) if bool(
                    (tops < 2e-4).any()) else -1
                log(f"[kernels] deep stack: tile {t} of {int(wins[t])} "
                    f"windows saturates at window {sat}")
                if int(wins[t]) < 40 or not 0 < sat < int(wins[t]) - 1:
                    raise AssertionError("deep stack: no tile of >= 40 "
                                         "windows saturating mid-segment")
            if name == "single-window tiles":
                busy = wins[wins > 0]
                log(f"[kernels] single-window tiles: {int((busy == 1).sum())}"
                    f" of {busy.numel()} busy tiles hold one window")
                if not (busy == 1).float().mean() >= 0.8:
                    raise AssertionError("single-window tiles: too few")
        panel_edge_scenes(dev, ekw)

        # the whole frame through the plain version, for phase 5
        color, t_final = tiles_to_image(want, RasterConfig(
            height=512, width=512, **kw))
        plain_frame0 = quantize(color + t_final[None]
                                * trainer.bg_color[:, None, None]).cpu()

    # ---- 5 main path
    frames = {}

    def writer(imgs, start):
        for j in range(imgs.shape[0]):
            frames[start + j] = imgs[j]

    K.reset_launches()
    torch.cuda.synchronize()
    fps = trainer.animate_chunk(chunk_size=16, max_frames=32,
                                save_video=False, writer=writer)
    launches = dict(K.LAUNCHES)
    log(f"[main] {len(frames)} frames at {fps:.2f} fps (host clock, "
        f"readback included), launches {launches}")
    if sorted(frames) != list(range(32)):
        raise AssertionError(f"expected frames 0..31, got {sorted(frames)}")
    for i, f in frames.items():
        if f.shape != (512, 512, 3) or f.dtype != np.uint8:
            raise AssertionError(f"frame {i}: {f.shape} {f.dtype}")
        if not f.std() > 1.0:
            raise AssertionError(f"frame {i} is flat (std {f.std():.3f})")
    steps = [np.abs(frames[i].astype(int) - frames[i + 1].astype(int)).mean()
             for i in range(31)]
    swing = np.abs(frames[0].astype(int) - frames[16].astype(int)).mean()
    log(f"[main] mean level change per frame {min(steps):.3f}.."
        f"{max(steps):.3f}, frame 0 vs 16: {swing:.3f}")
    if not (min(steps) > 0 and swing > 0.5):
        raise AssertionError("frames do not follow the motion")
    if launches["composite_fwd"] != 32:
        raise AssertionError(f"composite_fwd launched "
                             f"{launches['composite_fwd']} times, not 32")
    if any(K.STATE_WRITES.values()):
        raise AssertionError(f"the animation wrote the window-entry state: "
                             f"{K.STATE_WRITES}")
    d0 = np.abs(frames[0].astype(int) - plain_frame0.numpy().astype(int))
    log(f"[main] frame 0 vs plain-version render: max {d0.max()} levels, "
        f"{int((d0 > 1).sum())} values off by more than 1")
    if (d0 > 1).mean() > MAX_FLIP_FRACTION * 4:
        raise AssertionError("main-path frame 0 disagrees with the plain "
                             "version's render")

    # ---- 5b the same animation in the panel layout
    tiled_frames = dict(frames)
    frames.clear()
    trainer.raster_kw["layout"] = "panel"
    K.reset_launches()
    torch.cuda.synchronize()
    fps_p = trainer.animate_chunk(chunk_size=16, max_frames=32,
                                  save_video=False, writer=writer)
    panel_launches = dict(K.LAUNCHES)
    trainer.raster_kw["layout"] = "tiled"
    same = [np.array_equal(frames[i], tiled_frames[i]) for i in range(32)]
    log(f"[main panel] {len(frames)} frames at {fps_p:.2f} fps, launches "
        f"{panel_launches}, equal to the tiled frames: {sum(same)}/32")
    if sorted(frames) != list(range(32)) or not all(same):
        raise AssertionError("panel-layout frames differ from the tiled "
                             "layout's")
    if (panel_launches["composite_fwd_panel"] != 32
            or panel_launches["composite_fwd"] != 0
            or any(K.STATE_WRITES.values())):
        raise AssertionError(f"panel animation launches {panel_launches}, "
                             "expected 32 composite_fwd_panel and 0 tiled")

    # ---- 6 timing at frame 0's shapes, in turns without / with / with /
    # without keeping the state
    turns = [cuda_ms(lambda: K.composite_fwd_cuda(
        feats, offs, return_state=keep, **skw, **ckw))
        for keep in (False, True, True, False)]
    ms, ms_state = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    plain_ms = cuda_ms(lambda: K.composite_fwd_plain(feats, offs, **ckw))
    n_tiles = ckw["n_tiles_x"] * ckw["n_tiles_y"]
    npx = ckw["tile"] ** 2
    ops = OPS_PER_PAIR_PIXEL * walked * npx
    # walked feats rows, both offset tables, the output
    nbytes = 4 * (9 * walked + 2 * (n_tiles + 1) + n_tiles * 8 * npx)
    ops_ms = ops / H100_FP32_FLOPS * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f"[timing] composite_fwd without / with / with / without keeping "
        f"the state: {', '.join(f'{t:.4f}' for t in turns)} ms, plain "
        f"{plain_ms:.3f} ms, walked pairs {walked} of {n_pairs}, bound "
        f"{bound_ms:.4f} ms (ops {ops_ms:.4f} ms, bytes {bytes_ms:.4f} ms)"
        f", {tile_load(binning)} | {smi}")
    kernels = [{
        "name": "composite_fwd", "route": "cuda",
        "source": "sings_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "sings_tpu/ops/rasterizer/pallas_kernels.py:873",
        "launches": launches["composite_fwd"], "max_abs_err": None,
        "ms": ms, "kernel_ms": ms, "ms_with_state": ms_state,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]
    if profile_dir:
        profile(trainer, gs_attrs, frame0, kw, profile_dir)
    del trainer, gs_attrs, posed, frame0, feats, binning, want
    torch.cuda.empty_cache()
    kernels.extend(run_train(work, dev, smi, profile_dir))
    # ---- 13 the scan micro-benchmark, 14 the backward's formulas
    kernels.extend(run_scan(dev, smi))
    kernels.extend(finish_form_rows(run_experiments(dev, smi)))
    # ---- 15 the synthetic-template calibration
    run_calibrate(work, dev, smi, kernels, profile_dir)
    for row in kernels:
        if row["name"] in KERNEL_ERRS:
            row["max_abs_err"] = KERNEL_ERRS[row["name"]]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# the composite kernels by the profiler's (demangled) kernel names
COMPOSITE_KERNELS = {"composite_fwd": "fwd_window_kernel",
                     "composite_bwd": "bwd_kernel<(anonymous namespace)"
                                      "::Production>"}


# In the training context torch.profiler (CUPTI) drops the first kernel
# records of each session: a stage of two kernels (composite_bwd's zero
# fill and the kernel) showed no device time (PERF.md section 7). Every
# profiled call therefore runs after PREAMBLE spin kernels of its own,
# which the sums leave out and whose records the tables count.
PREAMBLE = 4
SPIN = "spin_kernel"


def profiled(fn) -> tuple:
    """One call of fn under torch.profiler, after the preamble: the
    device time (ms) of the kernels it launched, that of the composite
    kernels among them by name, the preamble kernels seen, and the
    profile."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PREAMBLE):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    seen = sum(e.count for e in evs if SPIN in e.key)
    evs = [e for e in evs if SPIN not in e.key]
    comp = {name: sum(e.self_device_time_total for e in evs if key in e.key)
            / 1e3 for name, key in COMPOSITE_KERNELS.items()}
    return (sum(e.self_device_time_total for e in evs) / 1e3, comp, seen,
            prof)


def require_seen(stage: str, comp: dict, names: list, prof,
                 out_dir: str) -> None:
    """A profiled stage that launches composite kernels must give each of
    them device time; if not, its trace goes to out_dir and it raises."""
    missing = [n for n in names if not comp[n] > 0.0]
    if missing:
        path = os.path.join(out_dir, "trace_" + "".join(
            c if c.isalnum() else "_" for c in stage) + ".json")
        prof.export_chrome_trace(path)
        raise AssertionError(f"profile of {stage!r}: no device time for "
                             f"{missing} (trace: {path})")


def profile(trainer, gs_attrs, frame0, kw, out_dir: str) -> None:
    """Stage times of one full-width frame (CUDA events, each stage run
    alone) and a torch.profiler trace of one 16-frame animation chunk:
    device time by kernel and the device's busy share of the window."""
    from sings_tpu_torch.model.avatar import get_gs_attrs
    from sings_tpu_torch.ops.rasterizer import kernels as K
    from sings_tpu_torch.ops.rasterizer.api import (
        _gather_feats, rasterize, tiles_to_image, RasterConfig, _pad_tiles,
    )
    from sings_tpu_torch.ops.rasterizer.common import preprocess
    from sings_tpu_torch.ops.rasterizer.tiles import bin_gaussians
    from sings_tpu_torch.train.trainer import quantize

    os.makedirs(out_dir, exist_ok=True)
    ds = trainer.anim_dataset
    cam = ds.camera
    rcfg = RasterConfig(height=cam.height, width=cam.width, **kw)
    ntx, nty = _pad_tiles(rcfg)
    chunk16 = ds.get_chunk(0, 16)
    g2d = preprocess(*frame0[:5], cam, sh_degree=3, alive=frame0[5])
    binning = bin_gaussians(
        g2d, tile=rcfg.tile, n_tiles_x=ntx, n_tiles_y=nty,
        max_span=rcfg.max_span, align=rcfg.chunk, main_width=rcfg.main_width,
        pair_cap=rcfg.pair_cap)
    feats = _gather_feats(binning, g2d.means2d, g2d.conics, g2d.colors,
                          g2d.opacities, rcfg.chunk)
    ckw = dict(tile=rcfg.tile, chunk=rcfg.chunk, n_tiles_x=ntx,
               n_tiles_y=nty)
    fkw = dict(grad_offsets=binning.grad_offsets,
               grad_cap=binning.pair_slot_capacity, return_state=False,
               **ckw)
    out = K.composite_fwd_cuda(feats, binning.tile_offsets, **fkw)

    def finish():
        color, t = tiles_to_image(out, rcfg)
        return quantize(color + t[None] * trainer.bg_color[:, None, None])

    with torch.no_grad():
        stages = [
            ("decode once: get_gs_attrs", lambda: get_gs_attrs(
                trainer.params, trainer.buffers, trainer.avatar_cfg), 1),
            ("pose: avatar_forward_chunk (16 frames)", lambda:
             trainer.pose_chunk(gs_attrs, chunk16), 16),
            ("preprocess", lambda: preprocess(
                *frame0[:5], cam, sh_degree=3, alive=frame0[5]), 1),
            ("bin_gaussians", lambda: bin_gaussians(
                g2d, tile=rcfg.tile, n_tiles_x=ntx, n_tiles_y=nty,
                max_span=rcfg.max_span, align=rcfg.chunk,
                main_width=rcfg.main_width, pair_cap=rcfg.pair_cap), 1),
            ("_gather_feats", lambda: _gather_feats(
                binning, g2d.means2d, g2d.conics, g2d.colors,
                g2d.opacities, rcfg.chunk), 1),
            ("composite_fwd kernel", lambda: K.composite_fwd_cuda(
                feats, binning.tile_offsets, **fkw), 1),
            ("relayout + bg blend + uint8", finish, 1),
            ("whole rasterize() + uint8", lambda: quantize(rasterize(
                *frame0[:5], cam, sh_degree=3, bg=trainer.bg_color,
                alive=frame0[5], **trainer.raster_kw)["render"]), 1),
        ]
        lines = [f"{'stage':45s} {'events ms':>10s} {'kernels ms':>10s}"
                 f" {'composite':>10s} {'pre':>4s}  per frame (events: 10 "
                 "back-to-back calls, host issue included; kernels: device "
                 "time, profiler; composite: the composite kernels' share; "
                 f"pre: of the {PREAMBLE} preamble kernels, those the "
                 "profiler recorded)"]
        for name, fn, per in stages:
            t = cuda_ms(fn, n=10) / per
            d, comp, seen, prof = profiled(fn)
            if "composite" in name or "rasterize" in name:
                require_seen(name, comp, ["composite_fwd"], prof, out_dir)
            lines.append(f"{name:45s} {t:10.4f} {d / per:10.4f} "
                         f"{sum(comp.values()) / per:10.4f} {seen:4d}")

        def chunk():
            trainer.animate_chunk(chunk_size=16, max_frames=16,
                                  save_video=False,
                                  writer=lambda imgs, start: None)

        chunk()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        K.reset_launches()
        busy_ms, comp, _, prof = profiled(chunk)
        require_seen("16-frame chunk", comp, ["composite_fwd"], prof,
                     out_dir)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:15]
    lines.append(f"16-frame chunk: wall {wall_ms:.3f} ms unprofiled (host "
                 f"clock), device kernels {busy_ms:.3f} ms "
                 f"(busy {100 * busy_ms / wall_ms:.1f}% of the unprofiled "
                 f"wall), composite launches {K.LAUNCHES['composite_fwd']}")
    for e in top:
        lines.append(f"  {e.self_device_time_total / 1e3:10.3f} ms "
                     f"{e.count:6d}x  {e.key[:90]}")
    text = "\n".join(lines)
    for line in lines:
        log(f"[profile] {line}")
    with open(os.path.join(out_dir, "profile_anim.txt"), "w") as fh:
        fh.write(text + "\n")


# ---------------------------------------------------------------------------
# the training path (phases 7-10)

# composite_bwd against its plain version: per gradient row, values off
# by more than BWD_RTOL of the row's largest magnitude count as flips
# (a pair whose T * (1 - alpha) sits within rounding of 1e-4 composites
# in one and not the other, which moves its pixel's dl_da for the rest
# of the window); at most MAX_BWD_FLIP_FRACTION of the compared values
BWD_RTOL = 1e-4
MAX_BWD_FLIP_FRACTION = 1e-4
# rasterize gradients through the kernels against the plain versions:
# the JAX package's own gradient tolerance (tests/test_rasterizer.py:
# atol 2e-4 * max|g|, rtol 2e-3), with the same flip allowance. An
# isotropic avatar's covariance does not depend on its rotation, so its
# d/dquats is zero up to rounding on both sides and is not compared: both
# must stay below ZERO_GRAD_REL of the largest d/dscales instead
GRAD_ATOL_REL, GRAD_RTOL, ZERO_GRAD_REL = 2e-4, 2e-3, 1e-5


def train_dotlist(work: str, extra=()) -> list:
    return (HUMAN_COMPLEX_DOTLIST + HUMAN_COMPLEX_TRAIN_DOTLIST
            + BENCH_TRAIN_DOTLIST + [
                f"output_path={work}", "exp_name=smoke_train",
                "dataset.name=kit", f"seed={SEED}",
                f"tpu.smpl_model_dir={work}/no_licensed_models"]
            + list(extra))


def make_train_kit(frames: int = 9, size: int = 512):
    """9 frames, 8 of them in the training split (get_data_splits holds
    one out), poses jittered from the seed. Images and masks are filled
    by seed_train_targets once the avatar exists."""
    kit = make_kit(frames, size)
    rng = np.random.RandomState(SEED + 1)
    smpl = dict(kit.smpl)
    smpl["body_pose"] = (rng.randn(frames, 69) * 0.08).astype(np.float32)
    smpl["transl"] = (smpl["transl"] + rng.randn(frames, 3) * 0.02).astype(
        np.float32)
    return kit._replace(smpl=smpl)


@torch.no_grad()
def seed_train_targets(trainer) -> None:
    """Each kit frame's mask is the starting avatar's own silhouette
    ((1 - T) > 0.5) and its image that render plus seeded noise, so the
    losses, the silhouette term and the patch sampler see a real
    subject."""
    from sings_tpu_torch.model.avatar import avatar_forward
    from sings_tpu_torch.ops.rasterizer.api import rasterize
    from sings_tpu_torch.train.step import sh_degree_mask

    gen = torch.Generator(device=trainer.device).manual_seed(SEED)
    mask_deg = sh_degree_mask(trainer.active_sh_degree, trainer.device)
    for f in range(trainer.images.shape[0]):
        out = avatar_forward(trainer.params, trainer.buffers,
                             trainer.avatar_cfg, trainer.template,
                             trainer.cache, dataset_idx=f)
        pkg = rasterize(out["xyz"], out["scales"], out["rotq"],
                        out["opacity"][:, 0],
                        out["shs"] * mask_deg[None, :, None],
                        trainer.camera, sh_degree=3,
                        bg=torch.zeros(3, device=trainer.device),
                        alive=trainer.buffers.alive > 0.5,
                        **trainer.raster_kw)
        trainer.masks[f] = ((1.0 - pkg["transmittance"]) > 0.5).float()
        noise = torch.randn(pkg["render"].shape, generator=gen,
                            device=trainer.device)
        trainer.images[f] = torch.clamp(pkg["render"] + 0.05 * noise, 0, 1)


def train_batches(trainer):
    k = trainer.inner_steps
    frames = list(trainer.kit.train_split[:k])
    if len(frames) != k:
        raise AssertionError(f"kit has {len(frames)} training frames, "
                             f"the chunk {k} steps")
    return {"rgb": trainer.images[frames], "mask": trainer.masks[frames],
            "idx": frames,
            "smpl_scale": torch.ones((k, 1), device=trainer.device)}


def step_render_inputs(trainer, batch, draws):
    """The training step's frame: rasterize inputs (leaves that want
    gradients, screen_probe included) and a loss of the render: the
    step's photometric objective with its silhouette term."""
    from sings_tpu_torch.losses.photometric import photometric_loss
    from sings_tpu_torch.model.avatar import avatar_forward
    from sings_tpu_torch.train.step import sh_degree_mask

    with torch.no_grad():
        out = avatar_forward(trainer.params, trainer.buffers,
                             trainer.avatar_cfg, trainer.template,
                             trainer.cache, dataset_idx=batch["idx"],
                             smpl_scale=batch["smpl_scale"])
        mask_deg = sh_degree_mask(trainer.active_sh_degree, trainer.device)
        leaves = [out["xyz"], out["scales"], out["rotq"],
                  out["opacity"][:, 0], out["shs"] * mask_deg[None, :, None],
                  torch.zeros((out["xyz"].shape[0], 2),
                              device=trainer.device)]
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    w = trainer.step_cfg.weights

    def loss_of(color, t_final):
        image = color + t_final[None] * draws["bg"][:, None, None]
        photo, _ = photometric_loss(draws, image, batch["rgb"],
                                    batch["mask"], draws["bg"],
                                    w.photometric, None)
        return photo + w.silhouette * torch.mean(
            (1.0 - t_final - batch["mask"]) ** 2)

    return leaves, loss_of


def composite_bwd_inputs(trainer, leaves, loss_of):
    """Frame 0's composite_bwd inputs as the step makes them: feats,
    binning, forward output and window-entry state of the render, and
    the loss's own cotangents of colour and transmittance, re-tiled."""
    from sings_tpu_torch.ops.rasterizer import kernels as K
    from sings_tpu_torch.ops.rasterizer.api import (
        RasterConfig, _pad_tiles, image_to_tiles, prepare_composite,
        tiles_to_image,
    )
    from sings_tpu_torch.ops.rasterizer.common import preprocess

    cam = trainer.camera
    rkw = {k: trainer.raster_kw[k] for k in (
        "tile", "chunk", "max_span", "max_pairs", "main_width",
        "tail_capacity", "pair_cap")}
    cfg = RasterConfig(height=cam.height, width=cam.width, **rkw)
    with torch.no_grad():
        g2d = preprocess(*[x.detach() for x in leaves[:5]], cam, sh_degree=3,
                         alive=trainer.buffers.alive > 0.5, tile=cfg.tile)
        feats, binning = prepare_composite(g2d, cfg)
    ntx, nty = _pad_tiles(cfg)
    ckw = dict(tile=cfg.tile, chunk=cfg.chunk, n_tiles_x=ntx, n_tiles_y=nty)
    fwd_out, state = K.composite_fwd_cuda(
        feats, binning.tile_offsets, grad_offsets=binning.grad_offsets,
        grad_cap=binning.pair_slot_capacity, **ckw)
    color, t_final = (x.detach().requires_grad_(True)
                      for x in tiles_to_image(fwd_out, cfg))
    g_color, g_t = torch.autograd.grad(loss_of(color, t_final),
                                       [color, t_final])
    gout = image_to_tiles(g_color, g_t, cfg).contiguous()
    return feats, binning, fwd_out, gout, state, ckw


def check_bwd(name, got, want, binning) -> float:
    """composite_bwd against its plain version at every slot the glue
    reads (main and tail tables, the spare slot included)."""
    slots = torch.unique(torch.cat([binning.main_slot.reshape(-1),
                                    binning.tail_slot.reshape(-1)]).long())
    g, w = got[:, slots], want[:, slots]
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel gradients not finite")
    scale = w.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
    err = (g - w).abs()
    n_over = int((err > BWD_RTOL * scale).sum())
    max_rel = float((err / scale).max()) if err.numel() else 0.0
    log(f"[kernels] composite_bwd {name}: {slots.numel()} slots read, "
        f"max_abs_err={float(err.max()):.3e}, max err / row scale "
        f"{max_rel:.3e}, values over {BWD_RTOL:g} of scale: "
        f"{n_over}/{err.numel()}")
    if n_over > MAX_BWD_FLIP_FRACTION * err.numel():
        raise AssertionError(f"{name}: composite_bwd disagrees with the "
                             "plain version")
    if float(got[:, -1].abs().max()) != 0.0:
        raise AssertionError(f"{name}: the spare slot is not zero")
    return float(err.max())


class plain_composites:
    """Route rasterize's composite through the plain versions for one
    comparison (the port itself never does; CUDA tensors take the
    kernels)."""

    def __enter__(self):
        from sings_tpu_torch.ops.rasterizer import api
        from sings_tpu_torch.ops.rasterizer import kernels as K

        self.saved = (api.composite_fwd, api.composite_bwd)
        api.composite_fwd = K.composite_fwd_plain
        api.composite_bwd = K.composite_bwd_plain
        return self

    def __exit__(self, *exc):
        from sings_tpu_torch.ops.rasterizer import api

        api.composite_fwd, api.composite_bwd = self.saved


def rasterize_grads(trainer, leaves, loss_of, layout="tiled"):
    from sings_tpu_torch.ops.rasterizer.api import rasterize

    out = rasterize(*leaves[:5], trainer.camera, sh_degree=3,
                    bg=torch.zeros(3, device=trainer.device),
                    alive=trainer.buffers.alive > 0.5,
                    screen_probe=leaves[5],
                    **dict(trainer.raster_kw, layout=layout))
    loss = loss_of(out["render"], out["transmittance"])
    return loss, torch.autograd.grad(loss, leaves)


def check_grads(names, got, want, isotropic: bool) -> float:
    worst = 0.0
    for name, g, w in zip(names, got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"d/d{name} not finite")
        err = (g - w).abs()
        if isotropic and name == "quats":
            limit = ZERO_GRAD_REL * float(
                want[names.index("scales")].abs().max())
            top = max(float(g.abs().max()), float(w.abs().max()))
            log(f"[kernels] rasterize d/dquats: not compared (isotropic "
                f"avatar), max|g| kernels {float(g.abs().max()):.3e}, plain "
                f"{float(w.abs().max()):.3e}, limit {limit:.3e}")
            if not top <= limit:
                raise AssertionError("d/dquats of an isotropic avatar is "
                                     "not zero up to rounding")
            continue
        scale = float(w.abs().max())
        n_over = int((err > GRAD_ATOL_REL * scale
                      + GRAD_RTOL * w.abs()).sum())
        worst = max(worst, float(err.max()))
        log(f"[kernels] rasterize d/d{name}: max|g| "
            f"{float(w.abs().max()):.3e}, "
            f"max_abs_err {float(err.max()):.3e}, outside tolerance "
            f"{n_over}/{err.numel()}")
        if n_over > MAX_BWD_FLIP_FRACTION * err.numel():
            raise AssertionError(f"rasterize d/d{name}: kernels disagree "
                                 "with the plain versions")
    return worst


def edge_scene_bwd(dev, ekw, seed: int, gauss, cam, name) -> float:
    from sings_tpu_torch.ops.rasterizer import kernels as K

    feats, b, ckw = composite_inputs(gauss, cam, ekw)
    fwd, state = K.composite_fwd_cuda(
        feats, b.tile_offsets, grad_offsets=b.grad_offsets,
        grad_cap=b.pair_slot_capacity, **ckw)
    gen = torch.Generator(device=dev).manual_seed(seed)
    gout = torch.randn(fwd.shape, generator=gen, device=dev)
    gout[:, 4:] = 0.0
    args = (feats, b.tile_offsets, b.grad_offsets, fwd, gout, state)
    kw = dict(ckw, grad_cap=b.pair_slot_capacity)
    return check_bwd(name, K.composite_bwd_cuda(*args, **kw),
                     K.composite_bwd_plain(*args, **kw), b)


def run_train(work: str, dev, smi: str, profile_dir: str | None) -> dict:
    from sings_tpu_torch.config.core import load_config
    from sings_tpu_torch.config.defaults import DEFAULTS
    from sings_tpu_torch.losses.photometric import draw_step_randoms
    from sings_tpu_torch.ops.rasterizer import kernels as K
    from sings_tpu_torch.train.trainer import Trainer
    from sings_tpu_torch.tree import tree_leaves

    # ---- 7 train setup
    t0 = time.time()
    cfg = load_config(DEFAULTS, None, train_dotlist(work))
    trainer = Trainer(cfg, mode="train", device=dev, kit=make_train_kit(),
                      image_writer=lambda path, img: None)
    seed_train_targets(trainer)
    CALIBRATE_TARGETS.update(masks=trainer.masks.cpu().numpy(),
                             tpl=trainer.tpl)
    acfg = trainer.avatar_cfg
    n_live = int(trainer.buffers.alive.sum())
    batches = train_batches(trainer)
    k = trainer.inner_steps
    cover = [float(m.mean()) for m in trainer.masks]
    log(f"[train setup] {n_live} live gaussians in {acfg.capacity} slots, "
        f"{k} steps a chunk, knn {trainer.step_cfg.knn_backend}, laplacian "
        f"table {tuple(trainer.region_lap.neighbors.shape)}, mask cover "
        f"{min(cover):.3f}..{max(cover):.3f}, raster {trainer.raster_kw} "
        f"({time.time() - t0:.1f}s)")
    if (k != 8 or trainer.step_cfg.knn_backend != "chunk"
            or trainer.raster_kw["chunk"] != 128 or min(cover) <= 0.01):
        raise AssertionError("recipe training settings not in effect")

    # ---- 8 composite_bwd and the rasterize gradients against plain
    batch0 = {name: v[0] for name, v in batches.items()}
    draws0 = draw_step_randoms(
        torch.Generator(device=dev).manual_seed(SEED), batch0["mask"],
        trainer.step_cfg.weights.photometric)
    leaves, loss_of = step_render_inputs(trainer, batch0, draws0)
    feats, binning, fwd_out, gout, entry, ckw = composite_bwd_inputs(
        trainer, leaves, loss_of)
    bargs = (feats, binning.tile_offsets, binning.grad_offsets, fwd_out,
             gout, entry)
    bkw = dict(ckw, grad_cap=binning.pair_slot_capacity)
    got = K.composite_bwd_cuda(*bargs, **bkw)
    want, walked, composited = K.composite_bwd_plain(
        *bargs, return_counts=True, **bkw)
    torch.cuda.synchronize()
    if float(gout[:, 3].abs().max()) == 0.0:
        raise AssertionError("the silhouette term's g_t is zero")
    n_pairs = int(binning.num_pairs)
    log(f"[kernels] training frame 0: feats {tuple(feats.shape)}, pairs "
        f"{n_pairs}, walked {walked}, compositing pair-pixels "
        f"{composited}, overflow {int(binning.overflow)}, "
        f"grad_cap {binning.pair_slot_capacity}, {tile_load(binning)}")
    max_err = check_bwd("training frame 0 (the loss's cotangents)", got,
                        want, binning)
    ekw = dict(tile=16, chunk=128, max_span=8, max_pairs=None, main_width=4,
               tail_capacity=None, pair_cap=None)
    g, cam = random_scene(400, 380, 500, 1, dev)
    max_err = max(max_err, edge_scene_bwd(dev, ekw, 11, g, cam,
                                          "500x380 padding tiles"))
    max_err = max(max_err, edge_scene_bwd(dev, ekw, 12,
                                          *saturating_stack(dev),
                                          "saturating stack"))
    g, cam = random_scene(200, 64, 96, 3, dev, z=(-4.0, -1.0))
    g[0][:5] = torch.tensor([[0.3, 0.2, 3.0]], device=dev)
    max_err = max(max_err, edge_scene_bwd(dev, ekw, 13, g, cam,
                                          "empty tiles"))
    names = ["means3d", "scales", "quats", "opacities", "features",
             "screen_probe"]
    loss_k, grads_k = rasterize_grads(trainer, leaves, loss_of)
    with plain_composites():
        loss_p, grads_p = rasterize_grads(trainer, leaves, loss_of)
    log(f"[kernels] rasterize loss through the kernels "
        f"{float(loss_k.detach()):.6f}, through the plain versions "
        f"{float(loss_p.detach()):.6f}")
    check_grads(names, grads_k, grads_p,
                trainer.avatar_cfg.isotropic)
    del grads_k, grads_p, got, want
    # the panel kernels on the training frame's own cotangents, and the
    # rasterize gradients in the panel layout
    check_panel("training frame 0 (the loss's cotangents)", feats,
                binning, ckw, to_planes(gout, ckw, 0.0))
    K.reset_launches()
    loss_k, grads_k = rasterize_grads(trainer, leaves, loss_of, "panel")
    with plain_composites():
        loss_p, grads_p = rasterize_grads(trainer, leaves, loss_of, "panel")
    log(f"[kernels] panel rasterize loss through the kernels "
        f"{float(loss_k.detach()):.6f}, through the plain versions "
        f"{float(loss_p.detach()):.6f}, launches {dict(K.LAUNCHES)}")
    if (K.LAUNCHES["composite_fwd_panel"], K.LAUNCHES["composite_bwd_panel"],
            K.LAUNCHES["composite_fwd"]) != (1, 1, 0):
        raise AssertionError("panel rasterize did not run the panel kernels")
    check_grads(names, grads_k, grads_p, trainer.avatar_cfg.isotropic)
    del grads_k, grads_p, leaves

    # ---- 9 main path: 2 train_scan calls, 16 steps
    state = (trainer.params, trainer.buffers, trainer.opt_state)
    p0 = trainer.params
    K.reset_launches()
    torch.cuda.synchronize()
    times, all_losses, all_skipped = [], [], []
    for c in range(2):
        t1 = time.perf_counter()
        p, b, o, losses, skipped, metrics = trainer.train_scan(
            *state, trainer.cache, batches, trainer.step_generator,
            TRAIN_STEP0 + c * k, trainer.active_sh_degree,
            trainer.region_lap, trainer.region_lap, trainer.lap_pos_w,
            trainer.lap_color_w)
        losses_h = losses.cpu()  # waits for the chunk
        times.append(time.perf_counter() - t1)
        all_losses += losses_h.tolist()
        all_skipped += skipped.cpu().tolist()
        state = (p, b, o)
    launches = dict(K.LAUNCHES)
    p, b, o = state
    terms = {name: [round(x, 6) for x in v.cpu().tolist()]
             for name, v in metrics.items()}
    log(f"[train] 16 steps from step {TRAIN_STEP0}: chunk wall "
        f"{times[0]:.3f}s, {times[1]:.3f}s (host clock, steps/s "
        f"{k / times[0]:.3f}, {k / times[1]:.3f}), launches {launches}")
    log(f"[train] losses {[round(x, 5) for x in all_losses]}")
    log(f"[train] last chunk's terms {terms}")
    if not all(math.isfinite(x) for x in all_losses):
        raise AssertionError("a training loss is not finite")
    if any(x != 0.0 for x in all_skipped):
        raise AssertionError(f"skipped steps: {all_skipped}")
    changed = {}
    for name in ("xyz", "triplane", "geometry_dec", "appearance_dec",
                 "global_orient", "body_pose", "transl"):
        diffs = [float((a - b_).abs().max()) for a, b_ in zip(
            tree_leaves(getattr(p, name)), tree_leaves(getattr(p0, name)))]
        changed[name] = max(diffs)
        if changed[name] == 0.0:
            raise AssertionError(f"parameter group {name} did not change")
    if not torch.equal(p.betas, p0.betas):
        raise AssertionError("betas changed although optim_betas is False")
    visible = b.grad_denom > 0
    accum = float(b.xyz_grad_accum[visible].max()) if bool(
        visible.any()) else 0.0
    log(f"[train] largest parameter change per group {changed}; "
        f"{int(visible.sum())} slots seen, max xyz_grad_accum {accum:.3e}, "
        f"Adam count {int(o.count)}")
    if accum <= 0.0:
        raise AssertionError("xyz_grad_accum is zero on every visible slot")
    for name in ("composite_fwd", "composite_bwd"):
        if launches[name] != 2 * k:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in {2 * k} steps, not {2 * k}")
    if K.STATE_WRITES["composite_fwd"] != 2 * k:
        raise AssertionError(f"the state was written {K.STATE_WRITES} "
                             f"times in {2 * k} steps")

    # ---- 10 timing of composite_bwd at frame 0's shapes
    ms = cuda_ms(lambda: K.composite_bwd_cuda(*bargs, **bkw))
    plain_ms = cuda_ms(lambda: K.composite_bwd_plain(*bargs, **bkw), n=5,
                       warm=1)
    n_tiles = ckw["n_tiles_x"] * ckw["n_tiles_y"]
    npx = ckw["tile"] ** 2
    ops = (OPS_PER_PAIR_PIXEL_BWD * walked * npx
           + OPS_PER_COMPOSITE_BWD * composited)
    # walked feats rows, both offset tables, rows 0-3 of the forward
    # output and of the cotangents, the 9-row gradient buffer written
    nbytes = 4 * (9 * walked + 2 * (n_tiles + 1) + 2 * n_tiles * 4 * npx
                  + 9 * binning.pair_slot_capacity)
    ops_ms = ops / H100_FP32_FLOPS * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f"[timing] composite_bwd {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"walked pairs {walked} of {n_pairs}, compositing pair-pixels "
        f"{composited}, overflow {int(binning.overflow)}, bound "
        f"{bound_ms:.4f} ms (ops {ops_ms:.4f} ms, bytes {bytes_ms:.4f} ms)"
        f", 1 launch per "
        f"step | {smi}")
    if profile_dir:
        profile_train(trainer, batches, bargs, bkw, profile_dir)
    # the backward's experiment forms on this frame (phase 14's checks)
    forms_on_frame("phase 7 training frame", bargs, bkw, binning, smi)
    bwd_row = {
        "name": "composite_bwd", "route": "cuda",
        "source": "sings_tpu_torch/csrc/composite_bwd.cu",
        "replaces": "sings_tpu/ops/rasterizer/pallas_kernels.py:912",
        "launches": launches["composite_bwd"], "max_abs_err": max_err,
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }
    # ---- 11 the training entry point, 12 its timing
    del p, b, o, state, bargs, feats, binning, fwd_out, gout, entry
    return [bwd_row] + run_entry(work, dev, trainer, batches, smi)


# ---------------------------------------------------------------------------
# the training entry point (phases 11-12)

def run_entry(work: str, dev, old, batches, smi: str) -> list:
    """Phase 11: on `old`, the recipe's pre-fit and one 8-step chunk
    (steps 1982-1989), saved by save_ckpt as the step-1990 checkpoint;
    then the training entry point, cli.train.main with ENTRY_DOTLIST over
    the same run directory: its Trainer resumes from that checkpoint,
    train() runs to ENTRY_STEPS, and the CLI writes its exports.
    Phase 12 on the trainer the CLI leaves. Returns the panel kernels'
    rows of the kernels line."""
    from sings_tpu_torch.cli import train as cli_train
    from sings_tpu_torch.config.core import load_config
    from sings_tpu_torch.config.defaults import DEFAULTS
    from sings_tpu_torch.mesh import native
    from sings_tpu_torch.ops.rasterizer import kernels as K
    from sings_tpu_torch.train.trainer import Trainer
    from sings_tpu_torch.tree import tree_leaves

    t0 = time.time()
    old.cfg.train.init_steps = RECIPE_INIT_STEPS
    old._init_attrs()
    torch.cuda.synchronize()
    t_fit = time.time() - t0
    k = len(batches["idx"])
    (old.params, old.buffers, old.opt_state, losses, skipped,
     _) = old.train_scan(old.params, old.buffers, old.opt_state, old.cache,
                         batches, old.step_generator, CKPT_STEP - k,
                         old.active_sh_degree, old.region_lap, old.region_lap,
                         old.lap_pos_w, old.lap_color_w)
    log(f"[entry] pre-fit {RECIPE_INIT_STEPS} steps in {t_fit:.1f}s, then "
        f"steps {CKPT_STEP - k}-{CKPT_STEP - 1}: losses "
        f"{[round(x, 4) for x in losses.tolist()]}, skipped "
        f"{int(skipped.sum())}")
    old.step = CKPT_STEP
    ck_path = old.save_ckpt(f"{CKPT_STEP:06d}")
    saved = [old.params, old.opt_state]
    kit = make_train_kit()._replace(images=old.images.cpu().numpy(),
                                    masks=old.masks.cpu().numpy())
    del old
    torch.cuda.empty_cache()
    argv = ["--device", "cuda"] + train_dotlist(
        work, ENTRY_DOTLIST + [f"anim_cfg_path={work}/anim.json"])
    log(f"[entry] dotlist over the recipe: {ENTRY_DOTLIST}")
    log(f"[entry] python -m sings_tpu_torch.cli.train {' '.join(argv)} "
        "(the kit held in memory: cli.train.main(argv, kit=, "
        "image_writer=))")

    split = {"chunks": 0.0, "density": 0.0, "validation": 0.0,
             "checkpoint": 0.0}
    ran, density, vals, ckpts, written = [], [], [], [], []
    held = {}
    orig_train = Trainer.train

    def train_checked(tr):
        """The CLI trainer's train(): its resume and event schedule
        checked, the loop's pieces timed, then the loop itself."""
        count = int(tr.opt_state.count)
        same = all(torch.equal(a, b_) for a, b_ in zip(
            tree_leaves((tr.params, tr.opt_state.mu, tr.opt_state.nu)),
            tree_leaves((saved[0], saved[1].mu, saved[1].nu))))
        log(f"[entry] resumed {os.path.basename(ck_path)}: step {tr.step}, "
            f"Adam count {count}, params and moments equal to the saved "
            f"ones: {same}, raster {tr.raster_kw} ({time.time() - t0:.1f}s)")
        if tr.step != CKPT_STEP or count != int(saved[1].count) or not same:
            raise AssertionError("the resumed Trainer does not hold the "
                                 "checkpoint's step and Adam state")
        saved.clear()
        events = [t for t in range(CKPT_STEP, ENTRY_STEPS)
                  if tr._is_event(t)]
        log(f"[entry] _is_event in [{CKPT_STEP}, {ENTRY_STEPS}): {events}")
        if events != ENTRY_EVENTS:
            raise AssertionError(f"events {events}, expected {ENTRY_EVENTS}")

        def timed(fn, key, record=None):
            def call(*a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                split[key] += time.perf_counter() - t
                if record is not None:
                    record(a, out)
                return out
            return call

        apply = tr._apply_density_result

        def apply_checked(res):
            before = int(tr.buffers.alive.sum())
            apply(res)
            after = int(tr.buffers.alive.sum())
            changed = torch.as_tensor(res.changed_slots, device=dev) > 0.5
            mu, nu = tr.opt_state.mu.xyz[changed], tr.opt_state.nu.xyz[changed]
            zero = (float(mu.abs().max()) == 0.0
                    and float(nu.abs().max()) == 0.0)
            log(f"[entry] density event after step {tr.step}: live "
                f"{before} -> {after}, {int(changed.sum())} slots changed, "
                f"Adam mu/nu zero there: {zero}")
            if not zero:
                raise AssertionError("Adam moments not zeroed at changed "
                                     "slots")
            density.append((tr.step, before, after))

        tr._apply_density_result = apply_checked
        tr.train_step = timed(tr.train_step, "chunks",
                              lambda a, out: ran.append((a[6], 1)))
        tr.train_scan = timed(tr.train_scan, "chunks", lambda a, out: ran.append(
            (a[6], len(a[4]["idx"]))))
        tr._adjust_density = timed(tr._adjust_density, "density")
        tr.validate = timed(tr.validate, "validation",
                            lambda a, out: vals.append((tr.step, out)))
        tr.save_ckpt = timed(tr.save_ckpt, "checkpoint",
                             lambda a, out: ckpts.append((tr.step, out)))
        held.update(tr=tr, count=count, runs0=dict(native.COLLAPSE_RUNS),
                    before=dict(K.LAUNCHES),
                    states0=K.STATE_WRITES["composite_fwd_panel"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        result = orig_train(tr)
        torch.cuda.synchronize()
        split["wall"] = time.perf_counter() - t1
        held["window"] = {name: K.LAUNCHES[name] - held["before"][name]
                          for name in K.LAUNCHES}
        held["states"] = (K.STATE_WRITES["composite_fwd_panel"]
                          - held["states0"])
        return result

    # ---- 11 main path: the CLI, launches counted from 0
    Trainer.train = train_checked
    K.reset_launches()
    torch.cuda.synchronize()
    t_cli = time.perf_counter()
    try:
        result = cli_train.main(argv, kit=kit, image_writer=lambda path, img:
                                written.append((path, img.shape)))
    finally:
        Trainer.train = orig_train
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t_cli
    launches = dict(K.LAUNCHES)
    tr, window = held["tr"], held["window"]
    wall = split["wall"]
    split["other"] = wall - sum(v for k, v in split.items() if k != "wall")
    log(f"[entry] cli.train.main: {t_cli:.3f}s host clock, train() "
        f"{CKPT_STEP} -> {tr.step} {wall:.3f}s, exports "
        f"{t_cli - wall:.3f}s; split {json.dumps({k: round(v, 3) for k, v in split.items()})}")
    log(f"[entry] chunks (first step, steps): {ran}")
    log(f"[entry] validations after step {[v[0] for v in vals]}, "
        f"checkpoints {[(c[0], os.path.basename(c[1])) for c in ckpts]}, "
        f"density {density}, collapse runs {native.COLLAPSE_RUNS}")
    log(f"[entry] final validation {json.dumps(result)}")

    # events at the predicted steps; no chunk crosses one
    steps = [t for t0_, k in ran for t in range(t0_, t0_ + k)]
    if steps != list(range(CKPT_STEP, ENTRY_STEPS)):
        raise AssertionError(f"steps run {steps}")
    singles = [t for t, k in ran if k == 1]
    if not set(ENTRY_EVENTS) <= set(singles):
        raise AssertionError(f"event steps not run alone: {ran}")
    if [v[0] for v in vals] != [2000, ENTRY_STEPS] or result != vals[-1][1]:
        raise AssertionError(f"validations after steps {vals}, CLI result "
                             f"{result}")
    if [(c[0], os.path.basename(c[1])) for c in ckpts] != [
            (2010, "human_002010.npz"), (ENTRY_STEPS, "human_final.npz")]:
        raise AssertionError(f"checkpoints {ckpts}")
    if not any(before != after for _, before, after in density):
        raise AssertionError(f"no density event changed the live count: "
                             f"{density}")
    runs0 = held["runs0"]
    if native.COLLAPSE_RUNS["native"] <= runs0["native"] or \
            native.COLLAPSE_RUNS["numpy"] != runs0["numpy"]:
        raise AssertionError("the native edge collapse did not run")
    for it, res in vals:
        for key in ("psnr", "ssim", "lpips", "psnr_masked", "psnr_composite",
                    "psnr_masked_refined", "psnr_masked_aligned",
                    "psnr_masked_train", "scales_p99", "opacity_mean"):
            if not math.isfinite(res.get(key, float("nan"))):
                raise AssertionError(f"validation after {it}: {key} "
                                     f"missing or not finite")
    if int(tr.opt_state.count) != held["count"] + ENTRY_STEPS - CKPT_STEP:
        raise AssertionError(f"Adam count {int(tr.opt_state.count)}")

    # the launches the window implies: one of each panel kernel a step;
    # per validation and val frame a render, a gauge-aligned render, the
    # refine steps (forward and backward each) and the refined render,
    # plus the train-frame diagnostics' renders; then the CLI's exports:
    # the .splat's render, the animation's frames and both turntables
    n_steps = ENTRY_STEPS - CKPT_STEP
    refine = int(tr.cfg.tpu.val_pose_refine_steps)
    n_val = len(tr.kit.val_split)
    n_diag = len(tr.kit.train_split[::max(1, len(tr.kit.train_split)
                                          // 8)][:8])
    n_anim = tr.anim_dataset.num_frames
    # animate_chunk renders whole 16-frame chunks, the last one padded
    n_anim_renders = -(-n_anim // 16) * 16
    n_canon = int(tr.cfg.human.canon_nframes)
    want = {"composite_fwd_panel": n_steps + len(vals) * (
                n_val * (3 + refine) + n_diag),
            "composite_bwd_panel": n_steps + len(vals) * n_val * refine,
            "composite_fwd": 0, "composite_bwd": 0}
    want_all = dict(want, composite_fwd_panel=want["composite_fwd_panel"]
                    + 1 + n_anim_renders + 2 * n_canon)
    log(f"[entry] launches in train() {window}, expected {want} ({n_steps} "
        f"steps, {len(vals)} validations of {n_val} val frame(s) with "
        f"{refine} refine steps and {n_diag} train-frame renders); in the "
        f"whole CLI call {launches}, expected {want_all} (+1 .splat render, "
        f"{n_anim_renders} animation renders, 2 x {n_canon} turntable "
        "frames)")
    if window != want or launches != want_all:
        raise AssertionError("panel kernel launches differ from the count "
                             "the CLI run implies")
    # only the forwards that a backward follows write the window-entry
    # state: the steps and the refine steps, not the validation's
    # renders under no_grad nor the exports
    states = K.STATE_WRITES["composite_fwd_panel"]
    log(f"[entry] forwards that wrote the state: {held['states']} in "
        f"train(), {states} in the whole CLI call (the backward's launches: "
        f"{want['composite_bwd_panel']})")
    if not held["states"] == states == want["composite_bwd_panel"]:
        raise AssertionError("the state was written by forwards that no "
                             "backward follows, or missed by one")

    # the CLI's outputs
    cfg_path = os.path.join(tr.logdir, "config_train.yaml")
    back = load_config(DEFAULTS, cfg_path)
    mesh_dir = os.path.join(tr.logdir, "meshes")
    sizes = {f: os.path.getsize(os.path.join(mesh_dir, f))
             for f in sorted(os.listdir(mesh_dir)) if "final" in f}
    sizes["showcase.splat"] = os.path.getsize(os.path.join(
        tr.logdir, "showcase.splat"))
    kinds = {}
    for path, shape in written:
        kind = os.path.basename(os.path.dirname(path))
        if kind == "canon":
            kind = os.path.basename(path).rsplit("_", 1)[0]
        kinds.setdefault(kind, set()).add(tuple(shape))
        kinds[kind + " images"] = kinds.get(kind + " images", 0) + 1
    log(f"[entry] exports {sizes}; images {json.dumps({k: v if isinstance(v, int) else sorted(v) for k, v in kinds.items()})}; "
        f"config_train.yaml reads back: layout {back.tpu.raster.layout}, "
        f"num_steps {back.train.num_steps}")
    if len(sizes) != 3 or min(sizes.values()) == 0:
        raise AssertionError("an export is empty")
    if (kinds.get("a_pose images"), kinds.get("da_pose images"),
            kinds.get("anim images"), kinds.get("a_pose")) != (
            n_canon, n_canon, n_anim, {(256, 256, 3)}):
        raise AssertionError("the CLI's turntables or animation frames "
                             "are missing")
    if (back.tpu.raster.layout, back.train.num_steps) != ("panel",
                                                          ENTRY_STEPS):
        raise AssertionError("config_train.yaml does not read back")

    rows = panel_timing(tr, launches, split, smi)

    # the step-2010 checkpoint resumes to its step
    path = os.path.join(tr.logdir_ckpt, "human_002010.npz")
    if not tr.load_ckpt(path) or tr.step != 2010:
        raise AssertionError("the step-2010 checkpoint does not resume")
    log(f"[entry] {os.path.basename(path)} resumes to step {tr.step}, Adam "
        f"count {int(tr.opt_state.count)}")
    return rows


def panel_timing(tr, launches: dict, split: dict, smi: str) -> list:
    """Phase 12, on the trainer the CLI left at step ENTRY_STEPS: its
    first training frame and the loss's own cotangents (the scene the
    train() window rendered). Both panel kernels against their plain
    versions and, bit for bit, the tiled kernels; their CUDA-event times
    and their plain versions', with bounds counted as the tiled kernels'
    are; the tiled kernels' times on the same inputs; the loop's
    host-clock split. Returns the panel kernels' kernels-line rows."""
    from sings_tpu_torch.losses.photometric import draw_step_randoms
    from sings_tpu_torch.ops.rasterizer import kernels as K

    batch0 = {name: v[0] for name, v in train_batches(tr).items()}
    draws0 = draw_step_randoms(
        torch.Generator(device=tr.device).manual_seed(SEED), batch0["mask"],
        tr.step_cfg.weights.photometric)
    leaves, loss_of = step_render_inputs(tr, batch0, draws0)
    feats, binning, fwd_t, gout_t, entry, ckw = composite_bwd_inputs(
        tr, leaves, loss_of)
    del leaves
    offs, goffs = binning.tile_offsets, binning.grad_offsets
    cap = binning.pair_slot_capacity
    pkw = panel_kw(ckw)
    skw = dict(grad_offsets=goffs, grad_cap=cap)
    gout_p = to_planes(gout_t, ckw, 0.0)
    check_panel("train() window's frame (the loss's cotangents)", feats,
                binning, ckw, gout_p)
    # the backward's experiment forms on this frame (phase 14's checks)
    forms_on_frame("phase 12 trained-avatar frame",
                   (feats, offs, goffs, fwd_t, gout_t, entry),
                   dict(ckw, grad_cap=cap), binning, smi)
    fwd_p, entry_p = K.composite_fwd_cuda(feats, offs, **skw, **pkw)
    _, walked, composited = K.composite_bwd_plain(
        feats, offs, goffs, fwd_p, gout_p, entry_p, grad_cap=cap,
        return_counts=True, **pkw)
    hp, wp = fwd_p.shape[1:]
    n_tiles = ckw["n_tiles_x"] * ckw["n_tiles_y"]
    npx = ckw["tile"] ** 2
    log(f"[timing] the window's frame {int(batch0['idx'])} at step "
        f"{tr.step}: {int(tr.buffers.alive.sum())} live gaussians, pairs "
        f"{int(binning.num_pairs)}, walked {walked}, compositing "
        f"pair-pixels {composited}, overflow {int(binning.overflow)}, "
        f"{tile_load(binning)}")
    rows = []
    for name, fn, plain, ops, nbytes in (
            ("composite_fwd_panel",
             lambda: K.composite_fwd_cuda(feats, offs, return_state=False,
                                          **skw, **pkw),
             lambda: K.composite_fwd_plain(feats, offs, **pkw),
             OPS_PER_PAIR_PIXEL * walked * npx,
             4 * (9 * walked + 2 * (n_tiles + 1) + 4 * hp * wp)),
            ("composite_bwd_panel",
             lambda: K.composite_bwd_cuda(
                 feats, offs, goffs, fwd_p, gout_p, entry_p, grad_cap=cap,
                 **pkw),
             lambda: K.composite_bwd_plain(
                 feats, offs, goffs, fwd_p, gout_p, entry_p, grad_cap=cap,
                 **pkw),
             OPS_PER_PAIR_PIXEL_BWD * walked * npx
             + OPS_PER_COMPOSITE_BWD * composited,
             4 * (9 * walked + 2 * (n_tiles + 1) + 2 * 4 * hp * wp
                  + 9 * cap))):
        ms = cuda_ms(fn)
        plain_ms = cuda_ms(plain, n=5, warm=1)
        ops_ms = ops / H100_FP32_FLOPS * 1e3
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        log(f"[timing] {name} {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms (ops {ops_ms:.4f} ms, bytes "
            f"{bytes_ms:.4f} ms), {launches[name]} launches in the CLI "
            f"call | {smi}")
        rows.append({
            "name": name, "route": "cuda",
            "source": "sings_tpu_torch/csrc/"
                      + name.replace("_panel", "") + ".cu",
            "replaces": "sings_tpu/ops/rasterizer/pallas_kernels.py:"
                        + ("789" if name == "composite_fwd_panel" else "827"),
            "launches": launches[name], "max_abs_err": None,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
        })
    # the forward as the training step runs it, with the state, in turns
    # with the forward without it
    turns = [cuda_ms(lambda: K.composite_fwd_cuda(
        feats, offs, return_state=i % 2 == 0, **skw, **pkw))
        for i in range(4)]
    rows[0]["ms_with_state"] = turns[0]
    tiled_f = cuda_ms(lambda: K.composite_fwd_cuda(
        feats, offs, return_state=False, **skw, **ckw))
    tiled_b = cuda_ms(lambda: K.composite_bwd_cuda(
        feats, offs, goffs, fwd_t, gout_t, entry, grad_cap=cap, **ckw))
    log(f"[timing] composite_fwd_panel in turns with / without / with / "
        f"without the state: {', '.join(f'{t:.4f}' for t in turns)} ms; "
        f"for comparison, the tiled layout on the same inputs: "
        f"composite_fwd {tiled_f:.4f} ms, composite_bwd {tiled_b:.4f} ms "
        f"| {smi}")
    wall = split["wall"]
    log("[timing] train() window " + ", ".join(
        f"{k} {v:.3f}s ({100 * v / wall:.1f}%)" for k, v in split.items()
        if k != "wall") + f" of {wall:.3f}s host clock | {smi}")
    return rows


def profile_train(trainer, batches, bargs, bkw, out_dir: str) -> None:
    """Stage times of one full-width training step (CUDA events, each
    stage alone) and a torch.profiler trace of one 8-step chunk."""
    from sings_tpu_torch.losses.photometric import (
        draw_step_randoms, photometric_loss,
    )
    from sings_tpu_torch.losses.regularizers import (
        gaussians_edge_loss_from_stat, l2_norm_loss, mesh_edge_loss,
    )
    from sings_tpu_torch.losses.regularizers import edge_stat
    from sings_tpu_torch.model.avatar import avatar_forward, get_canon_xyz
    from sings_tpu_torch.ops.rasterizer import kernels as K
    from sings_tpu_torch.ops.rasterizer.api import (
        RasterConfig, prepare_composite, rasterize, unsort_pair_grads,
    )
    from sings_tpu_torch.ops.rasterizer.common import preprocess
    from sings_tpu_torch.tree import tree_leaves, tree_map

    os.makedirs(out_dir, exist_ok=True)
    dev = trainer.device
    tr = trainer
    w = tr.step_cfg.weights
    batch = {name: v[0] for name, v in batches.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    draws = draw_step_randoms(gen, batch["mask"], w.photometric)
    es = edge_stat(get_canon_xyz(tr.params, tr.buffers, tr.avatar_cfg),
                   tr.buffers.alive)
    pair_grads = K.composite_bwd_cuda(*bargs, **bkw)

    def fwd():
        p = tree_map(lambda x: x.detach().requires_grad_(True), tr.params)
        return p, avatar_forward(p, tr.buffers, tr.avatar_cfg, tr.template,
                                 tr.cache, dataset_idx=batch["idx"],
                                 smpl_scale=batch["smpl_scale"])

    p, out = fwd()

    def raster():
        return rasterize(out["xyz"], out["scales"], out["rotq"],
                         out["opacity"][:, 0], out["shs"], tr.camera,
                         sh_degree=3, bg=draws["bg"],
                         alive=tr.buffers.alive > 0.5, **tr.raster_kw)

    pkg = raster()
    n = tr.avatar_cfg.capacity

    def losses():
        photo, _ = photometric_loss(draws, pkg["render"], batch["rgb"],
                                    batch["mask"], draws["bg"],
                                    w.photometric, None)
        reg = l2_norm_loss(w.l2, out["xyz_offsets"], out["scales"], None,
                           tr.buffers.alive)
        edge = mesh_edge_loss(out["xyz_canon"].detach(), tr.buffers.edges,
                              tr.buffers.edge_valid)
        conn = gaussians_edge_loss_from_stat(es, out["scales"],
                                             tr.buffers.alive)
        lap = tr.region_lap.loss_fused([
            (out["xyz_anchor_canon"], tr.lap_pos_w, None),
            (out["xyz_canon"], torch.ones_like(tr.lap_pos_w), [6, 7]),
            (out["shs"][:, 0], tr.lap_color_w, None)])
        return photo + reg + edge + conn + sum(lap)

    grads = [torch.zeros_like(x) for x in tree_leaves(tr.params)]
    it = iter(grads)
    grad_tree = tree_map(lambda _: next(it), tr.params)

    with torch.no_grad():
        g2d = preprocess(out["xyz"], out["scales"], out["rotq"],
                         out["opacity"][:, 0], out["shs"], tr.camera,
                         sh_degree=3, alive=tr.buffers.alive > 0.5)
        rkw = {k: tr.raster_kw[k] for k in (
            "tile", "chunk", "max_span", "max_pairs", "main_width",
            "tail_capacity", "pair_cap")}
        _, binning = prepare_composite(g2d, RasterConfig(
            height=tr.camera.height, width=tr.camera.width, **rkw))
    stages = [
        ("avatar forward (decode + pose)", lambda: fwd()),
        ("rasterize forward", raster),
        ("composite_bwd kernel", lambda: K.composite_bwd_cuda(*bargs,
                                                              **bkw)),
        ("un-sort glue", lambda: unsort_pair_grads(pair_grads, binning, n)),
        ("losses forward", losses),
        ("KNN statistic (once per chunk)", lambda: edge_stat(
            get_canon_xyz(tr.params, tr.buffers, tr.avatar_cfg),
            tr.buffers.alive)),
        ("optimizer update", lambda: tr.tx.update(grad_tree, tr.opt_state,
                                                  tr.params)),
        ("whole train_step", lambda: tr.train_step(
            tr.params, tr.buffers, tr.opt_state, tr.cache, batch, gen,
            TRAIN_STEP0, 0, tr.region_lap, tr.region_lap, tr.lap_pos_w,
            tr.lap_color_w, edge_stat=es)),
    ]
    # the composite kernels each stage launches
    needs = {"rasterize forward": ["composite_fwd"],
             "composite_bwd kernel": ["composite_bwd"],
             "whole train_step": ["composite_fwd", "composite_bwd"]}
    lines = [f"{'stage':40s} {'events ms':>10s} {'kernels ms':>10s} "
             f"{'composite':>10s} {'pre':>4s}  (events: 5 back-to-back "
             "calls, host issue included; kernels: device time, profiler; "
             "composite: the composite kernels' share; pre: of the "
             f"{PREAMBLE} preamble kernels, those the profiler recorded)"]
    for name, fn in stages:
        t = cuda_ms(fn, n=5, warm=1)
        d, comp, seen, prof = profiled(fn)
        if name in needs:
            require_seen(name, comp, needs[name], prof, out_dir)
        lines.append(f"{name:40s} {t:10.4f} {d:10.4f} "
                     f"{sum(comp.values()):10.4f} {seen:4d}")

    def chunk():
        out = tr.train_scan(tr.params, tr.buffers, tr.opt_state, tr.cache,
                            batches, gen, TRAIN_STEP0, 0, tr.region_lap,
                            tr.region_lap, tr.lap_pos_w, tr.lap_color_w)
        out[3].cpu()

    chunk()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, comp, _, prof = profiled(chunk)
    require_seen("8-step chunk", comp, ["composite_fwd", "composite_bwd"],
                 prof, out_dir)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:15]
    lines.append(f"8-step chunk: wall {wall_ms:.3f} ms unprofiled (host "
                 f"clock), device kernels {busy_ms:.3f} ms (busy "
                 f"{100 * busy_ms / wall_ms:.1f}% of the unprofiled wall)")
    for e in top:
        lines.append(f"  {e.self_device_time_total / 1e3:10.3f} ms "
                     f"{e.count:6d}x  {e.key[:90]}")
    for line in lines:
        log(f"[profile train] {line}")
    with open(os.path.join(out_dir, "profile_train.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# the experiment kernels (phases 13-14): sings_tpu_torch.scripts

# row 6 against its plain version: each step's row sums are taken in
# another order (tri and tri3 on the tensor cores, TF32 hi + lo parts;
# both accumulate the steps in float64, one after another, in the same
# CTA split), within this share of the largest output
SCAN_RTOL = 1e-5
# fp32 operations per element and step that the function needs, in
# every mode: the scaled copy la (1), the running sum down the rows (1),
# minus la for the exclusive sum (1) and the row sum (1), as the cumsum
# mode does them (csrc/chunk_scan_bench.cu; tri and tri3 multiply by the
# 0/1 triangle on the tensor cores). The bound takes them at the card's
# fp32 rate (the steps spread over every SM); the run on one CTA
# (ms_one_cta) is held to one SM's share of it (bound_one_sm_ms)
SCAN_FN_OPS = 4
H100_SMS = 132
# the backward forms: every form computes composite_bwd's gradients, and
# composite_bwd's form needs the fewest operations (34 per compositing
# pair-pixel; composite_bwd_variants.cu counts v1 61, v3 48, the moment
# forms 36 and 39 per written pair), so each form's bound is
# composite_bwd's: OPS_PER_PAIR_PIXEL_BWD, OPS_PER_COMPOSITE_BWD
FORMS = ("moments", "v1", "v3", "v4", "v2")
# the scripts' own check against composite_bwd: 2e-4 * max(scale, 1)
# (scripts/exp_bwd_moments.py:276)
SCRIPT_RTOL = 2e-4
FORM_REPLACES = {"moments": "scripts/exp_bwd_moments.py:199",
                 "v1": "scripts/exp_bwd_variants.py:259",
                 "v3": "scripts/exp_bwd_variants.py:259",
                 "v4": "scripts/exp_bwd_variants.py:259",
                 "v2": "scripts/exp_bwd_variants.py:259"}
# largest kernel-vs-plain error of each form over every check, and the
# gaps to composite_bwd on the human_complex frames (reported only)
FORM_ERRS = {f: 0.0 for f in FORMS}
FRAME_GAPS = {}


def form_fns(form: str, kw: dict):
    from sings_tpu_torch.ops.rasterizer import variants as V

    if form == "moments":
        return (lambda *a: V.composite_bwd_moments_cuda(*a, **kw),
                lambda *a: V.composite_bwd_moments_plain(*a, **kw))
    return (lambda *a: V.composite_bwd_variant_cuda(*a, variant=form, **kw),
            lambda *a: V.composite_bwd_variant_plain(*a, variant=form, **kw))


def written_gap(got, ref, binning) -> tuple:
    """Largest |got - ref| on the slots the kernels write, and that over
    max(scale, 1) (the scripts' measure) and over each row's scale."""
    from sings_tpu_torch.scripts._scene import written_slots

    slots = written_slots(binning)
    g, r = got[:, slots], ref[:, slots]
    err = (g - r).abs()
    scale = r.abs().amax(dim=1).clamp_min(1e-12)
    return (float(err.max()), float(err.max()) / max(float(r.abs().max()),
                                                     1.0),
            float((err.amax(dim=1) / scale).max()))


def forms_on_frame(name: str, args, kw: dict, binning, smi: str) -> None:
    """The five backward forms on a human_complex frame: each against its
    plain version (asserted, as composite_bwd is), v2 bitwise v4, the
    gap to composite_bwd on the same inputs (reported), and the times of
    all six kernels there (ops.timing.device_time, as the entry points
    time them)."""
    from sings_tpu_torch.ops.rasterizer import kernels as K
    from sings_tpu_torch.ops.timing import device_time

    def ms(fn) -> float:
        return device_time(fn, args, k1=1, k2=6, repeats=2) * 1e3

    ref = K.composite_bwd_cuda(*args, **kw)
    times = {"composite_bwd": ms(lambda *a: K.composite_bwd_cuda(*a, **kw))}
    outs, gaps = {}, {}
    for form in FORMS:
        fn, plain = form_fns(form, kw)
        outs[form] = fn(*args)
        torch.cuda.synchronize()
        FORM_ERRS[form] = max(FORM_ERRS[form], check_bwd(
            f"{form} {name}", outs[form], plain(*args), binning))
        gaps[form] = written_gap(outs[form], ref, binning)
        times[form] = ms(fn)
    if not torch.equal(outs["v2"], outs["v4"]):
        raise AssertionError(f"{name}: v2 is not bitwise equal to v4")
    FRAME_GAPS[name] = gaps
    log(f"[experiments] {name}: gap to composite_bwd (max abs, over "
        f"max(scale, 1), over the row's scale): " + ", ".join(
            f"{f} {g[0]:.3e} / {g[1]:.3e} / {g[2]:.3e}"
            for f, g in gaps.items()))
    log(f"[experiments] {name}: ms " + ", ".join(
        f"{f} {t:.4f}" for f, t in times.items()) + f" | {smi}")


def run_scan(dev, smi: str) -> list:
    """Phase 13: the entry point exp_cumsum_kernel at 4096 steps on
    every SM (its default), its launches counted from 0; each mode's
    kernel against its plain version with the same CTA split, at the SM
    count and at one CTA; times per step against the bound and one
    torch.cumsum over the block, and the entry point's times at one CTA
    (ms_one_cta) against one SM's share. Returns row 6's kernels-line
    rows, one per mode, in ms per step."""
    from sings_tpu_torch.device import set_full_float32
    from sings_tpu_torch.ops import scan_bench as SB
    from sings_tpu_torch.scripts import exp_cumsum_kernel

    set_full_float32()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    SB.reset_launches()
    torch.cuda.synchronize()
    res = exp_cumsum_kernel.main(["--device", "cuda"])
    torch.cuda.synchronize()
    launches = dict(SB.MODE_LAUNCHES)
    steps = res["steps"]
    log(f"[scan] exp_cumsum_kernel.main: {steps} steps on {res['ctas']} "
        f"CTAs, launches {launches} ({SB.LAUNCHES['chunk_scan_bench']} in "
        "all)")
    if res["ctas"] != sms:
        raise AssertionError(f"the entry point ran {res['ctas']} CTAs, not "
                             f"the card's {sms} SMs")
    one = exp_cumsum_kernel.main(["--device", "cuda", "--ctas", "1"])
    x = torch.from_numpy(np.random.RandomState(SEED).randn(
        SB.CHUNK, SB.NPX).astype(np.float32)).to(dev)
    lib_ms = cuda_ms(lambda: torch.cumsum(x, dim=0), n=200, warm=10)
    rows = []
    for mode in SB.MODES:
        if launches[mode] == 0:
            raise AssertionError(f"chunk_scan_bench {mode} never launched")
        errs = {}
        for ctas in (sms, 1):
            got = SB.chunk_scan_bench_cuda(x, mode=mode, ctas=ctas)
            want = SB.chunk_scan_bench_plain(x, mode=mode, ctas=ctas)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            if not bool(torch.isfinite(got).all()) or rel > SCAN_RTOL:
                raise AssertionError(f"chunk_scan_bench {mode} at {ctas} "
                                     f"CTAs disagrees with its plain "
                                     f"version: {rel:.3e}")
            errs[ctas] = (err, rel)
        plain_ms = cuda_ms(lambda: SB.chunk_scan_bench_plain(
            x, mode=mode, ctas=sms), n=2, warm=1)
        ms = res["modes"][mode]["ms"]
        ms_one = one["modes"][mode]["ms"]
        ops = SCAN_FN_OPS * SB.CHUNK * SB.NPX * steps
        ops_ms = ops / H100_FP32_FLOPS * 1e3
        bytes_ms = 4 * (SB.CHUNK * SB.NPX + SB.NPX) / H100_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        one_sm_ms = ops / (H100_FP32_FLOPS / H100_SMS) * 1e3
        log(f"[scan] {mode}: {ms:.4f} ms for {steps} steps on {sms} CTAs "
            f"({1e3 * ms / steps:.6f} us a step), on one CTA {ms_one:.4f} "
            f"ms ({1e3 * ms_one / steps:.4f} us a step), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.6f} ms (the card; one "
            f"SM's share {one_sm_ms:.4f} ms), torch.cumsum of the block "
            f"{1e3 * lib_ms:.4f} us, max_abs_err {errs[sms][0]:.3e} (rel "
            f"{errs[sms][1]:.2e}; one CTA {errs[1][0]:.3e}, rel "
            f"{errs[1][1]:.2e}) | {smi}")
        rows.append({
            "name": f"chunk_scan_bench[{mode}] (ms per step)",
            "route": "cuda",
            "source": "sings_tpu_torch/csrc/chunk_scan_bench.cu",
            "replaces": "scripts/exp_cumsum_kernel.py:73",
            "launches": launches[mode],
            "max_abs_err": max(e[0] for e in errs.values()),
            "ms": ms / steps, "plain_ms": plain_ms / steps,
            "bound_ms": bound_ms / steps,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ms_one_cta": ms_one / steps,
            "bound_one_sm_ms": one_sm_ms / steps,
            "library_ms": lib_ms,
        })
    return rows


def run_experiments(dev, smi: str) -> list:
    """Phase 14: the entry points exp_bwd_moments and exp_bwd_variants
    at their full sizes, launches counted from 0; then on each bench
    scene every form against its plain version and, at the scripts'
    tolerance, against composite_bwd; v2 bitwise v4; bounds. The times
    of the forms and of composite_bwd on the same inputs are the entry
    points' own. Returns rows 5 and 7 of the kernels line."""
    from sings_tpu_torch.ops.rasterizer import kernels as K
    from sings_tpu_torch.ops.rasterizer import variants as V
    from sings_tpu_torch.scripts import exp_bwd_moments, exp_bwd_variants
    from sings_tpu_torch.scripts._scene import bench_scene

    V.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    res_m = exp_bwd_moments.main(["--device", "cuda"])
    res_v = exp_bwd_variants.main(["--device", "cuda"])
    torch.cuda.synchronize()
    launches = dict(V.LAUNCHES)
    log(f"[experiments] exp_bwd_moments.main {json.dumps(res_m)}")
    log(f"[experiments] exp_bwd_variants.main {json.dumps(res_v)}")
    log(f"[experiments] both in {time.time() - t0:.1f}s, launches "
        f"{launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} never launched by the entry points")
    times = {"moments": res_m["composite_bwd_moments_ms"], **res_v["ms"]}
    rows = []
    for gout, forms, bwd_ms in (
            ("rand", ("moments",), res_m["composite_bwd_ms"]),
            ("ones", ("v1", "v3", "v4", "v2"), res_v["composite_bwd_ms"])):
        sc = bench_scene(dev, gout=gout)
        args, kw = sc.args, sc.kw
        ref = K.composite_bwd_cuda(*args, **kw)
        _, walked, composited = K.composite_bwd_plain(
            *args, return_counts=True, **kw)
        n_tiles = kw["n_tiles_x"] * kw["n_tiles_y"]
        npx = kw["tile"] ** 2
        # composite_bwd's bound: the fewest operations for these gradients
        ops = (OPS_PER_PAIR_PIXEL_BWD * walked * npx
               + OPS_PER_COMPOSITE_BWD * composited)
        nbytes = 4 * (9 * walked + 2 * (n_tiles + 1)
                      + 2 * n_tiles * 4 * npx + 9 * kw["grad_cap"])
        ops_ms = ops / H100_FP32_FLOPS * 1e3
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        log(f"[experiments] bench scene (gout {gout}): pairs "
            f"{int(sc.binning.num_pairs)}, walked {walked}, compositing "
            f"pair-pixels {composited}, {tile_load(sc.binning)}; "
            f"composite_bwd {bwd_ms:.4f} ms (the entry point's time), "
            f"bound {bound_ms:.4f} ms (ops {ops_ms:.4f}, bytes "
            f"{bytes_ms:.4f}) | {smi}")
        outs = {}
        for form in forms:
            fn, plain = form_fns(form, kw)
            outs[form] = fn(*args)
            torch.cuda.synchronize()
            err = check_bwd(f"{form} bench scene", outs[form], plain(*args),
                            sc.binning)
            FORM_ERRS[form] = max(FORM_ERRS[form], err)
            gap = written_gap(outs[form], ref, sc.binning)
            log(f"[experiments] {form} vs composite_bwd on the bench "
                f"scene: max abs {gap[0]:.3e}, over max(scale, 1) "
                f"{gap[1]:.3e} (script tolerance {SCRIPT_RTOL:g})")
            if not gap[1] < SCRIPT_RTOL:
                raise AssertionError(f"{form} disagrees with composite_bwd "
                                     "on the bench scene")
            plain_ms = cuda_ms(lambda: plain(*args), n=2, warm=1)
            name = V.launch_name(form)
            log(f"[timing] {name} {times[form]:.4f} ms (composite_bwd "
                f"{bwd_ms:.4f} ms on the same inputs; both the entry "
                f"point's), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} "
                f"ms, {launches[name]} launches by the entry point | {smi}")
            rows.append({
                "name": name, "route": "cuda",
                "source": "sings_tpu_torch/csrc/composite_bwd_variants.cu",
                "replaces": FORM_REPLACES[form],
                "launches": launches[name], "max_abs_err": None,
                "ms": times[form], "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": None, "composite_bwd_ms": bwd_ms,
            })
        if "v2" in outs and not torch.equal(outs["v2"], outs["v4"]):
            raise AssertionError("v2 is not bitwise equal to v4")
        del sc, args, ref, outs
    return rows


# ---------------------------------------------------------------------------
# the synthetic-template calibration (phase 15)

# phase 7's masks (the seeded avatar's own render at the kit's poses) and
# its template, filled by run_train
CALIBRATE_TARGETS = {}
# the calibration kit's poses are moved off those the masks and keypoints
# were made at: a seeded offset of every frame's translation (up to these
# metres) and seeded pose noise (radians)
CALIB_TRANSL_OFFSET = (0.05, 0.05, 0.2)
CALIB_POSE_NOISE = 0.03
CLI_REFINE_STEPS = 20
FIT_KEYS = ("betas", "global_orient", "body_pose", "transl")


def calibration_kit(dev):
    """Phase 7's 9-frame 512x512 kit with its avatar-rendered masks and
    COCO-133 keypoints (scores 1) at the projections of the posed joints
    (through _COCO133_SMPL_PAIRS) and of the face anchors
    (FACE_ANCHOR_INIT), its SMPL poses then perturbed. Returns the kit
    and its intrinsics."""
    from sings_tpu_torch.kinematics.template import DeviceTemplate
    from sings_tpu_torch.preprocess.refine import (
        FACE_ANCHOR_INIT, _COCO133_SMPL_PAIRS, posed_smpl_joints,
    )

    kit = make_train_kit()
    tpl = CALIBRATE_TARGETS["tpl"]
    size = kit.masks.shape[1]
    K = np.array([[1000.0, 0, size / 2], [0, 1000.0, size / 2], [0, 0, 1]],
                 np.float32)
    true = dict(kit.smpl, betas=np.zeros(tpl.num_betas, np.float32))
    with torch.no_grad():
        joints, head_rot = posed_smpl_joints(
            DeviceTemplate.from_host(tpl, dev),
            {k: torch.as_tensor(v, device=dev) for k, v in true.items()},
            return_head_rot=True)
        anchors = joints[:, 15, None] + torch.einsum(
            "fxy,ay->fax", head_rot, torch.as_tensor(FACE_ANCHOR_INIT,
                                                     device=dev))

    def px(points):
        uvw = points.cpu().numpy() @ K.T
        return uvw[..., :2] / uvw[..., 2:]

    f = kit.masks.shape[0]
    kp = np.zeros((f, 133, 2), np.float32)
    scores = np.zeros((f, 133), np.float32)
    for sj, cj in _COCO133_SMPL_PAIRS:
        kp[:, cj] = px(joints[:, sj])
        scores[:, cj] = 1.0
    kp[:, :5] = px(anchors)
    scores[:, :5] = 1.0
    rng = np.random.RandomState(SEED + 7)
    smpl = dict(kit.smpl)
    smpl["transl"] = (smpl["transl"] + rng.uniform(-1, 1, 3)
                      * CALIB_TRANSL_OFFSET).astype(np.float32)
    smpl["body_pose"] = (smpl["body_pose"] + rng.randn(f, 69)
                         * CALIB_POSE_NOISE).astype(np.float32)
    return kit._replace(masks=CALIBRATE_TARGETS["masks"], keypoints=kp,
                        keypoint_scores=scores, smpl=smpl), K


class stage_calls:
    """Each calibration stage's call (fit_skeleton, refine_smpl), looked
    up in preprocess.refine when the trainer calls it: its arguments,
    its result and its wall time, the card synchronised at both ends."""

    def __enter__(self):
        from sings_tpu_torch.preprocess import refine as R

        self.saved = {name: getattr(R, name) for name in ("fit_skeleton",
                                                          "refine_smpl")}
        self.calls = {}

        def recorded(name, fn):
            def run(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                self.calls[name] = dict(args=args, kw=kw, out=out,
                                        seconds=time.perf_counter() - t0)
                return out
            return run

        for name, fn in self.saved.items():
            setattr(R, name, recorded(name, fn))
        return self

    def __exit__(self, *exc):
        from sings_tpu_torch.preprocess import refine as R

        for name, fn in self.saved.items():
            setattr(R, name, fn)


def refine_camera(kit, K, dev):
    """The trainer's refine camera and masks: render_downscale
    d = size // 128, strided masks, K / d, the identity extrinsic."""
    from sings_tpu_torch.ops.graphics import make_camera

    size = kit.masks.shape[1]
    d = max(1, size // 128)
    Kd = K.copy()
    Kd[:2] /= d
    cam = make_camera(np.eye(4, dtype=np.float32), size // d, size // d,
                      K=Kd, device=dev)
    return cam, torch.as_tensor(np.ascontiguousarray(kit.masks[:, ::d, ::d]),
                                device=dev)


@torch.no_grad()
def silhouette_mse(trainer, kit, K, params: dict) -> float:
    """The silhouette term alone: the MSE of refine's silhouette against
    the mask, averaged over every frame of the kit."""
    from sings_tpu_torch.kinematics.template import smpl_forward
    from sings_tpu_torch.preprocess import refine as R

    dev = trainer.device
    dt = trainer.template
    cam, masks = refine_camera(kit, K, dev)
    p = {k: torch.as_tensor(params[k], device=dev) for k in FIT_KEYS}
    cfg = R.RefineConfig(splat_scale=R.auto_splat_scale(dt))
    out = smpl_forward(dt, p["betas"].reshape(1, -1), p["body_pose"],
                       p["global_orient"],
                       disable_posedirs=dt.posedirs is None)
    verts = out.verts + p["transl"][:, None]
    return float(torch.stack([torch.mean((R._silhouette(
        verts[i], cam, cfg, R.default_refine_raster_kw(dev)) - masks[i]) ** 2)
        for i in range(verts.shape[0])]).mean())


def silhouette_frame(trainer, kit, K, start: dict):
    """Refine's frame-0 inputs on its first step (`start`, stage A's
    poses and betas): the composite kernels' inputs of the silhouette,
    its window-entry state and the cotangents of the frame's MSE
    against the (strided) mask, the forward checked on the way
    (check_fwd). Returns composite_bwd's arguments and keywords, the
    binning and the composite keywords."""
    from sings_tpu_torch.kinematics.template import smpl_forward
    from sings_tpu_torch.ops.rasterizer.api import (
        RasterConfig, image_to_tiles, tiles_to_image,
    )
    from sings_tpu_torch.preprocess import refine as R

    dev = trainer.device
    start = {k: torch.as_tensor(start[k], device=dev) for k in FIT_KEYS}
    dt = trainer.template
    cam, masks = refine_camera(kit, K, dev)
    mask0 = masks[0]
    with torch.no_grad():
        out = smpl_forward(dt, start["betas"].reshape(1, -1),
                           start["body_pose"][:1], start["global_orient"][:1],
                           disable_posedirs=dt.posedirs is None)
        verts = out.verts[0] + start["transl"][0]
    n = verts.shape[0]
    gauss = [verts, torch.full((n, 3), R.auto_splat_scale(dt), device=dev),
             torch.tensor([[1.0, 0, 0, 0]], device=dev).repeat(n, 1),
             torch.full((n,), R.RefineConfig().splat_opacity, device=dev),
             torch.ones((n, 3), device=dev)]
    rkw = dict(R.default_refine_raster_kw(dev), max_pairs=None,
               main_width=6, tail_capacity=None, pair_cap=None)
    feats, binning, ckw = composite_inputs(gauss, cam, rkw)
    (fwd_out, state), _ = check_fwd("calibration silhouette frame 0", feats,
                                    binning, ckw)
    cfg = RasterConfig(height=cam.height, width=cam.width, **rkw)
    color, t_final = (x.detach().requires_grad_(True)
                      for x in tiles_to_image(fwd_out, cfg))
    sil = torch.clamp(color[0] + t_final * 0.0, 0.0, 1.0)  # bg zeros
    g_color, g_t = torch.autograd.grad(torch.mean((sil - mask0) ** 2),
                                       [color, t_final])
    gout = image_to_tiles(g_color, g_t, cfg).contiguous()
    bargs = (feats, binning.tile_offsets, binning.grad_offsets, fwd_out,
             gout, state)
    return bargs, dict(ckw, grad_cap=binning.pair_slot_capacity), binning, \
        ckw


def profile_calibrate(calls: dict, out_dir: str) -> None:
    """--profile: each calibration stage called again as the trainer
    called it (stage_calls), cut to a few steps, under torch.profiler:
    device time per step against the stage's unprofiled wall per step,
    the composite kernels' share, and the largest kernels of the
    refine."""
    from sings_tpu_torch.preprocess import refine as R

    os.makedirs(out_dir, exist_ok=True)
    configs = (R.SkeletonFitConfig, R.RefineConfig)

    def cut(x, n):
        return x._replace(steps=n) if isinstance(x, configs) else x

    lines = [f"{'stage':14s} {'wall ms':>10s} {'kernels ms':>10s} "
             f"{'composite':>10s} {'busy':>6s} {'pre':>4s}  per step (wall: "
             "the calibration's unprofiled host clock; kernels: device "
             "time, profiler; composite: the composite kernels' share)"]
    for name, n in (("fit_skeleton", 10), ("refine_smpl", 2)):
        call = calls[name]
        args = [cut(a, n) for a in call["args"]]
        kw = {k: cut(v, n) for k, v in call["kw"].items()}
        fn = getattr(R, name)
        fn(*args, **kw)  # warm
        busy, comp, seen, prof = profiled(lambda: fn(*args, **kw))
        if name == "refine_smpl":
            require_seen(name, comp, list(COMPOSITE_KERNELS), prof, out_dir)
            top = sorted([e for e in prof.key_averages() if e.device_type
                          == torch.autograd.DeviceType.CUDA],
                         key=lambda e: e.self_device_time_total,
                         reverse=True)[:12]
        wall = 1e3 * call["seconds"] / len(call["out"]["losses"])
        lines.append(f"{name:14s} {wall:10.3f} {busy / n:10.4f} "
                     f"{sum(comp.values()) / n:10.4f} "
                     f"{100 * busy / n / wall:5.1f}% {seen:4d}")
    lines.append("largest kernels of 2 refine steps:")
    for e in top:
        lines.append(f"  {e.self_device_time_total / 1e3:10.3f} ms "
                     f"{e.count:6d}x  {e.key[:90]}")
    for line in lines:
        log(f"[profile] {line}")
    with open(os.path.join(out_dir, "profile_calibrate.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")


def run_calibrate(work: str, dev, smi: str, rows: list,
                  profile_dir: str | None = None, extra=()) -> None:
    """Phase 15: Trainer(mode="train") with the synthetic template and
    tpu.auto_fit_synthetic unset calibrates it (fit_skeleton, then
    refine_smpl through the composite kernels) and caches the result;
    a second Trainer on the run directory loads the cache; the kernels
    at refine's frame 0 against their plain versions, timed; then
    cli.refine.main on the same kit. Adds a "calibrate" entry to the
    composite_fwd and composite_bwd rows."""
    from sings_tpu_torch.cli import refine as cli_refine
    from sings_tpu_torch.config.core import load_config
    from sings_tpu_torch.config.defaults import DEFAULTS
    from sings_tpu_torch.train.trainer import Trainer

    t0 = time.time()
    kit, K = calibration_kit(dev)
    cfg = load_config(DEFAULTS, None, HUMAN_COMPLEX_DOTLIST
                      + HUMAN_COMPLEX_TRAIN_DOTLIST + [
                          f"output_path={work}", "exp_name=smoke_calibrate",
                          "dataset.name=kit", f"seed={SEED}",
                          f"tpu.smpl_model_dir={work}/no_licensed_models",
                          "train.init_steps=10"] + list(extra))
    if not cfg.tpu.get("auto_fit_synthetic", True):
        raise AssertionError("tpu.auto_fit_synthetic is set off")
    a_steps = int(cfg.tpu.get("skeleton_fit_steps", 500))
    b_steps = int(cfg.tpu.get("synthetic_fit_steps", 300))
    frames = min(8, kit.masks.shape[0])  # RefineConfig.batch_frames
    log(f"[calibrate] kit: {kit.masks.shape[0]} frames "
        f"{kit.masks.shape[1]}x{kit.masks.shape[2]}, masks from phase 7's "
        f"render (cover {float(kit.masks.mean()):.3f}), COCO-133 keypoints "
        f"at the posed joints and face anchors, poses perturbed "
        f"({time.time() - t0:.1f}s)")

    # ---- the main path: the default training run's constructor
    from sings_tpu_torch.ops.rasterizer import kernels as KN

    with stage_calls() as stages:
        KN.reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer = Trainer(cfg, mode="train", device=dev, kit=kit,
                          image_writer=lambda path, img: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    launches, writes = dict(KN.LAUNCHES), dict(KN.STATE_WRITES)
    calls = stages.calls
    res_a = calls["fit_skeleton"]["out"]
    res_b = calls["refine_smpl"]["out"]
    px, losses = res_a["px_err"], res_b["losses"]
    log(f"[calibrate] Trainer(mode='train') {wall:.3f}s: fit_skeleton "
        f"{a_steps} steps {calls['fit_skeleton']['seconds']:.3f}s, "
        f"refine_smpl {b_steps} steps x {frames} frames "
        f"{calls['refine_smpl']['seconds']:.3f}s (host clock, card "
        f"synchronised) | {smi}")
    log(f"[calibrate] keypoint px err {px[0]:.3f} -> {px[-1]:.3f}; loss "
        f"{res_b['losses'][0]:.5f} -> {res_b['losses'][-1]:.5f}; betas "
        f"{np.round(res_b['betas'], 3).tolist()}; launches {launches}, "
        f"state writes {writes}")
    if not (np.all(np.isfinite(px)) and np.all(np.isfinite(losses))):
        raise AssertionError("a calibration loss is not finite")
    if not px[-1] < 0.5 * px[0]:
        raise AssertionError("the keypoint px error did not fall")
    sil = [silhouette_mse(trainer, kit, K, r) for r in (res_a, res_b)]
    log(f"[calibrate] silhouette MSE over the {kit.masks.shape[0]} frames "
        f"{sil[0]:.5f} -> {sil[1]:.5f}; refine's loss by step "
        f"{np.round(losses[::max(1, b_steps // 10)], 5).tolist()}")
    if not sil[1] < sil[0]:
        raise AssertionError("the silhouette loss did not fall")
    if len(px) != a_steps or len(losses) != b_steps:
        raise AssertionError("a stage ran another number of steps")
    cache = os.path.join(trainer.logdir, "synthetic_fit.npz")
    if not os.path.exists(cache):
        raise AssertionError("synthetic_fit.npz was not written")
    want = b_steps * frames
    if (launches["composite_fwd"], launches["composite_bwd"],
            writes["composite_fwd"]) != (want, want, want):
        raise AssertionError(f"the calibration launched {launches} "
                             f"(state writes {writes}), not {want} of each "
                             "tiled kernel")
    if launches["composite_fwd_panel"] or launches["composite_bwd_panel"]:
        raise AssertionError("the calibration launched a panel kernel")

    # ---- the kernels at refine's frame 0
    bargs, bkw, binning, ckw = silhouette_frame(trainer, kit, K, res_a)
    got = KN.composite_bwd_cuda(*bargs, **bkw)
    want_g, walked_b, composited = KN.composite_bwd_plain(
        *bargs, return_counts=True, **bkw)
    torch.cuda.synchronize()
    if float(bargs[4][:, 0].abs().max()) == 0.0:
        raise AssertionError("the silhouette's cotangents are zero")
    bwd_err = check_bwd("calibration silhouette frame 0 (the MSE's "
                        "cotangents)", got, want_g, binning)
    feats, offs = bargs[0], bargs[1]
    skw = dict(grad_offsets=bargs[2], grad_cap=bkw["grad_cap"])
    _, walked = KN.composite_fwd_plain(feats, offs, return_walked=True,
                                       **ckw)
    fwd_ms = cuda_ms(lambda: KN.composite_fwd_cuda(feats, offs, **skw,
                                                   **ckw))
    fwd_plain = cuda_ms(lambda: KN.composite_fwd_plain(feats, offs, **ckw),
                        n=5, warm=1)
    bwd_ms = cuda_ms(lambda: KN.composite_bwd_cuda(*bargs, **bkw))
    bwd_plain = cuda_ms(lambda: KN.composite_bwd_plain(*bargs, **bkw), n=5,
                        warm=1)
    n_tiles = ckw["n_tiles_x"] * ckw["n_tiles_y"]
    npx = ckw["tile"] ** 2
    f_ops = OPS_PER_PAIR_PIXEL * walked * npx / H100_FP32_FLOPS * 1e3
    f_bytes = 4 * (9 * walked + 2 * (n_tiles + 1) + n_tiles * 8 * npx) \
        / H100_BYTES_PER_S * 1e3
    b_ops = (OPS_PER_PAIR_PIXEL_BWD * walked_b * npx
             + OPS_PER_COMPOSITE_BWD * composited) / H100_FP32_FLOPS * 1e3
    b_bytes = 4 * (9 * walked_b + 2 * (n_tiles + 1) + 2 * n_tiles * 4 * npx
                   + 9 * bkw["grad_cap"]) / H100_BYTES_PER_S * 1e3
    log(f"[calibrate] silhouette frame 0: pairs {int(binning.num_pairs)}, "
        f"overflow {int(binning.overflow)}, walked {walked} (backward "
        f"{walked_b}), compositing pair-pixels {composited}, "
        f"{tile_load(binning)}")
    log(f"[calibrate] composite_fwd {fwd_ms:.4f} ms (keeping the state), "
        f"plain {fwd_plain:.3f} ms, bound {max(f_ops, f_bytes):.4f} ms (ops "
        f"{f_ops:.4f}, bytes {f_bytes:.4f}); composite_bwd {bwd_ms:.4f} ms, "
        f"plain {bwd_plain:.3f} ms, bound {max(b_ops, b_bytes):.4f} ms (ops "
        f"{b_ops:.4f}, bytes {b_bytes:.4f}); {want} launches of each | "
        f"{smi}")
    for row in rows:
        if row["name"] == "composite_fwd":
            row["calibrate"] = {
                "launches": launches["composite_fwd"], "ms": fwd_ms,
                "plain_ms": fwd_plain, "bound_ms": max(f_ops, f_bytes),
                "bound_by": "operations" if f_ops >= f_bytes else "bytes",
                "max_abs_err": KERNEL_ERRS["composite_fwd"]}
        elif row["name"] == "composite_bwd":
            row["calibrate"] = {
                "launches": launches["composite_bwd"], "ms": bwd_ms,
                "plain_ms": bwd_plain, "bound_ms": max(b_ops, b_bytes),
                "bound_by": "operations" if b_ops >= b_bytes else "bytes",
                "max_abs_err": bwd_err}
            row["max_abs_err"] = max(row["max_abs_err"], bwd_err)
    if profile_dir:
        profile_calibrate(calls, profile_dir)
    fitted = {k: np.asarray(trainer.kit.smpl[k]) for k in FIT_KEYS}
    del trainer, bargs, got, want_g, feats, binning
    torch.cuda.empty_cache()

    # ---- a second run on the same directory loads the cache
    with stage_calls() as stages:
        KN.reset_launches()
        t1 = time.perf_counter()
        again = Trainer(cfg, mode="train", device=dev, kit=kit,
                        image_writer=lambda path, img: None)
    log(f"[calibrate] second Trainer on the run directory "
        f"{time.perf_counter() - t1:.3f}s, launches {dict(KN.LAUNCHES)}, "
        f"stages run {sorted(stages.calls)}")
    if any(KN.LAUNCHES.values()) or stages.calls:
        raise AssertionError("the second Trainer refitted the calibration")
    if not all(np.array_equal(again.kit.smpl[k], fitted[k])
               for k in FIT_KEYS):
        raise AssertionError("the cached calibration was not loaded")
    del again
    torch.cuda.empty_cache()

    # ---- the refine entry point on the same kit
    kit_dir = os.path.join(work, "calibration_kit")
    os.makedirs(os.path.join(kit_dir, "score_demo_video"))
    np.savez(os.path.join(kit_dir, "score_demo_video", "cameras.npz"),
             intrinsic=K, extrinsic=np.eye(4, dtype=np.float32),
             height=kit.masks.shape[1], width=kit.masks.shape[2])
    kp_dir = os.path.join(kit_dir, "keypoints_coco133", "sapiens")
    os.makedirs(kp_dir)
    for i in range(kit.masks.shape[0]):
        with open(os.path.join(kp_dir, f"{i:06d}.json"), "w") as fh:
            json.dump({"instance_info": [{
                "keypoints": kit.keypoints[i].tolist(),
                "keypoint_scores": kit.keypoint_scores[i].tolist()}]}, fh)
    argv = ["--kit", kit_dir, "--steps", str(CLI_REFINE_STEPS),
            "--smpl_model_dir", f"{work}/no_licensed_models"]
    KN.reset_launches()
    t1 = time.perf_counter()
    out = cli_refine.main(argv, kit=kit)
    torch.cuda.synchronize()
    cli_launches = dict(KN.LAUNCHES)
    log(f"[calibrate] python -m sings_tpu_torch.cli.refine {' '.join(argv)} "
        f"(the kit held in memory) {time.perf_counter() - t1:.3f}s: loss "
        f"{out['losses'][0]:.5f} -> {out['losses'][-1]:.5f}, launches "
        f"{cli_launches}")
    saved = dict(np.load(os.path.join(kit_dir, "score_demo_video",
                                      "poses_optimized.npz")))
    if sorted(saved) != sorted(FIT_KEYS) or any(
            saved[k].shape != kit.smpl[k].shape for k in FIT_KEYS[1:]):
        raise AssertionError(f"poses_optimized.npz: {sorted(saved)}")
    if not np.all(np.isfinite(out["losses"])):
        raise AssertionError("cli.refine's loss is not finite")
    want = CLI_REFINE_STEPS * frames
    if (cli_launches["composite_fwd"], cli_launches["composite_bwd"]) != (
            want, want):
        raise AssertionError(f"cli.refine launched {cli_launches}, not "
                             f"{want} of each tiled kernel")


def finish_form_rows(rows: list) -> list:
    """Each form's largest kernel-vs-plain error over every check."""
    from sings_tpu_torch.ops.rasterizer import variants as V

    for row in rows:
        for form in FORMS:
            if row["name"] == V.launch_name(form):
                row["max_abs_err"] = FORM_ERRS[form]
    return rows


if __name__ == "__main__":
    sys.exit(main())
