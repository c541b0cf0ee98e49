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
recipe benchmark drives it (8 steps a chunk); multi-case training,
python -m sings_tpu_torch.cli.train_batch in both modes; the sharded
(dp, gs) step of sings_tpu_torch/dist on one rank over NCCL and on two
ranks sharing the card over gloo, with python -m
sings_tpu_torch.cli.train under tpu.mesh.gs=2; and the
training entry point, python -m sings_tpu_torch.cli.train
(cli.train.main with the kit held in memory) with
tpu.raster.layout=panel, resumed from a checkpoint; the synthetic-template calibration that a default training
run starts with (Trainer(mode="train") with tpu.auto_fit_synthetic
unset) and python -m sings_tpu_torch.cli.refine; and the kernel
experiments, python -m
sings_tpu_torch.scripts.{exp_cumsum_kernel,exp_bwd_moments,
exp_bwd_variants} at their own sizes. Phases:

  1 device      torch.cuda must be available; prints the card and limit
  2 build       nvcc for sm_90a (composite_fwd.cu and composite_bwd.cu,
                each one kernel for both layouts; composite_bwd_variants.cu,
                chunk_scan_bench.cu, triplane_bwd.cu, knn_topk.cu and
                bin_tiles.cu) and g++ (mesh_native), timed
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
                composite_fwd, composite_bwd and triplane_bwd launches from
                0 (one each a step), the forward launches that wrote
                the state (all of them) and knn_topk's (one a chunk, the
                chunk head's statistic)
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
                and the whole CLI call) checked; triplane_bwd launches
                counted in the pre-fit and chunk (one a step) and in the
                whole CLI call (one a training step)
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
 16 triplane bwd (run after phase 10, on phase 7's trainer) the
                triplane's backward, ops/grid_grad.py's kernel
                csrc/triplane_bwd.cu (the product rule, the coordinate and
                the grid gradients after the sorts), at the nested 64^3
                field's full width (127,744 queries, multires [1, 2, 4],
                C 32) and one training step's own cotangent on the
                features: against its plain version (grids within
                GRID_RTOL, dq within the JAX tolerance) and bit for bit
                between two calls; the rows of zero cotangent (the dead
                slots) and their dq; the Function's backward (grids and
                d/dpts) with the kernel against the same with the plain
                version, one launch; the segment lengths per level;
                CUDA-event times of the kernel, the sorts, the Function's
                backward, the plain version and index_add_ of the same
                rows; its bound in bytes; the peak allocated memory of
                one training step (phase 7's step at frame 0); under
                --profile each of the kernel's launches' device time
 17 options    the training options (phase 7's full-width setup, kit and
                pre-fit with the JAX defaults' tpu.random_lpips_factor
                0.05, tpu.knn_backend window and laplacian.type
                cotangent): 2 train_scan calls (16 steps from step 2000),
                composite_fwd, composite_bwd and triplane_bwd launches
                counted from 0 (16 each), every step finite with an LPIPS
                term > 0; on the card against the CPU: the LPIPS term and
                its d/dpatches at the step's patches, the cotangent
                laplacian's loss and gradient, knn_window_stat on the
                canonical cloud, and against the exact dense statistic
                (never under it); CUDA-event times of the LPIPS term,
                the gather and cotangent laplacians and both KNN
                statistics, the laplacian tables' host build times;
                rasterize_multi of two avatars bit for bit one rasterize
                of their concatenation in one composite_fwd launch; one
                chunk under ops/profiling.trace with span ranges, each
                and the program's own spans (the backward's on autograd's
                thread) in the exported trace, and its kernels' device time
 18 cases      (run after phase 16, on phase 7's trainer) multi-case
                training: one make_case_train_step call on two cases
                (phase 7's state and its perturbed copy) at step 2000
                against two single-card train_step calls on the same
                draws, bit for bit, composite_fwd, composite_bwd and
                triplane_bwd launched twice each from 0; then python -m
                sings_tpu_torch.cli.train_batch --simultaneous over phase
                7's 9-frame kit and a 7-frame kit of the same avatar at
                other seeded poses (the CasePool: padded to 9 frames, 6
                lockstep steps, the frame streams of RandomState(seed +
                7919 c), a validation at step 4 and the final checkpoint,
                results and exports per case, the cases apart and
                finite), 12 launches of each kernel in the pool's steps,
                the device time of a lockstep step (CUDA events) and its
                steps/s per case against phase 9's; then the CLI's
                sequential mode (--shard 0/1) over both kits
 19 sharded    (run after phase 18, on phase 7's trainer) the sharded
                (dp, gs) step of dist/: 19.1 frame 0 rendered strip by
                strip through camera_strip (rasterize(valid_rows=) for
                balanced windows) at gs 2 and 4 and balanced gs 4 from the
                kit's masks, max_span raised to the frame's widest tile
                rectangle and no pair_cap so that strips and the full frame
                bin the same pairs (pair counts printed), each strip's
                and the full frame's composite kernels against their plain
                versions (check_fwd, check_bwd), the owned rows and the
                gradients summed over the strips against the full frame's,
                every flipped value at a pixel with a gaussian on the
                1/255 alpha skip, the plain composites' strips beside the
                kernels'; 19.2 a one-rank
                process group over NCCL: make_sharded_train_step at (1, 1)
                against phase 7's train_step on the same draws at
                tests/test_dist.py's tolerances, both timed in turns (CUDA
                events), one launch of each kernel; 19.3 two ranks spawned
                on the one card over gloo (host-staged), from the parent's
                saved state: the step at (dp 1, gs 2) against 19.2 (loss
                rtol 5e-4, gradients 0.05 of the leaf scale), a rerun and
                the two ranks' states bit for bit, one launch of each
                kernel per rank, CUDA-event step times and the host time in
                the collectives; the case step at gs 2 on two cases bit for
                bit each case's sharded step; then cli.train.main with
                tpu.mesh.gs=2 --dist-backend gloo from torchrun's
                environment: a 10-step pre-fit and 4 steps through a prune
                (removing nothing), a densify and a checkpoint, rank 0
                alone writing, the ranks' final states bit for bit
 20 knn        (run after phase 16, on phase 7's trainer) the exact KNN
                statistic's kernel, ops/knn.py's csrc/knn_topk.cu, at the
                avatar's state (its canonical centres, 102,182 live in
                127,744 slots), on the live centres three times over
                (exact ties; a tenth invalid, and all valid) and on 1000
                points with 5 valid (fewer than k), for k 1, 9 and 16,
                against the torch path (matmul + torch.topk, the plain
                version's blocks on the card): distances bit for bit or
                within 2 ulps of sq_i + sq_j, indices apart only among
                equal distances, ascending, ties by the lower index, two
                calls bit for bit; knn_rows over the gs-4 split equal to
                knn's rows; 200 seeded random calls (sizes, masks, k,
                row ranges, NaN and infinite points), each synchronised;
                edge_stat within 1e-6 of the torch path's;
                device_time of the kernel, of edge_stat and of a quarter
                of the rows, CUDA-event time of the torch path, the bound
 21 binning    the tile binning's kernels, ops/rasterizer/tiles.py's
                csrc/bin_tiles.cu (bin_gaussians on CUDA tensors), at
                phase 4's animation frame 0 and at phase 8's training
                frame: every TileBinning field against the plain version
                (bin_gaussians_plain on the same CUDA inputs), integer for
                integer, and two calls bit for bit; no host wait inside a
                call (the profiler's CUDA runtime calls in its range, and
                torch's sync debug mode set to raise); LAUNCHES["bin_tiles"]
                one a rasterize call, counted through phase 5's
                animate_chunk (32 frames in each layout), phase 9's
                train_scan (16 steps) and phase 19 (a strip, a rank and
                step); CUDA-event and host-issue times of
                the kernel path and of the plain version, and the byte
                bound (each input read, each output written once)
With --profile, stage tables and torch.profiler kernel tables of an
animation frame (after phase 6), of a training step (after phase 16) and
of the calibration's two stages (in phase 15); each profiled stage that
launches a composite kernel or triplane_bwd must show that kernel's device
time, and the triplane's stage no indexing_backward_kernel. Every
failure raises; the script exits 0 only when every phase passed, and
then prints the kernels line and, last, the device line.
"""
from __future__ import annotations

import json
import math
import os
import re
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
# the CUDA sources: the composite kernels (each one kernel for both
# layouts), the experiment kernels, the triplane's grid backward, the
# exact KNN statistic and the tile binning
SOURCES = ["composite_fwd", "composite_bwd", "composite_bwd_variants",
           "chunk_scan_bench", "triplane_bwd", "knn_topk", "bin_tiles"]


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
    from sings_tpu_torch.ops.rasterizer import tiles as T
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
        # ---- 21 the binning's kernels at this frame
        bin_anim = check_binning("animation frame 0",
                                 *binning_inputs(frame0, ds.camera, kw), smi)

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
    T.reset_launches()
    torch.cuda.synchronize()
    fps = trainer.animate_chunk(chunk_size=16, max_frames=32,
                                save_video=False, writer=writer)
    launches = dict(K.LAUNCHES, **T.LAUNCHES)
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
    for name in ("composite_fwd", "bin_tiles"):
        if launches[name] != 32:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 "in 32 frames, not 32")
    BIN_STATS["launches_anim"] = launches["bin_tiles"]
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
    T.reset_launches()
    torch.cuda.synchronize()
    fps_p = trainer.animate_chunk(chunk_size=16, max_frames=32,
                                  save_video=False, writer=writer)
    panel_launches = dict(K.LAUNCHES, **T.LAUNCHES)
    trainer.raster_kw["layout"] = "tiled"
    same = [np.array_equal(frames[i], tiled_frames[i]) for i in range(32)]
    log(f"[main panel] {len(frames)} frames at {fps_p:.2f} fps, launches "
        f"{panel_launches}, equal to the tiled frames: {sum(same)}/32")
    if sorted(frames) != list(range(32)) or not all(same):
        raise AssertionError("panel-layout frames differ from the tiled "
                             "layout's")
    if (panel_launches["composite_fwd_panel"] != 32
            or panel_launches["composite_fwd"] != 0
            or panel_launches["bin_tiles"] != 32
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
    kernels.append(binning_row(bin_anim))
    # ---- 13 the scan micro-benchmark, 14 the backward's formulas
    kernels.extend(run_scan(dev, smi))
    kernels.extend(finish_form_rows(run_experiments(dev, smi)))
    # ---- 15 the synthetic-template calibration
    run_calibrate(work, dev, smi, kernels, profile_dir)
    # ---- 17 the training options of the JAX defaults
    run_options(work, dev, smi, profile_dir)
    for row in kernels:
        if row["name"] in KERNEL_ERRS:
            row["max_abs_err"] = KERNEL_ERRS[row["name"]]
        if row["name"] in SHARD_LAUNCHES:
            row["launches_sharded"] = SHARD_LAUNCHES[row["name"]]
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
# and every profiled kernel: the triplane backward's four kernels
PROFILED_KERNELS = dict(COMPOSITE_KERNELS, triplane_bwd="triplane_bwd_")


def composite_ms(comp: dict) -> float:
    """The composite kernels' device time in a profiled call's table."""
    return sum(comp[k] for k in COMPOSITE_KERNELS)


# In the training context torch.profiler (CUPTI) drops the first kernel
# records of each session: a stage of two kernels (composite_bwd's zero
# fill and the kernel) showed no device time (PERF.md section 7). Every
# profiled call therefore runs after PREAMBLE spin kernels of its own,
# which the sums leave out and whose records the tables count.
PREAMBLE = 4
SPIN = "spin_kernel"


def profiled(fn) -> tuple:
    """One call of fn under torch.profiler, after the preamble: the
    device time (ms) of the kernels it launched, that of the port's
    kernels among them by name (PROFILED_KERNELS), the preamble kernels
    seen, and the profile."""
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
            / 1e3 for name, key in PROFILED_KERNELS.items()}
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
                         f"{composite_ms(comp) / per:10.4f} {seen:4d}")

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


def composite_bwd_inputs(trainer, leaves, loss_of, cam=None,
                         raster_kw=None, valid_rows=None):
    """Frame 0's composite_bwd inputs as the step makes them: feats,
    binning, forward output and window-entry state of the render, and
    the loss's own cotangents of colour and transmittance, re-tiled.
    cam, raster_kw, valid_rows: another camera (a strip's), its raster
    keywords and owned rows, for the trainer's."""
    from sings_tpu_torch.ops.rasterizer import kernels as K
    from sings_tpu_torch.ops.rasterizer.api import (
        RasterConfig, _pad_tiles, image_to_tiles, prepare_composite,
        tiles_to_image,
    )
    from sings_tpu_torch.ops.rasterizer.common import preprocess

    cam = trainer.camera if cam is None else cam
    kw = trainer.raster_kw if raster_kw is None else raster_kw
    rkw = {k: kw[k] for k in (
        "tile", "chunk", "max_span", "max_pairs", "main_width",
        "tail_capacity", "pair_cap")}
    cfg = RasterConfig(height=cam.height, width=cam.width,
                       row_limit=valid_rows is not None, **rkw)
    with torch.no_grad():
        g2d = preprocess(*[x.detach() for x in leaves[:5]], cam, sh_degree=3,
                         alive=trainer.buffers.alive > 0.5, tile=cfg.tile)
        feats, binning = prepare_composite(g2d, cfg, valid_rows)
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
    from sings_tpu_torch.ops import grid_grad as GG
    from sings_tpu_torch.ops import knn as KN
    from sings_tpu_torch.ops.rasterizer import kernels as K
    from sings_tpu_torch.ops.rasterizer import tiles as T
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
    # ---- 21 the binning's kernels at the training frame
    with torch.no_grad():
        BIN_STATS["train"] = check_binning(
            "training frame 0", *binning_inputs(
                [x.detach() for x in leaves[:5]]
                + [trainer.buffers.alive > 0.5], trainer.camera,
                trainer.raster_kw), smi)
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
    GG.reset_launches()
    KN.reset_launches()
    T.reset_launches()
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
    launches = dict(K.LAUNCHES, triplane_bwd=GG.LAUNCHES["triplane_bwd"],
                    **T.LAUNCHES)
    BIN_STATS["launches_train"] = launches["bin_tiles"]
    knn_launches = KN.LAUNCHES["knn_topk"]
    if knn_launches != 2:
        raise AssertionError(f"the chunk head's statistic launched "
                             f"knn_topk {knn_launches} times in 2 chunks")
    p, b, o = state
    terms = {name: [round(x, 6) for x in v.cpu().tolist()]
             for name, v in metrics.items()}
    PHASE9_STEPS_PER_S[:] = [k / t for t in times]
    log(f"[train] 16 steps from step {TRAIN_STEP0}: chunk wall "
        f"{times[0]:.3f}s, {times[1]:.3f}s (host clock, steps/s "
        f"{k / times[0]:.3f}, {k / times[1]:.3f}), launches {launches}, "
        f"knn_topk {knn_launches}")
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
    # one composite forward and backward a step, one triplane_bwd (the
    # triplane's backward) and one binning (the forward's rasterize)
    for name in ("composite_fwd", "composite_bwd", "triplane_bwd",
                 "bin_tiles"):
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
    # ---- 16 the triplane's backward at the step's cotangent
    gfeat, peak = step_feature_cotangent(trainer, batches)
    gg_row, field_step = triplane_backward(
        trainer.params.triplane, trainer.params.xyz,
        trainer.avatar_cfg.triplane, gfeat, launches["triplane_bwd"], peak,
        smi, profile_dir)
    if profile_dir:
        profile_train(trainer, batches, bargs, bkw, field_step, profile_dir)
    # ---- 20 the exact KNN statistic's kernel at this state
    knn_row = run_knn(trainer, knn_launches, smi)
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
    del p, b, o, state, bargs, feats, binning, fwd_out, gout, entry
    del field_step
    # ---- 18 multi-case training: the case step on this trainer, the
    # pool and the sequential batch mode
    run_cases(work, dev, smi, trainer, batches)
    # ---- 19 the sharded (dp, gs) step on this trainer
    run_sharded(work, dev, smi, trainer, batches)
    # ---- 11 the training entry point, 12 its timing
    return [bwd_row, gg_row, knn_row] + run_entry(work, dev, trainer,
                                                  batches, smi)


# ---------------------------------------------------------------------------
# the triplane's backward (phase 16, on phase 7's trainer)

# the kernel's grid gradients against its plain version, per plane: both
# sum each cell in float64 and round once (in another order), then add
# the same four corners in float32 in JAX's order, so they differ by a
# few ulps of the plane's largest value at most
GRID_RTOL = 1e-6
# its dq: each row's channel sums (the weight path's dw_k) are a warp
# tree on the card and torch's einsum in the plain version, float32
# both, so dq is held at the JAX package's own tolerance for these
# gradients (tests/test_triplane_nested.py: rtol 5e-5, atol 3e-5 max|g|)
DQ_RTOL, DQ_ATOL_REL = 5e-5, 3e-5
GRID_REPLACES = ("sings_tpu/fields/triplane.py:378 (_triplane_nested_bwd, "
                 "XLA, no pallas_call)")


class plain_backward:
    """Route the triplane's backward through the plain version for one
    comparison (the port itself never does)."""

    def __enter__(self):
        from sings_tpu_torch.ops import grid_grad as GG

        self.saved = GG.triplane_bwd_cuda
        GG.triplane_bwd_cuda = GG.triplane_bwd_plain
        return self

    def __exit__(self, *exc):
        from sings_tpu_torch.ops import grid_grad as GG

        GG.triplane_bwd_cuda = self.saved


def step_feature_cotangent(trainer, batches) -> tuple:
    """The cotangent that one training step (at TRAIN_STEP0, frame 0)
    sends into the triplane features, by a hook on triplane_features'
    output in model/avatar.py for one train_step, and that step's peak
    allocated memory: (cotangent, {"before", "peak"} bytes)."""
    from sings_tpu_torch.losses.regularizers import edge_stat
    from sings_tpu_torch.model import avatar as AV

    tr = trainer
    batch = {name: v[0] for name, v in batches.items()}
    es = edge_stat(AV.get_canon_xyz(tr.params, tr.buffers, tr.avatar_cfg),
                   tr.buffers.alive)
    caught = []
    orig = AV.triplane_features

    def hooked(*a, **k):
        f = orig(*a, **k)
        if f.requires_grad:
            f.register_hook(lambda g: caught.append(g.detach().clone()))
        return f

    AV.triplane_features = hooked
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    try:
        tr.train_step(tr.params, tr.buffers, tr.opt_state, tr.cache, batch,
                      torch.Generator(device=tr.device).manual_seed(SEED),
                      TRAIN_STEP0, 0, tr.region_lap, tr.region_lap,
                      tr.lap_pos_w, tr.lap_color_w, edge_stat=es)
        torch.cuda.synchronize()
    finally:
        AV.triplane_features = orig
    peak = {"before": before, "peak": torch.cuda.max_memory_allocated()}
    if len(caught) != 1:
        raise AssertionError(f"{len(caught)} feature cotangents in a step")
    return caught[0], peak


def rel_err(got, want) -> float:
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def check_dq(name: str, got, want) -> float:
    """dq against the plain version's at DQ_RTOL, DQ_ATOL_REL; returns
    the largest error over the largest value."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: not finite")
    tol = DQ_ATOL_REL * float(want.abs().max()) + DQ_RTOL * want.abs()
    bad = int(((got - want).abs() > tol).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} values off the plain "
                             "version's beyond the JAX tolerance")
    return rel_err(got, want)


def pass_times(args, profile_dir: str, smi: str) -> dict:
    """Device time of each of the kernel's launches (torch.profiler)."""
    from sings_tpu_torch.ops import grid_grad as GG

    os.makedirs(profile_dir, exist_ok=True)
    _, comp, seen, prof = profiled(lambda: GG.triplane_bwd_cuda(*args))
    passes = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        found = re.search(r"triplane_bwd_\w+", e.key)
        name = found.group(0) if found else (
            "memset" if "memset" in e.key.lower() else None)
        if name:
            passes[name] = passes.get(name, 0.0) + \
                e.self_device_time_total / 1e3
    total = sum(passes.values())
    lines = [f"triplane_bwd passes (device ms, torch.profiler, pre "
             f"{seen} of {PREAMBLE}; {smi})"]
    lines += [f"  {k:36s} {v:9.4f}  {100 * v / max(total, 1e-30):5.1f}%"
              for k, v in passes.items()]
    lines.append(f"  {'total':36s} {total:9.4f}")
    for line in lines:
        log(f"[profile grid] {line}")
    with open(os.path.join(profile_dir, "profile_triplane_bwd.txt"),
              "w") as fh:
        fh.write("\n".join(lines) + "\n")
    if not comp["triplane_bwd"] > 0.0:
        raise AssertionError("profile of triplane_bwd: no device time")
    return passes


def triplane_backward(triplane: dict, xyz, tcfg, gfeat, launches: int,
                      peak: dict, smi: str, profile_dir) -> tuple:
    """Phase 16: the triplane's backward (ops/grid_grad.py, the kernel
    csrc/triplane_bwd.cu) at full width on the given field, points and
    feature cotangent: the kernel against its plain version, twice for
    its bits; the zero-cotangent rows; the Function's backward (the
    kernel) against the same with the plain version, grids and d/dpts;
    the segment lengths; CUDA-event times of the kernel, the sorts, the
    Function's backward, the plain version and index_add_ of the same
    rows; the bound; each launch's device time under --profile. Returns
    (kernels-line row, one forward and backward of the field at these
    inputs, for the profile)."""
    from sings_tpu_torch.fields import triplane as TT
    from sings_tpu_torch.ops import grid_grad as GG

    grids = [p for planes in triplane["grids"] for p in planes]
    meta = tuple((a, b, p.shape[1], p.shape[2]) for planes in
                 triplane["grids"] for p, (a, b) in zip(planes, TT.COO_COMBS))
    if not (tcfg.nested and TT._nestable(triplane["grids"], tcfg.multires)):
        raise AssertionError("the recipe's triplane is not nested")
    with torch.no_grad():
        q = TT.normalize_aabb(xyz, tcfg.bounds).contiguous()
        grids = [g.detach().contiguous() for g in grids]
        _, saved = TT.nested_forward(meta, q, grids)
        skeys, orders = GG.sort_keys(saved.keys)
    gout = gfeat.contiguous()
    args = (meta, q, grids, saved, skeys, orders, gout, True)
    dq_k, got = GG.triplane_bwd_cuda(*args)
    dq_a, again = GG.triplane_bwd_cuda(*args)
    dq_p, want = GG.triplane_bwd_plain(*args)
    torch.cuda.synchronize()
    max_err, worst = 0.0, 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"triplane_bwd plane {i}: not finite")
        max_err = max(max_err, float((a - b).abs().max()))
        worst = max(worst, rel_err(a, b))
    dq_err = check_dq("triplane_bwd dq", dq_k, dq_p)
    bits = [(a.view(torch.int32), b.view(torch.int32))
            for a, b in zip(got + [dq_k], again + [dq_a])]
    same = all(torch.equal(a, b) for a, b in bits)
    equal_plain = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                      for a, b in zip(got, want))
    zero = (gout == 0).all(dim=1)
    n, c = gout.shape[0], grids[0].shape[0]
    log(f"[grid bwd] {len(grids)} planes {[tuple(g.shape) for g in grids]}"
        f", {n} queries ({int((xyz.abs().amax(dim=1) == 0).sum())} at xyz "
        f"= 0, {int(zero.sum())} with a zero cotangent row), C {c}: grids "
        f"kernel vs plain max_abs_err {max_err:.3e}, {worst:.3e} of a "
        f"plane's largest value, bit for bit the plain version's: "
        f"{equal_plain}; dq {dq_err:.3e} of its largest value; two calls "
        f"bit for bit equal (grids and dq): {same}")
    if worst > GRID_RTOL or not same:
        raise AssertionError("triplane_bwd disagrees with its plain version "
                             "or differs between two calls")
    # the rows of zero cotangent, whose products the kernel skips: their
    # dq is exactly 0 in both
    if bool(zero.any()) and not (bool((dq_k[zero] == 0).all()) and bool(
            (dq_p[zero] == 0).all())):
        raise AssertionError("a zero-cotangent row's dq is not 0")
    # per level: occupied cells, the longest and the mean segment
    for lvl in range(len(meta) // 3):
        lens = []
        for gi, plane0, shift2, *_ in GG.problems(saved.layout):
            if plane0 // 3 == lvl:
                lens.append(torch.unique_consecutive(
                    skeys[gi] >> shift2, return_counts=True)[1])
        lens = torch.cat(lens)
        log(f"[grid bwd] level {lvl} ({meta[lvl * 3][2]}x{meta[lvl * 3][3]}"
            f" points): {lens.numel()} occupied cells over 3 orientations, "
            f"longest segment {int(lens.max())}, mean "
            f"{float(lens.float().mean()):.2f}")

    # the Function's backward, kernel against plain
    pts = xyz.detach().clone().requires_grad_(True)
    leaves = [g.detach().clone().requires_grad_(True) for g in grids]
    s_scales = len(meta) // 3
    field = {"grids": [leaves[3 * s:3 * s + 3] for s in range(s_scales)]}
    feats = TT.triplane_features(field, pts, tcfg)

    def function_bwd():
        return torch.autograd.grad(feats, [pts] + leaves, gfeat,
                                   retain_graph=True)

    GG.reset_launches()
    d_k = function_bwd()
    if GG.LAUNCHES["triplane_bwd"] != 1:
        raise AssertionError("the Function's backward did not launch "
                             "triplane_bwd once")
    with plain_backward():
        d_p = function_bwd()
    pts_err = check_dq("the Function's d/dpts", d_k[0], d_p[0])
    grid_errs = [rel_err(a, b) for a, b in zip(d_k[1:], d_p[1:])]
    log(f"[grid bwd] Function backward, kernel vs plain (share of the "
        f"largest value): d/dpts {pts_err:.3e}, grids {max(grid_errs):.3e}")
    if max(grid_errs) > GRID_RTOL:
        raise AssertionError("the Function's grid gradients disagree with "
                             "the plain version's")

    # times
    ms = cuda_ms(lambda: GG.triplane_bwd_cuda(*args))
    sort_ms = cuda_ms(lambda: GG.sort_keys(saved.keys))
    fn_ms = cuda_ms(function_bwd, n=10)
    plain_ms = cuda_ms(lambda: GG.triplane_bwd_plain(*args), n=3, warm=1)
    with torch.no_grad():
        txs, tys, _ = GG.plane_inputs(meta, q, grids, saved.keys,
                                      saved.layout)
        gouts = GG.plane_cotangents(gout, saved.samples)
        rows = GG.cell_rows(skeys, orders, txs, tys, gouts, saved.layout)
    cells = torch.cat([r[0] for r in rows])
    rows = torch.cat([r[1] for r in rows])
    acc = torch.zeros((GG.cell_bases(saved.layout)[-1], 4 * c),
                      device=rows.device)
    lib_ms = cuda_ms(lambda: acc.index_add_(0, cells, rows))
    del rows, cells, acc, gouts, txs, tys
    # bytes the function must move: gout, q and the planes read once, the
    # plane gradients and dq written once
    nbytes = 4 * (gout.numel() + 2 * q.numel()
                  + 2 * sum(g.numel() for g in grids))
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    passes = pass_times(args, profile_dir, smi) if profile_dir else None
    mib = 1 << 20
    log(f"[timing] triplane_bwd {ms:.4f} ms ({GG.KERNEL_LAUNCHES} "
        f"launches after the sorts, {sort_ms:.4f} ms), the Function's "
        f"backward {fn_ms:.4f} ms (sorts and kernel), plain {plain_ms:.3f} "
        f"ms, index_add_ of the same rows {lib_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms ({nbytes} bytes), {100 * bound_ms / ms:.1f}% "
        f"of it; {launches} launches in 16 steps; one training step's "
        f"peak allocated {peak['peak'] / mib:.1f} MiB "
        f"({(peak['peak'] - peak['before']) / mib:.1f} above the "
        f"{peak['before'] / mib:.1f} MiB held before it) | {smi}")
    row = {
        "name": "triplane_bwd", "route": "cuda",
        "source": "sings_tpu_torch/csrc/triplane_bwd.cu",
        "replaces": GRID_REPLACES, "launches": launches,
        "max_abs_err": max_err, "dq_max_rel_err": dq_err, "ms": ms,
        "kernel_ms": ms, "sort_ms": sort_ms, "function_bwd_ms": fn_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": lib_ms, "step_peak_bytes": peak["peak"],
        "step_start_bytes": peak["before"], "pass_ms": passes,
    }

    def field_step():
        f = TT.triplane_features(field, pts, tcfg)
        return torch.autograd.grad(f, [pts] + leaves, gfeat)

    return row, field_step


# ---------------------------------------------------------------------------
# the exact KNN statistic's kernel (phase 20, on phase 7's trainer)

KNN_KS = (1, 9, 16)
# a distance that is not the torch path's bit for bit is held within this
# many ulps of sq_i + sq_j (the size the cancellation rounds at)
KNN_ULPS = 2
# edge_stat through the kernel against the torch path's, relative
KNN_STAT_RTOL = 1e-6
# seeded random calls of the kernel, each synchronised
KNN_RANDOM_CASES = 200
# the benchmark's count of the statistic (benchmark/counts/flops.py): 8
# operations a pair
KNN_OPS_PER_PAIR = 8
KNN_REPLACES = ("none: sings_tpu/ops/knn.py::knn, knn_rows (blocked matmul "
                "+ lax.approx_min_k on the TPU, exact top-k elsewhere; no "
                "pallas_call)")


def knn_torch(points, k: int, valid, row_start: int = 0, rows=None):
    """The plain version's blocks (matmul + torch.topk) on the card: the
    library path the kernel replaced, kept here as its yardstick."""
    from sings_tpu_torch.ops import knn as KN

    rows = points.shape[0] if rows is None else rows
    sq = KN._sum_squares(points)
    ds, ids = [], []
    for s in range(row_start, row_start + rows, 4096):
        d, i = KN._block_topk(points, sq, slice(s, min(
            s + 4096, row_start + rows)), k, valid)
        ds.append(d)
        ids.append(i)
    return torch.clamp_min(torch.cat(ds), 0.0), torch.cat(ids)


def check_knn(name: str, points, k: int, valid) -> dict:
    """The kernel (knn_topk_cuda, unclamped, and knn) against the torch
    path at every row: distances bit for bit or within KNN_ULPS of sq_i
    + sq_j (count and worst logged), indices equal except among equal
    distances, the kernel's own order (ascending, ties by the lower
    index, every index valid, -1 only at +inf), and two calls bit for
    bit."""
    from sings_tpu_torch.ops import knn as KN

    n = points.shape[0]
    rd, ri = KN.knn_topk_cuda(points, k, valid, 0, n)
    gd, gi = KN.knn(points, k, valid=valid)
    again = KN.knn(points, k, valid=valid)
    if not (torch.equal(gd, again[0]) and torch.equal(gi, again[1])):
        raise AssertionError(f"knn {name}: two calls differ")
    if not (torch.equal(torch.clamp_min(rd, 0.0), gd) and torch.equal(
            ri, gi)):
        raise AssertionError(f"knn {name}: knn is not the launcher's rows")
    wd, wi = knn_torch(points, k, valid)
    fin = torch.isfinite(gd)
    if not torch.equal(fin, torch.isfinite(wd)):
        raise AssertionError(f"knn {name}: +inf slots differ")
    sq = KN._sum_squares(points)
    safe = torch.where(gi >= 0, gi, torch.zeros_like(gi))
    size = (sq[:, None] + sq[safe]).abs()
    ulp = torch.nextafter(size, torch.full_like(size, math.inf)) - size
    diff = torch.where(fin, (gd - wd).abs(), torch.zeros_like(gd))
    off = int((diff > 0).sum())
    worst = float((diff / ulp)[fin].max()) if bool(fin.any()) else 0.0
    if worst > KNN_ULPS:
        raise AssertionError(f"knn {name}: a distance {worst:.2f} ulps off")
    mism = (gi != wi) & fin
    ties_bad = 0
    if bool(mism.any()):
        r, c = torch.nonzero(mism, as_tuple=True)
        q = points[r].double()
        d_k = ((q - points[gi[r, c]].double()) ** 2).sum(1)
        d_w = ((q - points[wi[r, c]].double()) ** 2).sum(1)
        ties_bad = int(((d_k - d_w).abs() > 2 * KNN_ULPS
                        * ulp[r, c].double()).sum())
    if ties_bad:
        raise AssertionError(f"knn {name}: {ties_bad} neighbours differ "
                             "beyond a tie")
    asc = bool((rd[:, 1:] >= rd[:, :-1]).all())
    ties = bool(((rd[:, 1:] != rd[:, :-1]) | (ri[:, 1:] > ri[:, :-1])
                 | ~fin[:, 1:]).all())
    idx_ok = bool(((gi >= 0) == fin).all()) and (
        valid is None or bool(valid[safe][fin].all()))
    if not (asc and ties and idx_ok):
        raise AssertionError(f"knn {name}: ascending {asc}, ties by index "
                             f"{ties}, indices {idx_ok}")
    out = {"k": k, "dist_not_bitwise": off, "worst_ulps": worst,
           "index_ties": int(mism.sum()), "inf_slots": int((~fin).sum()),
           "clamped": int((rd < 0).sum())}
    log(f"[knn] {name} k={k}: distances not bit for bit {off} of "
        f"{gd.numel()}, worst {worst:.3f} ulps of sq_i + sq_j; indices "
        f"apart only among equal distances ({int(mism.sum())}); +inf "
        f"slots {out['inf_slots']}; clamped at 0 {out['clamped']}; two "
        "calls bit for bit")
    return out


def random_knn_cases(base, alive, cases: int) -> int:
    """Seeded random calls of knn_topk_cuda around the avatar's centres,
    each synchronised, so that a fault shows at its call: 1 to all
    127,744 slots, moved by 0 to 1 cm, a NaN or an infinite point now
    and then, no mask, the alive mask or a random one, k 1..16, all rows
    or a random range. Every output index is -1 or a valid slot, -1 only
    at +inf, every finite distance a valid slot's, the rows ascending; where n <= 3000 and every point is
    finite the distances are the torch path's within KNN_ULPS. Returns
    the number of cases."""
    from sings_tpu_torch.ops import knn as KN

    rng = np.random.RandomState(SEED)
    dev = base.device
    big = base.shape[0]
    for c in range(cases):
        n = int(rng.choice([big, rng.randint(1, 3001),
                            rng.randint(3001, big)]))
        pts = base[:n] + float(rng.choice([0.0, 1e-4, 1e-2])) * torch.tensor(
            rng.randn(n, 3).astype(np.float32), device=dev)
        if rng.rand() < 0.1:
            pts[rng.randint(n)] = float(rng.choice([math.nan, math.inf]))
        pts = pts.contiguous()
        mode = rng.randint(3)
        valid = (None if mode == 0 else alive[:n].clone() if mode == 1
                 else torch.tensor(rng.rand(n) < rng.rand(), device=dev))
        k = int(rng.randint(1, min(n, KN.MAX_K) + 1))
        rs = 0 if rng.rand() < 0.5 else int(rng.randint(n))
        rr = n - rs if rs == 0 else int(rng.randint(1, n - rs + 1))
        d, i = KN.knn_topk_cuda(pts, k, valid, rs, rr)
        torch.cuda.synchronize()
        fin = torch.isfinite(d)
        ok = (bool(((i >= -1) & (i < n)).all())
              and bool((i[fin] >= 0).all())
              and bool(torch.isinf(d[i < 0]).all())
              and bool((d[:, 1:] >= d[:, :-1])[fin[:, 1:]].all())
              and (valid is None or bool(valid[i[fin]].all())))
        if ok and n <= 3000 and bool(torch.isfinite(pts).all()):
            wd, _ = knn_torch(pts, k, valid, rs, rr)
            sq = KN._sum_squares(pts)
            size = (sq[rs:rs + rr, None]
                    + sq[torch.where(i >= 0, i, 0)]).abs()
            ulp = torch.nextafter(size, torch.full_like(size, math.inf)) - size
            gd = torch.clamp_min(d, 0.0)
            ok = bool(torch.equal(fin, torch.isfinite(wd))) and bool(
                ((gd - wd).abs() <= KNN_ULPS * ulp)[fin].all())
        if not ok:
            raise AssertionError(f"knn random case {c}: n {n} k {k} rows "
                                 f"{rs}+{rr}")
    return cases


def run_knn(trainer, launches: int, smi: str) -> dict:
    """Phase 20: ops/knn.py's kernel csrc/knn_topk.cu at the avatar's state
    (its canonical centres and alive mask), on a scene of duplicated
    points and on one with fewer than k valid candidates, against the
    torch path for k in KNN_KS (check_knn); knn_rows over the gs-4 split
    equal to knn's rows; edge_stat against the torch path's; the
    kernel's time (ops/timing.py::device_time) beside its bound and the
    torch path's. launches: phase 9's, one a chunk. Returns the
    kernels-line row."""
    from sings_tpu_torch.losses.regularizers import edge_stat
    from sings_tpu_torch.model.avatar import get_canon_xyz
    from sings_tpu_torch.ops import knn as KN
    from sings_tpu_torch.ops.timing import device_time

    tr = trainer
    with torch.no_grad():
        xyz = get_canon_xyz(tr.params, tr.buffers, tr.avatar_cfg)
    alive = tr.buffers.alive
    valid = alive > 0
    n, n_live = xyz.shape[0], int(valid.sum())
    stats = [check_knn("avatar", xyz, k, valid) for k in KNN_KS]
    # the gs-4 split of the rows, as dist/train_sharded.py asks for it
    full_d, full_i = KN.knn(xyz, 9, valid=valid)
    share = n // 4
    for r in range(4):
        d, i = KN.knn_rows(xyz, 9, row_start=r * share, rows=share,
                           valid=valid)
        if not (torch.equal(d, full_d[r * share:(r + 1) * share])
                and torch.equal(i, full_i[r * share:(r + 1) * share])):
            raise AssertionError(f"knn_rows range {r} is not knn's rows")
    # exact ties: the live centres three times over (the third copy
    # reversed), a tenth of them invalid
    live = xyz[valid][:30000]
    dup = torch.cat([live, live, live.flip(0)]).contiguous()
    gen = torch.Generator(device=xyz.device).manual_seed(SEED)
    dup_valid = torch.rand(dup.shape[0], generator=gen,
                           device=xyz.device) > 0.1
    stats += [check_knn("duplicates", dup, k, dup_valid) for k in KNN_KS]
    stats += [check_knn("duplicates, every point valid", dup, k, None)
              for k in KNN_KS]
    # fewer than k valid candidates: +inf and -1 in the tail
    few_valid = torch.zeros(1000, dtype=torch.bool, device=xyz.device)
    few_valid[torch.tensor([3, 17, 250, 500, 999])] = True
    few = xyz[:1000].contiguous()
    for k in (9, 16):
        stats.append(check_knn("5 valid of 1000", few, k, few_valid))
        d, i = KN.knn(few, k, valid=few_valid)
        if not (bool(torch.isinf(d[:, 5:]).all())
                and bool((i[:, 5:] == -1).all())):
            raise AssertionError("knn: the tail past 5 valid candidates")
    n_random = random_knn_cases(xyz, valid, KNN_RANDOM_CASES)
    log(f"[knn] {n_random} seeded random cases (sizes, masks, k, row "
        "ranges, NaN and infinite points): indices and order sound, the "
        "small ones the torch path's distances")
    # the statistic as the chunk head makes it
    stat = edge_stat(xyz, alive, k=tr.step_cfg.knn_k)
    wd, _ = knn_torch(xyz, tr.step_cfg.knn_k, valid)
    want = torch.sqrt(torch.clamp_min(wd[:, 1:], 1e-24)).mean(dim=1)
    stat_err = float(((stat - want).abs() / want.abs().clamp_min(
        1e-30)).max())
    if not bool(torch.isfinite(stat).all()) or stat_err > KNN_STAT_RTOL:
        raise AssertionError(f"edge_stat through the kernel: {stat_err:.3e}")
    # times: the kernel (with its glue), the statistic, the torch path
    ms = device_time(lambda _x: KN.knn(xyz, 9, valid=valid), (xyz,)) * 1e3
    stat_ms = device_time(lambda _x: edge_stat(xyz, alive, k=9),
                          (xyz,)) * 1e3
    rows_ms = device_time(lambda _x: KN.knn_rows(
        xyz, 9, row_start=0, rows=share, valid=valid), (xyz,)) * 1e3
    lib_ms = cuda_ms(lambda: knn_torch(xyz, 9, valid), n=2, warm=1)
    bound_ms = KNN_OPS_PER_PAIR * n_live ** 2 / H100_FP32_FLOPS * 1e3
    walk_ms = KNN_OPS_PER_PAIR * n * n_live / H100_FP32_FLOPS * 1e3
    log(f"[timing] knn_topk (k 9, {n_live} live in {n} slots, with its "
        f"glue) {ms:.4f} ms, edge_stat {stat_ms:.4f} ms, knn_rows of a "
        f"quarter {rows_ms:.4f} ms; the torch path (matmul + torch.topk) "
        f"{lib_ms:.3f} ms; bound {bound_ms:.4f} ms at N_live^2 pairs "
        f"({100 * bound_ms / ms:.1f}% of it), {walk_ms:.4f} ms at the "
        f"{n * n_live} pairs of a walk that skips no tile; edge_stat "
        f"within {stat_err:.2e}; "
        f"{launches} launches in 16 steps | {smi}")
    return {
        "name": "knn_topk", "route": "cuda",
        "source": "sings_tpu_torch/csrc/knn_topk.cu",
        "replaces": KNN_REPLACES, "launches": launches,
        "max_abs_err": None, "worst_ulps": max(x["worst_ulps"]
                                               for x in stats),
        "edge_stat_rel_err": stat_err, "ms": ms, "kernel_ms": ms,
        "edge_stat_ms": stat_ms, "rows_quarter_ms": rows_ms,
        "plain_ms": lib_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
        "bound_all_pairs_ms": walk_ms, "bound_by": "operations",
    }


# ---------------------------------------------------------------------------
# the tile binning's kernels (phase 21, at phase 4's and phase 8's frames)

BIN_REPLACES = ("none: sings_tpu/ops/rasterizer/tiles.py::bin_gaussians "
                "(XLA code, no pallas_call)")
# the runtime calls that make the host wait (benchmark/counts/spans.py)
BIN_WAIT_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                  "cudaEventSynchronize", "cudaMemcpy")
# phase 21's checks at the training frame and LAUNCHES["bin_tiles"] in
# phases 5 and 9
BIN_STATS = {}


def binning_inputs(gauss, cam, kw):
    """A frame's screen-space gaussians and bin_gaussians' keywords, as
    prepare_composite makes them (gauss as composite_inputs takes it)."""
    from sings_tpu_torch.ops.rasterizer.api import (
        RasterConfig, _pad_tiles, valid_tiles_y,
    )
    from sings_tpu_torch.ops.rasterizer.common import preprocess

    cfg = RasterConfig(height=cam.height, width=cam.width, **{
        k: kw[k] for k in ("tile", "chunk", "max_span", "max_pairs",
                           "main_width", "tail_capacity", "pair_cap")})
    g2d = preprocess(*gauss[:4], gauss[4], cam, sh_degree=3,
                     alive=gauss[5] if len(gauss) > 5 else None,
                     tile=cfg.tile)
    ntx, nty = _pad_tiles(cfg)
    return g2d, dict(tile=cfg.tile, n_tiles_x=ntx, n_tiles_y=nty,
                     max_span=cfg.max_span, align=cfg.chunk,
                     max_pairs=cfg.max_pairs, main_width=cfg.main_width,
                     tail_capacity=cfg.tail_capacity, cull=cfg.cull,
                     pair_cap=cfg.pair_cap,
                     valid_tiles_y=valid_tiles_y(cfg, None))


def bin_bytes(g2d, binning) -> int:
    """The binning's least traffic: each input field read once (means,
    depths, conics, opacities, radii, mask: 33 bytes a gaussian) and
    each output field written once."""
    n = g2d.means2d.shape[0]
    return 33 * n + sum(
        getattr(binning, f).numel() * getattr(binning, f).element_size()
        for f in binning._fields if f != "pair_slot_capacity")


def host_waits_in(fn) -> tuple:
    """One call of fn under the profiler: the runtime calls that make the
    host wait and the launch calls that start inside its range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PREAMBLE):
            torch.cuda._sleep(1000)
        with record_function("bin_call"):
            fn()
        torch.cuda.synchronize()
    evs = prof.events()
    outer = [e for e in evs if e.name == "bin_call"][0].time_range
    inside = [e.name for e in evs
              if outer.start <= e.time_range.start <= outer.end]
    waits = [x for x in inside if x in BIN_WAIT_CALLS]
    launches = [x for x in inside if x.startswith(("cudaLaunch",
                                                   "cuLaunch"))]
    return waits, launches


def check_binning(name: str, g2d, bkw: dict, smi: str) -> dict:
    """Phase 21 at one frame: bin_gaussians through csrc/bin_tiles.cu
    against bin_gaussians_plain on the same CUDA inputs, every field
    integer for integer, two calls bit for bit, no host wait inside a
    call; CUDA-event and host-issue times of both, the byte bound."""
    from sings_tpu_torch.ops.rasterizer import tiles as T

    want = T.bin_gaussians_plain(g2d, **bkw)
    got = T.bin_gaussians(g2d, **bkw)
    again = T.bin_gaussians(g2d, **bkw)
    torch.cuda.synchronize()
    for f in T.TileBinning._fields:
        a, b, c = getattr(got, f), getattr(want, f), getattr(again, f)
        same = (a == b == c) if f == "pair_slot_capacity" else (
            a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
            and torch.equal(a, c))
        if not same:
            raise AssertionError(f"binning {name}: {f} differs from the "
                                 "plain version's")
    waits, launches = host_waits_in(lambda: T.bin_gaussians(g2d, **bkw))
    if waits or not launches:
        raise AssertionError(f"binning {name}: host waits {waits} in a "
                             f"call ({len(launches)} launches seen)")
    torch.cuda.set_sync_debug_mode("error")
    try:
        T.bin_gaussians(g2d, **bkw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ms = cuda_ms(lambda: T.bin_gaussians(g2d, **bkw), n=50, warm=5)
    plain_ms = cuda_ms(lambda: T.bin_gaussians_plain(g2d, **bkw), n=10,
                       warm=2)

    def issue_ms(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e3

    host_ms = issue_ms(lambda: T.bin_gaussians(g2d, **bkw), 50)
    plain_host_ms = issue_ms(lambda: T.bin_gaussians_plain(g2d, **bkw), 10)
    nbytes = bin_bytes(g2d, got)
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    out = {"pairs": int(got.num_pairs), "overflow": int(got.overflow),
           "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
           "plain_host_ms": plain_host_ms, "bound_ms": bound_ms,
           "bytes": nbytes, "launch_calls": len(launches)}
    log(f"[binning] {name}: {g2d.means2d.shape[0]} gaussians, "
        f"{out['pairs']} pairs, overflow {out['overflow']}: every field the "
        f"plain version's, two calls bit for bit; no host wait in a call "
        f"({len(launches)} launch calls, profiler and sync debug mode)")
    log(f"[timing] binning {name}: kernels {ms:.4f} ms (host issue "
        f"{host_ms:.4f} ms), plain {plain_ms:.4f} ms (host "
        f"{plain_host_ms:.4f} ms), bound {bound_ms:.4f} ms ({nbytes} bytes"
        f", {100 * bound_ms / ms:.1f}% of it) | {smi}")
    return out


def binning_row(anim: dict) -> dict:
    """The kernels-line row of phase 21: the animation frame's times, the
    training frame's beside them, the launches of phases 5 and 9."""
    train = BIN_STATS["train"]
    return {
        "name": "bin_tiles", "route": "cuda",
        "source": "sings_tpu_torch/csrc/bin_tiles.cu",
        "replaces": BIN_REPLACES,
        "launches": BIN_STATS["launches_anim"],
        "launches_train": BIN_STATS["launches_train"],
        "max_abs_err": 0.0, "ms": anim["ms"], "kernel_ms": anim["ms"],
        "host_ms": anim["host_ms"], "plain_ms": anim["plain_ms"],
        "plain_host_ms": anim["plain_host_ms"],
        "bound_ms": anim["bound_ms"], "bound_by": "bytes",
        "train_frame_ms": train["ms"], "train_frame_plain_ms":
        train["plain_ms"], "library_ms": None,
    }


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
    from sings_tpu_torch.ops import grid_grad as GG
    from sings_tpu_torch.ops.rasterizer import kernels as K
    from sings_tpu_torch.train.trainer import Trainer
    from sings_tpu_torch.tree import tree_leaves

    t0 = time.time()
    old.cfg.train.init_steps = RECIPE_INIT_STEPS
    GG.reset_launches()
    old._init_attrs()
    torch.cuda.synchronize()
    t_fit = time.time() - t0
    fit_launches = GG.LAUNCHES["triplane_bwd"]
    k = len(batches["idx"])
    (old.params, old.buffers, old.opt_state, losses, skipped,
     _) = old.train_scan(old.params, old.buffers, old.opt_state, old.cache,
                         batches, old.step_generator, CKPT_STEP - k,
                         old.active_sh_degree, old.region_lap, old.region_lap,
                         old.lap_pos_w, old.lap_color_w)
    log(f"[entry] pre-fit {RECIPE_INIT_STEPS} steps in {t_fit:.1f}s, then "
        f"steps {CKPT_STEP - k}-{CKPT_STEP - 1}: losses "
        f"{[round(x, 4) for x in losses.tolist()]}, skipped "
        f"{int(skipped.sum())}; triplane_bwd launches: {fit_launches} in "
        f"the pre-fit, {GG.LAUNCHES['triplane_bwd'] - fit_launches} in the "
        "chunk")
    # the pre-fit trains the grids (not xyz) and each step the grids and
    # xyz: one triplane backward each
    if (fit_launches, GG.LAUNCHES["triplane_bwd"]) != (RECIPE_INIT_STEPS,
                                                    RECIPE_INIT_STEPS + k):
        raise AssertionError("triplane_bwd launches differ from one per "
                             "pre-fit step and training step")
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
    GG.reset_launches()
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
    # the triplane's backward: once a training step; the resumed Trainer
    # runs no pre-fit, and validation's pose refine, the density events
    # and the exports take no gradient of the field
    log(f"[entry] triplane_bwd launches in the whole CLI call "
        f"{GG.LAUNCHES['triplane_bwd']}, expected {n_steps} (one a step)")
    if GG.LAUNCHES["triplane_bwd"] != n_steps:
        raise AssertionError("triplane_bwd launches differ from one a step")
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


def profile_train(trainer, batches, bargs, bkw, field_step,
                  out_dir: str) -> None:
    """Stage times of one full-width training step (CUDA events, each
    stage alone) and a torch.profiler trace of one 8-step chunk.
    field_step: one triplane forward and backward (phase 16's)."""
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
        ("triplane forward+backward", field_step),
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
             "triplane forward+backward": ["triplane_bwd"],
             "whole train_step": ["composite_fwd", "composite_bwd",
                                  "triplane_bwd"]}
    lines = [f"{'stage':40s} {'events ms':>10s} {'kernels ms':>10s} "
             f"{'composite':>10s} {'triplane':>10s} {'pre':>4s}  (events: "
             "5 back-to-back calls, host issue included; kernels: device "
             "time, profiler; composite, triplane: the composite kernels' "
             "and triplane_bwd's share; "
             f"pre: of the {PREAMBLE} preamble kernels, those the profiler "
             "recorded)"]
    for name, fn in stages:
        t = cuda_ms(fn, n=5, warm=1)
        d, comp, seen, prof = profiled(fn)
        if name in needs:
            require_seen(name, comp, needs[name], prof, out_dir)
        if name == "triplane forward+backward":
            # the field's backward launches no autograd scatter of its
            # corner gathers any more
            scatter = [e for e in prof.key_averages()
                       if "indexing_backward" in e.key]
            if scatter:
                raise AssertionError(f"the triplane's backward still runs "
                                     f"{[e.key for e in scatter]}")
        lines.append(f"{name:40s} {t:10.4f} {d:10.4f} "
                     f"{composite_ms(comp):10.4f} "
                     f"{comp['triplane_bwd']:10.4f} {seen:4d}")

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
    CHUNK_DEVICE_MS["phase 9 (knn chunk, standard laplacian)"] = busy_ms
    require_seen("8-step chunk", comp, ["composite_fwd", "composite_bwd",
                                        "triplane_bwd"], prof, out_dir)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:15]
    scatter = [e for e in kernels if "indexing_backward" in e.key]
    lines.append(f"8-step chunk: wall {wall_ms:.3f} ms unprofiled (host "
                 f"clock), device kernels {busy_ms:.3f} ms (busy "
                 f"{100 * busy_ms / wall_ms:.1f}% of the unprofiled wall), "
                 f"triplane_bwd {comp['triplane_bwd']:.3f} ms; "
                 f"indexing_backward_kernel (none from the triplane: its "
                 f"stage above runs none) "
                 f"{sum(e.self_device_time_total for e in scatter) / 1e3:.3f}"
                 f" ms in {sum(e.count for e in scatter)} launches")
    for e in top:
        lines.append(f"  {e.self_device_time_total / 1e3:10.3f} ms "
                     f"{e.count:6d}x  {e.key[:90]}")
    for line in lines:
        log(f"[profile train] {line}")
    with open(os.path.join(out_dir, "profile_train.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# multi-case training (phase 18, on phase 7's trainer)

# phase 9's steps/s per chunk in this run (the pool is compared with it)
PHASE9_STEPS_PER_S = []
# the two cases: phase 7's 9-frame kit and a 7-frame kit of the same
# avatar at other seeded poses (padded to 9 frames by the pool)
CASE_FRAMES = (9, 7)
CASE_NAMES = ("kit9", "kit7")
# the pool (phase 18.2): 6 lockstep steps after a 10-step pre-fit, a
# validation at step 4, checkpoints, visualisation and animation only at
# the end; 10 pose-refine steps a validation frame (the recipe's 60 cut)
POOL_STEPS = 6
POOL_DOTLIST = ["train.init_steps=10", f"train.num_steps={POOL_STEPS}",
                "train.val_interval=4", "train.save_ckpt_interval=100000",
                "train.viz_interval=100000", "train.anim_interval=100000",
                "tpu.val_pose_refine_steps=10", "exp_name=smoke_cases"]
POOL_EVENTS = ["000004", "final"]
# the sequential mode (phase 18.3), shallower
SEQ_DOTLIST = ["train.init_steps=10", "train.num_steps=2",
               "train.val_interval=100000", "train.save_ckpt_interval=100000",
               "train.viz_interval=100000", "train.anim_interval=100000",
               "tpu.val_pose_refine_steps=10", "human.canon_nframes=4",
               "exp_name=smoke_seq"]
# the kernels a case step launches once per case
CASE_KERNELS = ("composite_fwd", "composite_bwd", "triplane_bwd")


def perturbed(tree):
    """tests/test_dist.py's _perturb: x * 1.02 + 0.001 on float leaves."""
    from sings_tpu_torch.tree import tree_map

    return tree_map(lambda x: x * 1.02 + 0.001 if x.is_floating_point()
                    else x, tree)


def launch_counts() -> dict:
    from sings_tpu_torch.ops import grid_grad as GG
    from sings_tpu_torch.ops.rasterizer import kernels as K
    from sings_tpu_torch.ops.rasterizer import tiles as T

    return dict(K.LAUNCHES, triplane_bwd=GG.LAUNCHES["triplane_bwd"],
                **T.LAUNCHES)


def reset_all_launches() -> None:
    from sings_tpu_torch.ops import grid_grad as GG
    from sings_tpu_torch.ops.rasterizer import kernels as K
    from sings_tpu_torch.ops.rasterizer import tiles as T

    K.reset_launches()
    GG.reset_launches()
    T.reset_launches()


@torch.no_grad()
def second_case_kit(trainer, frames: int = CASE_FRAMES[1]):
    """A kit of the same avatar at other seeded poses: each frame's mask
    its silhouette ((1 - T) > 0.5) and its image that render plus seeded
    noise, as seed_train_targets makes phase 7's."""
    from sings_tpu_torch.model.avatar import avatar_forward
    from sings_tpu_torch.ops.rasterizer.api import rasterize
    from sings_tpu_torch.train.step import sh_degree_mask

    tr = trainer
    dev = tr.device
    kit = make_kit(frames, tr.camera.height)
    rng = np.random.RandomState(SEED + 18)
    smpl = dict(kit.smpl)
    smpl["body_pose"] = (rng.randn(frames, 69) * 0.08).astype(np.float32)
    smpl["transl"] = (smpl["transl"] + rng.randn(frames, 3) * 0.02).astype(
        np.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    mask_deg = sh_degree_mask(tr.active_sh_degree, dev)
    images = np.zeros_like(kit.images)
    masks = np.zeros_like(kit.masks)
    for f in range(frames):
        out = avatar_forward(
            tr.params, tr.buffers, tr.avatar_cfg, tr.template, tr.cache,
            global_orient=torch.as_tensor(smpl["global_orient"][f],
                                          device=dev),
            body_pose=torch.as_tensor(smpl["body_pose"][f], device=dev),
            betas=tr.params.betas,
            transl=torch.as_tensor(smpl["transl"][f], device=dev),
            smpl_scale=torch.ones(1, device=dev), eval_mode=True)
        pkg = rasterize(out["xyz"], out["scales"], out["rotq"],
                        out["opacity"][:, 0],
                        out["shs"] * mask_deg[None, :, None], tr.camera,
                        sh_degree=3, bg=torch.zeros(3, device=dev),
                        alive=tr.buffers.alive > 0.5, **tr.raster_kw)
        masks[f] = ((1.0 - pkg["transmittance"]) > 0.5).float().cpu()
        noise = torch.randn(pkg["render"].shape, generator=gen, device=dev)
        images[f] = torch.clamp(pkg["render"] + 0.05 * noise, 0, 1).cpu()
    return kit._replace(smpl=smpl, images=images, masks=masks,
                        name=CASE_NAMES[1])


def expected_frames(seed: int, c: int, split: list, n: int) -> list:
    """The frames case c of a pool draws: np.random.RandomState(seed +
    7919 c)'s shuffles of the training split, reshuffled at each pass."""
    rng = np.random.RandomState(seed + 7919 * c)
    order = list(range(len(split)))
    rng.shuffle(order)
    out, cur = [], 0
    for _ in range(n):
        if cur >= len(order):
            rng.shuffle(order)
            cur = 0
        out.append(int(split[order[cur]]))
        cur += 1
    return out


def case_step_check(dev, trainer, batches) -> tuple:
    """18.1: one make_case_train_step call on two cases (phase 7's state
    and its perturbed copy, frames 0 and 1) against two single-card
    train_step calls on the same draws, bit for bit; 2 launches of each
    kernel from 0. Returns the case step's CUDA-event time and that of
    the exact KNN statistic it computes once a case (ms)."""
    from sings_tpu_torch.dist import train_cases as TCS
    from sings_tpu_torch.losses.photometric import draw_step_randoms
    from sings_tpu_torch.losses.regularizers import edge_stat
    from sings_tpu_torch.model.avatar import get_canon_xyz
    from sings_tpu_torch.tree import tree_leaves

    tr = trainer
    lpips = tr.lpips_params if float(tr.cfg.human.loss.lpips_w) > 0 else None
    step_fn = TCS.make_case_train_step(
        tr.avatar_cfg, tr.step_cfg, tr.template, tr.camera.height,
        tr.camera.width, tr.tx, lpips, tr.raster_kw)
    params = [tr.params, perturbed(tr.params)]
    frames = [int(batches["idx"][c]) for c in range(2)]
    batch = {"rgb": batches["rgb"][:2], "mask": batches["mask"][:2],
             "idx": frames, "smpl_scale": batches["smpl_scale"][:2]}
    pw = tr.step_cfg.weights.photometric
    draws = [draw_step_randoms(
        torch.Generator(device=dev).manual_seed(SEED + 180 + c),
        batch["mask"][c], pw) for c in range(2)]
    stacked = (TCS.stack_cases(params),
               TCS.stack_cases([tr.buffers] * 2),
               TCS.stack_cases([tr.opt_state] * 2),
               TCS.stack_cases([tr.cache] * 2),
               TCS.stack_cases([TCS.camera_arrays(tr.camera)] * 2))
    lap = TCS.stack_cases([tr.region_lap] * 2)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    reset_all_launches()
    torch.cuda.synchronize()
    start.record()
    cp, cb, co, cm = step_fn(*stacked, batch, [None, None], TRAIN_STEP0,
                             tr.active_sh_degree, lap, lap, tr.lap_pos_w,
                             tr.lap_color_w, draws=draws)
    stop.record()
    torch.cuda.synchronize()
    launches = launch_counts()
    case_ms = start.elapsed_time(stop)

    def single(c):
        frame = {k: v[c] for k, v in batch.items()}
        return tr.train_step(params[c], tr.buffers, tr.opt_state, tr.cache,
                             frame, None, TRAIN_STEP0, tr.active_sh_degree,
                             tr.region_lap, tr.region_lap, tr.lap_pos_w,
                             tr.lap_color_w, draws=draws[c])[:4]

    diffs = []
    for c in range(2):
        p, b, o, m = single(c)
        got = tree_leaves((cp, cb, co)) + [cm[k] for k in sorted(m)]
        want = tree_leaves((p, b, o)) + [m[k] for k in sorted(m)]
        if sorted(cm) != sorted(m):
            raise AssertionError(f"case step metrics {sorted(cm)} against "
                                 f"{sorted(m)}")
        for i, (g, w) in enumerate(zip(got, want)):
            g = g[c]
            if not torch.equal(g, w):
                diffs.append((c, i, float((g.double() - w.double()).abs()
                                          .max())))
        if not all(bool(torch.isfinite(x).all()) for x in want):
            raise AssertionError(f"case {c}: a value is not finite")
        if float(m["skipped"]) != 0.0:
            raise AssertionError(f"case {c}: step skipped")
    loss = [round(float(x), 6) for x in cm["loss"]]
    log(f"[cases step] 2 cases at step {TRAIN_STEP0} (frames {frames}, the "
        f"second case's params perturbed): losses {loss}, "
        f"{len(tree_leaves((cp, cb, co)))} state leaves and {len(cm)} "
        f"metrics a case against two train_step calls on the same draws: "
        f"{len(diffs)} differ; launches {launches}; {case_ms:.3f} ms of "
        "CUDA-event time")
    if diffs:
        p2 = single(0)
        p1 = single(0)
        rep = all(torch.equal(a, b_) for a, b_ in zip(tree_leaves(p1),
                                                      tree_leaves(p2)))
        raise AssertionError(f"the case step differs from the single-card "
                             f"steps at (case, leaf, max abs) {diffs[:12]};"
                             f" the single step repeats bit for bit: {rep}")
    if loss[0] == loss[1]:
        raise AssertionError("the two cases' losses are equal")
    for name in CASE_KERNELS:
        if launches[name] != 2:
            raise AssertionError(f"case step: {name} launched "
                                 f"{launches[name]} times, not 2")
    with torch.no_grad():
        xyz = get_canon_xyz(tr.params, tr.buffers, tr.avatar_cfg)
    stat_ms = cuda_ms(lambda: edge_stat(xyz, tr.buffers.alive,
                                        k=tr.step_cfg.knn_k), n=2, warm=1)
    log(f"[cases step] the exact KNN statistic {stat_ms:.3f} ms a call "
        f"(CUDA events), {2 * stat_ms / case_ms:.1%} of the case step")
    return case_ms, stat_ms


def run_cases(work: str, dev, smi: str, trainer, batches) -> None:
    """Phase 18: 18.1 the case step on phase 7's trainer against the
    single-card step; 18.2 python -m sings_tpu_torch.cli.train_batch
    --simultaneous over phase 7's kit and a 7-frame kit (the CasePool);
    18.3 the same CLI's sequential mode over both kits."""
    from sings_tpu_torch.cli import train_batch
    from sings_tpu_torch.tree import tree_leaves
    from sings_tpu_torch.train import trainer_cases as TCP

    t_phase = time.time()
    # ---- 18.1 the case step against two single-card steps
    case_ms, stat_ms = case_step_check(dev, trainer, batches)
    t_step = time.time() - t_phase

    # ---- 18.2 the simultaneous pool through the CLI
    t1 = time.time()
    kits = {CASE_NAMES[0]: make_train_kit()._replace(
                images=trainer.images.cpu().numpy(),
                masks=trainer.masks.cpu().numpy(), name=CASE_NAMES[0]),
            CASE_NAMES[1]: second_case_kit(trainer)}
    t_kits = time.time() - t1
    opts = [x for x in train_dotlist(work, POOL_DOTLIST)
            if not x.startswith("dataset.name=")]
    pools, step_ms, step_wall, frames_drawn, validated = [], [], [], {}, {}
    in_steps = {name: 0 for name in CASE_KERNELS}
    orig_make, orig_train = TCP.make_case_train_step, TCP.CasePool.train

    def timed_make(*a, **k):
        fn = orig_make(*a, **k)

        def step(*sa, **sk):
            before = launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            out = fn(*sa, **sk)
            stop.record()
            torch.cuda.synchronize()
            step_wall.append(time.perf_counter() - t)
            step_ms.append(start.elapsed_time(stop))
            after = launch_counts()
            for name in CASE_KERNELS:
                in_steps[name] += after[name] - before[name]
            return out
        return step

    def recorded_train(pool):
        pools.append(pool)
        for c, t in enumerate(pool.trainers):
            frames_drawn[c], validated[c] = [], []
            orig_val = t.validate

            def val(iter_s="final", _c=c, _v=orig_val):
                validated[_c].append(iter_s)
                return _v(iter_s)
            t.validate = val
        orig_next = pool._next_frame

        def next_frame(c):
            f = orig_next(c)
            frames_drawn[c].append(f)
            return f
        pool._next_frame = next_frame
        return orig_train(pool)

    TCP.make_case_train_step = timed_make
    TCP.CasePool.train = recorded_train
    try:
        reset_all_launches()
        torch.cuda.synchronize()
        t2 = time.time()
        results = train_batch.main(
            ["--simultaneous", "--device", "cuda", *opts, "--cases",
             *CASE_NAMES], kits=kits, image_writer=lambda path, img: None)
        t_pool = time.time() - t2
    finally:
        TCP.make_case_train_step = orig_make
        TCP.CasePool.train = orig_train
    total = launch_counts()
    pool = pools[0]
    ta, tb = pool.trainers
    wall = sum(step_wall)
    log(f"[cases pool] {len(step_ms)} lockstep steps of 2 cases: device "
        f"time a lockstep step {', '.join(f'{x:.3f}' for x in step_ms)} ms "
        f"(CUDA events), host wall {', '.join(f'{x:.3f}' for x in step_wall)}"
        f" s; {POOL_STEPS / wall:.3f} lockstep steps/s = steps/s per case "
        f"({2 * POOL_STEPS / wall:.3f} case steps/s), phase 9 in this run "
        f"{', '.join(f'{x:.3f}' for x in PHASE9_STEPS_PER_S)} steps/s; the "
        f"exact statistic twice a lockstep step "
        f"{2 * stat_ms / np.median(step_ms):.1%} of its median | {smi}")
    log(f"[cases pool] launches in the pool's steps {in_steps}; in the whole"
        f" CLI call (pre-fits, validations, exports) {total}; results "
        f"{ {k: round(v['psnr'], 3) for k, v in results.items()} }")
    if len(step_ms) != POOL_STEPS or pool.step != POOL_STEPS:
        raise AssertionError(f"the pool ran {len(step_ms)} steps, not "
                             f"{POOL_STEPS}")
    for name in CASE_KERNELS:
        if in_steps[name] != 2 * POOL_STEPS:
            raise AssertionError(f"pool: {name} launched {in_steps[name]} "
                                 f"times in {POOL_STEPS} lockstep steps of 2"
                                 " cases")
    for t in pool.trainers:
        if t.params.body_pose.shape[0] != CASE_FRAMES[0]:
            raise AssertionError(f"body_pose {tuple(t.params.body_pose.shape)}"
                                 f" not padded to {CASE_FRAMES[0]} frames")
    if len(tb.kit.images) != CASE_FRAMES[1]:
        raise AssertionError("the 7-frame kit's images were padded")
    for c, t in enumerate(pool.trainers):
        want = expected_frames(SEED, c, t.kit.train_split, POOL_STEPS)
        if frames_drawn[c] != want:
            raise AssertionError(f"case {c} drew frames {frames_drawn[c]}, "
                                 f"RandomState({SEED} + 7919 * {c}) gives "
                                 f"{want}")
        if validated[c] != POOL_EVENTS:
            raise AssertionError(f"case {c} validated at {validated[c]}")
        for f in ("ckpt/human_final.npz", "results_train.json",
                  "config_train.yaml", "showcase.splat"):
            if not os.path.exists(os.path.join(t.logdir, f)):
                raise AssertionError(f"case {c}: no {f}")
        if not all(bool(torch.isfinite(x).all())
                   for x in tree_leaves(t.params)):
            raise AssertionError(f"case {c}: a parameter is not finite")
    if sorted(results) != sorted(CASE_NAMES):
        raise AssertionError(f"pool results {sorted(results)}")
    if torch.equal(ta.params.xyz, tb.params.xyz):
        raise AssertionError("the two cases' xyz are equal")
    log(f"[cases pool] frames drawn {frames_drawn} (the RandomState "
        f"streams), validations {validated}, body_pose "
        f"{tuple(ta.params.body_pose.shape)} in both, xyz apart by "
        f"{float((ta.params.xyz - tb.params.xyz).abs().max()):.3e}")
    del pools, pool, ta, tb
    torch.cuda.empty_cache()

    # ---- 18.3 the sequential mode over both kits
    t3 = time.time()
    opts = [x for x in train_dotlist(work, SEQ_DOTLIST)
            if not x.startswith("dataset.name=")]
    reset_all_launches()
    seq = train_batch.main(["--device", "cuda", "--shard", "0/1", *opts,
                            "--cases", *CASE_NAMES], kits=kits,
                           image_writer=lambda path, img: None)
    t_seq = time.time() - t3
    seq_launches = launch_counts()
    log(f"[cases sequential] results "
        f"{ {k: round(v['psnr'], 3) for k, v in seq.items()} }, launches "
        f"{seq_launches}")
    if list(seq) != list(CASE_NAMES) or not all(
            math.isfinite(v["psnr"]) for v in seq.values()):
        raise AssertionError(f"sequential mode results {seq}")
    for name in CASE_KERNELS:
        # two training steps a case at least
        if seq_launches[name] < 2 * len(CASE_NAMES) * 2:
            raise AssertionError(f"sequential mode: {name} launched "
                                 f"{seq_launches[name]} times")
    log(f"[cases] stage walls: case step {t_step:.1f}s ({case_ms:.3f} ms of "
        f"device time), kits {t_kits:.1f}s, pool CLI {t_pool:.1f}s "
        f"(steps {wall:.1f}s), sequential CLI {t_seq:.1f}s; phase 18 "
        f"{time.time() - t_phase:.1f}s")


# ---------------------------------------------------------------------------
# the sharded (dp, gs) step (phase 19, on phase 7's trainer)

# 19.1 strips against the full frame. Each strip and the full frame (at
# the strips' raster keywords) pass check_fwd and check_bwd: the kernels
# against their plain versions on that binning, at the rasterizer's own
# ATOL and flip allowance. The owned rows against the full render at
# tests/test_dist.py:34's atol 2e-4, where a value over it is allowed
# only at a pixel that the cause explains: a strip camera's pixel
# coordinates round an ulp apart from the full frame's, so a pair whose
# alpha sits within rounding of the 1/255 skip (ALPHA_MIN) is composited
# in one and skipped in the other. Such a pixel holds a gaussian whose
# alpha in the two cameras lies on both sides of ALPHA_MIN, or within
# SKIP_REL of it (the walk's arithmetic, recomputed), and one flip moves
# it by at most T alpha (|c| + max |C|) <= 2 ALPHA_MIN max(1, max |c|)
# a flip (the gaussian's own term, and the pairs behind it rescaled by
# 1 / (1 - alpha)). The plain composites render the same strips: their
# flips are printed beside the kernels'. At most STRIP_FLIP_FRACTION of the owned
# values flip (about 4x the most seen: 18 of 786,432 at balanced gs 4 on
# the NVIDIA H100, each at a pixel with one gaussian on the skip, and the
# plain composites flipped the same pixels by the same amounts). The
# gradients summed over the strips at tests/test_dist.py:200's tolerance
# for strips against the full frame (GS2_GRAD_TOL below); beside it, the
# values over the rasterizer's BWD_RTOL of the leaf's scale, for the
# kernels and for the plain composites: the kernels may flag no more
# values that the plain composites do not than the backward's own flip
# allowance (MAX_BWD_FLIP_FRACTION). The strip layouts: equal strips at
# gs 2 and 4, and balanced_strip_bounds from the kit's masks at gs 4
STRIP_ATOL = 2e-4
SKIP_REL = 1e-6
STRIP_FLIP_FRACTION = 1e-4
STRIP_LAYOUTS = (("gs 2", 2, False), ("gs 4", 4, False),
                 ("balanced gs 4", 4, True))
# 19.2 the sharded step at world size 1 against the single-card step:
# tests/test_dist.py's (1, 1) tolerances
SHARD_METRIC_RTOL, SHARD_METRIC_ATOL = 2e-4, 1e-7
SHARD_GRAD_RTOL, SHARD_GRAD_ATOL_REL = 1e-3, 1e-4
SHARD_METRICS = ("loss", "photo", "reg_l2", "mesh_edge", "connect",
                 "lap_pos", "lap_color", "photo_l1", "photo_ssim",
                 "photo_sil", "skipped")
# 19.3 two ranks (gs 2) against world size 1: the loss at rtol 5e-4, the
# gradients at tests/test_dist.py:200's 0.05 (reassociation and T_EPS
# flips of deeply occluded gaussians)
GS2_LOSS_RTOL, GS2_GRAD_TOL = 5e-4, 0.05
# the CLI under tpu.mesh.gs=2: a 10-step pre-fit, then 4 steps with a
# prune at 1 (an event that removes nothing here: no splat is under the
# recipe's scale threshold), a densify at 2 that adds splats and a
# checkpoint at 3
SHARD_CLI_DOTLIST = [
    "train.num_steps=4", "train.init_steps=10", "train.val_interval=100000",
    "train.viz_interval=100000", "train.anim_interval=100000",
    "train.save_ckpt_interval=3", "tpu.val_pose_refine_steps=0",
    "human.canon_nframes=2", "anim_cfg_path=", "tpu.mesh.gs=2",
    "human.density_control.hybrid.prune_from_iter=1",
    "human.density_control.hybrid.prune_interval=100",
    "human.density_control.hybrid.densify_from_iter=2",
    "human.density_control.hybrid.densify_interval=100",
    "human.density_control.hybrid.densify_grad_threshold=0.0",
    "exp_name=smoke_shard"]
SHARD_KERNELS = ("composite_fwd", "composite_bwd", "triplane_bwd",
                 "bin_tiles")
# each kernel's launches in one sharded step on one rank of 19.3 (the
# kernels line's launches_sharded)
SHARD_LAUNCHES = {}


class KeepGrads:
    """SGD at learning rate 1 that keeps the gradients in its state
    (train/optim.py's interface): the steps' gradients compared as
    computed."""

    def init(self, params):
        from sings_tpu_torch.tree import tree_map

        return {"g": tree_map(torch.zeros_like, params)}

    def update(self, grads, state, params):
        from sings_tpu_torch.tree import tree_map

        return tree_map(lambda p, g: p - g, params, grads), {"g": grads}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def strip_inputs(trainer, batch):
    """Phase 7's frame gaussians as rasterize's leaves (screen_probe
    last), and the keywords under which strips and the full frame bin
    the same pairs (tests/test_dist.py::_sharded_setup's rule): max_span
    the frame's widest tile rectangle, main_width its square, no
    pair_cap."""
    from sings_tpu_torch.model.avatar import avatar_forward
    from sings_tpu_torch.ops.rasterizer.common import preprocess, tile_rect
    from sings_tpu_torch.train.step import sh_degree_mask

    cam = trainer.camera
    with torch.no_grad():
        out = avatar_forward(trainer.params, trainer.buffers,
                             trainer.avatar_cfg, trainer.template,
                             trainer.cache, dataset_idx=batch["idx"],
                             smpl_scale=batch["smpl_scale"])
        mask_deg = sh_degree_mask(trainer.active_sh_degree, trainer.device)
        leaves = [out["xyz"], out["scales"], out["rotq"],
                  out["opacity"][:, 0], out["shs"] * mask_deg[None, :, None]]
        tile = trainer.raster_kw["tile"]
        g2d = preprocess(*leaves, cam, sh_degree=3,
                         alive=trainer.buffers.alive > 0.5, tile=tile)
        x0, y0, x1, y1 = tile_rect(g2d, tile, -(-cam.width // tile),
                                   -(-cam.height // tile))
        span = int(max(int((x1 - x0).max()), int((y1 - y0).max()), 1))
    kw = dict(trainer.raster_kw, max_span=span, main_width=span * span,
              pair_cap=None, layout="tiled")
    leaves.append(torch.zeros((leaves[0].shape[0], 2), device=cam.view.device))
    return [x.detach().clone().requires_grad_(True) for x in leaves], kw


def strip_bounds_of(trainer, n_gs: int, balanced: bool):
    from sings_tpu_torch.dist.shard import balanced_strip_bounds

    h = trainer.camera.height
    if not balanced:
        return np.arange(n_gs + 1) * (h // n_gs), h // n_gs
    return balanced_strip_bounds(trainer.masks.sum(dim=(0, 2)).cpu().numpy(),
                                 n_gs, tile=trainer.raster_kw["tile"])


def skip_flips(leaves, alive, tile: int, cam, strip, y0: int, pix):
    """At full-frame pixels pix ((P, 2) x, y) that the strip camera
    `strip` (row offset y0) owns: the number of gaussians whose alpha in
    the two cameras lies on both sides of ALPHA_MIN or within SKIP_REL
    of it, with the plain walk's arithmetic (tile-local coordinates, exp
    in float64), and the largest |colour|."""
    from sings_tpu_torch.ops.rasterizer.common import preprocess
    from sings_tpu_torch.ops.rasterizer.kernels import ALPHA_MIN

    with torch.no_grad():
        g = [preprocess(*[x.detach() for x in leaves[:5]], c, sh_degree=3,
                        alive=alive, tile=tile) for c in (cam, strip)]
        counts = []
        for part in pix.split(64):
            alphas = []
            for gi, off in zip(g, (0, y0)):
                x = part[:, 0].to(torch.float32)
                y = (part[:, 1] - off).to(torch.float32)
                ox, oy = (torch.floor(x / tile) * tile,
                          torch.floor(y / tile) * tile)
                dx = (gi.means2d[None, :, 0] - ox[:, None]) - (x - ox)[:, None]
                dy = (gi.means2d[None, :, 1] - oy[:, None]) - (y - oy)[:, None]
                ca, cb, cc = (gi.conics[None, :, k] for k in range(3))
                power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
                al = torch.clamp_max(gi.opacities[None] * torch.exp(
                    power.double()).float(), 0.99)
                alphas.append(torch.where((power > 0) | ~alive[None],
                                          torch.zeros_like(al), al))
            lo = torch.minimum(*alphas)
            hi = torch.maximum(*alphas)
            counts.append(((lo <= ALPHA_MIN * (1 + SKIP_REL))
                           & (hi >= ALPHA_MIN * (1 - SKIP_REL))).sum(1))
        cmax = float(torch.maximum(g[0].colors.abs().max(),
                                   g[1].colors.abs().max()))
    return torch.cat(counts), cmax


def check_strips(trainer, batch) -> dict:
    """19.1: each strip layout rendered strip by strip through
    camera_strip (and valid_rows for balanced windows) against the full
    frame, forward and backward through the composite kernels: every
    strip's and the full frame's kernels against their plain versions
    (check_fwd, check_bwd), the owned rows with every value over
    STRIP_ATOL explained by an alpha-skip flip (skip_flips), the pairs
    binned, and the gradients of a seeded weighted sum of render and
    transmittance summed over the strips (the probe's y rescaled by H /
    window height, as the sharded step does); the plain composites'
    strips beside them. Returns the raster keywords."""
    from sings_tpu_torch.dist.shard import camera_strip
    from sings_tpu_torch.ops.rasterizer import kernels as K
    from sings_tpu_torch.ops.rasterizer.api import (
        RasterConfig, prepare_composite, rasterize,
    )
    from sings_tpu_torch.ops.rasterizer.common import preprocess
    from sings_tpu_torch.ops.rasterizer.kernels import ALPHA_MIN

    dev = trainer.device
    cam = trainer.camera
    hh, ww = cam.height, cam.width
    leaves, kw = strip_inputs(trainer, batch)
    alive = trainer.buffers.alive > 0.5
    bg = torch.zeros(3, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 191)
    w_img = torch.rand((3, hh, ww), generator=gen, device=dev)
    w_t = torch.rand((hh, ww), generator=gen, device=dev)
    rkw = {k: kw[k] for k in ("tile", "chunk", "max_span", "max_pairs",
                              "main_width", "tail_capacity", "pair_cap")}

    def pairs(c, valid_rows=None):
        with torch.no_grad():
            g2d = preprocess(*[x.detach() for x in leaves[:5]], c,
                             sh_degree=3, alive=alive, tile=kw["tile"])
            cfg = RasterConfig(height=c.height, width=c.width,
                               row_limit=valid_rows is not None, **rkw)
            return int(prepare_composite(g2d, cfg, valid_rows)[1].num_pairs)

    def loss_of(y0, y1):
        def f(color, t):
            return (color[:, : y1 - y0] * w_img[:, y0:y1]).sum() + (
                t[: y1 - y0] * w_t[y0:y1]).sum()
        return f

    def render(c, rows, valid_rows=None):
        out = rasterize(*leaves[:5], c, sh_degree=3, bg=bg, alive=alive,
                        screen_probe=leaves[5], valid_rows=valid_rows, **kw)
        loss = loss_of(*rows)(out["render"], out["transmittance"])
        return out["render"].detach(), torch.autograd.grad(loss, leaves)

    def kernels_vs_plain(name, c, rows, valid_rows=None):
        feats, binning, fwd_out, gout, state, ckw = composite_bwd_inputs(
            trainer, leaves, loss_of(*rows), cam=c, raster_kw=kw,
            valid_rows=valid_rows)
        check_fwd(name, feats, binning, ckw)
        args = (feats, binning.tile_offsets, binning.grad_offsets, fwd_out,
                gout, state)
        cap = binning.pair_slot_capacity
        got = K.composite_bwd_cuda(*args, grad_cap=cap, **ckw)
        torch.cuda.synchronize()
        check_bwd(name, got, K.composite_bwd_plain(*args, grad_cap=cap,
                                                   **ckw), binning)

    def flagged(grads, ref):
        """Per leaf, the values over BWD_RTOL of the leaf's scale."""
        return [(g - w).abs() > BWD_RTOL * float(w.abs().max())
                for g, w in zip(grads, ref)]

    full, g_full = render(cam, (0, hh))
    with plain_composites():
        full_p, g_full_p = render(cam, (0, hh))
    kernels_vs_plain("strips' keywords, full frame", cam, (0, hh))
    n_full = pairs(cam)
    names = ["means3d", "scales", "quats", "opacities", "features",
             "screen_probe"]
    for name, n_gs, balanced in STRIP_LAYOUTS:
        bounds, h_win = strip_bounds_of(trainer, n_gs, balanced)
        strips = [(int(bounds[i]), int(bounds[i + 1]),
                   camera_strip(cam, int(bounds[i]), h_win),
                   int(bounds[i + 1] - bounds[i]) if balanced else None)
                  for i in range(n_gs)]
        scale_y = torch.tensor([1.0, hh / h_win], device=dev)
        reset_all_launches()
        imgs = {}
        for plain in (False, True):
            owned, grads = [], [torch.zeros_like(x) for x in leaves]
            for y0, y1, c, vr in strips:
                if plain:
                    with plain_composites():
                        img, g = render(c, (y0, y1), vr)
                else:
                    img, g = render(c, (y0, y1), vr)
                owned.append(img[:, : y1 - y0])
                g = list(g)
                g[5] = g[5] * scale_y
                grads = [a + b for a, b in zip(grads, g)]
            imgs[plain] = (torch.cat(owned, dim=1), grads)
            if not plain:
                launches = launch_counts()
        n_pairs = sum(pairs(c, vr) for _, _, c, vr in strips)
        for i, (y0, y1, c, vr) in enumerate(strips):
            kernels_vs_plain(f"{name} strip {i}", c, (y0, y1), vr)

        err = (imgs[False][0] - full).abs()
        err_p = (imgs[True][0] - full_p).abs()
        over = err > STRIP_ATOL
        flip_px = over.any(0).nonzero()[:, [1, 0]]            # (P, 2) x, y
        near = torch.zeros(flip_px.shape[0], dtype=torch.long, device=dev)
        cmax = 1.0
        for y0, y1, c, _ in strips:
            sel = (flip_px[:, 1] >= y0) & (flip_px[:, 1] < y1)
            if bool(sel.any()):
                near[sel], cm = skip_flips(leaves, alive, kw["tile"], cam, c,
                                           y0, flip_px[sel])
                cmax = max(cmax, cm)
        px_err = err.amax(0)[flip_px[:, 1], flip_px[:, 0]]
        bound = near * 2 * ALPHA_MIN * (1 + SKIP_REL) * cmax
        unexplained = int(((near == 0) | (px_err > bound)).sum())
        over_p = (err_p > STRIP_ATOL).any(0)
        log(f"[shard strips] {name}: bounds {[int(b) for b in bounds]}, "
            f"window {h_win} rows, max_span {kw['max_span']}; pairs "
            f"{n_pairs} over the strips, {n_full} in the full frame; owned "
            f"rows against the full render max_abs_err {float(err.max()):.3e}"
            f", elements>{STRIP_ATOL:g}: {int(over.sum())}/{err.numel()} at "
            f"{flip_px.shape[0]} pixels, each with "
            f"{near.tolist()} gaussians on the 1/255 skip (unexplained "
            f"{unexplained}); the plain composites' strips against their "
            f"full frame: max_abs_err {float(err_p.max()):.3e}, elements>"
            f"{STRIP_ATOL:g}: {int((err_p > STRIP_ATOL).sum())} at "
            f"{int(over_p.sum())} pixels, {int((over_p & over.any(0)).sum())}"
            f" of them the kernels' too; launches {launches}")
        if (unexplained or int(over.sum()) > STRIP_FLIP_FRACTION
                * err.numel()):
            raise AssertionError(f"{name}: the strips disagree with the "
                                 "full frame")
        if abs(n_pairs - n_full) > 1e-4 * n_full:
            raise AssertionError(f"{name}: {n_pairs} pairs over the strips, "
                                 f"{n_full} in the full frame")
        for k in ("composite_fwd", "composite_bwd", "bin_tiles"):
            if launches[k] != n_gs:
                raise AssertionError(f"{name}: {k} launched {launches[k]} "
                                     f"times for {n_gs} strips")
        grads, grads_p = imgs[False][1], imgs[True][1]
        for leaf, g, w, fk, fp in zip(names, grads, g_full,
                                      flagged(grads, g_full),
                                      flagged(grads_p, g_full_p)):
            if leaf == "quats" and trainer.avatar_cfg.isotropic:
                continue  # zero up to rounding (check_grads)
            err = (g - w).abs()
            scale = float(w.abs().max())
            n_over = int((err > GS2_GRAD_TOL * (scale + w.abs())).sum())
            log(f"[shard strips] {name} d/d{leaf}: max|g| {scale:.3e}, "
                f"max_abs_err {float(err.max()):.3e}, over the tolerance "
                f"{n_over}/{err.numel()}; over {BWD_RTOL:g} of the scale: "
                f"kernels {int(fk.sum())}, plain {int(fp.sum())}, both "
                f"{int((fk & fp).sum())}")
            if n_over or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{name}: d/d{leaf} summed over the "
                                     "strips disagrees with the full "
                                     "frame's")
            if int((fk & ~fp).sum()) > MAX_BWD_FLIP_FRACTION * fk.numel():
                raise AssertionError(f"{name}: d/d{leaf}: the kernels flip "
                                     "values that the plain composites do "
                                     "not")
    return kw


def shard_inputs(trainer, batch, dev, raster_kw):
    """The step inputs phase 19.2 and the ranks of 19.3 share: phase 7's
    state at step TRAIN_STEP0, frame 0, one draw of the step's randoms,
    and the strips' raster keywords (strips and the full frame bin the
    same pairs, so that gs 2 and world 1 compute one objective)."""
    from sings_tpu_torch.losses.photometric import draw_step_randoms

    tr = trainer
    lpips_on = float(tr.cfg.human.loss.lpips_w) > 0
    return {
        "cfg": tr.avatar_cfg, "step_cfg": tr.step_cfg,
        "template": tr.template, "camera": tr.camera,
        "lpips": tr.lpips_params if lpips_on else None,
        "raster": raster_kw, "params": tr.params, "buffers": tr.buffers,
        "cache": tr.cache, "frame": batch, "lap": tr.region_lap,
        "lap_w": (tr.lap_pos_w, tr.lap_color_w),
        "active_sh_degree": tr.active_sh_degree,
        "draws": draw_step_randoms(
            torch.Generator(device=dev).manual_seed(SEED + 190),
            batch["mask"], tr.step_cfg.weights.photometric)}


def sharded_fn(st, mesh, tx):
    from sings_tpu_torch.dist.train_sharded import make_sharded_train_step
    from sings_tpu_torch.losses.regularizers import shard_region_laplacian

    fn = make_sharded_train_step(mesh, st["cfg"], st["step_cfg"],
                                 st["template"], st["camera"], tx,
                                 st["lpips"], st["raster"])
    srl = shard_region_laplacian(st["lap"], mesh.gs).shard(mesh.gs_idx)

    def call(params=None, grads_only=False):
        p = st["params"] if params is None else params
        args = (st["cache"], st["frame"], None, TRAIN_STEP0,
                st["active_sh_degree"], srl, srl, *st["lap_w"])
        if grads_only:
            return fn.grads_fn(p, st["buffers"], *args, draws=st["draws"])
        return fn(p, st["buffers"], tx.init(p), *args, draws=st["draws"])
    return call


def check_world1(st, trainer, smi: str) -> dict:
    """19.2: a process group of one rank over NCCL; the sharded step at
    (1, 1) against phase 7's single-card step (the same optimizer, one
    that keeps the gradients, and the same draws) at tests/test_dist.py's
    (1, 1) tolerances; both timed in turns (CUDA events)."""
    import torch.distributed as dist

    from sings_tpu_torch.dist.shard import make_mesh
    from sings_tpu_torch.train.step import make_train_step
    from sings_tpu_torch.tree import tree_leaves

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh(1)
        backend = dist.get_backend()
        tx = KeepGrads()
        step = sharded_fn(st, mesh, tx)
        single = make_train_step(st["cfg"], st["step_cfg"], st["template"],
                                 st["camera"], tx, st["lpips"], st["raster"])

        def one():
            return single(st["params"], st["buffers"], tx.init(st["params"]),
                          st["cache"], st["frame"], None, TRAIN_STEP0,
                          st["active_sh_degree"], st["lap"], st["lap"],
                          *st["lap_w"], draws=st["draws"])[:4]

        reset_all_launches()
        p, b, o, m = step()
        torch.cuda.synchronize()
        launches = launch_counts()
        p1, b1, o1, m1 = one()
        for k in SHARD_METRICS:
            a, w = float(m[k]), float(m1[k])
            if abs(a - w) > SHARD_METRIC_ATOL + SHARD_METRIC_RTOL * abs(w):
                raise AssertionError(f"world 1: metric {k} {a} against the "
                                     f"single-card step's {w}")
        worst = 0.0
        for i, (g, w) in enumerate(zip(tree_leaves(o["g"]),
                                       tree_leaves(o1["g"]))):
            scale = float(w.abs().max())
            bad = int(((g - w).abs() > SHARD_GRAD_ATOL_REL * scale
                       + SHARD_GRAD_RTOL * w.abs()).sum())
            worst = max(worst, float((g - w).abs().max()) / max(scale,
                                                                1e-30))
            if bad:
                raise AssertionError(f"world 1: gradient leaf {i}, {bad} "
                                     "elements outside tolerance")
        acc_err = float((b.xyz_grad_accum - b1.xyz_grad_accum).abs().max())
        if not bool(torch.allclose(b.xyz_grad_accum, b1.xyz_grad_accum,
                                   rtol=1e-3, atol=1e-9)) or not bool(
                torch.allclose(b.max_radii2d, b1.max_radii2d, atol=1e-4)):
            raise AssertionError(f"world 1: density statistics differ "
                                 f"(xyz_grad_accum max err {acc_err:.3e})")
        turns = [cuda_ms(f, n=2, warm=1) for f in (one, step, step, one)]
        loss, grads = step(grads_only=True)
    finally:
        dist.destroy_process_group()
    res = {"loss": float(loss), "grads": [g.detach() for g in
                                          tree_leaves(grads)],
           "single_ms": (turns[0] + turns[3]) / 2,
           "sharded_ms": (turns[1] + turns[2]) / 2, "launches": launches}
    log(f"[shard world 1] backend {backend}: the sharded step at (1, 1) "
        f"against phase 7's train_step on the same draws: loss "
        f"{float(m['loss']):.6f} / {float(m1['loss']):.6f}, largest "
        f"gradient error / leaf scale {worst:.3e}, xyz_grad_accum max err "
        f"{acc_err:.3e}; launches {launches}; CUDA-event step time single "
        f"{turns[0]:.3f}, sharded {turns[1]:.3f}, {turns[2]:.3f}, single "
        f"{turns[3]:.3f} ms | {smi}")
    for k in SHARD_KERNELS:
        if launches[k] != 1:
            raise AssertionError(f"world 1: {k} launched {launches[k]} "
                                 "times in one step")
    return res


def shard_rank(rank: int, work: str, ports: tuple) -> None:
    """19.3, one rank of two sharing the card over gloo (spawned): the
    sharded step at (dp 1, gs 2) from the parent's saved state (loss and
    gradients, a step twice, the ranks' states compared, launches and
    CUDA-event times, the transport's host time), the case step at gs 2
    on two cases against each case's sharded step, then cli.train.main
    with tpu.mesh.gs=2 --dist-backend gloo from torchrun's environment.
    Writes its results to work/shard_rank{rank}.pt."""
    import torch.distributed as dist

    from sings_tpu_torch.cli import train as cli_train
    from sings_tpu_torch.dist import collectives as C
    from sings_tpu_torch.dist import train_cases as TC
    from sings_tpu_torch.dist.shard import make_mesh
    from sings_tpu_torch.losses.regularizers import shard_region_laplacian
    from sings_tpu_torch.tree import tree_leaves

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{ports[0]}", rank=rank, world_size=2)
    st = torch.load(os.path.join(work, "shard_state.pt"), weights_only=False)
    mesh = make_mesh(2, dp=1)
    tx = KeepGrads()
    step = sharded_fn(st, mesh, tx)
    out = {"mesh": (mesh.dp_idx, mesh.gs_idx), "backend": dist.get_backend()}
    loss, grads = step(grads_only=True)
    out["loss"] = float(loss)
    out["grads"] = [g.detach().cpu() for g in tree_leaves(grads)]
    reset_all_launches()
    p, b, o, m = step()
    torch.cuda.synchronize()
    out["launches"] = launch_counts()
    p2, b2, o2, m2 = step()
    out["rerun_equal"] = all(torch.equal(x, y) for x, y in zip(
        tree_leaves((p, b, o, m)), tree_leaves((p2, b2, o2, m2))))
    out["ranks_equal"] = C.trees_equal((p, b, o, m), mesh.group)
    out["metrics"] = {k: float(v) for k, v in m.items()}

    # the step's time on this rank (CUDA events) and the host time spent
    # in the collectives (each call between two synchronisations)
    spent = [0.0]
    saved = (C._all_gather_cat, C._all_reduce, C._ppermute)

    def timed(f):
        def g(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = f(*a, **k)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t
            return r
        return g

    C._all_gather_cat, C._all_reduce, C._ppermute = (timed(f) for f in saved)
    try:
        step()
        spent[0] = 0.0
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        for _ in range(3):
            step()
        stop.record()
        torch.cuda.synchronize()
        out["wall_ms"] = (time.perf_counter() - t) * 1e3 / 3
        out["step_ms"] = start.elapsed_time(stop) / 3
        out["transport_ms"] = spent[0] * 1e3 / 3
    finally:
        C._all_gather_cat, C._all_reduce, C._ppermute = saved

    # the case step at gs 2: phase 7's state and its perturbed copy
    params = [st["params"], perturbed(st["params"])]
    srl = shard_region_laplacian(st["lap"], 2).shard(mesh.gs_idx)
    laps = TC.stack_cases([srl, srl])
    cam = st["camera"]
    case_step = TC.make_case_train_step(
        st["cfg"], st["step_cfg"], st["template"], cam.height, cam.width, tx,
        st["lpips"], st["raster"], gs=2, mesh=mesh)
    frame = st["frame"]
    batch = {k: (torch.stack([v, v]) if k != "idx" else [v, v])
             for k, v in frame.items()}
    reset_all_launches()
    cp, cb, co, cm = case_step(
        TC.stack_cases(params), TC.stack_cases([st["buffers"]] * 2),
        TC.stack_cases([tx.init(x) for x in params]),
        TC.stack_cases([st["cache"]] * 2),
        TC.stack_cases([TC.camera_arrays(cam)] * 2), batch, [None, None],
        TRAIN_STEP0, st["active_sh_degree"], laps, laps, *st["lap_w"],
        draws=[st["draws"]] * 2)
    out["case_launches"] = launch_counts()
    out["case_equal"] = []
    for c in range(2):
        want = step(params=params[c])
        got = [x[c] for x in tree_leaves((cp, cb, co))] + [
            cm[k][c] for k in sorted(want[3])]
        out["case_equal"].append(all(torch.equal(g, w) for g, w in zip(
            got, tree_leaves(want[:3]) + [want[3][k]
                                          for k in sorted(want[3])])))
    out["case_loss"] = [float(x) for x in cm["loss"]]
    del st, step, case_step, cp, cb, co, p, b, o, p2, b2, o2
    torch.cuda.empty_cache()

    # the training entry point under torchrun's environment, its own gloo
    # group
    dist.destroy_process_group()
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="localhost", MASTER_PORT=str(ports[1]))
    kit = torch.load(os.path.join(work, "shard_kit.pt"), weights_only=False)
    with open(os.path.join(work, "shard_cli.json")) as fh:
        opts = json.load(fh)
    rec = {"losses": [], "counts": [], "images": 0}
    from sings_tpu_torch.train import trainer as T

    orig_init = T.Trainer._init_mesh
    orig_apply = T.Trainer._apply_density_result

    def init_mesh(self, capacity):
        orig_init(self, capacity)
        f = self.train_step_sharded

        def recorded(*a, **k):
            r = f(*a, **k)
            rec["losses"].append(float(r[3]["loss"]))
            return r
        self.train_step_sharded = recorded
        rec["trainer"] = self

    def apply(self, res):
        before = int(self.buffers.alive.sum())
        orig_apply(self, res)
        rec["counts"].append((before, int(self.buffers.alive.sum())))

    def images(path, img):
        rec["images"] += 1

    T.Trainer._init_mesh, T.Trainer._apply_density_result = init_mesh, apply
    reset_all_launches()
    t = time.time()
    try:
        result = cli_train.main(["--device", "cuda", "--dist-backend", "gloo",
                                 *opts], kit=kit, image_writer=images)
    finally:
        T.Trainer._init_mesh, T.Trainer._apply_density_result = (
            orig_init, orig_apply)
    tr = rec.pop("trainer")
    rec.update(wall=time.time() - t, result=result, step=tr.step,
               launches=launch_counts(), alive=int(tr.buffers.alive.sum()),
               state=[x.detach().cpu() for x in tree_leaves(
                   (tr.params, tr.buffers, tr.opt_state))],
               ckpts=sorted(os.listdir(tr.logdir_ckpt)),
               group_left=not dist.is_initialized())
    out["cli"] = rec
    torch.save(out, os.path.join(work, f"shard_rank{rank}.pt"))


def run_sharded(work: str, dev, smi: str, trainer, batches) -> None:
    """Phase 19: 19.1 strips through camera_strip and rasterize(valid_rows=)
    against the full frame; 19.2 the sharded step at world size 1 over
    NCCL against the single-card step; 19.3 two ranks on the card over
    gloo (spawned): the sharded step at gs 2 against 19.2, the case step
    at gs 2, and cli.train.main with tpu.mesh.gs=2."""
    import torch.multiprocessing as mp

    from sings_tpu_torch.tree import tree_leaves

    t_phase = time.time()
    batch = {name: v[0] for name, v in batches.items()}
    kw = check_strips(trainer, batch)
    t_strips = time.time() - t_phase
    st = shard_inputs(trainer, batch, dev, kw)
    w1 = check_world1(st, trainer, smi)

    # ---- 19.3 two ranks on the one card over gloo
    t1 = time.time()
    torch.save(st, os.path.join(work, "shard_state.pt"))
    kit = make_train_kit()._replace(images=trainer.images.cpu().numpy(),
                                    masks=trainer.masks.cpu().numpy())
    torch.save(kit, os.path.join(work, "shard_kit.pt"))
    opts = [x for x in train_dotlist(work, SHARD_CLI_DOTLIST)]
    with open(os.path.join(work, "shard_cli.json"), "w") as fh:
        json.dump(opts, fh)
    del st
    torch.cuda.empty_cache()
    mp.start_processes(shard_rank, args=(work, (free_port(), free_port())),
                       nprocs=2, start_method="spawn")
    ranks = [torch.load(os.path.join(work, f"shard_rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    t_ranks = time.time() - t1
    a, b = ranks
    log(f"[shard gs 2] ranks {[r['mesh'] for r in ranks]} over "
        f"{a['backend']}: loss {a['loss']:.6f} (world 1 {w1['loss']:.6f}), "
        f"a rerun bit for bit {[r['rerun_equal'] for r in ranks]}, ranks' "
        f"states equal {a['ranks_equal']}; launches per rank "
        f"{[r['launches'] for r in ranks]}; CUDA-event step time per rank "
        f"{[round(r['step_ms'], 3) for r in ranks]} ms (host wall "
        f"{[round(r['wall_ms'], 3) for r in ranks]} ms), in the collectives"
        f" {[round(r['transport_ms'], 3) for r in ranks]} ms; world 1: "
        f"sharded {w1['sharded_ms']:.3f}, single-card {w1['single_ms']:.3f}"
        f" ms | {smi}")
    if [r["mesh"] for r in ranks] != [(0, 0), (0, 1)] or a["backend"] != \
            "gloo":
        raise AssertionError("19.3: the two ranks' mesh is not (1, 2) gloo")
    if not abs(a["loss"] - w1["loss"]) <= GS2_LOSS_RTOL * abs(w1["loss"]):
        raise AssertionError(f"gs 2 loss {a['loss']} against world 1's "
                             f"{w1['loss']}")
    for i, (g, w) in enumerate(zip(a["grads"], w1["grads"])):
        w = w.cpu()
        tol = GS2_GRAD_TOL * float(w.abs().max()) + GS2_GRAD_TOL * w.abs()
        if bool(((g - w).abs() > tol).any()):
            raise AssertionError(f"gs 2 gradient leaf {i} against world 1")
    for g, h in zip(a["grads"], b["grads"]):
        if not torch.equal(g, h):
            raise AssertionError("the two ranks' reduced gradients differ")
    if not (all(r["rerun_equal"] for r in ranks) and a["ranks_equal"]
            and b["ranks_equal"]):
        raise AssertionError("gs 2: a rerun or the ranks' states differ")
    for r in ranks:
        for k in SHARD_KERNELS:
            if r["launches"][k] != 1:
                raise AssertionError(f"gs 2: {k} launched {r['launches'][k]}"
                                     " times in one step on one rank")
            if r["case_launches"][k] != 2:
                raise AssertionError(f"gs 2 case step: {k} launched "
                                     f"{r['case_launches'][k]} times")
        if r["case_equal"] != [True, True]:
            raise AssertionError("the case step at gs 2 differs from the "
                                 "cases' sharded steps")
    log(f"[shard gs 2] case step on two cases: losses {a['case_loss']}, bit "
        f"for bit each case's sharded step on both ranks; launches per rank "
        f"{[r['case_launches'] for r in ranks]}")
    if a["case_loss"][0] == a["case_loss"][1] or not all(
            math.isfinite(x) for x in a["case_loss"]):
        raise AssertionError("case step at gs 2: losses")
    ca, cb = a["cli"], b["cli"]
    log(f"[shard cli] cli.train.main with tpu.mesh.gs=2 --dist-backend gloo:"
        f" losses {[round(x, 5) for x in ca['losses']]}, live counts around "
        f"the density events {ca['counts']}, checkpoints {ca['ckpts']}, "
        f"images written by rank 0 / 1: {ca['images']} / {cb['images']}, "
        f"launches per rank {[ca['launches'], cb['launches']]}, psnr "
        f"{ca['result']['psnr']:.3f}; {ca['wall']:.1f}s")
    if (len(ca["losses"]) != 4 or not all(math.isfinite(x)
                                          for x in ca["losses"])
            or ca["losses"] != cb["losses"] or ca["step"] != 4):
        raise AssertionError("cli gs 2: the steps' losses")
    if len(ca["counts"]) != 1 or not ca["counts"][0][1] > ca["counts"][0][0]:
        raise AssertionError(f"cli gs 2: density events {ca['counts']}")
    if ca["counts"] != cb["counts"] or not all(
            torch.equal(x, y) for x, y in zip(ca["state"], cb["state"])):
        raise AssertionError("cli gs 2: the ranks' final states differ")
    if ca["ckpts"] != ["human_000003.npz", "human_final.npz"] or cb[
            "images"] or not ca["images"] or not ca["group_left"]:
        raise AssertionError("cli gs 2: rank 0 alone writes; the CLI ends "
                             "its process group")
    for k in SHARD_KERNELS:
        if ca["launches"][k] < 4 or ca["launches"][k] != cb["launches"][k] \
                and k not in ("composite_fwd", "bin_tiles"):
            raise AssertionError(f"cli gs 2: {k} launches "
                                 f"{ca['launches'][k]} / {cb['launches'][k]}")
    SHARD_LAUNCHES.update({k: a["launches"][k] for k in SHARD_KERNELS})
    log(f"[shard] stage walls: strips {t_strips:.1f}s, world 1 "
        f"{t1 - t_phase - t_strips:.1f}s, two ranks {t_ranks:.1f}s; phase 19 "
        f"{time.time() - t_phase:.1f}s")


# ---------------------------------------------------------------------------
# the training options (phase 17)

# the device time of an 8-step chunk (ms) by phase: phase 9's under
# --profile (profile_train), phase 17's from its trace
CHUNK_DEVICE_MS = {}
# the JAX package's DEFAULTS (sings_tpu/config/defaults.py) where the
# recipe differs: the random-feature LPIPS term, and the opt-in windowed
# statistic and cotangent laplacian
OPTIONS_DOTLIST = ["tpu.random_lpips_factor=0.05", "tpu.knn_backend=window",
                   "human.loss.laplacian.type=cotangent",
                   "exp_name=smoke_options"]
# card against CPU: the LPIPS term (cuDNN's and the CPU's float32
# convolutions sum in other orders) at rtol 1e-4. Its gradient is
# ill-conditioned in float32 at the step's 128^2 patches (13 convolutions,
# unit-normalised features, max-pool windows over clipped flat areas):
# two CPU convolution algorithms (oneDNN's and the native one) give
# input gradients 1.8% of the largest element apart on such patches. So
# d/dpatches is held against the CPU's float64 gradient of the same
# function: the card's relative L2 error within LPIPS_GRAD_FACTOR times
# the CPU float32 gradient's own. The cotangent laplacian (card against
# CPU) at the JAX package's tests/test_banded_laplacian.py tolerances:
# loss rtol 1e-5, gradient rtol 1e-4 and atol 1e-6. The atol
# is absolute there and here: L x cancels at the inputs' scale (metres,
# |x| ~ 1), so where the laplacian gradient is ~1e-3 its rounding is not
# a share of that (a CPU rehearsal found one of 2,304 anchor gradients
# 3.5e-9 off, above 1e-6 of the largest, 1.0e-3)
LPIPS_RTOL, LPIPS_GRAD_FACTOR = 1e-4, 4.0
LAP_RTOL, LAP_GRAD_RTOL, LAP_GRAD_ATOL = 1e-5, 1e-4, 1e-6
# knn_window_stat, card against CPU: the same windows (the codes are
# exact); a squared distance cancels |a|^2 + |b|^2 - 2 a.b in float32,
# eps |p|^2 ~ 1.2e-7 m^2 at the avatar's metre scale, ~3e-5 m at a 2 mm
# neighbour, so within 1e-3 of the largest statistic
KNN_ATOL_REL = 1e-3
MULTI_OFFSET = (0.35, 0.0, 0.0)


def close_rel(name: str, got, want, rtol: float, atol_rel: float = 0.0,
              atol: float = 0.0) -> float:
    """max |got - want| / max |want|; raises where |got - want| exceeds
    atol + atol_rel max |want| + rtol |want|."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    bad = (got - want).abs() > atol + atol_rel * scale + rtol * want.abs()
    log(f"[options] {name}: max abs err {err:.3e} of max {scale:.3e}, "
        f"{int(bad.sum())} of {want.numel()} beyond rtol {rtol:g}, atol "
        f"{atol:g} + {atol_rel:g} of the max")
    if bad.any() or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: card and CPU disagree")
    return err / max(scale, 1e-30)


def lap_terms(out, trainer, dev):
    """The training step's fused laplacian terms at out's values, as new
    leaves on dev (anchor positions, hands, SH dc colour)."""
    leaves = [out[k].detach().to(dev).requires_grad_(True)
              for k in ("xyz_anchor_canon", "xyz_canon")]
    leaves.append(out["shs"][:, 0].detach().to(dev).requires_grad_(True))
    pw = trainer.lap_pos_w.to(dev)
    terms = [(leaves[0], pw, None), (leaves[1], torch.ones_like(pw), [6, 7]),
             (leaves[2], trainer.lap_color_w.to(dev), None)]
    return leaves, terms


def lap_value_grads(lap, out, trainer, dev):
    leaves, terms = lap_terms(out, trainer, dev)
    total = sum(lap.loss_fused(terms))
    return total, torch.autograd.grad(total, leaves)


def to_cpu(tup):
    return type(tup)(*[x.cpu() for x in tup])


def run_options(work: str, dev, smi: str, profile_dir: str | None) -> None:
    from sings_tpu_torch.config.core import load_config
    from sings_tpu_torch.config.defaults import DEFAULTS
    from sings_tpu_torch.losses import regularizers as R
    from sings_tpu_torch.losses.lpips import LPIPSParams, lpips_distance
    from sings_tpu_torch.losses.photometric import (
        crop_patches, draw_step_randoms,
    )
    from sings_tpu_torch.model.avatar import avatar_forward, get_canon_xyz
    from sings_tpu_torch.ops import grid_grad as GG
    from sings_tpu_torch.ops import profiling
    from sings_tpu_torch.ops.clip import clip
    from sings_tpu_torch.ops.knn import knn_window_stat
    from sings_tpu_torch.ops.rasterizer import kernels as K
    from sings_tpu_torch.ops.rasterizer.api import rasterize
    from sings_tpu_torch.ops.rasterizer.multi import rasterize_multi
    from sings_tpu_torch.train.trainer import Trainer

    # ---- 17 setup: phase 7's, with the options
    t0 = time.time()
    cfg = load_config(DEFAULTS, None, train_dotlist(work, OPTIONS_DOTLIST))
    tr = Trainer(cfg, mode="train", device=dev, kit=make_train_kit(),
                 image_writer=lambda path, img: None)
    seed_train_targets(tr)
    batches = train_batches(tr)
    k = tr.inner_steps
    w = tr.step_cfg.weights.photometric
    log(f"[options setup] knn {tr.step_cfg.knn_backend}, laplacian "
        f"{type(tr.region_lap).__name__} rows "
        f"{tuple(tr.region_lap.neighbors.shape)}, lpips weight {w.lpips}, "
        f"patches {w.num_patches} x {w.patch_size}^2 "
        f"({time.time() - t0:.1f}s)")
    if (tr.step_cfg.knn_backend != "window" or w.lpips != 0.05
            or not isinstance(tr.region_lap, R.CotRegionLaplacian)):
        raise AssertionError("phase 17 options not in effect")

    # ---- 17.1 training: 16 steps, launches from 0
    state = (tr.params, tr.buffers, tr.opt_state)
    K.reset_launches()
    GG.reset_launches()
    torch.cuda.synchronize()
    times, all_losses, lp = [], [], []
    for c in range(2):
        t1 = time.perf_counter()
        p, b, o, losses, skipped, metrics = tr.train_scan(
            *state, tr.cache, batches, tr.step_generator,
            TRAIN_STEP0 + c * k, tr.active_sh_degree, tr.region_lap,
            tr.region_lap, tr.lap_pos_w, tr.lap_color_w)
        all_losses += losses.cpu().tolist()
        times.append(time.perf_counter() - t1)
        lp += metrics["photo_lpips_patch"].cpu().tolist()
        if any(x != 0.0 for x in skipped.cpu().tolist()):
            raise AssertionError("phase 17: skipped steps")
        state = (p, b, o)
    launches = dict(K.LAUNCHES, triplane_bwd=GG.LAUNCHES["triplane_bwd"])
    log(f"[options train] 16 steps from step {TRAIN_STEP0}: chunk wall "
        f"{times[0]:.3f}s, {times[1]:.3f}s (host clock, steps/s "
        f"{k / times[0]:.3f}, {k / times[1]:.3f}), launches {launches}")
    log(f"[options train] losses {[round(x, 5) for x in all_losses]}, "
        f"lpips_patch {[round(x, 6) for x in lp]}")
    if not all(math.isfinite(x) for x in all_losses) or not all(
            math.isfinite(x) and x > 0 for x in lp):
        raise AssertionError("phase 17: a loss is not finite or an LPIPS "
                             "term not positive")
    for name in ("composite_fwd", "composite_bwd", "triplane_bwd"):
        if launches[name] != 2 * k:
            raise AssertionError(f"phase 17: {name} launched "
                                 f"{launches[name]} times in {2 * k} steps")
    del state, p, b, o

    # ---- 17.2 the same functions on the card and on the CPU
    cpu = torch.device("cpu")
    batch0 = {name: v[0] for name, v in batches.items()}
    draws = draw_step_randoms(torch.Generator(device=dev).manual_seed(SEED),
                              batch0["mask"], w)
    with torch.no_grad():
        out = avatar_forward(tr.params, tr.buffers, tr.avatar_cfg,
                             tr.template, tr.cache, dataset_idx=0)
        render = rasterize(out["xyz"], out["scales"], out["rotq"],
                           out["opacity"][:, 0], out["shs"], tr.camera,
                           sh_degree=3, bg=draws["bg"],
                           alive=tr.buffers.alive > 0.5,
                           **tr.raster_kw)["render"]
        m = batch0["mask"][None]
        gt = batch0["rgb"] * m + draws["bg"][:, None, None] * (1 - m)
        noise = draws["noise"]
        pred_p = crop_patches(render * m + noise * (1 - m), draws["ys"],
                              draws["xs"], w.patch_size)
        gt_p = crop_patches(gt * m + noise * (1 - m), draws["ys"],
                            draws["xs"], w.patch_size)
    def lpips_on(dtype, where):
        return LPIPSParams(
            convs=tuple((a.to(where, dtype), b_.to(where, dtype))
                        for a, b_ in tr.lpips_params.convs),
            lins=tuple(x.to(where, dtype) for x in tr.lpips_params.lins),
            pretrained=tr.lpips_params.pretrained)

    def lpips_term(params, pp, gp):
        pp = pp.detach().requires_grad_(True)
        term = w.lpips * lpips_distance(params, clip(pp, hi=1.0), gp).mean()
        return term, torch.autograd.grad(term, pp)[0]

    term_d, g_d = lpips_term(tr.lpips_params, pred_p, gt_p)
    term_c, g_c = lpips_term(lpips_on(torch.float32, cpu), pred_p.cpu(),
                             gt_p.cpu())
    _, g_64 = lpips_term(lpips_on(torch.float64, cpu), pred_p.cpu().double(),
                         gt_p.cpu().double())
    log(f"[options] LPIPS term card {float(term_d.detach()):.8f} CPU "
        f"{float(term_c.detach()):.8f}")
    close_rel("LPIPS term", term_d.reshape(1), term_c.reshape(1),
              LPIPS_RTOL)
    l2 = {name: float((g.double().cpu() - g_64).norm() / g_64.norm())
          for name, g in (("card", g_d), ("cpu float32", g_c))}
    mx = {name: float((g.double().cpu() - g_64).abs().max()
                      / g_64.abs().max())
          for name, g in (("card", g_d), ("cpu float32", g_c))}
    log(f"[options] LPIPS d/dpatches against the CPU's float64 gradient: "
        f"relative L2 error {l2}, largest element error / largest element "
        f"{mx}")
    if not (bool(torch.isfinite(g_d).all())
            and l2["card"] <= LPIPS_GRAD_FACTOR * l2["cpu float32"] + 1e-7):
        raise AssertionError("LPIPS d/dpatches: the card is further from "
                             "the float64 gradient than float32 allows")
    lpips_ms = cuda_ms(lambda: lpips_term(tr.lpips_params, pred_p, gt_p),
                       n=10)
    # the cotangent laplacian at the step's terms
    cot_cpu = to_cpu(tr.region_lap)
    ld, gd = lap_value_grads(tr.region_lap, out, tr, dev)
    lc, gc = lap_value_grads(cot_cpu, out, tr, cpu)
    close_rel("cotangent laplacian loss", ld.reshape(1), lc.reshape(1),
              LAP_RTOL)
    for name, a, b_ in zip(("anchors", "hands", "colour"), gd, gc):
        close_rel(f"cotangent laplacian d/d{name}", a, b_, LAP_GRAD_RTOL,
                  atol=LAP_GRAD_ATOL)
    # the windowed statistic on the canonical cloud
    with torch.no_grad():
        xyz = get_canon_xyz(tr.params, tr.buffers, tr.avatar_cfg)
    alive = tr.buffers.alive > 0
    win_d = knn_window_stat(xyz, 9, valid=alive)
    win_c = knn_window_stat(xyz.cpu(), 9, valid=alive.cpu())
    knn_err = close_rel("knn_window_stat", win_d, win_c, 0.0, KNN_ATOL_REL)
    exact = R.edge_stat(xyz, tr.buffers.alive)
    rel = ((win_d - exact) / torch.clamp_min(exact, 1e-9))[alive]
    win_ms = cuda_ms(lambda: knn_window_stat(xyz, 9, valid=alive), n=10)
    exact_ms = cuda_ms(lambda: R.edge_stat(xyz, tr.buffers.alive), n=5)
    log(f"[options] knn_window_stat against the exact statistic on "
        f"{int(alive.sum())} live points: mean |rel| "
        f"{float(rel.abs().mean()):.5f}, min rel {float(rel.min()):.3e}, "
        f"max rel {float(rel.max()):.5f}; {win_ms:.4f} ms against the "
        f"exact one's {exact_ms:.4f} ms | {smi}")
    if not float(rel.min()) > -1e-5:
        raise AssertionError("knn_window_stat underestimates the exact "
                             "statistic")

    # ---- 17.3 the gather and cotangent laplacians' builds and times
    cot = tr.region_lap
    builds = {}
    for kind in ("cotangent", "gather"):
        if kind == "gather":
            # the standard laplacian at its own table width
            tr.cfg.human.loss.laplacian.type = "standard"
            tr._lap_pad = None
        t1 = time.perf_counter()
        tr._rebuild_laplacians()
        builds[kind] = (time.perf_counter() - t1, tr.region_lap)
    gather = builds["gather"][1]
    lap_ms = {kind: cuda_ms(lambda lap=lap: lap_value_grads(
        lap, out, tr, dev), n=10) for kind, lap in (
            ("gather", gather), ("cotangent", cot))}
    log(f"[options] laplacian loss + backward (3 fused terms, CUDA events)"
        f" {', '.join(f'{k_} {v:.4f} ms' for k_, v in lap_ms.items())}; "
        f"host builds {', '.join(f'{k_} {v[0]:.3f} s' for k_, v in builds.items())}"
        f"; cotangent rows {tuple(cot.neighbors.shape)}, gather table "
        f"{tuple(gather.neighbors.shape)}; LPIPS term forward + backward "
        f"{lpips_ms:.4f} ms a step | {smi}")
    del builds, gather, cot_cpu

    # ---- 17.4 rasterize_multi: two avatars, one launch
    alive_b = tr.buffers.alive > 0.5
    shift = torch.tensor(MULTI_OFFSET, device=dev)
    with torch.no_grad():
        K.reset_launches()
        multi = rasterize_multi([out, out], tr.camera,
                                translations=[torch.zeros(3, device=dev),
                                              shift],
                                bg=draws["bg"], sh_degree=3,
                                alives=[alive_b, alive_b], **tr.raster_kw)
        n_multi = K.LAUNCHES["composite_fwd"]
        single = rasterize(
            torch.cat([out["xyz"], out["xyz"] + shift]),
            torch.cat([out["scales"]] * 2), torch.cat([out["rotq"]] * 2),
            torch.cat([out["opacity"][:, 0]] * 2),
            torch.cat([out["shs"]] * 2), tr.camera, sh_degree=3,
            bg=draws["bg"], alive=torch.cat([alive_b] * 2), **tr.raster_kw)
    same = torch.equal(multi["render"], single["render"])
    cover = float((multi["transmittance"] < 0.5).float().mean())
    log(f"[options] rasterize_multi of 2 x {int(alive_b.sum())} gaussians "
        f"at {tr.camera.height}x{tr.camera.width}: {n_multi} composite_fwd "
        f"launch, bit for bit one rasterize of the concatenation: {same}, "
        f"covered {cover:.3f}")
    if n_multi != 1 or not same or not cover > 0.01:
        raise AssertionError("rasterize_multi")
    del multi, single, out

    # ---- 17.5 one chunk under ops/profiling.trace
    names = ("options_chunk", "options_readback", "step.draws",
             "step.decode", "step.rasterize", "step.losses", "step.backward",
             "step.update", "raster.bin", "raster.composite_bwd",
             "triplane.bwd")
    trace_dir = os.path.join(work, "options_trace")
    with profiling.trace(trace_dir):
        for _ in range(PREAMBLE):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with profiling.span(names[0]):
            res = tr.train_scan(tr.params, tr.buffers, tr.opt_state,
                                tr.cache, batches, tr.step_generator,
                                TRAIN_STEP0, tr.active_sh_degree,
                                tr.region_lap, tr.region_lap, tr.lap_pos_w,
                                tr.lap_color_w)
        with profiling.span(names[1]):
            res[3].cpu()
    with open(os.path.join(trace_dir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    seen = {e.get("name") for e in events}
    kernel_ms = sum(e.get("dur", 0) for e in events
                    if e.get("cat") == "kernel"
                    and SPIN not in e.get("name", "")) / 1e3
    CHUNK_DEVICE_MS["phase 17 (knn window, cotangent, LPIPS)"] = kernel_ms
    log(f"[options trace] ranges {[n for n in names if n in seen]} in the "
        f"trace; the chunk's kernels {kernel_ms:.3f} ms of device time; "
        f"chunks' device time {CHUNK_DEVICE_MS} | {smi}")
    if any(n not in seen for n in names) or not kernel_ms > 0:
        raise AssertionError("profiling.trace: a range or the kernels are "
                             "missing from the trace")


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
                     f"{composite_ms(comp) / n:10.4f} "
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
