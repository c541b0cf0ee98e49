#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (sings_tpu_torch) on one card.

    python3 chip_smoke.py [--profile DIR]

Builds the hand-written CUDA kernels from sings_tpu_torch/csrc with nvcc
(one process per source, all started together), then drives the port's
two main paths at the full width of the configs/human_complex.yaml
avatar (synthetic SMPL-H template at synthetic_res 2.0, two
subdivisions: 102,182 gaussians in 127,744 slots; nested 64^3 triplane,
multires [1, 2, 4]; 512x512; pair_cap 4), with weights made from seed 0:
the animation render, Trainer(cfg, mode="anim").animate_chunk, and the
training step, Trainer(cfg, mode="train").train_scan, as bench.py's
recipe benchmark drives it (8 steps a chunk). Phases:

  1 device      torch.cuda must be available; prints the card and limit
  2 build       nvcc for sm_90a, timed
  3 setup       config from DEFAULTS + HUMAN_COMPLEX_DOTLIST, an
                in-memory 4-frame kit, a seeded 32-frame custom motion,
                a checkpoint written from the port's init_avatar,
                Trainer(mode="anim")
  4 kernels     composite_fwd against its plain version on frame 0's
                real inputs and on edge scenes
  5 main        animate_chunk(16 frames a chunk, 32 frames); counts
                composite_fwd launches from 0
  6 timing      CUDA-event times of composite_fwd and its plain version,
                and the least time the card could take for the same work
  7 train setup config + HUMAN_COMPLEX_TRAIN_DOTLIST (the recipe's loss,
                LR and schedule keys) + what bench.py sets, an in-memory
                9-frame 512x512 kit (8 training frames) whose masks and
                images come from the avatar's own seeded render,
                Trainer(mode="train") with a 10-step decoder pre-fit
  8 kernels     composite_bwd against its plain version on the training
                step's real frame-0 render and the loss's own cotangents,
                and on edge scenes; then the gradients of rasterize with
                respect to means, scales, quats, opacities, SH features
                and screen_probe through the kernels against the same
                through the plain versions
  9 train       2 calls of train_scan (16 steps from step 2000); counts
                composite_fwd and composite_bwd launches from 0
 10 timing      composite_bwd's CUDA-event time, its plain version's,
                and its bound
Every failure raises; the script exits 0 only when every phase passed,
and then prints the kernels line and, last, the device line.
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
    "human.density_control.hybrid.densify_until_iter=10000",
    "human.density_control.hybrid.prune_until_iter=12000",
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
]
# what bench.py's recipe benchmark sets, with a short pre-fit instead of
# its 1 step, and the recipe's 8-step chunks stated
BENCH_TRAIN_DOTLIST = ["train.init_steps=10", "tpu.auto_fit_synthetic=False",
                       "tpu.inner_steps=8"]
TRAIN_STEP0 = 2000  # both warmup gates open, laplacian ramp at 1

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

    from sings_tpu_torch.ops import cuda_build

    # ---- 2 build
    t0 = time.time()
    cuda_build.build(["composite_fwd", "composite_bwd"])
    log(f"[build] composite_fwd, composite_bwd built in "
        f"{time.time() - t0:.1f}s (one nvcc each, started together)")
    for name, info in cuda_build.BUILD_LOG.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

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
        got = K.composite_fwd_cuda(feats, binning.tile_offsets, **ckw)
        want, walked = K.composite_fwd_plain(feats, binning.tile_offsets,
                                             return_walked=True, **ckw)
        torch.cuda.synchronize()
        max_err = check_close("full width frame 0", got, want)
        # edge scenes
        ekw = dict(kw, max_span=8, pair_cap=None)
        g, cam = random_scene(400, 380, 500, 1, dev)
        f_, b_, c_ = composite_inputs(g, cam, ekw)
        max_err = max(max_err, check_close(
            "500x380 padding tiles", K.composite_fwd_cuda(
                f_, b_.tile_offsets, **c_),
            K.composite_fwd_plain(f_, b_.tile_offsets, **c_)))
        n = 300
        stack = [torch.tensor([[0.0, 0.0, 3.0]]).repeat(n, 1),
                 torch.full((n, 3), 0.2), torch.tensor([[1.0, 0, 0, 0]]
                                                       ).repeat(n, 1),
                 torch.full((n,), 0.95), torch.rand(n, 3, generator=(
                     torch.Generator().manual_seed(2)))]
        stack[0][:, 2] += torch.linspace(0, 0.5, n)
        stack = [t.to(dev) for t in stack]
        cam = random_scene(1, 64, 64, 0, dev)[1]
        f_, b_, c_ = composite_inputs(stack, cam, ekw)
        out_s = K.composite_fwd_cuda(f_, b_.tile_offsets, **c_)
        max_err = max(max_err, check_close(
            "saturating stack", out_s,
            K.composite_fwd_plain(f_, b_.tile_offsets, **c_)))
        if float(out_s[:, 3].min()) >= 1e-3:
            raise AssertionError("saturating stack did not saturate")
        g, cam = random_scene(200, 64, 96, 3, dev, z=(-4.0, -1.0))
        g[0][:5] = torch.tensor([[0.3, 0.2, 3.0]], device=dev)  # one corner
        f_, b_, c_ = composite_inputs(g, cam, ekw)
        out_e = K.composite_fwd_cuda(f_, b_.tile_offsets, **c_)
        max_err = max(max_err, check_close(
            "empty tiles", out_e,
            K.composite_fwd_plain(f_, b_.tile_offsets, **c_)))
        if float(out_e[:, 3].amin(dim=1).max()) != 1.0:
            raise AssertionError("empty tiles must keep T == 1")

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
    d0 = np.abs(frames[0].astype(int) - plain_frame0.numpy().astype(int))
    log(f"[main] frame 0 vs plain-version render: max {d0.max()} levels, "
        f"{int((d0 > 1).sum())} values off by more than 1")
    if (d0 > 1).mean() > MAX_FLIP_FRACTION * 4:
        raise AssertionError("main-path frame 0 disagrees with the plain "
                             "version's render")

    # ---- 6 timing at frame 0's shapes
    offs = binning.tile_offsets
    ms = cuda_ms(lambda: K.composite_fwd_cuda(feats, offs, **ckw))
    plain_ms = cuda_ms(lambda: K.composite_fwd_plain(feats, offs, **ckw))
    n_tiles = ckw["n_tiles_x"] * ckw["n_tiles_y"]
    npx = ckw["tile"] ** 2
    ops = OPS_PER_PAIR_PIXEL * walked * npx
    nbytes = 4 * (9 * walked + (n_tiles + 1) + n_tiles * 8 * npx)
    ops_ms = ops / H100_FP32_FLOPS * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f"[timing] composite_fwd {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"walked pairs {walked} of {n_pairs}, bound {bound_ms:.4f} ms "
        f"(ops {ops_ms:.4f} ms, bytes {bytes_ms:.4f} ms) | {smi}")
    kernels = [{
        "name": "composite_fwd", "route": "cuda",
        "source": "sings_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "sings_tpu/ops/rasterizer/pallas_kernels.py:873",
        "launches": launches["composite_fwd"], "max_abs_err": max_err,
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]
    if profile_dir:
        profile(trainer, gs_attrs, frame0, kw, profile_dir)
    del trainer, gs_attrs, posed, frame0, feats, binning, want, got
    torch.cuda.empty_cache()
    kernels.append(run_train(work, dev, smi, profile_dir))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


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
    out = K.composite_fwd_cuda(feats, binning.tile_offsets, **ckw)

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
                feats, binning.tile_offsets, **ckw), 1),
            ("relayout + bg blend + uint8", finish, 1),
            ("whole rasterize() + uint8", lambda: quantize(rasterize(
                *frame0[:5], cam, sh_degree=3, bg=trainer.bg_color,
                alive=frame0[5], **trainer.raster_kw)["render"]), 1),
        ]
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]

        def kernel_ms(fn):
            """Device time of the kernels one call launches (profiler)."""
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                fn()
                torch.cuda.synchronize()
            return sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       ) / 1e3, prof

        lines = [f"{'stage':45s} {'events ms':>10s} {'kernels ms':>10s}"
                 "  per frame (events: 10 back-to-back calls, host issue "
                 "included; kernels: device time, profiler)"]
        for name, fn, per in stages:
            t = cuda_ms(fn, n=10) / per
            d = kernel_ms(fn)[0] / per
            lines.append(f"{name:45s} {t:10.4f} {d:10.4f}")

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
        busy_ms, prof = kernel_ms(chunk)
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
    binning and forward output of the render, and the loss's own
    cotangents of colour and transmittance, re-tiled."""
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
    fwd_out = K.composite_fwd_cuda(feats, binning.tile_offsets, **ckw)
    color, t_final = (x.detach().requires_grad_(True)
                      for x in tiles_to_image(fwd_out, cfg))
    g_color, g_t = torch.autograd.grad(loss_of(color, t_final),
                                       [color, t_final])
    gout = image_to_tiles(g_color, g_t, cfg).contiguous()
    return feats, binning, fwd_out, gout, ckw


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


def rasterize_grads(trainer, leaves, loss_of):
    from sings_tpu_torch.ops.rasterizer.api import rasterize

    out = rasterize(*leaves[:5], trainer.camera, sh_degree=3,
                    bg=torch.zeros(3, device=trainer.device),
                    alive=trainer.buffers.alive > 0.5,
                    screen_probe=leaves[5], **trainer.raster_kw)
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
    fwd = K.composite_fwd_cuda(feats, b.tile_offsets, **ckw)
    gen = torch.Generator(device=dev).manual_seed(seed)
    gout = torch.randn(fwd.shape, generator=gen, device=dev)
    gout[:, 4:] = 0.0
    args = (feats, b.tile_offsets, b.grad_offsets, fwd, gout)
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
    cfg = load_config(
        DEFAULTS, None, HUMAN_COMPLEX_DOTLIST + HUMAN_COMPLEX_TRAIN_DOTLIST
        + BENCH_TRAIN_DOTLIST + [
            f"output_path={work}", "exp_name=smoke_train",
            "dataset.name=kit", f"seed={SEED}",
            f"tpu.smpl_model_dir={work}/no_licensed_models"])
    trainer = Trainer(cfg, mode="train", device=dev, kit=make_train_kit())
    seed_train_targets(trainer)
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
    feats, binning, fwd_out, gout, ckw = composite_bwd_inputs(
        trainer, leaves, loss_of)
    bargs = (feats, binning.tile_offsets, binning.grad_offsets, fwd_out,
             gout)
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
        f"grad_cap {binning.pair_slot_capacity}")
    max_err = check_bwd("training frame 0 (the loss's cotangents)", got,
                        want, binning)
    ekw = dict(tile=16, chunk=128, max_span=8, max_pairs=None, main_width=4,
               tail_capacity=None, pair_cap=None)
    g, cam = random_scene(400, 380, 500, 1, dev)
    max_err = max(max_err, edge_scene_bwd(dev, ekw, 11, g, cam,
                                          "500x380 padding tiles"))
    n = 300
    stack = [torch.tensor([[0.0, 0.0, 3.0]]).repeat(n, 1),
             torch.full((n, 3), 0.2),
             torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1),
             torch.full((n,), 0.95),
             torch.rand(n, 3, generator=torch.Generator().manual_seed(2))]
    stack[0][:, 2] += torch.linspace(0, 0.5, n)
    stack = [t.to(dev) for t in stack]
    cam = random_scene(1, 64, 64, 0, dev)[1]
    max_err = max(max_err, edge_scene_bwd(dev, ekw, 12, stack, cam,
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
    del grads_k, grads_p, got, want, leaves

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
    return {
        "name": "composite_bwd", "route": "cuda",
        "source": "sings_tpu_torch/csrc/composite_bwd.cu",
        "replaces": "sings_tpu/ops/rasterizer/pallas_kernels.py:912",
        "launches": launches["composite_bwd"], "max_abs_err": max_err,
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }


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
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def kernel_ms(fn):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   ) / 1e3, prof

    lines = [f"{'stage':40s} {'events ms':>10s} {'kernels ms':>10s}"
             "  (events: 5 back-to-back calls, host issue included; "
             "kernels: device time, profiler)"]
    for name, fn in stages:
        t = cuda_ms(fn, n=5, warm=1)
        d = kernel_ms(fn)[0]
        lines.append(f"{name:40s} {t:10.4f} {d:10.4f}")

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
    busy_ms, prof = kernel_ms(chunk)
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


if __name__ == "__main__":
    sys.exit(main())
