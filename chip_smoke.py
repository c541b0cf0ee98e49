#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (sings_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from sings_tpu_torch/csrc with nvcc,
then drives the port's animation-render path at the full width of the
configs/human_complex.yaml avatar (synthetic SMPL-H template at
synthetic_res 2.0, two subdivisions: 102,182 gaussians in 127,744 slots;
nested 64^3 triplane, multires [1, 2, 4]; 512x512 at fx = fy = 5000;
pair_cap 4) through Trainer(cfg, mode="anim").animate_chunk, with
weights made from seed 0. Phases:

  1 device   torch.cuda must be available; prints the card and its limit
  2 build    nvcc for sm_90a, timed
  3 setup    config from DEFAULTS + HUMAN_COMPLEX_DOTLIST, an in-memory
             4-frame kit, a seeded 32-frame custom motion, a checkpoint
             written from the port's init_avatar, Trainer(mode="anim")
  4 kernels  each kernel against its plain PyTorch version on frame 0's
             real inputs and on edge scenes
  5 main     animate_chunk(16 frames a chunk, 32 frames); counts launches
  6 timing   CUDA-event times of each kernel and its plain version, and
             the least time the card could take for the same work
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

H100_FP32_FLOPS = 67e12    # fp32 outside the tensor cores (SXM data sheet)
H100_BYTES_PER_S = 3.35e12
# fp32 operations every walked pair-pixel needs before its skip test:
# tile-local offsets (4), the conic quadratic (9), exp, opacity product,
# 0.99 clamp (3): the alpha of that pair at that pixel
OPS_PER_PAIR_PIXEL = 16
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
    cuda_build.build(["composite_fwd"])
    log(f"[build] composite_fwd built in {time.time() - t0:.1f}s")
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


if __name__ == "__main__":
    sys.exit(main())
