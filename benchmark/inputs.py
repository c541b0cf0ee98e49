"""The benchmark's inputs, made from --seed and handed to the program and
to the reference alike: the avatar's seeded weights, the training kit's
poses and camera, the animation motion, and each checked step's random
draws. The same seed gives the same inputs.

The generators follow chip_smoke.py's (make_kit, make_train_kit,
seeded_checkpoint, make_motion), with the seed of the run in place of
its fixed seed and the draws on the card.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

# one generator stream per kind of input, so that adding a draw to one
# leaves the others as they were
STREAM_WEIGHTS, STREAM_KIT, STREAM_NOISE, STREAM_MOTION, STREAM_DRAWS = (
    range(5))


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch.Generator on `device` for one input stream of the seed
    (any whole number; reduced to 63 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 8 + stream) % (1 << 63))
    return g


def seeded_weights(layout: dict, seed: int, device) -> dict:
    """The avatar's triplane and decoders from one uniform draw on the
    device: the planes uniform in [0.1, 0.5) and each linear layer
    kaiming-uniform (the port's init distributions), then the decoder
    heads as chip_smoke's seeded_checkpoint leaves them: scale and
    opacity weights times 0.01, their biases at the recipe's init
    targets (scale ~4 mm, opacity 0.8)."""
    sizes = [int(np.prod(s)) for scale in layout["planes"] for s in scale]
    for key in ("geometry_dec", "appearance_dec"):
        for fan_in, fan_out in layout[key].values():
            sizes += [fan_in * fan_out, fan_out]
    u = torch.rand(sum(sizes), generator=generator(seed, STREAM_WEIGHTS,
                                                   device), device=device)
    parts = iter(torch.split(u, sizes))
    grids = [[(0.1 + 0.4 * next(parts)).reshape(s) for s in scale]
             for scale in layout["planes"]]
    out = {"triplane": {"grids": grids}}
    for key in ("geometry_dec", "appearance_dec"):
        layers = {}
        for name, (fan_in, fan_out) in layout[key].items():
            bound_w = math.sqrt(1.0 / fan_in) * math.sqrt(3.0)
            bound_b = math.sqrt(1.0 / fan_in)
            w = ((next(parts) * 2 - 1) * bound_w).reshape(fan_in, fan_out)
            b = (next(parts) * 2 - 1) * bound_b
            layers[name] = {"w": w, "b": b}
        out[key] = layers
    s1 = out["geometry_dec"]["scales1"]
    s1["w"].mul_(0.01)
    s1["b"].fill_(math.log(math.expm1(0.004)))
    op = out["appearance_dec"].get("opacity")
    if op is not None:
        op["w"].mul_(0.01)
        op["b"].fill_(math.log(0.8 / 0.2))
    return out


def clone_weights(w: dict) -> dict:
    """A copy of seeded weights that shares no storage."""
    return {"triplane": {"grids": [[g.clone() for g in s]
                                   for s in w["triplane"]["grids"]]},
            **{k: {n: {p: t.clone() for p, t in layer.items()}
                   for n, layer in w[k].items()}
               for k in ("geometry_dec", "appearance_dec")}}


def kit_smpl(frames: int, seed: int, device, jitter: bool) -> dict:
    """The kit's SMPL parameters: upright at 5 m, zero betas; with
    jitter, body poses and translations jittered from the seed (the
    training kit)."""
    smpl = {"betas": np.zeros(10, np.float32),
            "body_pose": np.zeros((frames, 69), np.float32),
            "global_orient": np.tile([[np.pi, 0, 0]], (frames, 1)).astype(
                np.float32),
            "transl": np.tile([[0, 0.2, 5.0]], (frames, 1)).astype(
                np.float32)}
    if jitter:
        g = generator(seed, STREAM_KIT, device)
        r = torch.randn(frames, 72, generator=g, device=device).cpu().numpy()
        smpl["body_pose"] = (r[:, :69] * 0.08).astype(np.float32)
        smpl["transl"] = (smpl["transl"] + r[:, 69:] * 0.02).astype(
            np.float32)
    return smpl


def kit_intrinsics(size: int) -> np.ndarray:
    return np.array([[1000.0, 0, size / 2], [0, 1000.0, size / 2],
                     [0, 0, 1]])


def target_noise(shape, seed: int, device) -> torch.Tensor:
    """The seeded noise added to the rendered training targets."""
    return torch.randn(shape, generator=generator(seed, STREAM_NOISE,
                                                  device), device=device)


def write_motion(path: str, frames: int, seed: int, device) -> None:
    """A seeded custom-format motion (chip_smoke's make_motion with the
    run's seed): arms and legs swinging over 1.5 periods, upright root,
    a small sway of the root."""
    g = generator(seed, STREAM_MOTION, device)
    amp = (0.4 + 0.3 * torch.rand(4, generator=g, device=device)).cpu(
        ).numpy().astype(np.float32)
    ph = np.linspace(0, 1.5 * np.pi, frames, dtype=np.float32)
    pose = np.zeros((frames, 72), np.float32)
    pose[:, 0] = np.pi
    pose[:, 3 * 1 + 0] = amp[0] * np.sin(ph)
    pose[:, 3 * 2 + 0] = -amp[0] * np.sin(ph)
    pose[:, 3 * 4 + 0] = amp[1] * np.clip(np.sin(ph), 0, None)
    pose[:, 3 * 5 + 0] = amp[1] * np.clip(-np.sin(ph), 0, None)
    pose[:, 3 * 16 + 2] = -1.0 + amp[2] * np.sin(ph)
    pose[:, 3 * 17 + 2] = 1.0 + amp[3] * np.sin(ph)
    transl = np.stack([0.05 * np.sin(ph), np.zeros_like(ph),
                       0.02 * np.cos(ph)], -1).astype(np.float32)
    np.savez(path, body_pose=pose, transl=transl)


def write_anim_cfg(path: str, motion: str, traffic: dict) -> None:
    """The animation config (configs/anim_custom.yaml's keys) with the
    seeded motion as its source."""
    with open(path, "w") as fh:
        json.dump({"motion_src": motion, "motion_type": "custom",
                   "motion_start": 0, "motion_end": -1,
                   "motion_skip": int(traffic["motion_skip"]),
                   "render_size": list(traffic["render_size"]),
                   "image_zoom_ratio": 1.0,
                   "fx": float(traffic["focal"]),
                   "fy": float(traffic["focal"])}, fh)


def step_draws(draw_fn, seed: int, masks, photometric, device) -> list:
    """One draw dict per checked step, from the frozen copy of the
    port's draw_step_randoms on a generator of the seed; masks: the
    steps' (H, W) masks."""
    g = generator(seed, STREAM_DRAWS, device)
    return [draw_fn(g, m, photometric) for m in masks]


def tmpdir() -> str:
    """A fresh directory for the run's files under TMPDIR."""
    import tempfile

    return tempfile.mkdtemp(prefix="sings_bench_")


def remove(path: str) -> None:
    import shutil

    if path and os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
