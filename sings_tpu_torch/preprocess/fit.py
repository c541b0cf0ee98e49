"""SMPL-fit kit contract: score_demo_video/{poses.npz, cameras.npz}
(a copy of sings_tpu/preprocess/fit.py: host numpy, no device code).

The reference produces these files with ScoreHMR (PHALP tracking + PARE
features + diffusion-guided refinement, preprocess/utils/
fit_for_sings.py:120-286) — external models whose weights ship only as
empty git submodules in the snapshot, there as here. What IS part of
the framework contract is the exact on-disk format the trainer
consumes (data/kit.py, reference sings/rec/datasets/Customdataset.py:
179-217). This module owns that contract:

  * `write_poses_npz` / `write_cameras_npz` — writers any SMPL fitter
    (ScoreHMR, a mocap pipeline, hand annotation) can call to produce a
    trainer-ready kit, reproducing the reference's conventions
    (mean betas over the sequence, fit_for_sings.py:259; axis-angle
    global_orient/body_pose; identity extrinsic, :280-284).
  * `validate_kit` — structural check of a full training-kit directory
    (frame/mask/pose counts, intrinsics shape, split viability).

Reference file:line citations are to the reference's
preprocess/utils/fit_for_sings.py unless noted.
"""
from __future__ import annotations

import glob
import os

import numpy as np

SMPL_DIR = "score_demo_video"


def write_poses_npz(
    kit_dir: str,
    betas: np.ndarray,
    global_orient: np.ndarray,
    body_pose: np.ndarray,
    transl: np.ndarray,
    *,
    mean_betas: bool = True,
    optimized: bool = False,
) -> str:
    """Write score_demo_video/poses{_optimized}.npz (:259-268).

    betas: (nb,) or (F, nb) — per-frame betas are averaged over the
        sequence when mean_betas (the reference always does, :259;
        SURVEY "betas shared across frames").
    global_orient: (F, 3) axis-angle root orientation.
    body_pose: (F, 69) axis-angle body pose (23 SMPL joints), or
        (F, 63)/(F, 153) for SMPLH-style fitters — stored as given;
        the trainer's template slices what it needs.
    transl: (F, 3) camera-frame translation.
    """
    global_orient = np.asarray(global_orient, np.float32).reshape(-1, 3)
    f = global_orient.shape[0]
    body_pose = np.asarray(body_pose, np.float32).reshape(f, -1)
    transl = np.asarray(transl, np.float32).reshape(f, 3)
    betas = np.asarray(betas, np.float32)
    if betas.ndim == 2:
        if mean_betas:
            betas = betas.mean(axis=0)
        else:
            raise ValueError(
                "per-frame betas are not part of the kit contract "
                "(the trainer shares one betas vector across frames)")
    out_dir = os.path.join(kit_dir, SMPL_DIR)
    os.makedirs(out_dir, exist_ok=True)
    name = "poses_optimized.npz" if optimized else "poses.npz"
    path = os.path.join(out_dir, name)
    np.savez_compressed(
        path, betas=betas, global_orient=global_orient,
        body_pose=body_pose, transl=transl)
    return path


def write_cameras_npz(
    kit_dir: str,
    height: int,
    width: int,
    *,
    intrinsic: np.ndarray | None = None,
    focal: float | tuple[float, float] | None = None,
    center: tuple[float, float] | None = None,
    extrinsic: np.ndarray | None = None,
) -> str:
    """Write score_demo_video/cameras.npz (:270-286).

    Either pass a full (3, 3) `intrinsic`, or `focal` (+ optional
    principal `center`, default image center — the reference uses the
    fitter's camera center, which its dataset sets to W/2, H/2).
    `extrinsic` defaults to identity like the reference (:281): the
    fits live directly in the camera frame.
    """
    if intrinsic is None:
        if focal is None:
            raise ValueError("need intrinsic or focal")
        fx, fy = (focal, focal) if np.isscalar(focal) else focal
        cx, cy = center if center is not None else (width / 2, height / 2)
        intrinsic = np.array(
            [[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    intrinsic = np.asarray(intrinsic, np.float64).reshape(3, 3)
    if extrinsic is None:
        extrinsic = np.eye(4)
    out_dir = os.path.join(kit_dir, SMPL_DIR)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "cameras.npz")
    np.savez_compressed(
        path, intrinsic=intrinsic,
        extrinsic=np.asarray(extrinsic, np.float64).reshape(4, 4),
        height=np.array(int(height)), width=np.array(int(width)))
    return path


def validate_kit(kit_dir: str, *, skip_first: int = 2) -> dict:
    """Structurally validate a training kit; returns a summary dict.

    Checks the full contract the trainer assumes (data/kit.py,
    Customdataset.py:179-217): matching image/mask frame lists, pose
    arrays covering every frame, intrinsics/extrinsic shapes, and that
    enough frames survive the skip-first-2 + val-split rules.
    Raises ValueError with an itemized message on violations.
    """
    problems: list[str] = []
    imgs = sorted(glob.glob(os.path.join(kit_dir, "images", "*.png")))
    msks = sorted(glob.glob(os.path.join(kit_dir, "masks", "*.png")))
    if not imgs:
        problems.append("no images/*.png")
    if len(imgs) != len(msks):
        problems.append(f"{len(imgs)} images vs {len(msks)} masks")
    else:
        for i, m in zip(imgs, msks):
            if os.path.splitext(os.path.basename(i))[0] != \
                    os.path.splitext(os.path.basename(m))[0]:
                problems.append(f"frame name mismatch: {i} vs {m}")
                break

    smpl_dir = os.path.join(kit_dir, SMPL_DIR)
    poses_path = os.path.join(smpl_dir, "poses_optimized.npz")
    optimized = os.path.exists(poses_path)
    if not optimized:
        poses_path = os.path.join(smpl_dir, "poses.npz")
    n_pose_frames = None
    if not os.path.exists(poses_path):
        problems.append(f"missing {SMPL_DIR}/poses.npz")
    else:
        poses = dict(np.load(poses_path))
        if "thetas" in poses:  # legacy packed layout (data/kit.py:24)
            poses["global_orient"] = poses["thetas"][..., :3]
            poses["body_pose"] = poses["thetas"][..., 3:]
        for key in ("betas", "global_orient", "body_pose", "transl"):
            if key not in poses:
                problems.append(f"poses.npz missing key {key}")
        if "global_orient" in poses:
            n_pose_frames = int(
                np.asarray(poses["global_orient"]).reshape(-1, 3).shape[0])
            if imgs and n_pose_frames < len(imgs):
                problems.append(
                    f"{n_pose_frames} pose frames < {len(imgs)} images")
        if "betas" in poses and np.asarray(poses["betas"]).ndim != 1:
            problems.append("betas must be a single shared vector")

    cam_path = os.path.join(smpl_dir, "cameras.npz")
    if not os.path.exists(cam_path):
        problems.append(f"missing {SMPL_DIR}/cameras.npz")
    else:
        cams = dict(np.load(cam_path))
        for key, shape in (("intrinsic", (3, 3)), ("extrinsic", (4, 4))):
            if key not in cams:
                problems.append(f"cameras.npz missing key {key}")
            elif tuple(np.asarray(cams[key]).shape) != shape:
                problems.append(
                    f"cameras.npz {key} shape "
                    f"{np.asarray(cams[key]).shape} != {shape}")
        for key in ("height", "width"):
            if key not in cams:
                problems.append(f"cameras.npz missing key {key}")

    usable = max(len(imgs) - skip_first, 0)
    if imgs and usable < 2:
        problems.append(
            f"only {usable} usable frames after skip_first={skip_first}")

    if problems:
        raise ValueError(
            f"invalid training kit {kit_dir}:\n  - " +
            "\n  - ".join(problems))
    return {
        "kit_dir": kit_dir,
        "num_frames": len(imgs),
        "usable_frames": usable,
        "optimized_poses": optimized,
        "pose_frames": n_pose_frames,
    }


def main(argv=None):
    """CLI: sings-validate-kit <kit_dir> — structural kit check."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kit_dir")
    ap.add_argument("--skip-first", type=int, default=2)
    args = ap.parse_args(argv)
    print(json.dumps(validate_kit(args.kit_dir,
                                  skip_first=args.skip_first)))


def patch_phalp_smpl_cache(smpl_pkl: str, cache_dir: str | None = None):
    """Copy a local SMPL pkl into PHALP's model cache.

    Port of the reference's preprocess/patches/fix_phalp_smpl.py:1-15:
    when PHALP (inside ScoreHMR) cannot download SMPL_NEUTRAL.pkl, the
    fix is copying an existing local copy into its cache layout. The
    cache root defaults to phalp.configs.base.CACHE_DIR when the
    (external) package is importable, else ~/.cache.
    """
    import shutil

    if cache_dir is None:
        try:
            from phalp.configs.base import CACHE_DIR  # external dep

            cache_dir = CACHE_DIR
        except Exception:
            cache_dir = os.path.expanduser("~/.cache")
    tgt = os.path.join(cache_dir, "phalp/3D/models/smpl/SMPL_NEUTRAL.pkl")
    os.makedirs(os.path.dirname(tgt), exist_ok=True)
    shutil.copy(smpl_pkl, tgt)
    return tgt
