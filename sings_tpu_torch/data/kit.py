"""Training-kit dataset (port of sings_tpu/data/kit.py).

A kit directory contains images/*.png, masks/*.png and
score_demo_video/{poses(_optimized).npz, cameras.npz}. PIL is imported
only when images are decoded, so a TrainingKit built in memory needs
no image library.
"""
from __future__ import annotations

import glob
import json
import os
from typing import NamedTuple

import numpy as np

from ..ops.graphics import Camera, make_camera


def load_smpl_param(path: str) -> dict:
    smpl_params = dict(np.load(str(path)))
    if "thetas" in smpl_params:
        smpl_params["body_pose"] = smpl_params["thetas"][..., 3:]
        smpl_params["global_orient"] = smpl_params["thetas"][..., :3]
    return {
        "betas": smpl_params["betas"].astype(np.float32).reshape(-1),
        "body_pose": smpl_params["body_pose"].astype(np.float32),
        "global_orient": smpl_params["global_orient"].astype(np.float32),
        "transl": smpl_params["transl"].astype(np.float32),
    }


def scan_kit_frames(kit_dir: str, *, skip_first: int = 2,
                    max_frames: int | None = None) -> int:
    """Frame count load_kit() would produce, without decoding images
    (the case pool sizes the shared per-frame parameter axis with it
    before it builds any Trainer)."""
    n = len(glob.glob(f"{kit_dir}/images/*.png")) - skip_first
    if max_frames is not None:
        n = min(n, int(max_frames))
    return max(n, 0)


def get_data_splits(num_frames: int):
    """Every ~10th frame (offset half-window) is validation."""
    num_val = max(num_frames // 10, 1)
    length = int(1 / num_val * num_frames)
    offset = length // 2
    val_list = list(range(num_frames))[offset::length]
    train_list = sorted(set(range(num_frames)) - set(val_list))
    assert train_list and val_list
    return train_list, val_list


class TrainingKit(NamedTuple):
    images: np.ndarray        # (F, 3, H, W) float32 [0,1]
    masks: np.ndarray         # (F, H, W) float32
    smpl: dict                # betas (nb,), body_pose/global_orient/transl
    camera: Camera
    train_split: list
    val_split: list
    name: str
    keypoints: np.ndarray | None = None
    keypoint_scores: np.ndarray | None = None


def load_keypoints(kit_dir: str, *, skip_first: int = 2, downscale: int = 1,
                   max_frames: int | None = None):
    """Per-frame sapiens coco-133 keypoints if the kit has them, else
    (None, None)."""
    root = os.path.join(kit_dir, "keypoints_coco133")
    if not os.path.isdir(root):
        return None, None
    subdirs = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if not subdirs:
        return None, None
    files = sorted(glob.glob(os.path.join(root, subdirs[0], "*.json")))
    files = files[skip_first:]
    if max_frames is not None:
        files = files[:max_frames]
    coords, scores = [], []
    for p in files:
        with open(p) as fh:
            d = json.load(fh)
        inst = d["instance_info"][0]
        coords.append(np.asarray(inst["keypoints"], np.float32))
        scores.append(np.asarray(inst["keypoint_scores"], np.float32))
    if not coords:
        return None, None
    kp = np.stack(coords)
    if downscale > 1:
        kp = kp / float(downscale)
    return kp, np.stack(scores)


def load_kit(kit_dir: str, *, skip_first: int = 2, znear: float = 0.01,
             zfar: float = 100.0, use_optimized_poses: bool = True,
             downscale: int = 1, max_frames: int | None = None) -> TrainingKit:
    """Load a full training kit (the first skip_first frames dropped)."""
    from PIL import Image

    img_list = sorted(glob.glob(f"{kit_dir}/images/*.png"))
    msk_list = sorted(glob.glob(f"{kit_dir}/masks/*.png"))
    assert len(img_list) == len(msk_list) and img_list, kit_dir

    smpl_dir = os.path.join(kit_dir, "score_demo_video")
    smpl_path = os.path.join(smpl_dir, "poses_optimized.npz")
    if not (use_optimized_poses and os.path.exists(smpl_path)):
        smpl_path = os.path.join(smpl_dir, "poses.npz")
    smpl = load_smpl_param(smpl_path)

    cam_npz = np.load(os.path.join(smpl_dir, "cameras.npz"))
    K = np.asarray(cam_npz["intrinsic"], np.float32).copy()
    extrinsic = np.asarray(cam_npz["extrinsic"], np.float32)
    height = int(cam_npz["height"])
    width = int(cam_npz["width"])
    if downscale > 1:
        height //= downscale
        width //= downscale
        K[:2] /= downscale
    camera = make_camera(extrinsic, height, width, K=K, znear=znear,
                         zfar=zfar)

    img_list = img_list[skip_first:]
    msk_list = msk_list[skip_first:]
    for k in ("body_pose", "global_orient", "transl"):
        smpl[k] = smpl[k][skip_first:]
    if max_frames is not None:
        img_list = img_list[:max_frames]
        msk_list = msk_list[:max_frames]
        for k in ("body_pose", "global_orient", "transl"):
            smpl[k] = smpl[k][:max_frames]

    def _load(p, mode):
        im = Image.open(p).convert(mode)
        if downscale > 1:
            im = im.resize((width, height), Image.BILINEAR)
        return np.asarray(im, np.float32) / 255.0

    images = np.stack([_load(p, "RGB").transpose(2, 0, 1) for p in img_list])
    masks = np.stack([_load(p, "L") for p in msk_list])
    assert images.shape[2] == height and images.shape[3] == width

    train_split, val_split = get_data_splits(len(img_list))
    kp, kp_scores = load_keypoints(kit_dir, skip_first=skip_first,
                                   downscale=downscale, max_frames=max_frames)
    if kp is not None and kp.shape[0] != len(img_list):
        kp = kp_scores = None
    return TrainingKit(
        images=images, masks=masks, smpl=smpl, camera=camera,
        train_split=train_split, val_split=val_split,
        name=os.path.basename(os.path.normpath(kit_dir)),
        keypoints=kp, keypoint_scores=kp_scores,
    )
