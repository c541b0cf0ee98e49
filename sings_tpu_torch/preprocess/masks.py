"""AlphaPose keypoints -> SAM2 mask prompts -> masks/%06d.png (a copy of
sings_tpu/preprocess/masks.py: host numpy/cv2, no device code).

Host-side preprocess stage. The reference implementation
(preprocess/utils/get_masks_for_sings.py) couples three things: prompt
construction from the AlphaPose halpe-26 json (:100-131, :163-193),
driving the external SAM2 video predictor (:151-222), and mask
postprocessing/saving (:226-244). The prompt construction and the
postprocess are pure numpy/cv2 and are implemented (and tested) here;
the SAM2 predictor is an external model with licensed weights that are
not present in this snapshot (the reference repo itself ships it only
as an empty git submodule) — `run_sam2_video` gates on its import and
accepts any object implementing the same predictor protocol, so a fake
can drive the full flow in tests.

Reference file:line citations are to the reference's
preprocess/utils/get_masks_for_sings.py.
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np


def resize_bbox(box, img_width: int = 1080, img_height: int = 1080,
                scale_factor: float = 1.2) -> np.ndarray:
    """Scale a (x1, y1, x2, y2) box about its center, clamped to the
    image and floored to ints (get_masks_for_sings.py:42-66)."""
    x1, y1, x2, y2 = box
    w, h = x2 - x1, y2 - y1
    cx, cy = x1 + w / 2, y1 + h / 2
    sw, sh = w * scale_factor, h * scale_factor
    return np.array((
        int(max(0, cx - sw / 2)),
        int(max(0, cy - sh / 2)),
        int(min(img_width, cx + sw / 2)),
        int(min(img_height, cy + sh / 2)),
    ))


def check_poses(keypoints_path: str) -> dict:
    """Group AlphaPose results by person id (get_masks_for_sings.py:100-131).

    Returns {person_id: [{image_id, keypoints, box}, ...]} in file
    order. Handles the AlphaPose quirk where `idx` can be a (nested)
    list instead of an int.
    """
    with open(keypoints_path) as f:
        poses = json.load(f)

    pose_prompt: dict = {}
    for pose in poses:
        person_id = pose["idx"]
        while isinstance(person_id, list):  # AlphaPose bug (:119-121)
            person_id = person_id[0]
        pose_prompt.setdefault(person_id, []).append({
            "image_id": pose["image_id"],
            "keypoints": pose["keypoints"],
            "box": pose["box"],
        })
    return pose_prompt


def build_point_prompt(pose: dict) -> tuple[np.ndarray, np.ndarray]:
    """Positive point prompts for one frame's halpe-26 keypoints.

    Reproduces get_masks_for_sings.py:163-200: body points 5..19 (face
    and feet ignored), plus the two heel points, plus three synthetic
    torso points (hip center and the two shoulder->hip midpoints, using
    halpe indices 4/5 ears and 17/18 hips as the reference does).
    Returns (points (P, 2) float, labels (P,) all ones).
    """
    points = np.asarray(pose["keypoints"], np.float64).reshape(-1, 3)[:, :2]
    selected = points[5:20]
    selected = np.concatenate([selected, points[-2:]], axis=0)  # heels
    additional = np.stack([
        (points[17] + points[18]) / 2.0,
        (points[4] + points[17]) / 2.0,
        (points[5] + points[17]) / 2.0,
    ], axis=0)
    selected = np.concatenate([selected, additional], axis=0)
    return selected, np.ones(len(selected))


def postprocess_mask(mask: np.ndarray, erode_size: int = 1) -> np.ndarray:
    """Binary (H, W) or (1, H, W) mask -> eroded uint8 0/255 image
    (get_masks_for_sings.py:236-242)."""
    import cv2

    m = np.asarray(mask)
    if m.ndim == 3:
        m = m[0]
    out = (m > 0).astype(np.uint8) * 255
    if erode_size > 0:
        kernel = np.ones((erode_size, erode_size), np.uint8)
        out = cv2.erode(out, kernel, iterations=1)
    return out


def list_frames(video_dir: str) -> tuple[list[str], int, int]:
    """Frame names + (H, W); creates temp .jpg copies of .png frames
    (SAM2 only reads jpg; get_masks_for_sings.py:69-99)."""
    import cv2

    files = os.listdir(video_dir)
    jpgs = sorted(f for f in files if f.lower().endswith((".jpg", ".jpeg")))
    pngs = sorted(f for f in files if f.lower().endswith(".png"))
    if not jpgs:
        if not pngs:
            raise FileNotFoundError(f"no jpg or png frames in {video_dir}")
        for p in pngs:
            img = cv2.imread(os.path.join(video_dir, p))
            cv2.imwrite(os.path.join(video_dir, p[:-4] + ".jpg"), img)
        jpgs = [p[:-4] + ".jpg" for p in pngs]
    first = cv2.imread(os.path.join(video_dir, jpgs[0]))
    return jpgs, first.shape[0], first.shape[1]


def run_sam2_video(
    video_dir: str,
    keypoints_path: str,
    out_dir: str | None = None,
    *,
    predictor=None,
    only_first_frame: bool = True,
    erode_size: int = 1,
    cleanup_jpg: bool = False,
) -> str:
    """Full mask stage: prompts -> SAM2 propagation -> masks/%06d.png.

    `predictor` is a SAM2 video predictor (or any object with
    init_state/add_new_points_or_box/propagate_in_video); when None the
    official sam2 package is imported — unavailable in this snapshot,
    matching the reference's empty submodule. Mirrors
    get_masks_for_sings.py:135-247.
    """
    import cv2

    frame_names, img_h, img_w = list_frames(video_dir)
    pose_prompt = check_poses(keypoints_path)
    if len(pose_prompt) != 1:
        raise ValueError(
            f"only single-person videos are supported; found person ids "
            f"{sorted(pose_prompt)} (same contract as the reference, "
            f"get_masks_for_sings.py:148)")

    if predictor is None:
        try:
            from sam2.build_sam import build_sam2_video_predictor
        except ImportError as e:
            raise ImportError(
                "sam2 is not installed (the reference ships it as an "
                "empty submodule); pass `predictor=` explicitly") from e
        predictor = build_sam2_video_predictor(
            "configs/sam2.1/sam2.1_hiera_l.yaml",
            "./checkpoints/sam2.1_hiera_large.pt")

    state = predictor.init_state(video_path=video_dir)
    for obj_id, frames in pose_prompt.items():
        for frame_idx, pose in enumerate(frames):
            points, labels = build_point_prompt(pose)
            predictor.add_new_points_or_box(
                inference_state=state, frame_idx=frame_idx, obj_id=obj_id,
                points=points, labels=labels)
            # replicated off-by-one: the reference breaks AFTER adding,
            # so "only_first_frame" actually prompts frames 0 and 1
            # (get_masks_for_sings.py:203-216)
            if only_first_frame and frame_idx > 0:
                break

    if out_dir is None:
        out_dir = os.path.join(os.path.dirname(video_dir.rstrip("/")),
                               "masks")
    os.makedirs(out_dir, exist_ok=True)
    for frame_idx, obj_ids, mask_logits in predictor.propagate_in_video(
            state):
        for i, _obj in enumerate(obj_ids):
            mask = np.asarray(mask_logits[i]) > 0.0
            out = postprocess_mask(mask, erode_size)
            cv2.imwrite(os.path.join(out_dir, f"{frame_idx:06d}.png"), out)

    if cleanup_jpg:
        for f in glob.glob(os.path.join(video_dir, "*.jpg")):
            os.remove(f)
    return out_dir


def main(argv=None):
    """CLI: sings-extract-masks --video-dir images/ --keypoints
    alphapose-results.json [--out-dir masks/]."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--video-dir", required=True,
                    help="directory of extracted frames")
    ap.add_argument("--keypoints", required=True,
                    help="AlphaPose halpe-26 results json")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--erode-size", type=int, default=1)
    ap.add_argument("--all-frames", action="store_true",
                    help="prompt every frame instead of the first")
    args = ap.parse_args(argv)
    out = run_sam2_video(
        args.video_dir, args.keypoints, args.out_dir,
        only_first_frame=not args.all_frames, erode_size=args.erode_size)
    print(out)
