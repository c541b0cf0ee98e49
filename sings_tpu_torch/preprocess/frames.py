"""Video -> training-kit frame extraction (a copy of
sings_tpu/preprocess/frames.py).

Host-side preprocess stage (no device code): dumps `images/%06d.png`
from a video, optionally center-cropping and Lanczos-resizing each kept
frame to a square — the contract consumed by the downstream mask /
SMPL-fit stages and ultimately by the kit loader (data/kit.py).

Reference behavior: preprocess/utils/extract_frames.py:22-70 (frame
interval skip, crop via sub-pixel rect around a center point, resize to
1080x1080, zero-padded 6-digit names). Deviations: the resize target is
a parameter instead of hardcoded 1080, and a corrupt/short video raises
instead of silently truncating.
"""
from __future__ import annotations

import os


def extract_frames(
    video_path: str,
    out_dir: str,
    frame_interval: int = 1,
    img_center: tuple[float, float] | None = None,
    crop_hw: tuple[int, int] | None = None,
    resize_to: int = 1080,
) -> int:
    """Extract every `frame_interval`-th frame to `out_dir/images/`.

    Returns the number of images written. If `img_center` is given,
    each frame is cropped to `crop_hw` (height, width) around that
    (x, y) center with sub-pixel accuracy and resized to
    `resize_to` x `resize_to` (Lanczos), matching the reference's
    1080x1080 convention.
    """
    import cv2

    if img_center is not None and crop_hw is None:
        raise ValueError("img_center requires crop_hw=(h, w)")

    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {video_path}")
    frame_cnt = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))

    img_idx = 0
    for i in range(frame_cnt):
        ret, frame = cap.read()
        if not ret:
            break
        if i % frame_interval:
            continue
        if img_center is not None:
            h, w = crop_hw
            frame = cv2.getRectSubPix(
                frame, (int(w), int(h)),
                (float(img_center[0]), float(img_center[1])))
            frame = cv2.resize(frame, (resize_to, resize_to),
                               interpolation=cv2.INTER_LANCZOS4)
        cv2.imwrite(os.path.join(img_dir, f"{img_idx:06d}.png"), frame)
        img_idx += 1

    cap.release()
    return img_idx


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Extract frames from a video into a training kit "
                    "(images/%06d.png)")
    p.add_argument("-v", "--video_path", required=True)
    p.add_argument("-o", "--out_dir", required=True)
    p.add_argument("--frame_interval", type=int, default=1)
    p.add_argument("--img_center", type=float, nargs=2, default=None,
                   metavar=("CX", "CY"))
    p.add_argument("--img_h", type=int, default=None)
    p.add_argument("--img_w", type=int, default=None)
    p.add_argument("--resize_to", type=int, default=1080)
    a = p.parse_args(argv)

    crop = (a.img_h, a.img_w) if a.img_h and a.img_w else None
    n = extract_frames(a.video_path, a.out_dir, a.frame_interval,
                       tuple(a.img_center) if a.img_center else None,
                       crop, a.resize_to)
    print(f"saved {n} frames to {os.path.join(a.out_dir, 'images')}")


if __name__ == "__main__":
    main()
