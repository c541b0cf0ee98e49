"""Video assembly: ffmpeg subprocess with cv2.VideoWriter fallback
(this image ships cv2 but not the ffmpeg binary)."""
from __future__ import annotations

import glob
import os
import shutil
import subprocess


def create_video(img_dir: str, out_path: str, fps: int = 20,
                 ext: str = "png") -> bool:
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    if shutil.which("ffmpeg"):
        cmd = (
            f"ffmpeg -hide_banner -loglevel error -framerate {fps} "
            f"-pattern_type glob -i '{img_dir}/*.{ext}' "
            f"-vf \"pad=ceil(iw/2)*2:ceil(ih/2)*2\" "
            f"-c:v libx264 -pix_fmt yuv420p {out_path} -y"
        )
        return subprocess.call(cmd, shell=True) == 0
    try:
        import cv2

        frames = sorted(glob.glob(f"{img_dir}/*.{ext}"))
        if not frames:
            return False
        first = cv2.imread(frames[0])
        h, w = first.shape[:2]
        vw = cv2.VideoWriter(
            out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        for f in frames:
            vw.write(cv2.imread(f))
        vw.release()
        return True
    except Exception as e:
        print(f"[video] no ffmpeg and cv2 writer failed: {e}")
        return False
