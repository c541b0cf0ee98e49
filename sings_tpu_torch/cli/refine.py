"""Preprocess refinement entry point (port of sings_tpu/cli/refine.py;
reference preprocess/utils/ooptimize_smpl(h).py): refine a kit's SMPL
fits against its masks (+ optional sapiens keypoints) and write
poses_optimized.npz next to poses.npz.

Usage:
    python -m sings_tpu_torch.cli.refine --kit /path/to/kit [--steps 300]
        [--device cuda]

Runs on the card (the composite kernels) unless --device cpu is given.
The kit's images and masks are read with PIL; main(kit=) takes a kit
held in memory instead (cameras.npz and the keypoint JSONs are still
read from --kit, and the result is written there). The default model
directory is the relative data/human_models. Without a licensed model
there, the synthetic template is used and, as the Trainer does, the
kit's betas (which parametrise the licensed SMPL) are replaced by zeros
at the template's dimension.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def load_sapiens_keypoints(kit_dir: str, num_frames: int):
    """Read keypoints_coco133/sapiens_*/ *.json if present."""
    roots = sorted(glob.glob(os.path.join(kit_dir, "keypoints_coco133", "*")))
    if not roots:
        return None, None
    files = sorted(glob.glob(os.path.join(roots[0], "*.json")))
    if len(files) < num_frames:
        return None, None
    from ..preprocess.refine import coco133_to_smpl

    kps, valids = [], []
    for fp in files[:num_frames]:
        with open(fp) as fh:
            data = json.load(fh)
        # sapiens json: {"instance_info": [{"keypoints": [[x,y],...]}]}
        try:
            pts = np.asarray(
                data["instance_info"][0]["keypoints"], np.float32)[:133, :2]
        except (KeyError, IndexError, TypeError):
            return None, None
        kp, valid = coco133_to_smpl(pts)
        kps.append(kp)
        valids.append(valid)
    return np.stack(kps), np.stack(valids)


def main(argv=None, *, kit=None):
    """kit: optional in-memory TrainingKit (as Trainer takes it)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--kit", required=True)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--downscale", type=int, default=4)
    parser.add_argument("--body_template", default="smpl")
    parser.add_argument("--smpl_model_dir", default="data/human_models")
    parser.add_argument("--optimize_betas", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..device import resolve_device
    from ..kinematics.body_model import load_template
    from ..kinematics.template import DeviceTemplate
    from ..preprocess.refine import RefineConfig, refine_smpl

    device = resolve_device(args.device)
    if kit is None:
        from ..data.kit import load_kit

        kit = load_kit(args.kit, skip_first=0, use_optimized_poses=False)
    tpl = load_template(
        os.path.join(args.smpl_model_dir, args.body_template),
        args.body_template, num_betas=len(kit.smpl["betas"]))
    smpl = dict(kit.smpl)
    if tpl.name == "synthetic":
        smpl["betas"] = np.zeros(tpl.num_betas, np.float32)
    template = DeviceTemplate.from_host(tpl, device)

    cam_npz = np.load(os.path.join(args.kit, "score_demo_video",
                                   "cameras.npz"))
    K = np.asarray(cam_npz["intrinsic"], np.float32)

    kps, valid = load_sapiens_keypoints(args.kit, len(kit.masks))
    cfg = RefineConfig(steps=args.steps, render_downscale=args.downscale,
                       optimize_betas=args.optimize_betas)
    out = refine_smpl(template, kit.camera, K, smpl, kit.masks, kps, valid,
                      cfg)
    print(f"refine loss {out['losses'][0]:.5f} -> {out['losses'][-1]:.5f}")

    result = {k: out[k] for k in ("betas", "global_orient", "body_pose",
                                  "transl")}
    dst = os.path.join(args.kit, "score_demo_video", "poses_optimized.npz")
    try:
        np.savez(dst, **result)
        print(f"wrote {dst}")
    except OSError as e:  # a read-only kit
        alt = os.path.join(os.getcwd(), "poses_optimized.npz")
        np.savez(alt, **result)
        print(f"kit read-only ({e}); wrote {alt}")
    return out


if __name__ == "__main__":
    main()
