"""Training entry point (port of sings_tpu/cli/train.py).

Usage:
    python -m sings_tpu_torch.cli.train -c configs/human_complex.yaml \
        [--device cuda] [dataset.name=f_2 train.num_steps=1000 ...]

Trains on the card (or the CPU with --device cpu), then writes the
final point cloud and ellipsoid meshes, the .splat showcase, the
animation when the config names one, and the a_pose / da_pose
turntables. A YAML config needs PyYAML; a JSON one (or no file, only
the dotlist over the defaults) needs none. The kit named by the
config's dataset keys is read from disk with PIL; main(kit=) takes one
held in memory instead.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None, *, kit=None, image_writer=None):
    """kit: optional in-memory TrainingKit; image_writer: optional sink
    of the saved images (both as Trainer takes them)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--cfg_file", type=str, default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs="*", help="dotlist overrides")
    args = parser.parse_args(argv)

    from ..config.core import load_config, save_config
    from ..config.defaults import DEFAULTS
    from ..train.trainer import Trainer

    cfg = load_config(DEFAULTS, args.cfg_file, args.opts)
    trainer = Trainer(cfg, mode="train", device=args.device, kit=kit,
                      image_writer=image_writer)
    save_config(cfg, os.path.join(trainer.logdir, "config_train.yaml"))
    result = trainer.train()
    trainer.visualize("final")
    trainer.save_splat_file()  # reference train_avatar.py:66 save_splat
    if trainer.anim_dataset is not None:
        trainer.animate_chunk(iter_s="final")
    # the reference renders both canonical poses at the end
    # (train_avatar.py:76-77)
    for pose_type in ("a_pose", "da_pose"):
        trainer.render_canonical("final", nframes=cfg.human.canon_nframes,
                                 pose_type=pose_type)
    print("final:", result)
    return result


if __name__ == "__main__":
    main()
