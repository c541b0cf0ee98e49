"""Training entry point (port of sings_tpu/cli/train.py).

Usage:
    python -m sings_tpu_torch.cli.train -c configs/human_complex.yaml \
        [--device cuda] [dataset.name=f_2 train.num_steps=1000 ...]

Sharded training, one process per rank of a (dp, gs) mesh:
    torchrun --nproc_per_node=N -m sings_tpu_torch.cli.train ... \
        tpu.mesh.dp=D tpu.mesh.gs=G [--dist-backend nccl|gloo]
with N = D * G; each rank trains on cuda:LOCAL_RANK (modulo the card
count: several ranks may share a card over gloo, which NCCL refuses).
Rank 0 writes the run's files; the others wait at barriers.

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
    parser.add_argument("--dist-backend", choices=("nccl", "gloo"),
                        default=None,
                        help="process-group backend under torchrun "
                        "(default: nccl on CUDA, gloo on the CPU)")
    parser.add_argument("opts", nargs="*", help="dotlist overrides")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from ..config.core import load_config, save_config
    from ..config.defaults import DEFAULTS
    from ..dist.collectives import barrier, start_from_env
    from ..train.trainer import Trainer

    device, started = start_from_env(args.dist_backend, args.device)
    cfg = load_config(DEFAULTS, args.cfg_file, args.opts)
    trainer = Trainer(cfg, mode="train", device=device, kit=kit,
                      image_writer=image_writer)
    if trainer.io_rank:
        save_config(cfg, os.path.join(trainer.logdir, "config_train.yaml"))
    result = trainer.train()
    if trainer.io_rank:
        trainer.visualize("final")
        trainer.save_splat_file()  # reference train_avatar.py:66
        if trainer.anim_dataset is not None:
            trainer.animate_chunk(iter_s="final")
        # the reference renders both canonical poses at the end
        # (train_avatar.py:76-77)
        for pose_type in ("a_pose", "da_pose"):
            trainer.render_canonical("final",
                                     nframes=cfg.human.canon_nframes,
                                     pose_type=pose_type)
        print("final:", result)
    if dist.is_initialized():
        barrier(dist.group.WORLD)
    if started:
        dist.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
