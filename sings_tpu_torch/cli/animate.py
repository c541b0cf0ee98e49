"""Animation entry point (port of sings_tpu/cli/animate.py).

Reloads config_train.yaml from a finished run directory, finds the
latest checkpoint, and renders the configured motion.

Usage:
    python -m sings_tpu_torch.cli.animate -o output/exp/f_2 [--chunk 16] \
        [--device cuda]
"""
from __future__ import annotations

import argparse
import os


def main(argv=None, *, writer=None):
    """writer: optional frame sink passed to Trainer.animate_chunk."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-o", "--output_dir", required=True)
    parser.add_argument("--chunk", type=int, default=16)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("opts", nargs="*")
    args = parser.parse_args(argv)

    from ..config.core import load_config
    from ..config.defaults import DEFAULTS
    from ..train.trainer import Trainer

    cfg_path = os.path.join(args.output_dir, "config_train.yaml")
    cfg = load_config(DEFAULTS, cfg_path, list(args.opts) + ["eval=True"])
    cfg.logdir = args.output_dir
    cfg.logdir_ckpt = os.path.join(args.output_dir, "ckpt")

    trainer = Trainer(cfg, mode="anim", device=args.device)
    fps = trainer.animate_chunk(chunk_size=args.chunk, iter_s="anim",
                                writer=writer)
    print(f"animation fps: {fps:.2f}")
    return fps


if __name__ == "__main__":
    main()
