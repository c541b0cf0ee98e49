"""Batch training over several cases (port of
sings_tpu/cli/train_batch.py).

Two modes:
- default: each case's whole training runs in this process, one after
  the other (the port's cli.train.main per case); several hosts split
  the cases by `--shard i/n`.
- --simultaneous: all cases train in lockstep, one case step updating
  every case (train/trainer_cases.py::CasePool); the cases' steps run
  one after another, each split over --gs ranks (one process each,
  under torchrun --nproc_per_node=GS; rank 0 writes).

Usage:
    python -m sings_tpu_torch.cli.train_batch -c configs/human_complex.yaml \
        --cases f_2 m_1 m_3 [--shard 0/2 | --simultaneous] \
        [--device cuda] [overrides...]

main(argv, kits={case: TrainingKit}) trains on kits held in memory
instead of reading each case's kit directory.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None, *, kits=None, image_writer=None):
    """kits: optional {case name: in-memory TrainingKit}; image_writer:
    optional sink of the saved images (both as Trainer takes them).
    Returns {case: the final validation metrics}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--cfg_file", type=str, default=None)
    parser.add_argument("--cases", nargs="+", required=True)
    parser.add_argument("--shard", type=str, default="0/1",
                        help="i/n: this host trains cases i, i+n, ...")
    parser.add_argument("--simultaneous", action="store_true",
                        help="train all cases at once, in lockstep, "
                        "instead of one after another")
    parser.add_argument("--gs", type=int, default=1,
                        help="gaussian/strip shards per case "
                        "(simultaneous mode; one rank each)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dist-backend", choices=("nccl", "gloo"),
                        default=None,
                        help="process-group backend under torchrun "
                        "(default: nccl on CUDA, gloo on the CPU)")
    parser.add_argument("opts", nargs="*")
    args = parser.parse_args(argv)

    if args.simultaneous:
        return _train_simultaneous(args, kits, image_writer)

    i, n = (int(x) for x in args.shard.split("/"))
    cases = args.cases[i::n]
    print(f"[batch] shard {i}/{n}: {cases}")

    from .train import main as train_main

    results = {}
    for case in cases:
        print(f"[batch] === training {case} ===", flush=True)
        results[case] = train_main(
            (["-c", args.cfg_file] if args.cfg_file else [])
            + ["--device", args.device, f"dataset.name={case}"]
            + list(args.opts),
            kit=None if kits is None else kits[case],
            image_writer=image_writer)
    for case, res in results.items():
        print(f"[batch] {case}: {res}")
    return results


def _train_simultaneous(args, kits, image_writer):
    import torch.distributed as dist

    from ..config.core import load_config, save_config
    from ..config.defaults import DEFAULTS
    from ..dist.collectives import start_from_env
    from ..train.trainer_cases import CasePool

    args.device, started = start_from_env(args.dist_backend, args.device)
    cfgs = [load_config(DEFAULTS, args.cfg_file,
                        [f"dataset.name={case}"] + list(args.opts))
            for case in args.cases]
    pool = CasePool(cfgs, gs=args.gs, device=args.device,
                    kits=None if kits is None else [kits[c]
                                                    for c in args.cases],
                    image_writer=image_writer)
    io = pool.trainers[0].io_rank
    for cfg, t in zip(cfgs, pool.trainers):
        if io:
            save_config(cfg, os.path.join(t.logdir, "config_train.yaml"))
    results = pool.train()
    for t in pool.trainers:
        if io:
            t.visualize("final")
            t.save_splat_file()
    if io:
        for case, res in results.items():
            print(f"[batch] {case}: {res}")
    if started:
        dist.barrier()
        dist.destroy_process_group()
    return results


if __name__ == "__main__":
    main()
