"""Tiny shapes of the cells for CPU tests."""
import json
import os

# tiny shapes of the cells for the CPU: the same paths at a template of
# a few hundred vertices, 128x128 kits and 64x64 frames; chunk 8, as the
# port's Trainer composites on the CPU
TINY_CONFIG = ["tpu.synthetic_res=0.5", "human.n_subdivision=0",
               "human.kplanes.resolution=[16,16,16]",
               "human.density_control.min_n_gaussians=100",
               "human.loss.patch_size=32", "tpu.raster.chunk=8"]
# a small size of the cells, for the card's tests and for the controls
# whose faults the tiny shapes hide: at the tiny template the leftover
# patches are too small a share of the loss for half a batch to show
SMALL_CONFIG = ["tpu.synthetic_res=1.0", "human.n_subdivision=1"]
TINY_TRAFFIC = {
    "complex-train": {"kit_size": 128},
    "complex-anim": {"render_size": [64, 64], "motion_frames": 40,
                     "kit_size": 64},
}

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def tiny(cell: str) -> dict:
    """Overrides of a cell (a new training cell takes complex-train's)."""
    return {"config": list(TINY_CONFIG),
            "traffic": dict(TINY_TRAFFIC.get(cell,
                                             TINY_TRAFFIC["complex-train"]))}


def last_json(out: str) -> dict:
    """The JSON object on the last line of a run's standard output."""
    return json.loads(out.strip().splitlines()[-1])


def run_cell(cell: str, seed: int, capsys, trace: int = 0, root=None):
    """One run of the cell at tiny shapes on the CPU; (rc, last line or
    None, standard error)."""
    import time

    import torch

    import run

    kw = {} if root is None else {"root": root}
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.5", "--trace", str(trace)],
                  device=torch.device("cpu"), overrides=tiny(cell),
                  t_start=time.time(), **kw)
    cap = capsys.readouterr()
    line = last_json(cap.out) if rc == 0 else None
    return rc, line, cap.err
