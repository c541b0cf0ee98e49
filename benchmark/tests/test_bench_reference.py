"""The frozen reference against the port at tiny shapes on the CPU, and
the controls that the comparison has to fail: half of the batch on the
CPU, TF32 on the card."""
import argparse
import json

import numpy as np
import pytest
import torch

from bench_tiny import SMALL_CONFIG, tiny

CELLS = ("complex-train", "complex-anim")


def _program_and_reference(cell: str, seed: int, tmp_path):
    """The program's Trainer and the reference's avatar from one cell's
    inputs at tiny shapes, with the same seeded weights."""
    import inputs
    import run
    from reference import build as RB
    from sings_tpu_torch.config.core import load_config
    from sings_tpu_torch.config.defaults import DEFAULTS
    from sings_tpu_torch.data.kit import TrainingKit, get_data_splits
    from sings_tpu_torch.ops.graphics import make_camera
    from sings_tpu_torch.train.trainer import Trainer

    files = run.cell_files(run.ROOT, run.manifest(run.ROOT), cell)
    ctx, runner = run.make_ctx(
        files, argparse.Namespace(seed=seed, seconds=0.0, trace=0),
        torch.device("cpu"), tiny(cell), run.ROOT, 0.0)
    inputs.remove(ctx.tmp)
    ctx.tmp = str(tmp_path)
    ri = runner.reference_inputs(ctx)
    size = int(ctx.traffic["kit_size"])
    train, val = get_data_splits(int(ctx.traffic["kit_frames"]))
    kit = TrainingKit(images=ri["images"].numpy(), masks=ri["masks"].numpy(),
                      smpl=ri["smpl"],
                      camera=make_camera(np.eye(4), size, size, K=ri["K"]),
                      train_split=train, val_split=val, name="kit")
    tr = Trainer(load_config(DEFAULTS, None, runner.program_dotlist(ctx)),
                 mode="train", device="cpu", kit=kit,
                 image_writer=lambda p, i: None)
    tr.params = tr.params._replace(**inputs.clone_weights(ri["weights"]))
    av = RB.avatar(ri["cfg"], ri["smpl"], inputs.clone_weights(ri["weights"]),
                   "cpu")
    return tr, av, RB.training(av, ri["camera"], "cpu")


def test_the_reference_works_out_the_programs_state_again(tmp_path,
                                                          one_thread):
    """Template anchors, buffers and the region laplacian's tables, each
    derived on both sides from the configuration and the inputs."""
    from sings_tpu_torch.tree import tree_leaves

    tr, av, rt = _program_and_reference("complex-train", 11, tmp_path)
    assert torch.equal(tr.params.xyz, av.params.xyz)
    for a, b in zip(tree_leaves(tr.params), tree_leaves(av.params)):
        assert torch.equal(a, b)
    for name in tr.buffers._fields:
        assert torch.equal(getattr(tr.buffers, name),
                           getattr(av.buffers, name)), name
    assert torch.equal(tr.region_lap.neighbors, rt.region_lap.neighbors)
    assert torch.equal(tr.lap_pos_w, rt.lap_pos_w)


def _control(cell: str, kind: str, seeds, device, overrides, capsys):
    import control

    assert control.main(["--workload", cell, "--kind", kind, "--seeds",
                         *map(str, seeds)], device=device,
                        overrides=overrides) == 0
    out = capsys.readouterr().out
    return json.loads(out.strip().splitlines()[-1])["readings"]


def test_half_of_the_batch_fails_the_training_cell(capsys, one_thread):
    import run

    limits = run.cell_files(run.ROOT, run.manifest(run.ROOT),
                            "complex-train")["limits"]
    small = tiny("complex-train")
    small["config"] += SMALL_CONFIG
    readings = _control("complex-train", "half_batch", (1, 2, 3),
                        torch.device("cpu"), small, capsys)
    for seed, numbers in readings.items():
        assert any(v > limits[k] for k, v in numbers.items()), (seed,
                                                                numbers)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_tf32_fails_each_cell(cell, card, capsys):
    """The reference in TF32 against itself in float32, at a small size
    on the card."""
    import run

    limits = run.cell_files(run.ROOT, run.manifest(run.ROOT),
                            cell)["limits"]
    small = {"config": list(SMALL_CONFIG), "traffic": {}}
    readings = _control(cell, "tf32", (1, 2, 3), card, small, capsys)
    for seed, numbers in readings.items():
        assert any(v > limits[k] for k, v in numbers.items()), (seed,
                                                                numbers)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_each_cell_on_the_card(cell, trace, card, capsys):
    """The whole run at a small size on the card, traced and not."""
    import time

    import run

    small = {"config": list(SMALL_CONFIG), "traffic": {}}
    rc = run.main(["--workload", cell, "--seed", "21", "--seconds", "2",
                   "--trace", str(trace)], device=card, overrides=small,
                  t_start=time.time())
    out = capsys.readouterr().out
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["metrics"]
