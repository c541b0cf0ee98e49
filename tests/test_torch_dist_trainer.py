"""The port's Trainer with tpu.mesh on a module-scoped gloo world of 4
ranks (tests/torch_dist_work.py): python -m sings_tpu_torch.cli.train's
main on every rank, in-memory kit, at (dp 2, gs 2) and with balanced
strips, through a prune, a densify and a checkpoint (tests/test_dist.
py:366's smoke run, with events). Held: every step's loss finite and
nothing skipped, the same on every rank; both density events change the
live count; rank 0 alone writes the checkpoints; every rank ends with
the same params, buffers and Adam state, bit for bit, and so does a
Trainer that resumes from the final checkpoint on every rank; the
validation result reaches every rank.
"""
import numpy as np
import pytest

from torch_dist_work import (  # noqa: F401
    train_mesh, two_torch_threads, world_fixture,
)

world = world_fixture(4, threads=2)

EVENTS = [
    "train.num_steps=4", "train.val_interval=100", "train.viz_interval=100",
    "train.save_ckpt_interval=3", "tpu.val_pose_refine_steps=0",
    "human.canon_nframes=1",
    "human.density_control.min_n_gaussians=10",
    "human.density_control.hybrid.prune_from_iter=1",
    "human.density_control.hybrid.prune_interval=100",
    "human.density_control.hybrid.prune_opacity_threshold=0.9",
    "human.density_control.hybrid.prune_scale_threshold=0.05",
    "human.density_control.hybrid.densify_from_iter=2",
    "human.density_control.hybrid.densify_interval=100",
    "human.density_control.hybrid.densify_grad_threshold=0.0",
    "human.density_control.hybrid.densify_scale_threshold=0.0"]


@pytest.mark.parametrize("balance", [False, True])
def test_trainer_on_a_mesh_of_four_ranks(world, tmp_path, balance):
    extra = EVENTS + ["tpu.mesh.dp=2", "tpu.mesh.gs=2"] + (
        ["tpu.mesh.balance_strips=True"] if balance else [])
    outs = world.run(train_mesh, tmp=str(tmp_path), extra=extra)
    assert sorted(o["mesh"] for o in outs) == [(0, 0), (0, 1), (1, 0),
                                               (1, 1)]
    ref = outs[0]
    assert len(ref["losses"]) == 4 and np.isfinite(ref["losses"]).all()
    assert ref["skipped"] == 0.0 and ref["step"] == 4
    # the prune at 1 and the densify at 2 both changed the live count
    (b0, a0), (b1, a1) = ref["counts"]
    assert a0 < b0 and a1 > b1 == a0
    assert ref["ckpts"] == ["human_000003.npz", "human_final.npz"]
    assert np.isfinite(ref["result"]["psnr"])
    if balance:
        assert ref["strip_bounds"][0] == 0 and ref["strip_bounds"][-1] == 48
    else:
        assert ref["strip_bounds"] is None
    for o in outs:
        for k in ("losses", "counts", "digest", "resumed", "alive",
                  "result", "strip_bounds"):
            assert o[k] == ref[k], k
        assert o["resumed_step"] == 4
        # the resumed Trainer holds the final state
        assert o["resumed"] == o["digest"]
    # rank 0 alone wrote images (the validation pairs)
    assert ref["io"] and not any(o["io"] for o in outs[1:])
