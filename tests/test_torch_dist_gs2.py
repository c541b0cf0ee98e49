"""The port's gs axis on a module-scoped gloo world of 2 ranks
(tests/torch_dist_work.py): balanced strips, the case step and the
case pool.

Held: the sharded step's (loss, gradients) with balanced strips (bounds
[0, 48, 64], 48-row windows, tests/test_dist.py:428) against JAX's on
the same (1, 2) mesh at tests/test_dist.py's (1, 1) tolerances (the
decompositions are equal) and against the port's gs 1 at :428's; the
case step at gs 2 on two cases (a state and its perturbed copy, each
through its own camera) bit for bit each case's sharded step at (dp 1,
gs 2), on both ranks; python -m sings_tpu_torch.cli.train_batch
--simultaneous --gs 2 over two kits: finite losses, the cases apart,
every case's state bit for bit the same on both ranks, rank 0's
checkpoints and results on both.
"""
import jax
import numpy as np

import torch_dist_setup as S
from sings_tpu_torch.tree import tree_leaves
from torch_dist_work import case_pool_gs, case_step_gs, sharded_step, \
    two_torch_threads, world_fixture  # noqa: F401

world = world_fixture(2, threads=2)
RNG = jax.random.PRNGKey(3)
BOUNDS = np.asarray([0, 48, 64], np.int32)


def test_balanced_strips_match_jax_and_gs1(world):
    outs = world.run(sharded_step, setup=S.port_setup(), dp=1, gs=2,
                     draws=S.draws(RNG, 1), step=0, grads_only=True,
                     strip_bounds=BOUNDS, strip_h_max=48)
    got = outs[0]["runs"][0]
    for a, b in zip(tree_leaves(outs[1]["runs"][0]), tree_leaves(got)):
        np.testing.assert_array_equal(a, b)
    jl, jg = S.jax_step(RNG, 1, 2, grads_only=True, bounds=BOUNDS, h_max=48)
    np.testing.assert_allclose(got["loss"], jl, rtol=S.METRIC_RTOL)
    S.check_grads(got["grads"], jg)
    one = sharded_step(S.port_setup(), 1, 1, S.draws(RNG, 1), 0,
                       grads_only=True)["runs"][0]
    np.testing.assert_allclose(got["loss"], one["loss"],
                               rtol=S.LOSS_RTOL_GS)
    S.check_grads(got["grads"], tree_leaves(one["grads"]),
                  rtol=S.GRAD_RTOL_GS, atol_rel=S.GRAD_RTOL_GS)


def test_case_step_at_gs2_is_each_cases_sharded_step(world):
    d = S.draws(RNG, 2)
    outs = world.run(case_step_gs, setup=S.port_setup(), draws=d)
    for o in outs:
        assert o["equal"] == [True, True]
        assert np.isfinite(o["loss"]).all() and not o["skipped"].any()
        assert o["loss"][0] != o["loss"][1]
    assert outs[0]["digest"] == outs[1]["digest"]


def test_case_pool_at_gs2(world, tmp_path):
    outs = world.run(case_pool_gs, tmp=str(tmp_path), steps=3)
    a, b = outs
    assert (a["gs_idx"], b["gs_idx"]) == (0, 1)
    assert a["step"] == 3 and len(a["losses"]) == 3
    assert np.isfinite(a["losses"]).all()
    assert all(x[0] != x[1] for x in a["losses"])
    for k in ("losses", "digests", "results", "ckpts"):
        assert a[k] == b[k], k
    assert a["ckpts"] == [["human_final.npz"]] * 2
    assert sorted(a["results"]) == ["a", "b"]
    assert all(np.isfinite(r["psnr"]) for r in a["results"].values())
