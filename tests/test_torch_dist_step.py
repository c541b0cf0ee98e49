"""The port's sharded step (sings_tpu_torch/dist/train_sharded.py) held
against sings_tpu's make_sharded_train_step and against the port's
single-card step.

tests/torch_dist_setup.py's inputs (tests/test_dist.py's
_sharded_setup); JAX runs on meshes of the 8-device CPU backend, the
port on a module-scoped gloo world of 4 ranks (tests/torch_dist_work.
py), both with SGD at learning rate 1 that keeps the gradients, the
port on JAX's draws. Held: at (1, 1) (no process group) every metric,
gradient and density buffer against JAX's (1, 1) and against the
port's single-card step, at tests/test_dist.py's (1, 1) tolerances, and
a NaN frame skipped by the non-finite guard as the single-card step
skips it; at
(1, 4) the same against JAX's (1, 4) (the decompositions are equal) and
the loss and gradients against the port's (1, 1) at tests/test_dist.
py's gs-4 tolerances; at (2, 2), each dp rank on its own frame, a rerun
bit for bit, every rank's state bit for bit equal, and the state
against JAX's (2, 2) on the same frames.
"""
import jax
import numpy as np
import pytest
import torch

import torch_dist_setup as S
from sings_tpu_torch.tree import tree_leaves
from torch_dist_work import SGD, _np_tree, _t_tree, sharded_step, \
    two_torch_threads, world_fixture  # noqa: F401

world = world_fixture(4)
RNG = jax.random.PRNGKey(3)


@pytest.fixture(scope="module")
def port11():
    """The port's sharded step at (1, 1) in this process."""
    return sharded_step(S.port_setup(), 1, 1, S.draws(RNG, 1), 0)["runs"][0]


def test_mesh11_matches_jax(port11):
    jp, jb, jg, jm = S.jax_step(RNG, 1, 1)
    S.check_metrics(port11["metrics"], jm)
    assert float(port11["metrics"]["photo_lpips_patch"]) > 0
    S.check_grads(port11["grads"], jg)
    S.check_density(port11["buffers"], jb)


def test_mesh11_matches_single_card_step(port11):
    from sings_tpu_torch.train.step import make_train_step

    s = _t_tree(S.port_setup())
    body = make_train_step(s["cfg"], s["step_cfg"], s["template"],
                           s["camera"], SGD(), s["lpips"], s["raster"])
    tx = SGD()
    p, b, o, m, _ = body(s["params"], s["buffers"], tx.init(s["params"]),
                         s["cache"], s["frame"], None, 0, 0, s["lap"],
                         s["lap"], s["lap_w"], s["lap_w"],
                         draws=_t_tree(S.draws(RNG, 1)[0]))
    assert sorted(m) == sorted(port11["metrics"])
    S.check_metrics(port11["metrics"], _np_tree(m))
    S.check_grads(port11["grads"], tree_leaves(_np_tree(o["g"])))
    S.check_density(port11["buffers"], _np_tree(b))


def test_mesh11_nonfinite_step_is_skipped():
    """tests/test_torch_train_step.py::test_nonfinite_step_is_skipped on
    the sharded step at (1, 1), with the port's Adam: a NaN frame leaves
    the parameters, the Adam state and the density buffers as they were;
    a good frame still updates."""
    from sings_tpu_torch.dist.shard import make_mesh
    from sings_tpu_torch.dist.train_sharded import make_sharded_train_step
    from sings_tpu_torch.losses.regularizers import shard_region_laplacian
    from sings_tpu_torch.train.optim import (
        LRConfig, TrainFlags, make_optimizer,
    )

    s = _t_tree(S.port_setup())
    tx = make_optimizer(LRConfig(), TrainFlags())
    fn = make_sharded_train_step(
        make_mesh(1, dp=1), s["cfg"], s["step_cfg"], s["template"],
        s["camera"], tx, s["lpips"], s["raster"])
    srl = shard_region_laplacian(s["lap"], 1)
    params, buffers, state = s["params"], s["buffers"], tx.init(s["params"])
    d = _t_tree(S.draws(RNG, 1)[0])
    bad = dict(s["frame"], rgb=s["frame"]["rgb"] * float("nan"))

    def run(frame):
        return fn(params, buffers, state, s["cache"], frame, None, 0, 0,
                  srl, srl, s["lap_w"], s["lap_w"], draws=d)

    np_, nb, no, m = run(bad)
    assert float(m["skipped"]) == 1.0
    for a, b in zip(tree_leaves((np_, no)), tree_leaves((params, state))):
        assert torch.equal(a, b)
    for f in ("max_radii2d", "xyz_grad_accum", "grad_denom"):
        assert torch.equal(getattr(nb, f), getattr(buffers, f))
    np_, nb, no, m = run(s["frame"])
    assert float(m["skipped"]) == 0.0 and np.isfinite(float(m["loss"]))
    assert int(no.count) == int(state.count) + 1
    assert not torch.equal(np_.xyz, params.xyz)


def test_mesh14_matches_jax_and_gs1(world, port11):
    outs = world.run(sharded_step, setup=S.port_setup(), dp=1, gs=4,
                     draws=S.draws(RNG, 1), step=0)
    assert [o["mesh"] for o in outs] == [(0, g) for g in range(4)]
    got = outs[0]["runs"][0]
    for o in outs[1:]:
        for a, b in zip(tree_leaves(o["runs"][0]), tree_leaves(got)):
            np.testing.assert_array_equal(a, b)
    jp, jb, jg, jm = S.jax_step(RNG, 1, 4)
    S.check_metrics(got["metrics"], jm)
    S.check_grads(got["grads"], jg)
    S.check_density(got["buffers"], jb)
    # against gs 1: the same objective, split
    np.testing.assert_allclose(float(got["metrics"]["loss"]),
                               float(port11["metrics"]["loss"]),
                               rtol=S.LOSS_RTOL_GS)
    S.check_grads(got["grads"], tree_leaves(port11["grads"]),
                  rtol=S.GRAD_RTOL_GS, atol_rel=S.GRAD_RTOL_GS)


@pytest.fixture(scope="module")
def port22(world):
    """The port's (2, 2) step, run twice, each dp rank on its own frame
    and draws."""
    return world.run(sharded_step, setup=S.port_setup(), dp=2, gs=2,
                     draws=S.draws(RNG, 2), step=0, runs=2,
                     frames=S.frames(2))


def test_mesh22_deterministic_and_ranks_equal(port22):
    outs = port22
    assert sorted(o["mesh"] for o in outs) == [(0, 0), (0, 1), (1, 0),
                                               (1, 1)]
    ref = tree_leaves(outs[0]["runs"][0])
    for o in outs:
        for run in o["runs"]:
            for a, b in zip(tree_leaves(run), ref):
                np.testing.assert_array_equal(a, b)
    m = outs[0]["runs"][0]["metrics"]
    assert np.isfinite(m["loss"]) and m["skipped"] == 0.0
    # the two dp ranks' frames and draws differ: dp averages two
    # different objectives
    f = S.frames(2)
    assert not np.array_equal(f[0]["rgb"], f[1]["rgb"])
    assert not np.array_equal(S.draws(RNG, 2)[0]["bg"],
                              S.draws(RNG, 2)[1]["bg"])


def test_mesh22_matches_jax(port22):
    """dp 2 against JAX's (2, 2) mesh on the same two frames: the
    metrics and gradients averaged over dp, max_radii2d the max and the
    accumulators the sum over dp, at the (1, 1) tolerances."""
    got = port22[0]["runs"][0]
    jp, jb, jg, jm = S.jax_step(RNG, 2, 2, frames=S.frames(2))
    S.check_metrics(got["metrics"], jm)
    S.check_grads(got["grads"], jg)
    S.check_density(got["buffers"], jb)
