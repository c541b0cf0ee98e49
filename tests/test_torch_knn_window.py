"""The port's windowed KNN statistic held against sings_tpu/ops/knn.py.

morton3d's codes equal JAX's bit for bit, and knn_window_stat equals
JAX's (rtol 1e-6, atol 1e-6 of the largest value: the same f32
distances, ulps apart from the matmul's summation order) on the cases
of tests/test_ops.py and on clouds whose Morton codes tie (duplicate
points, points in one cell) with dead slots: the stable sort searches
the same windows as jnp.argsort. The statistic keeps JAX's contract
against the exact one (it never underestimates), and the
regularizer's window backend equals JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.losses import regularizers as jreg
from sings_tpu.ops import knn as jknn
from sings_tpu_torch.losses import regularizers as treg
from sings_tpu_torch.ops import knn as tknn

RTOL = 1e-6


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


def _capsule(n, seed):
    rng = np.random.RandomState(seed)
    t = rng.uniform(0, 1, n).astype(np.float32)
    th = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    pts = np.stack([0.1 * np.cos(th), t * 1.6, 0.1 * np.sin(th)], -1)
    return (pts + 0.003 * rng.randn(n, 3)).astype(np.float32)


def _tied(n, seed):
    """A coarse lattice: many exact duplicates and shared cells; a tenth
    of the slots dead, parked at the origin as pruned gaussians are."""
    rng = np.random.RandomState(seed)
    pts = (np.round(rng.randn(n, 3) * 2.0) / 2.0).astype(np.float32)
    pts[: n // 8] = pts[n // 8: n // 4]        # exact duplicates
    valid = rng.rand(n) > 0.1
    pts[~valid] = 0.0
    return pts, valid


CLOUDS = {
    # tests/test_ops.py:184-235
    "window_covers_all": lambda: (np.random.RandomState(3).randn(128, 3)
                                  .astype(np.float32), None, 5, 256, 32),
    "surface_cloud": lambda: (_capsule(8192, 4), None, 9, 256, 256),
    "valid_mask": lambda: _valid_mask_case(),
    "tied_codes_dead_slots": lambda: (*_tied(2048, 6), 9, 256, 256),
}


def _valid_mask_case():
    pts = np.random.RandomState(5).randn(256, 3).astype(np.float32)
    pts[100:140] = 50.0
    valid = np.ones(256, bool)
    valid[100:140] = False
    return pts, valid, 4, 512, 64


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_morton_codes_equal_jax(name):
    pts, valid, *_ = CLOUDS[name]()
    if valid is None:
        valid = np.ones(len(pts), bool)
    want = np.asarray(jknn.morton3d(jnp.asarray(pts), jnp.asarray(valid)))
    got = tknn.morton3d(torch.tensor(pts), torch.tensor(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "tied_codes_dead_slots":
        assert len(np.unique(want)) < len(want) // 2


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_knn_window_stat_matches_jax(name, monkeypatch):
    """Three blocks a pass: several passes on every cloud."""
    monkeypatch.setattr(tknn, "BLOCKS_PER_PASS", 3)
    pts, valid, k, window, block = CLOUDS[name]()
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.tensor(valid)
    want = np.asarray(jknn.knn_window_stat(jnp.asarray(pts), k, valid=jv,
                                           window=window, block=block))
    got = tknn.knn_window_stat(torch.tensor(pts), k, valid=tv,
                               window=window, block=block)
    _close(got.numpy(), want)
    if valid is not None:
        assert np.all(got.numpy()[~valid] == 0.0)


def test_knn_window_stat_never_underestimates():
    """JAX's accuracy contract (tests/test_ops.py): against the exact
    statistic, missed neighbours only inflate it; mean error < 10%."""
    pts = torch.tensor(_capsule(8192, 4))
    d, _ = tknn.knn(pts, 9)
    exact = torch.sqrt(torch.clamp_min(d[:, 1:], 1e-24)).mean(1)
    got = tknn.knn_window_stat(pts, 9)
    rel = ((got - exact) / torch.clamp_min(exact, 1e-9)).numpy()
    assert np.all(rel > -1e-5), rel.min()
    assert np.abs(rel).mean() < 0.10


def test_edge_loss_window_backend_matches_jax():
    pts, valid = _tied(1024, 7)
    rng = np.random.RandomState(8)
    scales = (rng.rand(1024, 3) * 0.3).astype(np.float32)
    alive = valid.astype(np.float32)
    want = jreg.gaussians_edge_loss(jnp.asarray(pts), jnp.asarray(scales),
                                    jnp.asarray(alive), k=9,
                                    backend="window")
    ts = torch.tensor(scales, requires_grad=True)
    got = treg.gaussians_edge_loss(torch.tensor(pts), ts,
                                   torch.tensor(alive), k=9,
                                   backend="window")
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    stat = treg.edge_stat(torch.tensor(pts), torch.tensor(alive),
                          backend="window")
    _close(stat.numpy(), np.asarray(jreg.edge_stat(
        jnp.asarray(pts), jnp.asarray(alive), backend="window")))
    assert not stat.requires_grad
    with pytest.raises(ValueError, match="backend"):
        treg.edge_stat(torch.tensor(pts), torch.tensor(alive),
                       backend="chunk")
