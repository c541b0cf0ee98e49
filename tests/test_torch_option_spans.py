"""The training options' spans (ops/profiling.py::span) inside
step.losses.

Under profiling.trace() one train_step of the tiny Trainer with the
three options (the LPIPS term at lpips_w 1.0 x random_lpips_factor
0.05, tpu.knn_backend=window, the cotangent laplacian) writes
losses.lpips, losses.knn_window and losses.laplacian once each, every
one inside the step's step.losses; a step of the recipe (no LPIPS term,
the chunk statistic, the standard laplacian) writes losses.laplacian
alone. A traced options step gives the untraced one's state bit for
bit.
"""
import pytest
import torch

from sings_tpu_torch.ops import profiling
from sings_tpu_torch.tree import tree_leaves
from test_torch_spans import _inside, _one_step, _ranges
from test_torch_train_step import _tiny_kit, _tiny_trainer_cfg

OPTIONS = ["train.init_steps=0", "tpu.random_lpips_factor=0.05",
           "tpu.knn_backend=window", "human.loss.laplacian.type=cotangent"]
OPTION_SPANS = ("losses.lpips", "losses.knn_window", "losses.laplacian")


def _trainer(tmp, extra):
    from sings_tpu_torch.train.trainer import Trainer

    return Trainer(_tiny_trainer_cfg(tmp, extra), mode="train",
                   device="cpu", kit=_tiny_kit(),
                   image_writer=lambda path, img: None)


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """(the options Trainer, the recipe's Trainer), one torch thread."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    options = _trainer(tmp_path_factory.mktemp("options"), OPTIONS)
    recipe = _trainer(tmp_path_factory.mktemp("recipe"),
                      ["train.init_steps=0"])
    yield options, recipe
    torch.set_num_threads(saved)


def test_the_options_trainer_takes_the_three_paths(trainers):
    from sings_tpu_torch.losses.regularizers import CotRegionLaplacian

    tr, _recipe = trainers
    assert tr.step_cfg.weights.photometric.lpips == pytest.approx(0.05)
    assert tr.step_cfg.knn_backend == "window"
    assert isinstance(tr.region_lap, CotRegionLaplacian)


def test_an_options_step_writes_each_option_span_inside_the_losses(
        trainers, tmp_path):
    tr, _recipe = trainers
    with profiling.trace(str(tmp_path)):
        _one_step(tr)
    r = _ranges(tmp_path)
    (losses,) = r["step.losses"]
    for name in OPTION_SPANS:
        assert len(r.get(name, [])) == 1, name
        assert _inside(r[name][0], losses), name
    # no span of the options nests in another
    ivs = sorted(r[n][0] for n in OPTION_SPANS)
    assert all(a[1] <= b[0] for a, b in zip(ivs, ivs[1:]))


def test_a_recipe_step_writes_the_laplacian_span_alone(trainers, tmp_path):
    _options, tr = trainers
    assert tr.step_cfg.knn_backend == "chunk"
    with profiling.trace(str(tmp_path)):
        _one_step(tr)
    r = _ranges(tmp_path)
    assert len(r["losses.laplacian"]) == 1
    assert _inside(r["losses.laplacian"][0], r["step.losses"][0])
    assert "losses.lpips" not in r and "losses.knn_window" not in r


def test_a_traced_options_step_equals_an_untraced_one(trainers, tmp_path):
    tr, _recipe = trainers
    p0, o0, m0 = _one_step(tr)
    with profiling.trace(str(tmp_path)):
        p1, o1, m1 = _one_step(tr)
    assert float(m0["photo_lpips_patch"]) > 0
    for name, a, b in (("params", p0, p1), ("mu", o0.mu, o1.mu),
                       ("nu", o0.nu, o1.nu)):
        la, lb = tree_leaves(a), tree_leaves(b)
        assert len(la) == len(lb) > 0
        assert all(torch.equal(x, y) for x, y in zip(la, lb)), name
    assert m0.keys() == m1.keys()
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
