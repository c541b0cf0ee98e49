"""One training step with each option of the port's Trainer, against
sings_tpu's step, and the Trainer accepting each option.

tests/test_torch_train_step.py's harness (a tiny synthetic-template
avatar warmed by one JAX step, carried into the port with JAX's random
draws) takes one step at step 2000, past impose_from_iter, with, in
turn, the LPIPS term at lpips_w 1.0 x random_lpips_factor 0.05 on JAX's
random features, the windowed KNN statistic, the cotangent laplacian,
and tpu.laplacian_backend banded, for which the port's Trainer builds
the gather laplacian and JAX's step takes its banded one: every loss
term at the harness's tolerance,
the gradients at the rasterizer's, the new parameters within 2% of the
learning rate (one Adam update amplifies gradient rounding where the
moments are small; the cotangent option moves one element of 16,384 by
1.7% of lr), the density buffers. The functions themselves are held in
tests/test_torch_train_option_parts.py.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.losses import regularizers as jreg
from sings_tpu.train import step as jstep
from sings_tpu_torch.config.core import load_config
from sings_tpu_torch.config.defaults import DEFAULTS
from sings_tpu_torch.losses import regularizers as treg
from sings_tpu_torch.train.trainer import Trainer
from sings_tpu_torch.train import step as tstep
from test_torch_train_option_parts import jax_lpips, tables_equal
from test_torch_train_step import (  # noqa: F401  (setup is a fixture)
    RASTER, STEP, _check_metrics, _check_state, _tiny_kit,
    _tiny_trainer_cfg, setup,
)

PARAM_ATOL = 1e-5  # 2% of the learning rate, 5e-4


# ---------------------------------------------------------------------------
# one training step with each option, against JAX's


def _option_step(s, option):
    """(JAX body, port body, JAX laplacian, port laplacian) for one
    option, over tests/test_torch_train_step.py's harness."""
    jw, tw = s.jstep_cfg.weights, s.tstep_cfg.weights
    jsc, tsc = s.jstep_cfg, s.tstep_cfg
    jlp = tlp = None
    if option == "lpips":
        jw = jw._replace(photometric=jw.photometric._replace(lpips=0.05))
        tw = tw._replace(photometric=tw.photometric._replace(lpips=0.05))
        jlp, tlp = jax_lpips()
    if option == "window":
        jsc = jsc._replace(knn_backend="window")
        tsc = tsc._replace(knn_backend="window")
    jsc, tsc = jsc._replace(weights=jw), tsc._replace(weights=tw)
    b = s.buffers
    edges = np.asarray(b.edges)[np.asarray(b.edge_valid) > 0.5]
    labels = np.where(np.asarray(b.alive) > 0.5, np.asarray(b.vertex_label),
                      -1)
    if option == "cotangent":
        faces = np.asarray(b.faces)[np.asarray(b.face_valid) > 0.5]
        args = (np.asarray(s.params.xyz), faces, labels, s.w_pos)
        jlap = jreg.build_cot_region_laplacian(*args, num_regions=15,
                                               pad_width_to=8)
        tlap = treg.build_cot_region_laplacian(*args, num_regions=15,
                                               pad_width_to=8)
    elif option == "banded":
        # the port's laplacian comes from the Trainer (_trainer_laplacian)
        jlap = jreg.build_region_laplacian_banded(edges, labels, s.w_pos,
                                                  num_regions=15)
        tlap = None
    else:
        jlap = s.jlap
        tlap = None
    if tlap is not None:
        tables_equal(tlap, jlap)
    jbody = jax.jit(jstep.make_train_step(
        s.jcfg, jsc, s.jdt, s.jcam, s.jtx, jlp, dict(RASTER, interpret=True)))
    tbody = tstep.make_train_step(s.tcfg, tsc, s.tdt, s.tcam, s.ttx, tlp,
                                  RASTER)
    return jbody, tbody, jlap, tlap


def _trainer_laplacian(s, buffers, backend):
    """The laplacian Trainer._rebuild_laplacians builds over the port's
    buffers for tpu.laplacian_backend=backend."""
    stub = types.SimpleNamespace(
        cfg=load_config(DEFAULTS, None, [f"tpu.laplacian_backend={backend}"]),
        buffers=buffers, lap_pos_w=torch.tensor(s.w_pos), _lap_pad=None,
        _lap_rows_pad=None, device=torch.device("cpu"), mesh=None)
    Trainer._rebuild_laplacians(stub)
    return stub.region_lap


@pytest.mark.parametrize("option", ["lpips", "window", "cotangent",
                                    "banded"])
def test_one_step_with_option_matches_jax(setup, option):
    s = setup
    jbody, tbody, jlap, tlap = _option_step(s, option)
    key = jax.random.PRNGKey(21)
    jlaps = (jlap, jlap, jnp.asarray(s.w_pos), jnp.asarray(s.w_col))
    jp, jb, jo, jm, jr = jbody(s.params, s.buffers, s.opt_state, s.jcache,
                               s.jbatch(1), key, jnp.asarray(STEP),
                               jnp.asarray(0), *jlaps)
    tp, tb, to, glap = s.port_state(s.params, s.buffers, s.opt_state)
    if option == "banded":
        # the gather laplacian, the harness's JAX one table for table
        glap = _trainer_laplacian(s, tb, "banded")
        tables_equal(glap, s.jlap)
    tlaps = s.tlaps(glap if tlap is None else tlap)
    tp, tb, to, tm, tr = tbody(tp, tb, to, s.tcache, s.tbatch(1), None,
                               STEP, 0, *tlaps, draws=s.draws(key, 1))
    assert sorted(tm) == sorted(jm)
    _check_metrics(tm, jm)
    assert float(tm["skipped"]) == 0.0 and float(tm["lap_pos"]) > 0
    if option == "lpips":
        assert float(tm["photo_lpips_patch"]) > 0
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=2e-5)
    _check_state(s, (tp, tb, to), (jp, jb, jo), s.opt_state, PARAM_ATOL)


# ---------------------------------------------------------------------------
# the Trainer accepts every option


@pytest.mark.parametrize("extra,lap_cls", [
    (["tpu.knn_backend=window", "human.loss.laplacian.type=cotangent"],
     treg.CotRegionLaplacian),
    (["tpu.laplacian_backend=banded"], treg.RegionLaplacian),
])
def test_trainer_builds_and_scans_each_option(tmp_path, extra, lap_cls):
    tr = Trainer(_tiny_trainer_cfg(tmp_path, extra), mode="train",
                 device="cpu", kit=_tiny_kit())
    assert isinstance(tr.region_lap, lap_cls)
    window = "tpu.knn_backend=window" in extra
    assert tr.step_cfg.knn_backend == ("window" if window else "chunk")
    frames = list(tr.kit.train_split[:2])
    batches = {"rgb": tr.images[frames], "mask": tr.masks[frames],
               "idx": frames, "smpl_scale": torch.ones((2, 1))}
    p, b, o, losses, skipped, m = tr.train_scan(
        tr.params, tr.buffers, tr.opt_state, tr.cache, batches,
        tr.step_generator, STEP, 0, tr.region_lap, tr.region_lap,
        tr.lap_pos_w, tr.lap_color_w)
    assert torch.isfinite(losses).all() and skipped.tolist() == [0.0, 0.0]
    assert float(m["lap_pos"][0]) > 0 and float(m["connect"][0]) > 0
    shape = tuple(tr.region_lap.neighbors.shape)
    tr._rebuild_laplacians()  # grow-only: the same shapes again
    assert tuple(tr.region_lap.neighbors.shape) == shape


def test_trainer_refuses_norm_laplacian(tmp_path):
    cfg = _tiny_trainer_cfg(tmp_path, ["human.loss.laplacian.type=norm",
                                       "train.init_steps=0"])
    with pytest.raises(NotImplementedError, match="norm"):
        Trainer(cfg, mode="train", device="cpu", kit=_tiny_kit())


def test_trainer_refuses_the_mesh(tmp_path):
    """tpu.mesh needs one process per rank: a mesh of dp * gs ranks in a
    process without a process group of that size raises (the JAX
    package's "only N available"), as does a gs that does not divide the
    image height. The mesh itself runs in tests/test_torch_dist_*.py."""
    for mesh in (["tpu.mesh.dp=2", "tpu.mesh.gs=1"],
                 ["tpu.mesh.dp=1", "tpu.mesh.gs=4"]):
        cfg = _tiny_trainer_cfg(tmp_path, mesh + ["train.init_steps=0"])
        with pytest.raises(ValueError, match="process group has 1"):
            Trainer(cfg, mode="train", device="cpu", kit=_tiny_kit())
