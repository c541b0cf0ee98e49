"""The port's case step (sings_tpu_torch/dist/train_cases.py) held
against sings_tpu's make_case_train_step at (case = 2, gs = 1).

Two cases of the tiny synthetic-template avatar of
tests/test_torch_train_step.py (one JAX warm step, carried into both
packages): a state and its perturbed copy (tests/test_dist.py's
_perturb), each with its own frame and its own camera, at step 2000
(every gate open). The JAX side runs on a (case = 2, gs = 1) mesh of
the 8-device CPU backend with the region laplacian split as
tests/test_dist.py's _srl splits it, the Pallas kernels in interpret
mode; the port side gets JAX's draws for fold_in(rng, c). Both update
with SGD at learning rate 1, as tests/test_dist.py does, so a new
parameter is the old one minus its gradient (kept in the optimizer
state, where the two are compared as well). Tolerances are
tests/test_dist.py's for the case step (metrics rtol 2e-4 / atol 1e-7;
params rtol 1e-3 / atol 1e-4 of the largest; xyz_grad_accum rtol 3e-3 /
atol 1e-4 of the largest). Then the case step with a config that says
knn_backend window (the case step's statistic stays the exact one, as
JAX's does), the port's case step against its own single-card step per
case bit for bit, and gs > 1 refused without a process group of gs
ranks (tests/test_torch_dist_gs2.py runs it on one).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sings_tpu.dist import train_cases as jcases
from sings_tpu.losses.regularizers import shard_region_laplacian
from sings_tpu.ops.graphics import make_camera as jcam
from sings_tpu_torch.dist import train_cases as tcases
from sings_tpu_torch.ops.graphics import make_camera as tcam
from sings_tpu_torch.train import step as tstep
from sings_tpu_torch.train.checkpoint import (
    buffers_from_numpy, params_from_numpy, region_laplacian_from_numpy,
)
from sings_tpu_torch.tree import tree_leaves, tree_map
from test_torch_losses import jax_step_draws
from test_torch_train_step import HW, RASTER, STEP, Setup, _np

# tests/test_dist.py's case-step tolerances
METRIC_RTOL, METRIC_ATOL = 2e-4, 1e-7
PARAM_RTOL, PARAM_ATOL_REL = 1e-3, 1e-4
ACCUM_RTOL, ACCUM_ATOL_REL = 3e-3, 1e-4
FRAMES = (1, 2)
# case 1 looks through a longer lens from a point shifted sideways
K1 = np.array([[66.0, 0, HW / 2], [0, 64.0, HW / 2], [0, 0, 1]])
W2C1 = np.eye(4)
W2C1[0, 3] = 0.05


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


class SGD:
    """The port's side of jax_sgd: new params = params - grads (the
    optimizer interface of train/optim.py), the gradients kept in the
    state."""

    def init(self, params):
        return {"g": tree_map(torch.zeros_like, params)}

    def update(self, grads, state, params):
        return tree_map(lambda p, g: p - g, params, grads), {"g": grads}


def jax_sgd():
    """optax.sgd(1.0) that keeps the gradients in its state, so that they
    are compared as computed (old minus new params would round them at
    the parameters' scale)."""
    return optax.GradientTransformation(
        init=lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        update=lambda g, state, params=None: (
            jax.tree.map(lambda x: -x, g), {"g": g}))


def _perturb(params, eps=0.02):
    return jax.tree.map(
        lambda x: x * (1.0 + eps) + 0.001
        if jnp.issubdtype(x.dtype, jnp.floating) else x, params)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    s = Setup(str(tmp_path_factory.mktemp("models")))
    # one JAX step first (as tests/test_torch_train_step.py warms it)
    p, b, o, m, _ = jax.jit(s.jbody)(
        s.params, s.buffers, s.opt_state, s.jcache, s.jbatch(0),
        jax.random.PRNGKey(100), jnp.asarray(STEP - 1), jnp.asarray(0),
        *s.jlaps())
    assert float(m["skipped"]) == 0.0
    s.params, s.buffers = p, b
    s.case_params = [s.params, _perturb(s.params)]
    s.jcams = [s.jcam, jcam(W2C1, HW, HW, K=K1)]
    s.tcams = [s.tcam, tcam(W2C1, HW, HW, K=K1)]
    s.rng = jax.random.PRNGKey(5)
    s.draws = [jax_step_draws(jax.random.fold_in(s.rng, c),
                              s.mask[f], s.jstep_cfg.weights.photometric)[1]
               for c, f in enumerate(FRAMES)]

    # the JAX case step on a (case = 2, gs = 1) mesh
    jtx = jax_sgd()
    mesh = jcases.make_case_mesh(2, 1)
    jstep_fn = jcases.make_case_train_step(
        mesh, s.jcfg, s.jstep_cfg, s.jdt, HW, HW, jtx, None,
        dict(RASTER, interpret=True))
    sp = jcases.stack_cases(s.case_params)
    srl = jcases.stack_cases([shard_region_laplacian(s.jlap, 1)] * 2)
    batch = jcases.stack_cases([s.jbatch(f) for f in FRAMES])
    sc = lambda t: jcases.shard_cases(t, mesh)  # noqa: E731
    with mesh:
        out = jstep_fn(
            sc(sp), sc(jcases.stack_cases([s.buffers] * 2)),
            sc(jax.vmap(jtx.init)(sp)),
            sc(jcases.stack_cases([s.jcache] * 2)),
            sc(jcases.stack_cases([jcases.camera_arrays(c)
                                   for c in s.jcams])),
            sc(batch), s.rng, STEP, 0, sc(srl), sc(srl),
            jnp.asarray(s.w_pos), jnp.asarray(s.w_col))
    s.jout = jax.tree.map(np.asarray, out)
    return s


def port_inputs(s):
    """The port's stacked case inputs from the same JAX states."""
    params = [params_from_numpy(_np(p)) for p in s.case_params]
    buffers = buffers_from_numpy(_np(s.buffers))
    lap = region_laplacian_from_numpy(s.jlap)
    tx = SGD()
    return dict(
        params=params, buffers=buffers, lap=lap, tx=tx,
        stacked=(tcases.stack_cases(params),
                 tcases.stack_cases([buffers] * 2),
                 tcases.stack_cases([tx.init(p) for p in params]),
                 tcases.stack_cases([s.tcache] * 2),
                 tcases.stack_cases([tcases.camera_arrays(c)
                                     for c in s.tcams]),
                 {"rgb": torch.tensor(s.rgb[list(FRAMES)]),
                  "mask": torch.tensor(s.mask[list(FRAMES)]),
                  "idx": list(FRAMES), "smpl_scale": torch.ones((2, 1))}),
        lap_stacked=tcases.stack_cases([lap] * 2))


def run_port(s, step_cfg, inputs):
    fn = tcases.make_case_train_step(s.tcfg, step_cfg, s.tdt, HW, HW,
                                     inputs["tx"], None, RASTER)
    lap = inputs["lap_stacked"]
    return fn(*inputs["stacked"], [None, None], STEP, 0, lap, lap,
              torch.tensor(s.w_pos), torch.tensor(s.w_col), draws=s.draws)


def check_against_jax(s, out):
    tp, tb, to, tm = out
    jp, jb, jo, jm = s.jout
    assert sorted(tm) == sorted(jm)
    for c in range(2):
        for k in jm:
            np.testing.assert_allclose(
                float(tm[k][c]), float(jm[k][c]), rtol=METRIC_RTOL,
                atol=METRIC_ATOL, err_msg=f"case {c}: {k}")
        for (path, a1), a2, g1, g2 in zip(
                jax.tree_util.tree_flatten_with_path(jp)[0],
                tree_leaves(tp), jax.tree.leaves(jo["g"]),
                tree_leaves(to["g"])):
            a1, a2 = np.asarray(a1)[c], a2[c].numpy()
            scale = max(np.abs(a1).max(), 1e-12)
            np.testing.assert_allclose(
                a2, a1, rtol=PARAM_RTOL, atol=PARAM_ATOL_REL * scale,
                err_msg=f"case {c}: {jax.tree_util.keystr(path)}")
            # the gradients themselves, at tests/test_dist.py's gradient
            # tolerance of the mesh (1, 1) step (the same numbers)
            g1, g2 = np.asarray(g1)[c], g2[c].numpy()
            np.testing.assert_allclose(
                g2, g1, rtol=PARAM_RTOL,
                atol=PARAM_ATOL_REL * max(np.abs(g1).max(), 1e-12),
                err_msg=f"case {c}: d/d{jax.tree_util.keystr(path)}")
        ga = jb.xyz_grad_accum[c]
        assert ga.max() > 0
        np.testing.assert_allclose(
            tb.xyz_grad_accum[c].numpy(), ga, rtol=ACCUM_RTOL,
            atol=ACCUM_ATOL_REL * float(np.abs(ga).max()))
        np.testing.assert_array_equal(tb.grad_denom[c].numpy(),
                                      jb.grad_denom[c])
        assert float(tm["skipped"][c]) == 0.0
        assert float(tm["connect"][c]) > 0
    # the perturbed case and the other camera move the result
    assert not np.allclose(tm["loss"][0].numpy(), tm["loss"][1].numpy())


@pytest.mark.parametrize("knn_backend", ["chunk", "window"])
def test_case_step_matches_jax(cases, knn_backend):
    """Per case, the port's case step equals JAX's at (case 2, gs 1);
    a config that asks for the windowed statistic still gets the exact
    one, as in JAX's case step."""
    s = cases
    step_cfg = s.tstep_cfg._replace(knn_backend=knn_backend)
    out = run_port(s, step_cfg, port_inputs(s))
    check_against_jax(s, out)


def test_case_step_is_the_single_step_per_case(cases):
    """Bit for bit: each case's slice of the case step's outputs equals
    the port's single-card step on that case's state, frame, camera and
    draws (with the exact statistic)."""
    s = cases
    inputs = port_inputs(s)
    tp, tb, to, tm = run_port(s, s.tstep_cfg, inputs)
    body = tstep.make_train_step(
        s.tcfg, s.tstep_cfg._replace(knn_backend="dense"), s.tdt, s.tcam,
        inputs["tx"], None, RASTER)
    lap = inputs["lap"]
    for c, f in enumerate(FRAMES):
        p, b, o, m, _ = body(
            inputs["params"][c], inputs["buffers"],
            inputs["tx"].init(inputs["params"][c]), s.tcache, s.tbatch(f),
            None, STEP, 0, lap, lap, torch.tensor(s.w_pos),
            torch.tensor(s.w_col), draws=s.draws[c], camera=s.tcams[c])
        for a, b_ in zip(tree_leaves((tp, tb, to)),
                         tree_leaves((p, b, o))):
            assert torch.equal(a[c], b_)
        assert sorted(m) == sorted(tm)
        for k in m:
            assert torch.equal(tm[k][c], m[k]), k


def test_case_step_draws_from_each_generator(cases):
    """Without draws, case c draws from generators[c]: two generators of
    one seed give equal cases' draws, another seed another loss."""
    s = cases
    inputs = port_inputs(s)
    fn = tcases.make_case_train_step(s.tcfg, s.tstep_cfg, s.tdt, HW, HW,
                                     inputs["tx"], None, RASTER)
    params, buffers, opt, caches, _, batch = inputs["stacked"]
    same = tcases.stack_cases([tcases.camera_arrays(s.tcam)] * 2)
    batch = dict(batch, rgb=batch["rgb"][[0, 0]], mask=batch["mask"][[0, 0]],
                 idx=[FRAMES[0]] * 2)
    params = tcases.stack_cases([inputs["params"][0]] * 2)
    lap = inputs["lap_stacked"]
    gens = [torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)]
    _, _, _, m = fn(params, buffers, opt, caches, same, batch, gens, STEP, 0,
                    lap, lap, torch.tensor(s.w_pos), torch.tensor(s.w_col))
    assert torch.equal(m["loss"][0], m["loss"][1])
    gens = [torch.Generator().manual_seed(3), torch.Generator().manual_seed(4)]
    _, _, _, m = fn(params, buffers, opt, caches, same, batch, gens, STEP, 0,
                    lap, lap, torch.tensor(s.w_pos), torch.tensor(s.w_col))
    assert not torch.equal(m["loss"][0], m["loss"][1])


def test_camera_arrays_round_trip():
    """A case's camera rebuilt from camera_arrays carries the original
    floats; the matrices are float32, as in JAX's camera_arrays."""
    cam = tcam(W2C1, HW, HW, K=K1)
    arr = tcases.camera_arrays(cam)
    jarr = jcases.camera_arrays(jcam(W2C1, HW, HW, K=K1))
    assert sorted(arr) == sorted(jarr)
    for k in arr:
        np.testing.assert_allclose(arr[k].numpy(), np.asarray(jarr[k]),
                                   rtol=1e-7, err_msg=k)
    for k in ("view", "proj", "cam_center"):
        assert arr[k].dtype == torch.float32
    assert float(arr["tan_fovx"]) == cam.tan_fovx
    assert float(arr["tan_fovy"]) == cam.tan_fovy


def test_case_step_refuses_gs():
    """gs > 1 splits each case over a process group of gs ranks (run in
    tests/test_torch_dist_gs2.py); without one it raises."""
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        tcases.make_case_train_step(None, None, None, HW, HW, None, None,
                                    {}, gs=2)
    assert tcases.make_case_mesh(2, 1) is None
