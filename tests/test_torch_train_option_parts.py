"""The new loss and render functions of the port held against sings_tpu.

Each on the same numpy inputs as the JAX package's function, at the
tolerance stated where it is compared: the cotangent laplacian
(tests/test_fields_losses.py's grid mesh), its tables equal and its
losses and gradients at that file's tolerances; the gather laplacian,
which the port builds for every tpu.laplacian_backend, against JAX's
gather and banded laplacians on tests/test_banded_laplacian.py's random
meshes at that file's tolerances; the LPIPS
distance's gradient against jax.grad with JAX's own random features,
on random and on clipped, flat patches (max-pool ties), and the
tpu.lpips_weights npz path; densify_and_prune_vanilla;
rasterize_multi; trace and span. One training step with
each option is in tests/test_torch_train_options.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.losses import lpips as jlpips
from sings_tpu.losses import regularizers as jreg
from sings_tpu.model import density as jdens
from sings_tpu.ops.rasterizer.multi import rasterize_multi as jmulti
from sings_tpu_torch.losses import lpips as tlpips
from sings_tpu_torch.losses import regularizers as treg
from sings_tpu_torch.model import density as tdens
from sings_tpu_torch.ops import profiling
from sings_tpu_torch.ops.graphics import make_camera as tcam
from sings_tpu_torch.ops.rasterizer import api as tapi
from sings_tpu_torch.ops.rasterizer import kernels as tk
from sings_tpu_torch.ops.rasterizer.multi import rasterize_multi as tmulti

# the uniform laplacian's layouts against each other and port against
# JAX: the JAX package's tests/test_banded_laplacian.py tolerances (loss
# rtol 1e-5, gradient rtol 1e-4 with atol 1e-6 of the largest value)
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL_REL = 1e-5, 1e-4, 1e-6


def _grad_close(got, want, rtol=GRAD_RTOL, atol_rel=GRAD_ATOL_REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()))


def tables_equal(tlap, jlap):
    for name, a, b in zip(jlap._fields, tlap, jlap):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)


def _loss_and_grads(lap, terms_np):
    xs = [torch.tensor(x).requires_grad_(True) for x, _, _ in terms_np]
    outs = lap.loss_fused([(x, None if w is None else torch.tensor(w), r)
                           for x, (_, w, r) in zip(xs, terms_np)])
    total = outs[0] + 2.0 * sum(outs[1:]) if len(outs) > 1 else outs[0]
    grads = torch.autograd.grad(total, xs)
    return [float(o.detach()) for o in outs], [g.numpy() for g in grads]


def _jax_loss_and_grads(lap, terms_np):
    def tot(*xs):
        outs = lap.loss_fused([(x, None if w is None else jnp.asarray(w), r)
                               for x, (_, w, r) in zip(xs, terms_np)])
        total = outs[0] + 2.0 * sum(outs[1:]) if len(outs) > 1 else outs[0]
        return total, outs

    xs = [jnp.asarray(x) for x, _, _ in terms_np]
    grads, outs = jax.grad(tot, argnums=tuple(range(len(xs))),
                           has_aux=True)(*xs)
    return [float(o) for o in outs], [np.asarray(g) for g in grads]


def jax_lpips():
    """JAX's random-feature LPIPS network and the port's copy of it."""
    jp = jlpips.get_lpips(None, seed=0)
    tp = tlpips.lpips_params_from_numpy(
        [(np.asarray(w), np.asarray(b)) for w, b in jp.convs],
        [np.asarray(x) for x in jp.lins], jp.pretrained)
    return jp, tp


# ---------------------------------------------------------------------------
# the cotangent laplacian

def _grid_mesh(n=6, seed=0):
    """tests/test_fields_losses.py::_grid_mesh."""
    rng = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    verts = np.stack([xs.ravel(), ys.ravel(), rng.randn(n * n) * 0.1],
                     1).astype(np.float64)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces += [[a, a + 1, a + n + 1], [a, a + n + 1, a + n]]
    return verts, np.array(faces)


@pytest.mark.parametrize("pad", [False, True])
def test_cot_laplacian_matches_jax(pad):
    verts, faces = _grid_mesh()
    labels = (verts[:, 0] > 2.5).astype(np.int64)
    rw = np.array([1.0, 2.0], np.float32)
    kw = dict(num_regions=2)
    jl = jreg.build_cot_region_laplacian(verts, faces, labels, rw, **kw)
    if pad:
        kw.update(pad_rows_to=jl.neighbors.shape[0] + 13,
                  pad_width_to=jl.neighbors.shape[1] + 3)
        jl = jreg.build_cot_region_laplacian(verts, faces, labels, rw, **kw)
    tl = treg.build_cot_region_laplacian(verts, faces, labels, rw, **kw)
    tables_equal(tl, jl)
    rng = np.random.RandomState(1)
    x = rng.randn(len(verts), 3).astype(np.float32)
    y = rng.randn(len(verts), 3).astype(np.float32)
    for terms in ([(x, None, None)],
                  [(x, None, None), (y, np.ones(2, np.float32), [1])]):
        lt, gt = _loss_and_grads(tl, terms)
        lj, gj = _jax_loss_and_grads(jl, terms)
        np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL)
        for a, b in zip(gt, gj):
            _grad_close(a, b)


def test_cot_edge_weights_match_jax():
    verts, faces = _grid_mesh(5, seed=2)
    for a, b in zip(treg.cot_edge_weights(verts, faces),
                    jreg.cot_edge_weights(verts, faces)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the gather laplacian against JAX's gather and banded ones

def _random_mesh(c=300, n_edges=900, regions=4, seed=0, dead_frac=0.1):
    """tests/test_banded_laplacian.py::random_mesh."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, regions, c)
    labels[rng.rand(c) < dead_frac] = -1
    e = rng.randint(0, c, (n_edges, 2))
    e = e[e[:, 0] != e[:, 1]]
    x = rng.randn(c, 3).astype(np.float32)
    w = rng.rand(regions + 11).astype(np.float32)
    return labels, e, x, np.pad(w, (0, max(0, 15 - len(w))))[:15]


@pytest.mark.parametrize("seed,c", [(0, 300), (1, 300), (2, 1100)])
def test_gather_laplacian_matches_jax_banded_and_gather(seed, c):
    """c 1100: JAX's band in three 512-row blocks, the last one
    partial."""
    labels, e, x, w = _random_mesh(c=c, n_edges=3 * c, seed=seed)
    jb = jreg.build_region_laplacian_banded(e, labels, w, num_regions=15)
    jg = jreg.build_region_laplacian(e, labels, w, num_regions=15)
    tl = treg.build_region_laplacian(e, labels, w, num_regions=15)
    tables_equal(tl, jg)
    y = np.random.RandomState(seed + 3).randn(*x.shape).astype(np.float32)
    for terms in ([(x, None, None)], [(x, None, [1, 2])],
                  [(x, None, None), (y, np.ones(15, np.float32), [6, 7])]):
        lt, gt = _loss_and_grads(tl, terms)
        lb, gb = _jax_loss_and_grads(jb, terms)
        lg, gg = _jax_loss_and_grads(jg, terms)
        np.testing.assert_allclose(lt, lb, rtol=LOSS_RTOL)
        np.testing.assert_allclose(lt, lg, rtol=LOSS_RTOL)
        for a, b, g in zip(gt, gb, gg):
            _grad_close(a, b)
            _grad_close(a, g)


def test_gather_laplacian_no_edges_and_pad_width():
    """No edges: every labelled row is -x, as JAX's band has it. A wider
    pad_to adds only invalid slots: the same loss and gradient."""
    labels = np.array([0, 1, -1, 2])
    e = np.zeros((0, 2), np.int64)
    w = np.ones(15, np.float32)
    x = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    lap = treg.build_region_laplacian(e, labels, w)
    (lt,), _ = _loss_and_grads(lap, [(x, None, None)])
    (lb,), _ = _jax_loss_and_grads(
        jreg.build_region_laplacian_banded(e, labels, w), [(x, None, None)])
    np.testing.assert_allclose(lt, lb, rtol=1e-6)
    labels, e, x, w = _random_mesh(seed=4)
    lap1 = treg.build_region_laplacian(e, labels, w)
    d1 = lap1.neighbors.shape[1]
    lap2 = treg.build_region_laplacian(e, labels, w, pad_to=d1 + 64)
    assert lap2.neighbors.shape[1] == d1 + 64
    (l1,), (g1,) = _loss_and_grads(lap1, [(x, None, None)])
    (l2,), (g2,) = _loss_and_grads(lap2, [(x, None, None)])
    np.testing.assert_allclose(l2, l1, rtol=LOSS_RTOL)
    _grad_close(g2, g1)


# ---------------------------------------------------------------------------
# LPIPS as a training loss


def _flat_patches():
    """Patches clipped at 1.0 over flat areas, and a flat 0.3 block:
    equal values in every max-pool window there."""
    rng = np.random.RandomState(5)
    x = np.clip(rng.rand(2, 3, 32, 32) * 1.6, 0, 1).astype(np.float32)
    x[:, :, 4:20, 6:22] = 1.0
    x[1, :, 20:32, 0:16] = 0.3
    y = np.clip(x + 0.1 * rng.randn(*x.shape), 0, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("case", ["random", "flat"])
def test_lpips_gradient_matches_jax(case):
    """d lpips / d x at 32², JAX's random features; rtol 1e-4 and atol
    1e-5 of the largest value (float32 convolutions summed in another
    order)."""
    jp, tp = jax_lpips()
    if case == "random":
        rng = np.random.RandomState(0)
        x = rng.rand(2, 3, 32, 32).astype(np.float32)
        y = np.clip(x + rng.randn(*x.shape).astype(np.float32) * 0.1, 0, 1)
    else:
        x, y = _flat_patches()
    vj, gj = jax.value_and_grad(
        lambda a: jlpips.lpips_distance(jp, a, jnp.asarray(y)).sum())(
            jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    vt = tlpips.lpips_distance(tp, tx, torch.tensor(y)).sum()
    (gt,) = torch.autograd.grad(vt, tx)
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-5)
    _grad_close(gt.numpy(), gj, rtol=1e-4, atol_rel=1e-5)


def test_lpips_input_norm_is_made_once_per_device_and_dtype():
    """The input shift and scale are made once per device and dtype (a
    tensor made from host data on the card waits for its queue), with
    the lpips package's values."""
    cpu = torch.device("cpu")
    shift, scale = tlpips._input_norm(cpu, torch.float32)
    assert tlpips._input_norm(cpu, torch.float32)[0] is shift
    assert tuple(shift.shape) == tuple(scale.shape) == (1, 3, 1, 1)
    assert shift.flatten().tolist() == torch.tensor(
        (-0.030, -0.088, -0.188)).tolist()
    assert scale.flatten().tolist() == torch.tensor(
        (0.458, 0.448, 0.450)).tolist()
    assert tlpips._input_norm(cpu, torch.float64)[0].dtype == torch.float64


def test_lpips_weights_npz_round_trip(tmp_path):
    """tpu.lpips_weights: an npz in the official layout loads as
    pretrained and gives JAX's distance on the same file."""
    rng = np.random.RandomState(0)
    arrays = {}
    cin = 3
    for i, (cout, _) in enumerate(tlpips._VGG_PLAN):
        arrays[f"conv{i}_w"] = (rng.randn(3, 3, cin, cout) * 0.05).astype(
            np.float32)
        arrays[f"conv{i}_b"] = (rng.randn(cout) * 0.01).astype(np.float32)
        cin = cout
    for j, d in enumerate(tlpips._LIN_DIMS):
        arrays[f"lin{j}_w"] = rng.rand(1, d, 1, 1).astype(np.float32)
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **arrays)
    tp = tlpips.get_lpips(path)
    jp = jlpips.get_lpips(path)
    assert tp.pretrained and jp.pretrained
    x = rng.rand(1, 3, 32, 32).astype(np.float32)
    y = rng.rand(1, 3, 32, 32).astype(np.float32)
    np.testing.assert_allclose(
        tlpips.lpips_distance(tp, torch.tensor(x), torch.tensor(y)).numpy(),
        np.asarray(jlpips.lpips_distance(jp, jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-5)


# ---------------------------------------------------------------------------
# vanilla density, rasterize_multi, trace


def test_densify_and_prune_vanilla_matches_jax():
    """tests/test_density.py::test_vanilla_clone_split_prune's state,
    with max_screen_size on: every DensityResult field equal."""
    from test_density import make_state

    for screen in (None, 20.0):
        tpl, buffers, xyz, fwd, n, c = make_state()
        buffers["xyz_grad_accum"][:10] = 1.0
        fwd["scales_canon"][:5] = 0.5
        fwd["opacity"][20:30] = 0.001
        buffers["max_radii2d"][40:44] = 30.0
        kw = dict(grad_threshold=0.5, min_opacity=0.01, percent_dense=0.1,
                  densify_extent=1.0, max_screen_size=screen, max_n_gs=c)
        want = jdens.densify_and_prune_vanilla(
            {k: v.copy() for k, v in buffers.items()}, xyz.copy(), fwd,
            rng=np.random.RandomState(3), **kw)
        got = tdens.densify_and_prune_vanilla(
            {k: v.copy() for k, v in buffers.items()}, xyz.copy(), fwd,
            rng=np.random.RandomState(3), **kw)
        assert got._fields == want._fields
        for name, a, b in zip(want._fields, got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), name)
        assert got.changed and got.num_alive == n - 5 - 10 + 5 + 10 - (
            4 if screen else 0)


def test_rasterize_multi_matches_jax():
    """tests/test_rasterizer.py:131's two scenes, one translated: equal
    to JAX's rasterize_multi (tests/test_torch_rasterizer.py's 2e-5),
    and to one rasterize over the concatenation bit for bit, in one
    composite_fwd call."""
    from test_rasterizer import make_scene

    cam, m1, s1, q1, o1, f1, bg = make_scene(n=30, seed=1)
    _, m2, s2, q2, o2, f2, _ = make_scene(n=25, seed=2)
    t2 = np.array([0.3, -0.1, 0.5], np.float32)
    outs = [dict(xyz=m1, scales=s1, rotq=q1, opacity=o1, shs=f1),
            dict(xyz=m2, scales=s2, rotq=q2, opacity=o2, shs=f2)]
    kw = dict(tile=16, chunk=8, max_span=8)
    want = jmulti(outs, cam, translations=[jnp.zeros(3), jnp.asarray(t2)],
                  bg=bg, sh_degree=0, interpret=True, **kw)
    tc = tcam(np.eye(4), height=48, width=48, fovx=0.9, fovy=0.9)
    touts = [{k: torch.tensor(np.array(v)) for k, v in o.items()}
             for o in outs]
    tbg = torch.tensor(np.array(bg))
    calls = []
    real = tapi.composite_fwd
    tapi.composite_fwd = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        got = tmulti(touts, tc, translations=[np.zeros(3, np.float32), t2],
                     bg=tbg, sh_degree=0, **kw)
    finally:
        tapi.composite_fwd = real
    assert len(calls) == 1
    np.testing.assert_allclose(got["render"].numpy(),
                               np.asarray(want["render"]), atol=2e-5)
    cat = [torch.cat([touts[0][k], touts[1][k]]) for k in
           ("xyz", "scales", "rotq", "opacity", "shs")]
    cat[0] = torch.cat([touts[0]["xyz"], touts[1]["xyz"] + torch.tensor(t2)])
    single = tapi.rasterize(*cat, tc, sh_degree=0, bg=tbg, **kw)
    assert torch.equal(got["render"], single["render"])
    assert tk.LAUNCHES["composite_fwd"] == 0  # the plain version on CPU


def test_trace_and_annotate_write_named_ranges(tmp_path):
    """trace() writes a span's range, around the operation it holds,
    into the Chrome trace."""
    import json

    with profiling.trace(str(tmp_path)):
        with profiling.span("outer_stage"):
            torch.ones(8).sum()
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    ranges = [e for e in events if e.get("name") == "outer_stage"
              and e.get("cat") == "user_annotation"]
    assert len(ranges) == 1
    a, b = ranges[0]["ts"], ranges[0]["ts"] + ranges[0]["dur"]
    ops = [e for e in events if e.get("name") == "aten::sum"]
    assert ops and all(a <= e["ts"] <= b for e in ops)
