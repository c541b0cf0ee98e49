"""sings_tpu_torch rasterizer held against sings_tpu.

preprocess field by field; bin_gaussians integer fields exactly;
composite_fwd_plain against the Pallas composite_fwd in interpret mode on
the same feats/offsets; rasterize against the JAX rasterizer at the
tolerance of tests/test_rasterizer.py (2e-5) and against the port's own
dense oracle. On the CPU the port runs the plain version; the CUDA
kernel is compared with it on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.ops.graphics import make_camera as jcam
from sings_tpu.ops.rasterizer import api as japi
from sings_tpu.ops.rasterizer import common as jcom
from sings_tpu.ops.rasterizer import pallas_kernels as jpk
from sings_tpu.ops.rasterizer import tiles as jtiles
from sings_tpu.ops.rotations import axis_angle_to_quaternion
from sings_tpu_torch.ops.graphics import make_camera as tcam
from sings_tpu_torch.ops.rasterizer import api as tapi
from sings_tpu_torch.ops.rasterizer import common as tcom
from sings_tpu_torch.ops.rasterizer import kernels as tk
from sings_tpu_torch.ops.rasterizer import tiles as ttiles
from sings_tpu_torch.ops.rasterizer.reference import composite_dense

TOL = 2e-5  # tests/test_rasterizer.py:52


def make_scene(n=60, seed=0, h=48, w=48, sh=True):
    """Numpy inputs of tests/test_rasterizer.py::make_scene, plus rows
    that exercise the culls: z on both sides of 0.2 and off-screen."""
    rng = np.random.RandomState(seed)
    means = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                      rng.uniform(2.0, 6.0, n)], -1).astype(np.float32)
    means[0] = [0.0, 0.0, 0.19]
    means[1] = [0.0, 0.0, 0.21]
    means[2] = [40.0, 0.0, 3.0]
    scales = rng.uniform(0.02, 0.15, (n, 3)).astype(np.float32)
    quats = np.asarray(axis_angle_to_quaternion(
        jnp.asarray(rng.randn(n, 3).astype(np.float32) * 0.5)))
    opac = rng.uniform(0.2, 1.0, n).astype(np.float32)
    if sh:
        feats = (rng.randn(n, 16, 3) * 0.3).astype(np.float32)
    else:
        feats = rng.rand(n, 3).astype(np.float32)
    bg = rng.rand(3).astype(np.float32)
    alive = np.ones(n, bool)
    alive[3] = False
    cams = (jcam(np.eye(4), height=h, width=w, fovx=0.9, fovy=0.7),
            tcam(np.eye(4), height=h, width=w, fovx=0.9, fovy=0.7))
    return cams, (means, scales, quats, opac, feats), bg, alive


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.tensor(np.array(a)) for a in arrays])


def _g2d_torch(g):
    return tcom.Gaussians2D(*[torch.tensor(np.array(x)) for x in g])


def test_preprocess_fields():
    (jc, tc), arrays, _, alive = make_scene()
    ja, ta = _both(arrays)
    gj = jcom.preprocess(*ja, jc, sh_degree=3, alive=jnp.asarray(alive))
    gt = tcom.preprocess(*ta, tc, sh_degree=3, alive=torch.tensor(alive))
    for f in ("means2d", "depths", "conics", "colors", "opacities"):
        np.testing.assert_allclose(getattr(gt, f).numpy(),
                                   np.asarray(getattr(gj, f)), atol=1e-5,
                                   rtol=1e-5, err_msg=f)
    np.testing.assert_array_equal(gt.radii.numpy(), np.asarray(gj.radii))
    np.testing.assert_array_equal(gt.mask.numpy(), np.asarray(gj.mask))
    assert not gt.mask[0] and gt.mask[1] and not gt.mask[2]
    assert not gt.mask[3]
    rect_j = jcom.tile_rect(gj, 16, 3, 3)
    rect_t = tcom.tile_rect(_g2d_torch(gj), 16, 3, 3)
    for a, b in zip(rect_t, rect_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


BIN_CASES = {
    "default": dict(max_span=3),
    "wide_span": dict(max_span=5, main_width=6),
    "pair_cap": dict(max_span=3, pair_cap=4, main_width=4),
    "max_pairs": dict(max_span=3, max_pairs=100),
    "no_cull": dict(max_span=3, cull=False),
    "small_tail": dict(max_span=4, main_width=2, tail_capacity=1),
}


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_bin_gaussians_exact(case):
    kw = dict(BIN_CASES[case], tile=16, n_tiles_x=5, n_tiles_y=3, align=8)
    (jc, _), arrays, _, alive = make_scene(n=120, h=48, w=80)
    means = arrays[0]
    if case == "default":
        means[10:20, 2] = 3.0  # equal depths: stable order decides
    gj = jcom.preprocess(*_both(arrays)[0], jc, sh_degree=3,
                         alive=jnp.asarray(alive))
    bj = jtiles.bin_gaussians(gj, **kw)
    bt = ttiles.bin_gaussians(_g2d_torch(gj), **kw)
    for f in bt._fields:  # the backward-glue tables included
        np.testing.assert_array_equal(np.asarray(getattr(bt, f)),
                                      np.asarray(getattr(bj, f)), f)
    if case == "max_pairs":
        assert int(bt.overflow) > 0 and int(bt.num_pairs) > 100


def test_composite_plain_matches_pallas_interpret():
    (jc, _), arrays, _, alive = make_scene(n=80, h=40, w=56)
    gj = jcom.preprocess(*_both(arrays)[0], jc, sh_degree=3,
                         alive=jnp.asarray(alive))
    kw = dict(tile=16, n_tiles_x=4, n_tiles_y=3)
    b = jtiles.bin_gaussians(gj, max_span=5, align=8, **kw)
    feats, _ = japi._gather_feats(b, gj.means2d, gj.conics, gj.colors,
                                  gj.opacities, 8)
    want = jpk.composite_fwd(feats, b.tile_offsets, chunk=8, interpret=True,
                             **kw)
    got = tk.composite_fwd_plain(torch.tensor(np.array(feats)),
                                 torch.tensor(np.array(b.tile_offsets)),
                                 chunk=8, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    assert tk.LAUNCHES["composite_fwd"] == 0


def _render_both(h, w, n=60, seed=0, **kw):
    (jc, tc), arrays, bg, alive = make_scene(n=n, seed=seed, h=h, w=w)
    ja, ta = _both(arrays)
    rj = japi.rasterize(*ja, jc, sh_degree=3, bg=jnp.asarray(bg),
                        alive=jnp.asarray(alive), interpret=True, chunk=8,
                        **kw)
    rt = tapi.rasterize(*ta, tc, sh_degree=3, bg=torch.tensor(bg),
                        alive=torch.tensor(alive), chunk=8, **kw)
    return rj, rt, (tc, ta, bg, alive)


@pytest.mark.parametrize("hw,kw", [
    ((48, 48), dict(max_span=8)),
    ((48, 80), dict(max_span=3, pair_cap=4, main_width=4)),
    ((40, 56), dict(max_span=5)),
])
def test_rasterize_matches_jax(hw, kw):
    rj, rt, _ = _render_both(*hw, **kw)
    for k in ("render", "transmittance", "means2d"):
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]),
                                   atol=TOL, err_msg=k)
    np.testing.assert_array_equal(rt["radii"].numpy(),
                                  np.asarray(rj["radii"]))


def test_rasterize_matches_dense_oracle():
    _, rt, (tc, ta, bg, alive) = _render_both(48, 80, max_span=8)
    ref = tapi.rasterize(*ta, tc, sh_degree=3, bg=torch.tensor(bg),
                         alive=torch.tensor(alive), backend="reference")
    np.testing.assert_allclose(rt["render"].numpy(), ref["render"].numpy(),
                               atol=TOL)
    g = tcom.preprocess(*ta, tc, sh_degree=3, alive=torch.tensor(alive))
    img, t = composite_dense(g, 48, 80, torch.tensor(bg))
    np.testing.assert_allclose(img.numpy(), ref["render"].numpy(), atol=0)


def test_saturated_stack_early_exit():
    """64 opaque gaussians on one spot: the termination rule and the
    per-tile exit, against JAX."""
    n = 64
    means = np.tile([[0.0, 0.0, 3.0]], (n, 1)).astype(np.float32)
    means[:, 2] += np.linspace(0, 0.5, n).astype(np.float32)
    arrays = (means, np.full((n, 3), 0.2, np.float32),
              np.tile([1.0, 0, 0, 0], (n, 1)).astype(np.float32),
              np.full(n, 0.95, np.float32),
              np.random.RandomState(0).rand(n, 3).astype(np.float32))
    ja, ta = _both(arrays)
    jc = jcam(np.eye(4), height=32, width=32, fovx=0.9, fovy=0.9)
    tc = tcam(np.eye(4), height=32, width=32, fovx=0.9, fovy=0.9)
    rj = japi.rasterize(*ja, jc, bg=jnp.ones(3), interpret=True, chunk=8,
                        max_span=8)
    rt = tapi.rasterize(*ta, tc, bg=torch.ones(3), chunk=8, max_span=8)
    np.testing.assert_allclose(rt["render"].numpy(), np.asarray(rj["render"]),
                               atol=TOL)
    assert float(rt["transmittance"].min()) < 1e-3


def test_cuda_wrapper_refuses_cpu_and_backward_raises():
    feats = torch.zeros((16, 16))
    offs = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        tk.composite_fwd_cuda(feats, offs, tile=16, chunk=8, n_tiles_x=1,
                              n_tiles_y=1)
    out = tk.composite_fwd(feats, offs, tile=16, chunk=8, n_tiles_x=1,
                           n_tiles_y=1)
    assert out.shape == (1, 8, 256) and float(out[:, 3].min()) == 1.0
    assert tk.LAUNCHES["composite_fwd"] == 0
    (_, tc), arrays, bg, _ = make_scene(n=10)
    ta = [torch.tensor(np.array(a)) for a in arrays]
    ta[0].requires_grad_(True)
    r = tapi.rasterize(*ta, tc, sh_degree=3, chunk=8)
    # the backward runs too, through the plain version on the CPU
    r["render"].sum().backward()
    assert torch.isfinite(ta[0].grad).all() and float(ta[0].grad.abs().max()) > 0
    assert tk.LAUNCHES == {"composite_fwd": 0, "composite_bwd": 0,
                           "composite_fwd_panel": 0,
                           "composite_bwd_panel": 0}
