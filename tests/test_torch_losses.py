"""The port's losses, schedules and optimizer held against sings_tpu.

SSIM, the photometric objective (fed JAX's own random draws), l2 norm,
mesh edge, the dense KNN and its edge statistic (exact: the JAX package
computes the exact top-k on the CPU), the region laplacian against both
JAX backends (gather and banded), the learning-rate schedules, and Adam
with the per-field learning-rate map against optax over 3 updates.
Values and gradients on the same numpy inputs, at the tolerances
stated per test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.losses import photometric as jph
from sings_tpu.losses import regularizers as jreg
from sings_tpu.model.avatar import AvatarParams as JParams
from sings_tpu.ops import knn as jknn
from sings_tpu.ops import schedules as jsched
from sings_tpu.ops.ssim import ssim as jssim
from sings_tpu.train import optim as joptim
from sings_tpu_torch.losses import photometric as tph
from sings_tpu_torch.losses import regularizers as treg
from sings_tpu_torch.ops import knn as tknn
from sings_tpu_torch.ops import schedules as tsched
from sings_tpu_torch.ops.ssim import ssim as tssim
from sings_tpu_torch.train import optim as toptim
from sings_tpu_torch.train.checkpoint import (
    adam_state_from_numpy, params_from_numpy, region_laplacian_from_numpy,
)
from sings_tpu_torch.tree import tree_leaves

RTOL = 1e-5  # f32 value agreement where the arithmetic is the same


def _t(x, grad=False):
    return torch.tensor(np.array(x), requires_grad=grad)


def _grad_close(got, want, name=""):
    """tests/test_rasterizer.py's gradient tolerance."""
    scale = max(1e-3, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=2e-4 * scale, rtol=2e-3,
                               err_msg=name)


def _images(seed=0, c=3, h=40, w=48):
    rng = np.random.RandomState(seed)
    a = rng.rand(c, h, w).astype(np.float32)
    b = np.clip(a + 0.2 * rng.randn(c, h, w), -0.2, 1.2).astype(np.float32)
    mask = np.zeros((h, w), np.float32)
    mask[6:34, 10:40] = 1.0
    return a, b, mask


def test_ssim_value_and_grad():
    a, b, _ = _images()
    fj = lambda x: jssim(x, jnp.asarray(b))  # noqa: E731
    vj, gj = jax.value_and_grad(fj)(jnp.asarray(a))
    ta = _t(a, True)
    vt = tssim(ta, _t(b))
    (gt,) = torch.autograd.grad(vt, ta)
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=RTOL)
    _grad_close(gt.numpy(), np.asarray(gj))
    # batched form
    np.testing.assert_allclose(
        float(tssim(_t(np.stack([a, b])), _t(np.stack([b, a])))),
        float(jssim(jnp.stack([a, b]), jnp.stack([b, a]))), rtol=RTOL)


def jax_step_draws(rng, mask, weights):
    """The random inputs sings_tpu's train step and photometric_loss
    draw from `rng`, in the port's draw_step_randoms layout."""
    k_bg, k_photo = jax.random.split(rng)
    bg = jax.random.uniform(k_bg, (3,))
    k_noise, k_patch = jax.random.split(k_photo)
    h, w = mask.shape
    noise = jax.random.uniform(k_noise, (3, h, w), jnp.float32)
    p = weights.patch_size
    half = p // 2
    k_in, k_u, k_choice = jax.random.split(k_patch, 3)
    interior = jax.lax.dynamic_slice(jnp.asarray(mask), (half, half),
                                     (h - p, w - p))
    logits = jnp.where(interior.reshape(-1) > 0, 0.0, -1e9)
    idx = jax.random.categorical(k_in, logits, shape=(weights.num_patches,))
    ys_un = jax.random.randint(k_u, (weights.num_patches,), 0, h - p)
    xs_un = jax.random.randint(k_u, (weights.num_patches,), 0, w - p)
    use = jax.random.uniform(k_choice, ()) < 0.9
    ys = jnp.where(use, idx // (w - p), ys_un)
    xs = jnp.where(use, idx % (w - p), xs_un)
    return k_photo, {"bg": _t(bg), "noise": _t(noise),
                     "ys": _t(ys).long(), "xs": _t(xs).long()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_photometric_loss_with_jax_draws(seed):
    pred, gt, mask = _images(seed)
    weights = jph.PhotometricWeights(l1=0.8, ssim=0.2, lpips=0.0,
                                     num_patches=4, patch_size=16,
                                     grad_pyramid=0.2)
    k_photo, draws = jax_step_draws(jax.random.PRNGKey(seed), mask, weights)
    bg = draws["bg"].numpy()

    def fj(x):
        return jph.photometric_loss(k_photo, x, jnp.asarray(gt),
                                    jnp.asarray(mask), jnp.asarray(bg),
                                    weights, None)

    (vj, dj), gj = jax.value_and_grad(fj, has_aux=True)(jnp.asarray(pred))
    tp = _t(pred, True)
    vt, dt = tph.photometric_loss(draws, tp, _t(gt), _t(mask), draws["bg"],
                                  tph.PhotometricWeights(*weights), None)
    (gt_,) = torch.autograd.grad(vt, tp)
    assert sorted(dt) == sorted(dj) == ["grad_pyr", "l1", "ssim"]
    for k in dj:
        np.testing.assert_allclose(float(dt[k].detach()), float(dj[k]),
                                   rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _grad_close(gt_.numpy(), np.asarray(gj))


def test_draw_step_randoms_shapes_and_ranges():
    mask = np.zeros((40, 48), np.float32)
    mask[14:22, 20:30] = 1.0
    g = torch.Generator().manual_seed(0)
    w = tph.PhotometricWeights(num_patches=64, patch_size=16)
    d = tph.draw_step_randoms(g, _t(mask), w)
    assert d["bg"].shape == (3,) and d["noise"].shape == (3, 40, 48)
    assert float(d["noise"].min()) >= 0 and float(d["noise"].max()) < 1
    ys, xs = d["ys"].numpy(), d["xs"].numpy()
    assert ys.shape == (64,) and (ys >= 0).all() and (ys < 40 - 16).all()
    assert (xs >= 0).all() and (xs < 48 - 16).all()
    # centred inside the mask (probability 0.9) or all uniform
    inside = mask[ys + 8, xs + 8] > 0
    assert inside.all() or inside.mean() < 0.3
    crops = tph.crop_patches(_t(np.arange(3 * 40 * 48, dtype=np.float32)
                                .reshape(3, 40, 48)), d["ys"], d["xs"], 16)
    assert crops.shape == (64, 3, 16, 16)
    assert float(crops[0, 1, 0, 0]) == 40 * 48 + ys[0] * 48 + xs[0]


def _reg_inputs(n=300, seed=0):
    rng = np.random.RandomState(seed)
    xyz = rng.randn(n, 3).astype(np.float32)
    off = (rng.randn(n, 3) * 0.01).astype(np.float32)
    scales = rng.uniform(0.001, 0.02, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.0, 1.0, (n, 1)).astype(np.float32)
    alive = (rng.rand(n) > 0.1).astype(np.float32)
    return xyz, off, scales, opac, alive


@pytest.mark.parametrize("with_opacity", [False, True])
def test_l2_norm_loss(with_opacity):
    _, off, scales, opac, alive = _reg_inputs()
    cfg = jreg.L2NormConfig(lambda_xyz_offsets=0.001, max_scale_threshold=0.005,
                            lambda_max_scale=0.01, lambda_min_opacity=0.001)

    def fj(o, s, op):
        return jreg.l2_norm_loss(cfg, o, s, op if with_opacity else None,
                                 jnp.asarray(alive))

    vj, gj = jax.value_and_grad(fj, argnums=(0, 1, 2))(
        jnp.asarray(off), jnp.asarray(scales), jnp.asarray(opac))
    ta = [_t(off, True), _t(scales, True), _t(opac, True)]
    vt = treg.l2_norm_loss(treg.L2NormConfig(*cfg), ta[0], ta[1],
                           ta[2] if with_opacity else None, _t(alive))
    gt = torch.autograd.grad(vt, ta, allow_unused=True)
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=RTOL)
    for g, w in zip(gt, gj):
        _grad_close(np.zeros_like(w) if g is None else g.numpy(),
                    np.asarray(w))


def test_mesh_edge_loss():
    xyz, *_ = _reg_inputs()
    rng = np.random.RandomState(1)
    edges = rng.randint(0, 300, (500, 2)).astype(np.int32)
    valid = (rng.rand(500) > 0.2).astype(np.float32)
    vj, gj = jax.value_and_grad(lambda v: jreg.mesh_edge_loss(
        v, jnp.asarray(edges), jnp.asarray(valid)))(jnp.asarray(xyz))
    tv = _t(xyz, True)
    vt = treg.mesh_edge_loss(tv, _t(edges), _t(valid))
    (gt,) = torch.autograd.grad(vt, tv)
    np.testing.assert_allclose(float(vt), float(vj), rtol=RTOL)
    _grad_close(gt.numpy(), np.asarray(gj))


@pytest.mark.parametrize("block", [4096, 128])
def test_knn_and_edge_stat_exact(block):
    xyz, _, scales, _, alive = _reg_inputs(n=700)
    dj, ij = jknn.knn(jnp.asarray(xyz), 9, valid=jnp.asarray(alive > 0),
                      block=block)
    dt, it = tknn.knn(_t(xyz), 9, valid=_t(alive > 0), block=block)
    # same top-k; |q|^2 + |p|^2 - 2 q.p rounds differently in the two
    # matmuls (the self distance, ~0, by up to a few f32 ulps of |q|^2)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert (alive[it.numpy()] > 0).all()
    sj = jreg.edge_stat(jnp.asarray(xyz), jnp.asarray(alive), k=9)
    st = treg.edge_stat(_t(xyz), _t(alive), k=9)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)
    lj = jreg.gaussians_edge_loss_from_stat(sj, jnp.asarray(scales),
                                            jnp.asarray(alive))
    lt = treg.gaussians_edge_loss(_t(xyz), _t(scales), _t(alive), k=9)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)


def _random_mesh(c=400, n_edges=1200, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 15, c)
    labels[rng.rand(c) < 0.1] = -1
    e = rng.randint(0, c, (n_edges, 2))
    e = e[e[:, 0] != e[:, 1]]
    return labels, e, rng


@pytest.mark.parametrize("jax_backend", ["gather", "banded"])
def test_region_laplacian_against_both_jax_backends(jax_backend):
    labels, edges, rng = _random_mesh()
    c = labels.shape[0]
    w_pos = rng.rand(15).astype(np.float32)
    w_col = rng.rand(15).astype(np.float32)
    anchors = rng.randn(c, 3).astype(np.float32)
    xyz = rng.randn(c, 3).astype(np.float32)
    dc = rng.randn(c, 3).astype(np.float32)
    build = (jreg.build_region_laplacian if jax_backend == "gather"
             else jreg.build_region_laplacian_banded)
    lap_j = build(edges, labels, w_pos, num_regions=15)

    def fj(a, x, d):
        return jnp.stack(lap_j.loss_fused([
            (a, jnp.asarray(w_pos), None), (x, jnp.ones(15), [6, 7]),
            (d, jnp.asarray(w_col), None)]))

    vj = fj(jnp.asarray(anchors), jnp.asarray(xyz), jnp.asarray(dc))
    gj = jax.grad(lambda *a: fj(*a).sum(), argnums=(0, 1, 2))(
        jnp.asarray(anchors), jnp.asarray(xyz), jnp.asarray(dc))
    lap_t = treg.build_region_laplacian(edges, labels, w_pos, num_regions=15)
    ta = [_t(anchors, True), _t(xyz, True), _t(dc, True)]
    vt = torch.stack(lap_t.loss_fused([
        (ta[0], _t(w_pos), None), (ta[1], torch.ones(15), [6, 7]),
        (ta[2], _t(w_col), None)]))
    gt = torch.autograd.grad(vt.sum(), ta)
    np.testing.assert_allclose(vt.detach().numpy(), np.asarray(vj),
                               rtol=1e-5)
    for g, w in zip(gt, gj):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)
    if jax_backend == "gather":  # the tables themselves, and the carry-over
        for a, b in zip(lap_t, lap_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        again = region_laplacian_from_numpy(lap_j)
        np.testing.assert_allclose(float(again.loss(ta[0].detach())),
                                   float(vt[0]), rtol=1e-6)


@pytest.mark.parametrize("name,args", [
    ("expon_lr", dict(lr_init=3.2e-4, lr_final=3.2e-6, lr_delay_mult=0.01,
                      max_steps=16000)),
    ("expon_lr", dict(lr_init=1e-3, lr_final=1e-5, lr_delay_steps=100,
                      lr_delay_mult=0.1, max_steps=500)),
    ("cosine_lr", dict(lr_init=1e-3, lr_final=1e-5, lr_delay_steps=50,
                       t_max=400)),
    ("constant_lr", dict(lr=5e-4)),
])
def test_schedules(name, args):
    fj = getattr(jsched, name)(**args)
    ft = getattr(tsched, name)(**args)
    for step in (-1, 0, 1, 37, 50, 99, 100, 399, 400, 2000, 16000, 20000):
        np.testing.assert_allclose(float(ft(step)), float(fj(step)),
                                   rtol=1e-6, err_msg=f"{name} {step}")
        np.testing.assert_allclose(float(ft(torch.tensor(step))),
                                   float(fj(step)), rtol=1e-6)


def _tiny_params(seed):
    rng = np.random.RandomState(seed)

    def r(*s):
        return rng.randn(*s).astype(np.float32)

    return JParams(
        xyz=r(20, 3),
        triplane={"grids": [[r(4, 5, 5), r(4, 5, 5), r(4, 5, 5)]]},
        geometry_dec={"net0": {"b": r(6), "w": r(12, 6)},
                      "xyz": {"b": r(3), "w": r(6, 3)}},
        appearance_dec={"net0": {"b": r(5), "w": r(12, 5)}},
        global_orient=r(2, 6), body_pose=r(2, 138), transl=r(2, 3),
        betas=r(10))


@pytest.mark.parametrize("clip", [0.0, 5.0])
def test_adam_and_lr_map_against_optax(clip):
    flags = joptim.TrainFlags(optim_pose=True, optim_betas=False,
                              optim_trans=False)
    lr = joptim.LRConfig(position_max_steps=10)
    tx = joptim.make_optimizer(lr, flags, grad_clip_norm=clip)
    pj = jax.tree.map(jnp.asarray, _tiny_params(0))
    sj = tx.init(pj)
    tt = toptim.make_optimizer(toptim.LRConfig(*lr), toptim.TrainFlags(*flags),
                               grad_clip_norm=clip)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj))
    st = tt.init(pt)
    for i in range(3):
        g = _tiny_params(10 + i)
        uj, sj = tx.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = jax.tree.map(lambda p, u: p + u, pj, uj)
        pt, st = tt.update(params_from_numpy(g), st, pt)
        for a, b in zip(tree_leaves(pt), jax.tree.leaves(pj)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    assert int(st.count) == 3
    np.testing.assert_array_equal(pt.betas.numpy(), _tiny_params(0).betas)
    # the carried-over state matches the port's own
    conv = adam_state_from_numpy(jax.tree.map(np.asarray, sj))
    assert int(conv.count) == 3
    for a, b in zip(tree_leaves(conv.nu), tree_leaves(st.nu)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
