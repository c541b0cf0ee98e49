"""The port's rasterizer backward held against sings_tpu.

bin_gaussians' backward-glue tables integer for integer;
composite_bwd_plain against the Pallas composite_bwd (interpret mode)
on the same feats, offsets, forward output and cotangents, at every
slot the glue reads; the gradients of rasterize with respect to means,
scales, quats, opacities, SH features and screen_probe against
jax.grad of the JAX rasterizer at that package's own tolerance
(atol 2e-4 * max|g|, rtol 2e-3, tests/test_rasterizer.py). On the CPU
the port runs the plain version; chip_smoke.py holds the CUDA kernel
against it on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.ops.graphics import make_camera as jcam
from sings_tpu.ops.rasterizer import api as japi
from sings_tpu.ops.rasterizer import common as jcom
from sings_tpu.ops.rasterizer import pallas_kernels as jpk
from sings_tpu.ops.rasterizer import tiles as jtiles
from sings_tpu_torch.ops.graphics import make_camera as tcam
from sings_tpu_torch.ops.rasterizer import api as tapi
from sings_tpu_torch.ops.rasterizer import kernels as tk
from sings_tpu_torch.ops.rasterizer import tiles as ttiles
from test_torch_rasterizer import _g2d_torch, make_scene

GLUE = ("grad_offsets", "main_slot", "tail_slot", "tail_of_gauss",
        "overflow", "pair_slot_capacity")


def _grad_close(got, want, name):
    scale = max(1e-3, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=2e-4 * scale, rtol=2e-3,
                               err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(max_span=3, main_width=4),
    dict(max_span=3, main_width=4, pair_cap=4),
    dict(max_span=5, main_width=2, tail_capacity=2),  # tail overflow
], ids=["pair_cap_none", "pair_cap_4", "tail_overflow"])
def test_glue_tables_exact(kw):
    (jc, _), arrays, _, alive = make_scene(n=150, h=48, w=80, seed=4)
    arrays[1][:20] *= 3.0  # some wide gaussians for the tail table
    gj = jcom.preprocess(*[jnp.asarray(a) for a in arrays], jc, sh_degree=3,
                         alive=jnp.asarray(alive))
    kw = dict(kw, tile=16, n_tiles_x=5, n_tiles_y=3, align=8)
    bj = jtiles.bin_gaussians(gj, **kw)
    bt = ttiles.bin_gaussians(_g2d_torch(gj), **kw)
    for f in GLUE:
        np.testing.assert_array_equal(np.asarray(getattr(bt, f)),
                                      np.asarray(getattr(bj, f)), f)
    assert bt.pair_slot_capacity == jtiles.grad_capacity(
        bt.sorted_gauss.shape[0], 15, 8)
    if "tail_capacity" in kw:
        big = int((bt.tail_of_gauss < 2).sum())
        assert big == 2 and int(bt.overflow) > 0


def _bwd_inputs(n=80, h=40, w=56, seed=0, max_span=5, pair_cap=None):
    (jc, _), arrays, _, alive = make_scene(n=n, h=h, w=w, seed=seed)
    gj = jcom.preprocess(*[jnp.asarray(a) for a in arrays], jc, sh_degree=3,
                         alive=jnp.asarray(alive))
    ntx, nty = -(-w // 16), -(-h // 16)
    kw = dict(tile=16, n_tiles_x=ntx, n_tiles_y=nty)
    b = jtiles.bin_gaussians(gj, max_span=max_span, align=8,
                             pair_cap=pair_cap, main_width=4, **kw)
    feats, _ = japi._gather_feats(b, gj.means2d, gj.conics, gj.colors,
                                  gj.opacities, 8)
    fwd = jpk.composite_fwd(feats, b.tile_offsets, chunk=8, interpret=True,
                            **kw)
    rng = np.random.RandomState(seed + 1)
    gout = rng.randn(ntx * nty, 8, 256).astype(np.float32)
    gout[:, 4:] = 0.0
    return b, feats, fwd, jnp.asarray(gout), kw


def entry_state(feats, b, kw, chunk=8):
    """The port's plain forward's window-entry state of JAX inputs: the
    backward's starting point."""
    t = lambda x: torch.tensor(np.array(x))  # noqa: E731
    return tk.composite_fwd_plain(
        t(feats), t(b.tile_offsets), grad_offsets=t(b.grad_offsets),
        grad_cap=b.pair_slot_capacity, chunk=chunk, **kw)[1]


def _glue_read_slots(b):
    slots = np.concatenate([np.asarray(b.main_slot).ravel(),
                            np.asarray(b.tail_slot).ravel()])
    return np.unique(slots)


@pytest.mark.parametrize("case", [
    dict(), dict(h=48, w=80, max_span=3, pair_cap=4, seed=2)],
    ids=["span5", "pair_cap4"])
def test_composite_bwd_plain_matches_pallas_interpret(case):
    b, feats, fwd, gout, kw = _bwd_inputs(**case)
    cap = b.pair_slot_capacity
    want = np.asarray(jpk.composite_bwd(
        feats, b.tile_offsets, b.grad_offsets, fwd, gout, chunk=8,
        grad_cap=cap, interpret=True, **kw))
    t = lambda x: torch.tensor(np.array(x))  # noqa: E731
    got = tk.composite_bwd_plain(t(feats), t(b.tile_offsets),
                                 t(b.grad_offsets), t(fwd), t(gout),
                                 entry_state(feats, b, kw), chunk=8,
                                 grad_cap=cap, **kw).numpy()
    assert got.shape == (9, cap)
    slots = _glue_read_slots(b)
    assert cap - 1 in slots and slots.size > 100
    for r in range(9):
        _grad_close(got[r, slots], want[r, slots], f"row {r}")
    np.testing.assert_array_equal(got[:, cap - 8:], 0.0)  # spare window
    assert tk.LAUNCHES["composite_bwd"] == 0


def _grads_both(arrays, jc, tc, bg, alive, kw, loss_kind="target"):
    """Gradients of a loss of the render and transmittance w.r.t.
    means, scales, quats, opacities, features and screen_probe."""
    n = arrays[0].shape[0]
    rng = np.random.RandomState(7)
    target = rng.rand(3, jc.height, jc.width).astype(np.float32)
    t_target = rng.rand(jc.height, jc.width).astype(np.float32)

    def jloss(means, scales, quats, opac, feats, probe):
        out = japi.rasterize(means, scales, quats, opac, feats, jc,
                             sh_degree=3, bg=jnp.asarray(bg),
                             alive=jnp.asarray(alive), screen_probe=probe,
                             interpret=True, chunk=8, **kw)
        return (jnp.sum((out["render"] - target) ** 2)
                + jnp.sum((out["transmittance"] - t_target) ** 2))

    ja = [jnp.asarray(a) for a in arrays] + [jnp.zeros((n, 2))]
    gj = jax.grad(jloss, argnums=tuple(range(6)))(*ja)
    ta = [torch.tensor(np.array(a), requires_grad=True) for a in arrays]
    probe = torch.zeros((n, 2), requires_grad=True)
    out = tapi.rasterize(*ta, tc, sh_degree=3, bg=torch.tensor(bg),
                         alive=torch.tensor(alive), screen_probe=probe,
                         chunk=8, **kw)
    loss = (torch.sum((out["render"] - torch.tensor(target)) ** 2)
            + torch.sum((out["transmittance"] - torch.tensor(t_target)) ** 2))
    gt = torch.autograd.grad(loss, ta + [probe])
    return [g.numpy() for g in gt], [np.asarray(g) for g in gj]


@pytest.mark.parametrize("hw,kw", [
    ((48, 64), dict(max_span=3, pair_cap=4, main_width=4)),
    ((40, 56), dict(max_span=4, main_width=2, tail_capacity=4)),
], ids=["pair_cap4", "tail"])
def test_rasterize_gradients_match_jax(hw, kw):
    (jc, tc), arrays, bg, alive = make_scene(n=50, h=hw[0], w=hw[1])
    got, want = _grads_both(arrays, jc, tc, bg, alive, kw)
    names = ["means", "scales", "quats", "opacities", "features",
             "screen_probe"]
    for g, w, name in zip(got, want, names):
        assert np.isfinite(g).all(), name
        _grad_close(g, w, name)
    assert np.abs(want[5]).max() > 0  # the density statistic is live


def test_saturated_stack_gradients():
    """64 opaque gaussians on one spot: the walks stop at saturation in
    both packages, the gradients agree, and they fade towards the back."""
    n = 24
    means = np.tile([[0.0, 0.0, 3.0]], (n, 1)).astype(np.float32)
    means[:, 2] += np.linspace(0, 0.5, n).astype(np.float32)
    arrays = (means, np.full((n, 3), 0.2, np.float32),
              np.tile([1.0, 0, 0, 0], (n, 1)).astype(np.float32),
              np.full(n, 0.95, np.float32),
              np.random.RandomState(0).rand(n, 3).astype(np.float32))
    jc = jcam(np.eye(4), height=32, width=32, fovx=0.9, fovy=0.9)
    tc = tcam(np.eye(4), height=32, width=32, fovx=0.9, fovy=0.9)
    got, want = _grads_both(arrays, jc, tc, np.ones(3, np.float32),
                            np.ones(n, bool), dict(max_span=2))
    for g, w, name in zip(got, want, ["means", "scales", "quats", "opac",
                                      "rgb", "probe"]):
        _grad_close(g, w, name)
    # only the thin tails of the stack reach its back
    assert np.abs(got[4][-1]).max() < 0.1 * np.abs(got[4][0]).max()


def test_cuda_wrapper_refuses_cpu_tensors():
    b, feats, fwd, gout, kw = _bwd_inputs()
    t = lambda x: torch.tensor(np.array(x))  # noqa: E731
    args = (t(feats), t(b.tile_offsets), t(b.grad_offsets), t(fwd), t(gout),
            entry_state(feats, b, kw))
    with pytest.raises(ValueError, match="CUDA"):
        tk.composite_bwd_cuda(*args, chunk=8, grad_cap=b.pair_slot_capacity,
                              **kw)
    out = tk.composite_bwd(*args, chunk=8, grad_cap=b.pair_slot_capacity,
                           **kw)
    assert out.shape == (9, b.pair_slot_capacity)
    assert tk.LAUNCHES["composite_bwd"] == 0
