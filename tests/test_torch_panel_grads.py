"""rasterize(layout="panel") of the port held against sings_tpu's.

Values at TOL and the gradients with respect to means, scales, quats,
opacities, SH features and screen_probe at the JAX package's gradient
tolerance (atol 2e-4 * max|g|, rtol 2e-3), on a 56x40 image (padding
sub-tiles in the panel) with an overflowing tail table; the port's
panel and tiled layouts give the same image bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from sings_tpu.ops.rasterizer import api as japi
from sings_tpu_torch.ops.rasterizer import api as tapi
from test_torch_panel import TOL
from test_torch_rasterizer import make_scene


def _rasterize_both(arrays, jc, tc, bg, alive, kw, layout):
    n = arrays[0].shape[0]
    rng = np.random.RandomState(7)
    target = rng.rand(3, jc.height, jc.width).astype(np.float32)
    t_target = rng.rand(jc.height, jc.width).astype(np.float32)

    def jloss(means, scales, quats, opac, feats, probe):
        out = japi.rasterize(means, scales, quats, opac, feats, jc,
                             sh_degree=3, bg=jnp.asarray(bg),
                             alive=jnp.asarray(alive), screen_probe=probe,
                             interpret=True, chunk=8, layout=layout, **kw)
        loss = (jnp.sum((out["render"] - target) ** 2)
                + jnp.sum((out["transmittance"] - t_target) ** 2))
        return loss, out["render"]

    ja = [jnp.asarray(a) for a in arrays] + [jnp.zeros((n, 2))]
    (_, jimg), gj = jax.value_and_grad(jloss, argnums=tuple(range(6)),
                                       has_aux=True)(*ja)
    ta = [torch.tensor(np.array(a), requires_grad=True) for a in arrays]
    probe = torch.zeros((n, 2), requires_grad=True)
    out = tapi.rasterize(*ta, tc, sh_degree=3, bg=torch.tensor(bg),
                         alive=torch.tensor(alive), screen_probe=probe,
                         chunk=8, layout=layout, **kw)
    loss = (torch.sum((out["render"] - torch.tensor(target)) ** 2)
            + torch.sum((out["transmittance"] - torch.tensor(t_target))
                        ** 2))
    gt = torch.autograd.grad(loss, ta + [probe])
    return (out["render"].detach(), [g.numpy() for g in gt],
            np.asarray(jimg), [np.asarray(g) for g in gj])


def test_rasterize_panel_layout_matches_jax():
    """56x40: padding columns in the panel, and an overflowing tail
    table."""
    kw = dict(max_span=4, main_width=2, tail_capacity=4, pair_cap=4)
    (jc, tc), arrays, bg, alive = make_scene(n=50, h=40, w=56)
    img, got, jimg, want = _rasterize_both(arrays, jc, tc, bg, alive, kw,
                                           "panel")
    np.testing.assert_allclose(img.numpy(), jimg, atol=TOL)
    names = ["means", "scales", "quats", "opacities", "features",
             "screen_probe"]
    for g, w, name in zip(got, want, names):
        assert np.isfinite(g).all(), name
        scale = max(1e-3, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=2e-4 * scale, rtol=2e-3,
                                   err_msg=name)
    # the port's two layouts: the same image bit for bit
    ta = [torch.tensor(np.array(a)) for a in arrays]
    tiled = tapi.rasterize(*ta, tc, sh_degree=3, bg=torch.tensor(bg),
                           alive=torch.tensor(alive), chunk=8, **kw)
    assert torch.equal(img, tiled["render"])
