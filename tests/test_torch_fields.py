"""sings_tpu_torch fields held against sings_tpu: the nested and the
plain triplane forward, and the decoder MLPs, on the same parameters."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.fields import decoders as jdec
from sings_tpu.fields import triplane as jtri
from sings_tpu_torch.fields import decoders as tdec
from sings_tpu_torch.fields import triplane as ttri


def _to_torch(tree):
    return jax.tree.map(lambda x: torch.tensor(np.array(x)), tree)


@pytest.mark.parametrize("nested", [True, False])
def test_triplane_features(nested):
    cfg_j = jtri.TriplaneConfig(resolution=(16, 16, 16), out_dim=8,
                                multires=(1, 2), nested=nested)
    cfg_t = ttri.TriplaneConfig(resolution=(16, 16, 16), out_dim=8,
                                multires=(1, 2), nested=nested)
    params = jtri.init_triplane(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.RandomState(0)
    pts = rng.uniform(-1.2, 1.2, (300, 3)).astype(np.float32)
    want = jtri.triplane_features(params, jnp.asarray(pts), cfg_j)
    got = ttri.triplane_features(_to_torch(params), torch.tensor(pts), cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-5)
    # shapes of the port's own init follow the same layout
    own = ttri.init_triplane(torch.Generator().manual_seed(0), cfg_t)
    assert [[tuple(p.shape) for p in s] for s in own["grids"]] == \
        [[p.shape for p in s] for s in params["grids"]]
    lo = min(float(p.min()) for s in own["grids"] for p in s)
    hi = max(float(p.max()) for s in own["grids"] for p in s)
    assert 0.1 <= lo and hi < 0.5


def test_normalize_aabb_sign_quirk():
    pts = np.array([[-1.0, 0.0, 1.0]], np.float32)
    got = ttri.normalize_aabb(torch.tensor(pts), 1.0)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jtri.normalize_aabb(jnp.asarray(pts), 1.0)))
    np.testing.assert_allclose(got.numpy(), [[1.0, 0.0, -1.0]])


@pytest.mark.parametrize("isotropic,fixed_opacity",
                         [(True, False), (False, True)])
def test_decoders(isotropic, fixed_opacity):
    cfg_j = jdec.DecoderConfig(n_features=16, isotropic=isotropic,
                               fixed_opacity=fixed_opacity)
    cfg_t = tdec.DecoderConfig(*cfg_j)
    kg, ka = jax.random.split(jax.random.PRNGKey(1))
    pg = jdec.init_geometry_decoder(kg, cfg_j)
    pa = jdec.init_appearance_decoder(ka, cfg_j)
    rng = np.random.RandomState(1)
    feats = rng.randn(100, 16).astype(np.float32)
    off = rng.randn(100, 1).astype(np.float32)
    gj = jdec.geometry_decoder(pg, jnp.asarray(feats), cfg_j)
    gt = tdec.geometry_decoder(_to_torch(pg), torch.tensor(feats), cfg_t)
    for k in ("xyz_offsets", "scales", "scales_aux", "rotations"):
        if gj[k] is None:
            assert gt[k] is None
            continue
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(gj[k]),
                                   atol=2e-6, rtol=1e-5, err_msg=k)
    aj = jdec.appearance_decoder(pa, jnp.asarray(feats), cfg_j,
                                 opacity_offset=jnp.asarray(off))
    at = tdec.appearance_decoder(_to_torch(pa), torch.tensor(feats), cfg_t,
                                 opacity_offset=torch.tensor(off))
    for k in ("shs", "opacity"):
        np.testing.assert_allclose(at[k].numpy(), np.asarray(aj[k]),
                                   atol=2e-6, rtol=1e-5, err_msg=k)
    # the port's init has the JAX pytree's layout
    own = tdec.init_geometry_decoder(torch.Generator().manual_seed(0), cfg_t)
    assert jax.tree.map(np.shape, pg) == jax.tree.map(
        lambda x: tuple(x.shape), own)
