"""sings_tpu_torch kinematics held against sings_tpu: the copied body
template, SMPL forward, lbs_extra, the canonical-pose cache, and custom
motion loading with the rebase."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.kinematics import amass as jam
from sings_tpu.kinematics import body_model as jbm
from sings_tpu.kinematics import lbs as jlbs
from sings_tpu.kinematics import template as jtpl
from sings_tpu_torch.kinematics import amass as tam
from sings_tpu_torch.kinematics import body_model as tbm
from sings_tpu_torch.kinematics import lbs as tlbs
from sings_tpu_torch.kinematics import template as ttpl

FIELDS = ("v_template", "faces", "edges", "shapedirs", "j_regressor",
          "parents", "lbs_weights", "vertex_label", "vertex_id")


@pytest.mark.parametrize("kw", [
    dict(num_betas=10, n_seg=4, n_ring=8),
    dict(num_betas=10, n_seg=4, n_ring=8, hands=True, n_bone_betas=10),
])
def test_template_copy_is_array_equal(kw):
    a = jbm.synthetic_template(**kw)
    b = tbm.synthetic_template(**kw)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert a.name == b.name and a.n_bone_betas == b.n_bone_betas
    sa = jbm.subdivide_template(a, 1)
    sb = tbm.subdivide_template(b, 1)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f), f)


def test_load_template_synthetic_fallback(tmp_path):
    kw = dict(num_betas=10, n_subdivision=1, synthetic_res=0.5)
    a = jbm.load_template(str(tmp_path / "none"), "smplh", **kw)
    b = tbm.load_template(str(tmp_path / "none"), "smplh", **kw)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


def _pose_inputs(nb, b=3, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, nb).astype(np.float32) * 0.5,
            rng.randn(b, 69).astype(np.float32) * 0.3,
            rng.randn(b, 3).astype(np.float32) * 0.3)


@pytest.mark.parametrize("hands", [False, True])
def test_smpl_forward_and_cache(hands):
    tpl = jbm.synthetic_template(num_betas=10, n_seg=4, n_ring=8,
                                 hands=hands)
    jd = jtpl.DeviceTemplate.from_host(tpl)
    td = ttpl.DeviceTemplate.from_host(tpl)
    betas, pose, go = _pose_inputs(10)
    oj = jtpl.smpl_forward(jd, jnp.asarray(betas), jnp.asarray(pose),
                           jnp.asarray(go))
    ot = ttpl.smpl_forward(td, torch.tensor(betas), torch.tensor(pose),
                           torch.tensor(go))
    for f in ("verts", "joints", "A", "T", "v_shaped"):
        np.testing.assert_allclose(getattr(ot, f).numpy(),
                                   np.asarray(getattr(oj, f)), atol=2e-6,
                                   rtol=1e-5, err_msg=f)
    cj = jtpl.canonical_pose_cache(jd, jnp.asarray(betas[0]), "da_pose")
    ct = ttpl.canonical_pose_cache(td, torch.tensor(betas[0]), "da_pose")
    for f in ct._fields:
        np.testing.assert_allclose(getattr(ct, f).numpy(),
                                   np.asarray(getattr(cj, f)), atol=1e-5,
                                   rtol=1e-5, err_msg=f)


def test_lbs_extra():
    rng = np.random.RandomState(5)
    A = rng.randn(2, 24, 4, 4).astype(np.float32)
    pts = rng.randn(2, 300, 3).astype(np.float32)
    w = rng.rand(300, 24).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    vj, tj = jlbs.lbs_extra(jnp.asarray(A), jnp.asarray(pts), jnp.asarray(w))
    vt, tt = tlbs.lbs_extra(torch.tensor(A), torch.tensor(pts),
                            torch.tensor(w))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("rebase", [True, False])
def test_custom_motion_with_rebase(tmp_path, rebase):
    rng = np.random.RandomState(6)
    path = tmp_path / "motion.npz"
    np.savez(path, body_pose=rng.randn(20, 72).astype(np.float32) * 0.4,
             transl=rng.randn(20, 3).astype(np.float32))
    mj = jam.load_motion(str(path), "custom", 2, -1, 3, rebase=rebase)
    mt = tam.load_motion(str(path), "custom", 2, -1, 3, rebase=rebase)
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], atol=1e-5, rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(tam.euler_to_matrix(0.1, -0.2, 0.3),
                                  jam.euler_to_matrix(0.1, -0.2, 0.3))
