"""sings_tpu_torch kinematics held against sings_tpu: the copied body
template, SMPL forward, lbs_extra, the canonical-pose cache, custom
motion loading with the rebase, and the posing's skeleton
(kinematics/pose.py's plain version) with its joint tables."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.kinematics import amass as jam
from sings_tpu.kinematics import body_model as jbm
from sings_tpu.kinematics import lbs as jlbs
from sings_tpu.kinematics import template as jtpl
from sings_tpu.ops import rotations as jrot
from sings_tpu_torch.kinematics import amass as tam
from sings_tpu_torch.kinematics import body_model as tbm
from sings_tpu_torch.kinematics import lbs as tlbs
from sings_tpu_torch.kinematics import pose as tpose
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


# ---------------------------------------------------------------------------
# the skeleton of kinematics/pose.py (plain version) against the JAX
# package's smpl_forward(...).A @ inv_A_t2cano, in value and gradient

def _pose_rows(rng, b, six):
    """b frames' root and body rows (6D or axis-angle), the body's first
    joint at angle ~0 and its second near pi."""
    tiny = np.array([1e-9, -2e-9, 0.0], np.float32)
    near_pi = np.array([0.6, 0.0, 0.8], np.float32) * np.float32(np.pi - 1e-3)
    aa_go = (rng.randn(b, 3) * 0.5).astype(np.float32)
    aa_bp = (rng.randn(b, 23, 3) * 0.4).astype(np.float32)
    aa_bp[:, 0], aa_bp[:, 1] = tiny, near_pi
    if not six:
        return aa_go, aa_bp.reshape(b, 69)
    to6 = lambda x: np.array(jrot.axis_angle_to_rotation_6d(  # noqa: E731
        jnp.asarray(x)))
    go = to6(aa_go) + (rng.randn(b, 6) * 0.05).astype(np.float32)
    bp = to6(aa_bp)
    bp[:, 2:] += (rng.randn(b, 21, 6) * 0.05).astype(np.float32)
    return go, bp.reshape(b, 138)


def _jax_skeleton(jd, inv, go, bp, betas, six):
    b = go.shape[0]
    if six:
        go = jrot.rotation_6d_to_axis_angle(go)
        bp = jrot.rotation_6d_to_axis_angle(bp.reshape(b, -1, 6)).reshape(
            b, -1)
    out = jtpl.smpl_forward(jd, jnp.broadcast_to(betas, (b, betas.shape[0])),
                            bp, go, disable_posedirs=False)
    return out.A @ inv


@pytest.mark.parametrize("layout", ["smpl", "smplh", "smplh_mano"])
@pytest.mark.parametrize("b,six", [(1, True), (3, True), (1, False),
                                   (3, False)])
def test_skeleton_plain_against_jax(layout, b, six):
    """A @ inv_A_t2cano of J = 24 (SMPL) and J = 52 (SMPL-H, its hands at
    zero or at MANO's mean) from 6D rows (the avatar's learned pose) or
    axis-angle (a motion), a joint near angle 0 and one near pi; the
    gradients of the pose rows and betas."""
    rng = np.random.RandomState(b * 10 + six)
    tpl = jbm.synthetic_template(num_betas=10, n_seg=4, n_ring=8,
                                 hands=layout != "smpl")
    if layout == "smplh_mano":
        tpl = tpl._replace(
            hands_components=rng.randn(2, 12, 45).astype(np.float32),
            hands_mean=(rng.randn(2, 45) * 0.3).astype(np.float32))
    jd = jtpl.DeviceTemplate.from_host(tpl)
    td = ttpl.DeviceTemplate.from_host(tpl)
    nb = tpl.shapedirs.shape[2]
    inv = np.asarray(jtpl.canonical_pose_cache(
        jd, jnp.zeros(nb), "da_pose").inv_A_t2cano)
    go, bp = _pose_rows(rng, b, six)
    betas = (rng.randn(nb) * 0.5).astype(np.float32)
    cot = rng.randn(b, tpl.parents.shape[0], 4, 4).astype(np.float32)

    def jloss(go, bp, betas):
        a = _jax_skeleton(jd, jnp.asarray(inv), go, bp, betas, six)
        return jnp.sum(a * cot), a

    g_j, a_j = jax.jit(jax.grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(go), jnp.asarray(bp), jnp.asarray(betas))
    leaves = [torch.tensor(x, requires_grad=True) for x in (go, bp, betas)]
    frames = tpose.Frames(go=leaves[0], bp=leaves[1], go6=six, bp6=six,
                          betas=leaves[2], transl=torch.zeros(b, 3))
    a_t = tpose.skeleton_plain(td, torch.tensor(inv), frames)
    np.testing.assert_allclose(a_t.detach().numpy(), np.asarray(a_j),
                               atol=2e-6, rtol=1e-5)
    g_t = torch.autograd.grad((a_t * torch.tensor(cot)).sum(), leaves)
    for name, gt, gj in zip(("go", "bp", "betas"), g_t, g_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4,
                                   atol=1e-5 * np.abs(gj).max(),
                                   err_msg=name)


def test_joint_tables_are_the_regression_of_the_shaped_template():
    """The posing's joints of betas are smpl_forward's own, bit for bit
    (the same ops and shapes), and JAX's within rounding; the template's
    joint tables give full_pose's rows past the body and the parents."""
    rng = np.random.RandomState(3)
    tpl = jbm.synthetic_template(num_betas=10, n_seg=4, n_ring=8, hands=True)
    hm = (rng.randn(2, 45) * 0.3).astype(np.float32)
    tpl = tpl._replace(hands_components=rng.randn(2, 12, 45).astype(
        np.float32), hands_mean=hm)
    td = ttpl.DeviceTemplate.from_host(tpl)
    betas = (rng.randn(tpl.shapedirs.shape[2]) * 0.5).astype(np.float32)
    joints = tpose.shaped_joints(td, torch.tensor(betas))
    out = ttpl.smpl_forward(td, torch.tensor(betas)[None],
                            torch.zeros(1, 63))
    assert torch.equal(joints, tlbs.vertices2joints(td.j_regressor,
                                                    out.v_shaped)[0])
    jd = jtpl.DeviceTemplate.from_host(tpl)
    v_shaped = jd.v_template + jlbs.blend_shapes(jnp.asarray(betas)[None],
                                                 jd.shapedirs)[0]
    np.testing.assert_allclose(joints.numpy(),
                               np.asarray(jd.j_regressor @ v_shaped),
                               atol=2e-6, rtol=1e-5)
    np.testing.assert_array_equal(td.rest_pose.numpy(), hm.reshape(-1))
    assert td.parent_index.dtype == torch.int32
    np.testing.assert_array_equal(td.parent_index.numpy(), tpl.parents)
