"""The port's clamps and |x| held against JAX at a tie.

JAX passes half the cotangent where a clipped value equals its bound
(a quarter where it equals both); torch.clamp passes all of it. For
every clamp site of losses/photometric.py, ops/rasterizer/common.py and
ops/rotations.py, a value exactly on the bound, and the port's gradient
against jax.grad of the JAX package's function on the same numpy
inputs. Where a tie moves a gradient the site uses ops/clip.py's clip
(JAX's factor); where the clamp's branch gets no cotangent the test
shows that nothing moves, and the site keeps torch.clamp. Likewise
|x| at exactly 0 (jnp.abs' derivative +1 there, torch.abs' 0:
ops/clip.py's abs in the L1 terms), jax.nn.softplus at 0 (0.5) in the
geometry decoder, and jnp.maximum at SH colour 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.fields import decoders as jdec
from sings_tpu.losses import photometric as jph
from sings_tpu.ops import sh as jsh
from sings_tpu.ops import ssim as jssim
from sings_tpu.ops import graphics as jgr
from sings_tpu.ops import rotations as jrot
from sings_tpu.ops.rasterizer import common as jcommon
from sings_tpu_torch.fields import decoders as tdec
from sings_tpu_torch.losses import photometric as tph
from sings_tpu_torch.ops import clip as tclip
from sings_tpu_torch.ops import graphics as tgr
from sings_tpu_torch.ops import rotations as trot
from sings_tpu_torch.ops import sh as tsh
from sings_tpu_torch.ops import ssim as tssim
from sings_tpu_torch.ops.rasterizer import common as tcommon
from test_torch_losses import _images, jax_step_draws


def _same(got, want, rtol=1e-6, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * scale, err_msg=what)


@pytest.mark.parametrize("x,lo,hi", [
    (0.0, 0.0, 3.0), (3.0, 0.0, 3.0), (0.0, 0.0, 0.0), (-1.0, 0.0, 3.0),
    (1.0, 0.0, 3.0), (4.0, 0.0, 3.0), (1.0, None, 1.0), (2.0, None, 1.0),
    (1e-12, 1e-12, None), (0.5, 1e-12, None), (-np.inf, None, 1.0),
])
def test_clip_factor_matches_jax(x, lo, hi):
    """clip's gradient is jax.grad of jnp.clip, a missing bound too."""
    want = float(jax.grad(lambda v: jnp.clip(v, lo, hi))(jnp.float32(x)))
    t = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    out = tclip.clip(t, lo, hi)
    out.backward()
    assert float(out) == float(jnp.clip(jnp.float32(x), lo, hi))
    assert float(t.grad) == want


def test_photometric_patch_clamp_tie():
    """losses/photometric.py: the patches' pred_p.clip(max=1.0) at pixels
    exactly 1.0 (a white background no splat reaches): the grad-pyramid
    term's cotangent into pred, half there in JAX."""
    pred, _, mask = _images(5)
    pred[:, 8:30, 12:38] = 1.0
    # a target without plateaus: where both images are flat the
    # difference of their gradients is exactly 0, and jnp.abs' derivative
    # there is 1 (torch's 0), another tie than the clamp's
    gt = np.random.RandomState(6).rand(*pred.shape).astype(np.float32)
    weights = jph.PhotometricWeights(l1=0.0, ssim=0.0, lpips=0.0,
                                     num_patches=4, patch_size=16,
                                     grad_pyramid=1.0)
    k_photo, draws = jax_step_draws(jax.random.PRNGKey(5), mask, weights)
    bg = draws["bg"].numpy()
    gj = jax.grad(lambda x: jph.photometric_loss(
        k_photo, x, jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(bg),
        weights, None)[0])(jnp.asarray(pred))
    tp = torch.tensor(pred, requires_grad=True)
    vt, _ = tph.photometric_loss(draws, tp, torch.tensor(gt),
                                 torch.tensor(mask), draws["bg"],
                                 tph.PhotometricWeights(*weights), None)
    (gt_,) = torch.autograd.grad(vt, tp)
    ties = pred == 1.0
    assert float(np.abs(np.asarray(gj)[ties]).max()) > 0.0
    _same(gt_.numpy(), gj, 1e-5)


def _cameras(tan):
    w2c = np.eye(4, dtype=np.float32)
    jc = jgr.make_camera(w2c, 48, 64, fovx=1.0, fovy=1.0)
    tc = tgr.make_camera(w2c, 48, 64, fovx=1.0, fovy=1.0)
    return (jc._replace(tan_fovx=tan, tan_fovy=tan),
            tc._replace(tan_fovx=tan, tan_fovy=tan))


def test_projection_tangent_clamp_tie():
    """ops/rasterizer/common.py: txtz, tytz exactly on +-1.3 tan(fov/2)
    (x / z == 0.65 in float32 at tan 0.5): the 2D covariance's gradient
    with respect to the view-space point."""
    jc, tc = _cameras(0.5)
    lim = np.float32(1.3)
    p_view = np.array([[lim, 0.1, 2.0], [-lim, lim, 2.0], [0.2, -lim, 2.0],
                       [0.3, 0.2, 4.0]], np.float32)
    assert (p_view[:3, :2] / p_view[:3, 2:] == np.float32(0.65)).any()
    rng = np.random.RandomState(0)
    a = rng.randn(4, 3, 3).astype(np.float32)
    cov3d = (a @ a.transpose(0, 2, 1) + np.eye(3, dtype=np.float32))
    wts = rng.randn(4, 3).astype(np.float32)
    gj = jax.grad(lambda p, c: jnp.sum(jcommon.project_cov3d_to_2d(
        c, p, jc) * wts), argnums=(0, 1))(jnp.asarray(p_view),
                                          jnp.asarray(cov3d))
    tp = torch.tensor(p_view, requires_grad=True)
    tcv = torch.tensor(cov3d, requires_grad=True)
    loss = torch.sum(tcommon.project_cov3d_to_2d(tcv, tp, tc)
                     * torch.tensor(wts))
    gt_ = torch.autograd.grad(loss, (tp, tcv))
    _same(gt_[0].numpy(), gj[0], 1e-5, "p_view")
    _same(gt_[1].numpy(), gj[1], 1e-5, "cov3d")


def _rot_grads(fj, ft, x, seed=0):
    """jax.grad and the port's gradient of sum(f(x) * weights)."""
    w = np.random.RandomState(seed).randn(
        *np.asarray(fj(jnp.asarray(x))).shape).astype(np.float32)
    gj = jax.grad(lambda v: jnp.sum(fj(v) * w))(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    (gt_,) = torch.autograd.grad(torch.sum(ft(tx) * torch.tensor(w)), tx)
    return gt_.numpy(), np.asarray(gj)


def test_rotations_norm_floor_tie():
    """ops/rotations.py::_norm: a quaternion whose norm is exactly the
    1e-12 floor (four components 5e-13: the sum of squares is exact).
    The floor's cotangent is the radial part of x / |x|'s, which
    quaternion_to_matrix's quadratic terms make nonzero: the tie moves
    d/dquat (clip repairs it). quaternion_to_axis_angle depends on the
    direction only, so its radial cotangent is zero there."""
    a = np.float32(np.float32(1e-12) / 2)
    quat = np.full((1, 4), a, np.float32)
    assert float(torch.linalg.norm(torch.tensor(quat))) == float(
        np.float32(1e-12))
    for fj, ft in [(jrot.quaternion_to_matrix, trot.quaternion_to_matrix),
                   (jrot.quaternion_to_axis_angle,
                    trot.quaternion_to_axis_angle)]:
        got, want = _rot_grads(fj, ft, quat)
        _same(got, want, 1e-5, ft.__name__)


def test_rotations_w_clamp_tie_moves_nothing():
    """ops/rotations.py::quaternion_to_axis_angle's w.clamp(-1, 1) at w
    exactly 1 (and -1, flipped to 1) with xyz small but above the
    small-angle switch. w is 1 after the normalisation only while |xyz|
    < ~2.4e-4, and x / |x|'s Jacobian removes the radial (w) part of the
    cotangent up to a factor |xyz|: the tie's half moves d/dquat by less
    than float32's rounding of the other components. torch.clamp stays;
    the gradients agree to a few ulps."""
    quat = np.array([[1.0, 1e-4, 0.0, 0.0], [-1.0, 0.0, -2e-4, 1e-4],
                     [1.0, 2e-4, 1e-4, 0.0]], np.float32)
    q = torch.tensor(quat)
    assert torch.equal((q / torch.linalg.norm(q, dim=-1, keepdim=True))
                       [:, 0].abs(), torch.ones(3))
    for seed in range(3):
        got, want = _rot_grads(jrot.quaternion_to_axis_angle,
                               trot.quaternion_to_axis_angle, quat, seed)
        _same(got, want, 1e-6, f"seed {seed}")


def _diag(d):
    m = np.zeros((1, 3, 3), np.float32)
    m[0, [0, 1, 2], [0, 1, 2]] = d
    return m


def _tenth_pivot():
    """diag(0, 1, e): the fourth candidate's square 1 - 0 - 1 + e is e
    exactly, and sqrt(e) is float32(0.1); the first candidate (2 + e)
    is selected."""
    tenth = np.float32(0.1)
    e = np.float32(tenth * tenth)
    for _ in range(64):
        if float(torch.sqrt(torch.tensor(e))) == float(tenth):
            return _diag([0.0, 1.0, e])
        e = np.nextafter(e, np.float32(1.0), dtype=np.float32)
    raise AssertionError("no square with a 0.1 root")


@pytest.mark.parametrize("case", ["zero_entry", "sqrt_floor", "pivot_floor"])
def test_matrix_to_quaternion_floor_ties_move_nothing(case):
    """ops/rotations.py::matrix_to_quaternion's floors (clamp_min(0.0) of
    the four pivots' squares, _safe_sqrt's 1e-18, the candidates'
    clamp_min(0.1)): the four squares sum to 4, so the selected pivot is
    >= 1 and a tie is only ever on a candidate the argmax drops, whose
    cotangent is zero. torch.clamp stays; the gradients agree."""
    m = {"zero_entry": _diag([0.0, 0.0, 1.0]),
         "sqrt_floor": _diag([-1.0, np.float32(1e-18), 0.0]),
         "pivot_floor": None}[case]
    if m is None:
        m = _tenth_pivot()
    got, want = _rot_grads(jrot.matrix_to_quaternion,
                           trot.matrix_to_quaternion, m)
    _same(got, want, 1e-5)


def test_axis_angle_floor_ties_move_nothing():
    """quaternion_to_axis_angle's w.clamp_min(0.5) at w == 0.5 (its
    small-angle branch is not taken there) and the axis-angle
    converters' angle.clamp_min(1e-12) at |v| == 1e-12 (the small-angle
    branch is taken there, so the floored branch gets no cotangent):
    nothing moves, torch.clamp stays."""
    half = np.array([[0.5, 0.5, 0.5, 0.5]], np.float32)
    got, want = _rot_grads(jrot.quaternion_to_axis_angle,
                           trot.quaternion_to_axis_angle, half)
    _same(got, want, 1e-5, "w == 0.5")
    tiny = np.array([[np.float32(1e-12), 0.0, 0.0]], np.float32)
    for fj, ft in [(jrot.axis_angle_to_matrix, trot.axis_angle_to_matrix),
                   (jrot.axis_angle_to_quaternion,
                    trot.axis_angle_to_quaternion)]:
        got, want = _rot_grads(fj, ft, tiny)
        _same(got, want, 1e-5, ft.__name__)


@pytest.mark.parametrize("x", [0.0, -0.0, 1.5, -2.0])
def test_abs_gradient_matches_jax(x):
    want = float(jax.grad(jnp.abs)(jnp.float32(x)))
    t = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    out = tclip.abs(t)
    out.backward()
    assert float(out) == abs(x) and float(t.grad) == want


@pytest.mark.parametrize("term", ["l1", "grad_pyramid"])
def test_photometric_abs_tie(term):
    """masked_l1 and grad_pyramid_distance where prediction and target
    are equal and flat: |pred - gt| and |dpred - dgt| exactly 0, where
    jnp.abs passes +1 (torch.abs 0)."""
    pred, _, mask = _images(7)
    gt = pred.copy()
    gt[:, 20:, :] = np.random.RandomState(8).rand(*gt[:, 20:, :].shape)
    pred[:, :16, :] = 1.0
    gt[:, :16, :] = 1.0
    mask[:] = 1.0
    weights = jph.PhotometricWeights(
        l1=1.0 if term == "l1" else 0.0, ssim=0.0, lpips=0.0,
        num_patches=4, patch_size=16,
        grad_pyramid=1.0 if term == "grad_pyramid" else 0.0)
    k_photo, draws = jax_step_draws(jax.random.PRNGKey(9), mask, weights)
    bg = draws["bg"].numpy()
    gj = jax.grad(lambda x: jph.photometric_loss(
        k_photo, x, jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(bg),
        weights, None)[0])(jnp.asarray(pred))
    tp = torch.tensor(pred, requires_grad=True)
    vt, _ = tph.photometric_loss(draws, tp, torch.tensor(gt),
                                 torch.tensor(mask), draws["bg"],
                                 tph.PhotometricWeights(*weights), None)
    (gt_,) = torch.autograd.grad(vt, tp)
    assert float(np.abs(np.asarray(gj)[:, :16]).max()) > 0.0
    _same(gt_.numpy(), gj, 1e-5)


def test_geometry_softplus_tie():
    """fields/decoders.py's softplus at scales_aux exactly 0: JAX's
    derivative 0.5 (logaddexp's exp(x - out)); the forward is the
    port's log1p(exp(-|x|)) + max(x, 0) bit for bit (XLA's log1p and
    its flushed denormals differ from it by an ulp)."""
    x = np.array([0.0, -0.0, 1e-3, -3.0, 25.0, -90.0], np.float32)
    tx = torch.tensor(x)
    want_v = (torch.log1p(torch.exp(-tx.abs())) + tx.clamp_min(0)).numpy()
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(jax.nn.softplus(v)))(
        jnp.asarray(x)))
    t = torch.tensor(x, requires_grad=True)
    out = tdec.softplus(t)
    (g,) = torch.autograd.grad(out.sum(), t)
    np.testing.assert_array_equal(out.detach().numpy(), want_v)
    assert float(g[0]) == 0.5 == float(want_g[0])
    _same(g.numpy(), want_g, 1e-6)
    # through the decoder: a scales head whose output is 0 for row 0
    rng = np.random.RandomState(0)
    cfg = jdec.DecoderConfig(n_features=8)
    jp = jdec.init_geometry_decoder(jax.random.PRNGKey(0), cfg)
    jp = jax.tree.map(np.asarray, jp)
    feats = rng.randn(4, 8).astype(np.float32)
    jp["scales1"]["w"] = np.zeros_like(jp["scales1"]["w"])
    jp["scales1"]["b"] = np.zeros_like(jp["scales1"]["b"])
    gj = jax.grad(lambda p: jnp.sum(jdec.geometry_decoder(
        p, jnp.asarray(feats), cfg)["scales"]))(
            jax.tree.map(jnp.asarray, jp))
    tp = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), jp)
    out = tdec.geometry_decoder(tp, torch.tensor(feats),
                                tdec.DecoderConfig(*cfg))["scales"]
    (gb,) = torch.autograd.grad(out.sum(), tp["scales1"]["b"])
    _same(gb.numpy(), gj["scales1"]["b"], 1e-6)
    assert float(gb[0]) == 0.5 * out.shape[0] * out.shape[1]


def test_sh_colour_floor_tie():
    """ops/sh.py::sh_to_rgb at eval_sh + 0.5 exactly 0 (a dc coefficient
    of -1.7724538 in float32): jnp.maximum's half cotangent."""
    sh = np.zeros((3, 1, 3), np.float32)
    sh[0, 0] = np.float32(-1.7724538)
    sh[1, 0] = 0.3
    sh[2, 0] = -3.0
    dirs = np.tile(np.float32([[0.0, 0.0, 1.0]]), (3, 1))
    fj = lambda v: jnp.sum(jsh.sh_to_rgb(0, v, jnp.asarray(dirs)))  # noqa
    assert float(np.asarray(jsh.sh_to_rgb(0, jnp.asarray(sh),
                                          jnp.asarray(dirs)))[0, 0]) == 0.0
    gj = np.asarray(jax.grad(fj)(jnp.asarray(sh)))
    t = torch.tensor(sh, requires_grad=True)
    (g,) = torch.autograd.grad(tsh.sh_to_rgb(0, t, torch.tensor(dirs)).sum(),
                               t)
    np.testing.assert_array_equal(g.numpy(), gj)


def test_ssim_variance_floor_ties_move_nothing():
    """ops/ssim.py's variance floors max(E[x^2] - mu^2, 0) at exactly 0
    (flat 0 and flat 1 windows): the variance's own gradient there is
    2 w (x - mu) = 0, so JAX's half factor moves no more than rounding;
    torch.clamp is kept (rtol 1e-5 of the largest value)."""
    rng = np.random.RandomState(0)
    a = rng.rand(3, 24, 24).astype(np.float32)
    b = rng.rand(3, 24, 24).astype(np.float32)
    a[:, :14, :14] = b[:, :14, :14] = 0.0
    a[:, 14:, 14:] = b[:, 14:, 14:] = 1.0
    gj = jax.grad(lambda x: jssim.ssim(x, jnp.asarray(b)))(jnp.asarray(a))
    t = torch.tensor(a, requires_grad=True)
    (g,) = torch.autograd.grad(tssim.ssim(t, torch.tensor(b)), t)
    _same(g.numpy(), gj, 1e-5)
