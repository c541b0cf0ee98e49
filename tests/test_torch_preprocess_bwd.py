"""The preprocess's hand-derived backward held against autograd and JAX.

ops/rasterizer/common.py::preprocess is one autograd Function whose
backward is, on the CPU, preprocess_bwd_plain (the backward kernel's
arithmetic in torch ops). Here, on inputs that sit on every tie the
derivation has to honour (a view-space tangent exactly on its +-1.3 tan
clamp, an SH colour exactly 0, a quaternion whose norm is exactly the
1e-12 floor, a zero quaternion, dead slots at xyz = 0), in float64 and
float32, in both feature layouts, with and without alive, with the clamp
fields set and a scale modifier:
  * preprocess_bwd_plain against torch.autograd of preprocess_fwd_plain
    (the torch composition, whose clamps carry JAX's tie gradient);
  * preprocess's gradients against jax.vjp of the JAX package's
    preprocess with the same cotangents;
and on the CPU neither kernel is launched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.ops.graphics import make_camera as jcam
from sings_tpu.ops.rasterizer import common as jcom
from sings_tpu_torch.ops.graphics import make_camera as tcam
from sings_tpu_torch.ops.rasterizer import common as C
from sings_tpu_torch.ops.sh import C0

N = 64
# rows that sit on a tie
TAN_X, TAN_NEG, TAN_Y, SH_ZERO, Q_FLOOR, Q_ZERO = 0, 1, 2, 3, 4, 5
DEAD = slice(6, 10)
W2C = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 2.0], [0, 0, 0, 1]],
               np.float32)


def sh_zero_coefficient(dtype) -> float:
    """A coefficient s with C0 * s == -0.5 exactly in dtype: the colour
    clip(C0 * s + 0.5, 0) is then exactly 0."""
    c0 = torch.tensor(C0, dtype=dtype)
    s = torch.tensor(-0.5 / C0, dtype=dtype)
    for _ in range(64):
        v = float(c0 * s)
        if v == -0.5:
            return float(s)
        s = torch.nextafter(s, torch.tensor(
            0.0 if v < -0.5 else -1.0, dtype=dtype))
    raise AssertionError("no coefficient with C0 * s == -0.5")


def floor_quaternion(dtype):
    """A quaternion whose norm, as torch computes it, is exactly the
    float 1e-12, off the identity (whose radial cotangent is 0)."""
    floor = float(torch.tensor(1e-12, dtype=dtype))
    for q in ([5e-13] * 4, [0, 6e-13, 8e-13, 0], [0, 0, 1e-12, 0]):
        t = torch.tensor([q], dtype=dtype)
        if float(torch.linalg.norm(t, dim=-1)) == floor:
            return t[0]
    raise AssertionError("no quaternion on the norm floor")


def scene(dtype, seed, sh_layout=True, k=16):
    """(means, scales, quats, features, alive) with the tie rows."""
    rng = np.random.RandomState(seed)
    means = np.stack([rng.uniform(-0.5, 0.5, N), rng.uniform(-0.5, 0.5, N),
                      rng.uniform(0.5, 3.0, N)], -1)
    # x / z on the clamp at tan 0.5, the camera 2 in front of z = 0
    means[TAN_X] = [1.3, 0.1, 0.0]
    means[TAN_NEG] = [-1.3, 1.3, 0.0]
    means[TAN_Y] = [0.2, -1.3, 0.0]
    means[DEAD] = 0.0
    scales = rng.uniform(0.02, 0.2, (N, 3))
    quats = rng.randn(N, 4)
    feats = rng.randn(N, k, 3) * 0.3 if sh_layout else rng.rand(N, 3)
    alive = rng.rand(N) < 0.85
    alive[DEAD] = False
    t = [torch.tensor(x, dtype=dtype) for x in (means, scales, quats, feats)]
    t[2][Q_FLOOR] = floor_quaternion(dtype)
    t[2][Q_ZERO] = 0.0
    if sh_layout:
        t[3][SH_ZERO] = 0.0
        t[3][SH_ZERO, 0, 1] = sh_zero_coefficient(dtype)
        t[3][DEAD] = 0.0
    return t + [torch.tensor(alive)]


def cameras(dtype, clamp=None):
    """The port's and the JAX package's camera: 2 m in front, tan 0.5
    (1.3 tan is 0.65, x / z of the tangent rows), optionally the clamp
    fields."""
    tc = tcam(W2C, 48, 64, fovx=1.0, fovy=1.0)
    jc = jcam(W2C, 48, 64, fovx=1.0, fovy=1.0)
    kw = dict(tan_fovx=0.5, tan_fovy=0.5)
    if clamp is not None:
        kw.update(clamp_tan_fovx=clamp, clamp_tan_fovy=clamp)
    tc = tc._replace(view=tc.view.to(dtype), proj=tc.proj.to(dtype),
                     cam_center=tc.cam_center.to(dtype), **kw)
    return tc, jc._replace(**kw)


# (name, SH layout, sh_degree, alive given, clamp fields, scale_modifier)
CASES = [
    ("sh3", True, 3, True, None, 1.0),
    ("sh2 no alive", True, 2, False, None, 0.6),
    ("sh1", True, 1, True, None, 1.0),
    ("sh0", True, 0, True, None, 1.3),
    ("rgb", False, 3, True, None, 1.0),
    ("clamp tan", True, 3, True, 0.3, 1.0),
]


def _spec(case, dtype):
    _, sh_layout, deg, _, clamp, smod = case
    tc, jc = cameras(dtype, clamp)
    return C.Projection(tc, deg, smod, 16), jc


def _cotangents(out, seed):
    g = torch.Generator().manual_seed(seed)
    return [None if o is None else torch.randn(o.shape, generator=g,
                                               dtype=o.dtype)
            for o in out[:4]]


def check_ties(spec, m, s, q, feats, dtype):
    """The inputs sit on the ties they are built for."""
    lim = float(torch.tensor(0.65, dtype=dtype))
    pv = torch.cat([m, m.new_ones((N, 1))], 1) @ spec.camera.view
    if spec.camera.clamp_tan_fovx is None:
        assert float(pv[TAN_X, 0] / pv[TAN_X, 2]) == lim
        assert float(pv[TAN_NEG, 0] / pv[TAN_NEG, 2]) == -lim
        assert float(pv[TAN_Y, 1] / pv[TAN_Y, 2]) == -lim
    assert float(torch.linalg.norm(q[Q_FLOOR])) == float(
        torch.tensor(1e-12, dtype=dtype))
    if feats.dim() == 3:
        colors = C.preprocess_fwd_plain(spec, m, s, q, feats, None)[3]
        assert float(colors[SH_ZERO, 1]) == 0.0
        assert float((C0 * feats[SH_ZERO, 0, 1]).to(dtype)) == -0.5


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_plain_backward_matches_autograd(case, dtype):
    spec, _ = _spec(CASES[case], dtype)
    m, s, q, feats, alive = scene(dtype, case, CASES[case][1])
    sh = feats if feats.dim() == 3 else None
    check_ties(spec, m, s, q, feats, dtype)
    leaves = [x.clone().requires_grad_(True) for x in (m, s, q)]
    sh_leaf = None if sh is None else sh.clone().requires_grad_(True)
    out = C.preprocess_fwd_plain(spec, *leaves, sh_leaf,
                                 alive if CASES[case][3] else None)
    cots = _cotangents(out, case)
    loss = sum((o * c).sum() for o, c in zip(out[:4], cots)
               if o is not None)
    want = torch.autograd.grad(loss, leaves + ([sh_leaf] if sh_leaf
                                               is not None else []))
    got = C.preprocess_bwd_plain(spec, m, s, q, sh, *cots)
    rtol = 1e-10 if dtype == torch.float64 else 2e-5
    for name, a, b in zip(("means3d", "scales", "quats", "sh"), got, want):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol,
                                   atol=rtol * scale, err_msg=name)
    # the tie rows carry a gradient that the ties move: at the norm floor
    # half the radial part stays (all of it would leave g . q == 0)
    assert float(want[0][TAN_X].abs().sum()) > 0.0
    assert float(want[2][Q_FLOOR] @ q[Q_FLOOR]) != 0.0
    assert bool(torch.all(want[2][Q_ZERO] == 0.0))


def jax_grads(jc, arrays, alive, deg, smod, cots):
    """jax.vjp of the JAX package's preprocess in means, scales, quats and
    features, with the port's cotangents."""
    m, s, q, f = [jnp.asarray(a.numpy()) for a in arrays]
    opac = jnp.ones(N)

    def fwd(m, s, q, f):
        g = jcom.preprocess(m, s, q, opac, f, jc, sh_degree=deg,
                            scale_modifier=smod, alive=alive)
        return g.means2d, g.depths, g.conics, g.colors

    _, vjp = jax.vjp(fwd, m, s, q, f)
    return [np.asarray(x) for x in vjp(tuple(
        jnp.asarray(c.numpy()) for c in cots))]


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_preprocess_gradients_match_jax(case):
    """preprocess's Function on CPU tensors (the plain forward and
    backward) against jax.vjp, float32, at a tenth of the rasterizer
    gradient tests' tolerance. The zero quaternion's gradient is JAX's
    NaN (its norm's sqrt at 0) and the port's 0: that row is left out."""
    name, sh_layout, deg, alive_on, clamp, smod = CASES[case]
    spec, jc = _spec(CASES[case], torch.float32)
    m, s, q, feats, alive = scene(torch.float32, 10 + case, sh_layout)
    leaves = [x.clone().requires_grad_(True) for x in (m, s, q, feats)]
    C.reset_launches()
    g2d = C.preprocess(*leaves[:3], torch.ones(N), leaves[3], spec.camera,
                       sh_degree=deg, scale_modifier=smod,
                       alive=alive if alive_on else None)
    out = (g2d.means2d, g2d.depths, g2d.conics, g2d.colors)
    cots = _cotangents(out, case)
    got = torch.autograd.grad(out, leaves, cots)
    want = jax_grads(jc, (m, s, q, feats), jnp.asarray(alive.numpy())
                     if alive_on else None, deg, smod, cots)
    keep = np.ones(N, bool)
    keep[Q_ZERO] = False
    for nm, a, b in zip(("means3d", "scales", "quats", "features"), got,
                        want):
        a, b = a.numpy()[keep], b[keep]
        scale = max(1e-3, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5 * scale,
                                   err_msg=f"{name}: {nm}")
    assert C.LAUNCHES == {"preprocess_fwd": 0, "preprocess_bwd": 0}


def test_fields_and_autograd_wiring():
    """preprocess's Gaussians2D on CPU tensors: the plain forward's fields
    with grad and without, radii and mask without a gradient, RGB
    features and opacities passed through, nothing saved under no_grad,
    and a camera that requires grad refused."""
    spec, _ = _spec(CASES[0], torch.float32)
    m, s, q, feats, alive = scene(torch.float32, 0)
    opac = torch.rand(N, 1)
    want = C.preprocess_fwd_plain(spec, m, s, q, feats, alive)
    leaves = [x.clone().requires_grad_(True) for x in (m, s, q, feats)]
    g = C.preprocess(*leaves[:3], opac, leaves[3], spec.camera, sh_degree=3,
                     alive=alive)
    for name, a, b in zip(C.Gaussians2D._fields[:3] + ("colors",),
                          (g.means2d, g.depths, g.conics, g.colors), want):
        assert torch.equal(a.detach(), b), name
        assert a.grad_fn is not None, name
    assert torch.equal(g.radii, want[4]) and torch.equal(g.mask, want[5])
    assert not g.radii.requires_grad and not g.mask.requires_grad
    assert g.opacities.shape == (N,) and torch.equal(g.opacities, opac[:, 0])
    with torch.no_grad():
        g0 = C.preprocess(*leaves[:3], opac, leaves[3], spec.camera,
                          sh_degree=3, alive=alive)
    assert g0.means2d.grad_fn is None and torch.equal(g0.conics, want[2])
    rgb = torch.rand(N, 3, requires_grad=True)
    g1 = C.preprocess(*leaves[:3], opac, rgb, spec.camera)
    assert g1.colors is rgb
    cam = spec.camera._replace(view=spec.camera.view.clone()
                               .requires_grad_(True))
    with pytest.raises(ValueError, match="camera"):
        C.preprocess(*leaves[:3], opac, leaves[3], cam, sh_degree=3)
    assert C.LAUNCHES == {"preprocess_fwd": 0, "preprocess_bwd": 0}
