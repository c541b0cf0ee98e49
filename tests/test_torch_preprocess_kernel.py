"""The preprocess's CUDA path (csrc/preprocess.cu through
ops/rasterizer/common.py::preprocess_fwd_cuda / preprocess_bwd_cuda).

On the CPU: the argument check refuses what the kernels do not take
before any device is touched, and the launchers refuse CPU tensors.

On the card (marker `cuda`, skipped without one; this file imports no
JAX, so it runs there as `python -m pytest
tests/test_torch_preprocess_kernel.py --noconftest -o addopts= -q`): at
the cells' size (127,744 slots, 25,562 of them dead at xyz = 0, SH
(N, 16, 3) at degree 3) under the animation's and a training camera,
and at every option, the forward kernel's seven fields against the plain
forward on the same CUDA inputs (radii and mask equal everywhere, the
float fields within a few ulps; a differing radius or mask is reported
with its distance from the integer it rounds at), the backward kernel
against the plain backward, one launch each a rasterize and a backward,
and a whole render with its backward under torch's sync debug mode.
"""
import numpy as np
import pytest
import torch

from sings_tpu_torch.ops import cuda_build
from sings_tpu_torch.ops.graphics import make_camera
from sings_tpu_torch.ops.rasterizer import common as C

FIELDS = ("means2d", "depths", "conics", "colors", "radii", "mask")
# the human_complex cells: slots, dead slots (xyz = 0, alive False)
SLOTS, DEAD = 127_744, 25_562


def cell_scene(n, dead, seed, k=16, device="cpu"):
    """A seeded avatar-like cloud at 2-4 m: means, activated scales from
    sub-millimetre to ~8 cm, unit quaternions, SH features, alive; the
    first `dead` slots dead at xyz = 0 with zero features."""
    g = torch.Generator().manual_seed(seed)

    def u(*s):
        return torch.rand(*s, generator=g)

    means = torch.stack([(u(n) - 0.5) * 0.8, (u(n) - 0.5) * 1.7,
                         (u(n) - 0.5) * 0.4], -1)
    scales = torch.exp(-7.0 + 4.5 * u(n, 3))
    quats = torch.randn(n, 4, generator=g)
    quats = quats / quats.norm(dim=-1, keepdim=True)
    sh = torch.randn(n, k, 3, generator=g) * 0.3
    sh[:, 0] = (u(n, 3) - 0.5) / 0.28209479177387814
    alive = torch.ones(n, dtype=torch.bool)
    means[:dead] = 0.0
    sh[:dead] = 0.0
    alive[:dead] = False
    return [x.to(device) for x in (means, scales, quats, sh, alive)]


def cell_camera(kind, device, size=512):
    """The animation's front camera (fx 5000 at 10 m) or a training
    camera (a turned orbit at 3 m, fx 700)."""
    if kind == "anim":
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, 3] = [0.0, 0.2, 10.0]
        K = np.array([[5000.0, 0, size / 2], [0, 5000.0, size / 2],
                      [0, 0, 1]], np.float32)
    else:
        th = 0.7
        w2c = np.array([[np.cos(th), 0, -np.sin(th), 0.05],
                        [0, 1, 0, 0.1], [np.sin(th), 0, np.cos(th), 3.0],
                        [0, 0, 0, 1]], np.float32)
        K = np.array([[700.0, 0, size / 2], [0, 700.0, size / 2],
                      [0, 0, 1]], np.float32)
    return make_camera(w2c, size, size, K=K, device=device)


def _bad_args():
    """(name, input edits, spec edits) that the kernels do not take."""
    m, s, q, sh, alive = cell_scene(40, 3, 0)
    return [
        ("float64 means", dict(means3d=m.double()), {}),
        ("(N, 4) means", dict(means3d=torch.zeros(40, 4)), {}),
        ("short scales", dict(scales=s[:-1]), {}),
        ("float64 quats", dict(quats=q.double()), {}),
        ("(N, 3) quats", dict(quats=q[:, :3]), {}),
        ("float64 sh", dict(sh=sh.double()), {}),
        ("too few coefficients", dict(sh=sh[:, :9]), {}),
        ("int alive", dict(alive=alive.int()), {}),
        ("short alive", dict(alive=alive[:-1]), {}),
        ("no gaussians", dict(means3d=m[:0], scales=s[:0], quats=q[:0],
                              sh=sh[:0], alive=alive[:0]), {}),
        ("degree 4", {}, dict(sh_degree=4)),
        ("float degree", {}, dict(sh_degree=3.0)),
        ("tile 0", {}, dict(tile=0)),
        ("float64 camera", {}, dict(camera="double")),
    ]


BAD = _bad_args()


@pytest.mark.parametrize("case", range(len(BAD)),
                         ids=[name for name, _, _ in BAD])
def test_check_pre_refuses(case):
    _, edit, spec_edit = BAD[case]
    m, s, q, sh, alive = cell_scene(40, 3, 0)
    args = dict(means3d=m, scales=s, quats=q, sh=sh, alive=alive)
    args.update(edit)
    cam = cell_camera("train", "cpu")
    if spec_edit.pop("camera", None):
        cam = cam._replace(view=cam.view.double())
    spec = C.Projection(cam, 3, 1.0, 16)._replace(**spec_edit)
    with pytest.raises(ValueError, match="preprocess"):
        C._check_pre(spec, **args)


def test_check_pre_takes_every_option():
    m, s, q, sh, alive = cell_scene(40, 3, 0)
    cam = cell_camera("train", "cpu")
    for deg, feats, al in ((3, sh, alive), (0, sh[:, :1], None),
                           (2, sh, None), (1, None, alive)):
        C._check_pre(C.Projection(cam, deg, 0.5, 8), m, s, q, feats, al)


def test_cuda_launchers_refuse_cpu_tensors():
    m, s, q, sh, alive = cell_scene(40, 3, 0)
    spec = C.Projection(cell_camera("train", "cpu"), 3, 1.0, 16)
    with pytest.raises(ValueError, match="CUDA"):
        C.preprocess_fwd_cuda(spec, m, s, q, sh, alive)
    with pytest.raises(ValueError, match="CUDA"):
        C.preprocess_bwd_cuda(spec, m, s, q, sh)
    assert "preprocess" not in cuda_build._LIBS


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: csrc/preprocess.cu runs only "
                    "there (no interpret mode)")
    return torch.device("cuda")


def ulps(a, b):
    """Distance in float32 steps, elementwise; NaN against NaN is 0."""
    def key(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    d = (key(a) - key(b)).abs()
    return torch.where(torch.isnan(a) & torch.isnan(b),
                       torch.zeros_like(d), d)


def boundary_report(spec, m, s, q, sh, alive, diff) -> str:
    """Each differing gaussian's 3 sqrt(lam1) and its four tile bounds
    before floor, each with its distance from the nearest integer (the
    plain forward's values)."""
    cam, tile = spec.camera, spec.tile
    n = m.shape[0]
    p_hom4 = torch.cat([m, m.new_ones((n, 1))], 1)
    cov2d = C.project_cov3d_to_2d(
        C.build_covariance_3d(s * spec.scale_modifier, q),
        (p_hom4 @ cam.view)[:, :3], cam)
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] ** 2
    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    r3 = 3.0 * torch.sqrt((mid + torch.sqrt(
        torch.clamp_min(mid * mid - det, 0.1))).clamp_min(0.0))
    means2d, _, _, _, radii, _ = C.preprocess_fwd_plain(spec, m, s, q, sh,
                                                        alive)
    r = torch.ceil(r3)
    bounds = torch.stack([means2d[:, 0] - r, means2d[:, 1] - r,
                          means2d[:, 0] + r + tile - 1,
                          means2d[:, 1] + r + tile - 1], 1) / tile
    lines = []
    for i in diff.nonzero()[:, 0][:20].tolist():
        v = float(r3[i])
        b = bounds[i].tolist()
        lines.append(f"gaussian {i}: 3 sqrt(lam1) {v!r} "
                     f"({abs(v - round(v)):.3g} from an integer), tile "
                     f"bounds {b} ({min(abs(x - round(x)) for x in b):.3g})")
    return "\n".join(lines)


def check_forward(spec, m, s, q, sh, alive, max_ulps=4):
    want = C.preprocess_fwd_plain(spec, m, s, q, sh, alive)
    C.reset_launches()
    got = C.preprocess_fwd_cuda(spec, m, s, q, sh, alive)
    again = C.preprocess_fwd_cuda(spec, m, s, q, sh, alive)
    torch.cuda.synchronize()
    assert C.LAUNCHES == {"preprocess_fwd": 2, "preprocess_bwd": 0}
    worst = {}
    for name, a, b, c in zip(FIELDS, got, want, again):
        if b is None:
            assert a is None and c is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype in (torch.int32, torch.bool):
            assert torch.equal(a, c), f"{name}: two calls differ"
            diff = a != b
            assert not bool(diff.any()), (
                f"{name} differs at {int(diff.sum())} gaussians:\n"
                + boundary_report(spec, m, s, q, sh, alive, diff))
        else:
            assert int(ulps(a, c).max()) == 0, f"{name}: two calls differ"
            assert torch.equal(torch.isnan(a), torch.isnan(b)), name
            worst[name] = int(ulps(a, b).max())
    assert max(worst.values()) <= max_ulps, worst
    return worst


CARD_FWD = [
    ("anim frame", "anim", 3, 16, 1.0, True, None),
    ("training frame", "train", 3, 16, 1.0, True, None),
    ("degree 0, RGB", "train", 0, 0, 1.0, True, None),
    ("degree 1, no alive", "train", 1, 16, 1.0, False, None),
    ("degree 2 of 9 coefficients", "train", 2, 9, 1.0, True, None),
    ("scale modifier 0.7", "train", 3, 16, 0.7, True, None),
    ("clamped tangents", "train", 3, 16, 1.0, True, 0.05),
    ("tile 8", "anim", 3, 16, 1.0, True, "tile 8"),
    ("isotropic scales", "anim", 3, 16, 1.0, True, "isotropic"),
]


def _case(kind, deg, k, smod, alive_on, extra, device, n=SLOTS, dead=DEAD):
    m, s, q, sh, alive = cell_scene(n, dead, 20 + deg, max(k, 1), device)
    cam = cell_camera(kind, device)
    tile = 16
    if extra == "tile 8":
        tile = 8
    elif extra == "isotropic":
        s = s[:, :1].expand(-1, 3).contiguous()
    elif extra is not None:
        cam = cam._replace(clamp_tan_fovx=extra, clamp_tan_fovy=extra)
    feats = sh if k else None
    return (C.Projection(cam, deg, smod, tile), m, s, q, feats,
            alive if alive_on else None)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(CARD_FWD)),
                         ids=[c[0] for c in CARD_FWD])
def test_forward_kernel_equals_plain_on_the_card(cuda_device, case):
    _, kind, deg, k, smod, alive_on, extra = CARD_FWD[case]
    spec, m, s, q, sh, alive = _case(kind, deg, k, smod, alive_on, extra,
                                     cuda_device)
    check_forward(spec, m, s, q, sh, alive)


def rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(CARD_FWD)),
                         ids=[c[0] for c in CARD_FWD])
def test_backward_kernel_equals_plain_on_the_card(cuda_device, case):
    """The backward kernel against the plain backward on the same CUDA
    inputs and cotangents (a strided one among them), both against the
    plain backward in float64: the kernel within float32 rounding of it
    and no further from it than the plain float32 backward. Isotropic
    scales leave the covariance blind to the rotation: there d/dquats is
    zero up to rounding on every path."""
    _, kind, deg, k, smod, alive_on, extra = CARD_FWD[case]
    spec, m, s, q, sh, alive = _case(kind, deg, k, smod, alive_on, extra,
                                     cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(case)
    n = m.shape[0]
    cots = [torch.randn(n, 9, generator=g, device=cuda_device)[:, 2:4],
            torch.randn(n, generator=g, device=cuda_device),
            torch.randn(n, 3, generator=g, device=cuda_device),
            torch.randn(n, 3, generator=g, device=cuda_device)
            if sh is not None else None]
    # cotangents live where the composite gives them: on masked slots
    mask = C.preprocess_fwd_plain(spec, m, s, q, sh, alive)[5]
    cots = [None if c is None else c * mask.reshape(
        (n,) + (1,) * (c.dim() - 1)) for c in cots]
    want = C.preprocess_bwd_plain(spec, m, s, q, sh, *cots)
    C.reset_launches()
    got = C.preprocess_bwd_cuda(spec, m, s, q, sh, *cots)
    again = C.preprocess_bwd_cuda(spec, m, s, q, sh, *cots)
    torch.cuda.synchronize()
    assert C.LAUNCHES == {"preprocess_fwd": 0, "preprocess_bwd": 2}
    dspec = spec._replace(camera=spec.camera._replace(
        view=spec.camera.view.double(), proj=spec.camera.proj.double(),
        cam_center=spec.camera.cam_center.double()))
    exact = C.preprocess_bwd_plain(
        dspec, m.double(), s.double(), q.double(),
        None if sh is None else sh.double(),
        *[None if c is None else c.double() for c in cots])
    for name, a, b, c, e in zip(("means3d", "scales", "quats", "sh"), got,
                                want, again, exact):
        if b is None:
            assert a is None, name
            continue
        assert torch.equal(a, c), f"{name}: two calls differ"
        assert bool(torch.isfinite(a).all()), name
        if extra == "isotropic" and name == "quats":
            zero = 1e-5 * float(want[1].abs().max())
            assert float(a.abs().max()) <= zero
            assert float(b.abs().max()) <= zero
            continue
        err, plain_err = rel_err(a, b), rel_err(b.double(), e)
        kern_err = rel_err(a.double(), e)
        assert err < 1e-5, (name, err)
        assert kern_err <= 4 * plain_err + 1e-6, (name, kern_err, plain_err)


@pytest.mark.cuda
def test_one_launch_each_a_render_and_its_backward(cuda_device):
    """rasterize on the card: one forward launch a render (no_grad too),
    one backward launch a backward, the gradients the plain backward's;
    and a whole render and its backward never make the host wait."""
    from sings_tpu_torch.ops.rasterizer.api import rasterize

    spec, m, s, q, sh, alive = _case("train", 3, 16, 1.0, True, None,
                                     cuda_device)
    opac = torch.full((m.shape[0],), 0.6, device=cuda_device)
    kw = dict(sh_degree=3, alive=alive, chunk=128, max_span=3, pair_cap=4,
              main_width=4)
    C.reset_launches()
    with torch.no_grad():
        rasterize(m, s, q, opac, sh, spec.camera, **kw)
    assert C.LAUNCHES == {"preprocess_fwd": 1, "preprocess_bwd": 0}
    leaves = [x.clone().requires_grad_(True) for x in (m, s, q, sh)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = rasterize(*leaves[:3], opac, leaves[3], spec.camera, **kw)
        loss = (out["render"] ** 2).sum()
        grads = torch.autograd.grad(loss, leaves)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert C.LAUNCHES == {"preprocess_fwd": 2, "preprocess_bwd": 1}
    assert all(bool(torch.isfinite(x).all()) for x in grads)
    with torch.no_grad():
        torch.cuda.set_sync_debug_mode("error")
        try:
            rasterize(m, s, q, opac, sh, spec.camera, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert C.LAUNCHES == {"preprocess_fwd": 3, "preprocess_bwd": 1}
