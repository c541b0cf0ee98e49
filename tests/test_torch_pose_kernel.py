"""The posing's CUDA path (csrc/pose.cu through
kinematics/pose.py::pose_gaussians and its launchers).

On the CPU: the argument check refuses what the kernels do not take, the
launchers refuse CPU tensors before anything is built, and the plain path
launches nothing.

On the card (marker `cuda`, skipped without one; this file imports no
JAX, so it runs there as `python -m pytest tests/test_torch_pose_kernel.py
--noconftest -o addopts= -q`): at the human_complex cells' width (the
SMPL-H synthetic template at synthetic_res 2.0 and two subdivisions,
102,182 live gaussians in 127,744 slots, 52 joints) the kernels against
the plain version on the same CUDA inputs: one frame from 6D rows with its
backward (every input's gradient), 16 frames of the animation's
axis-angle forward, each held against the plain version in float64 where
the plain version in float32 is held too; a training frame's forward
bit for bit; the training kit's root row (a half turn) entry by entry;
one launch of each kernel a forward and a backward, no host wait, the
same bits on a second call.
"""
import numpy as np
import pytest
import torch

from sings_tpu_torch.kinematics import pose as P
from sings_tpu_torch.kinematics.body_model import (
    load_template, synthetic_template,
)
from sings_tpu_torch.kinematics.template import (
    DeviceTemplate, canonical_pose_cache,
)
from sings_tpu_torch.ops import cuda_build
from sings_tpu_torch.ops.rotations import (
    axis_angle_to_rotation_6d, rotation_6d_to_axis_angle,
    rotation_6d_to_matrix,
)

SLOTS = 127_744


def small_case(device="cpu", hands=True, b=2, n=50, seed=0):
    """A small template's tables and b frames of n gaussians."""
    g = torch.Generator().manual_seed(seed)
    tpl = synthetic_template(num_betas=10, n_seg=4, n_ring=8, hands=hands)
    dt = DeviceTemplate.from_host(tpl, device)
    cache = canonical_pose_cache(dt, torch.zeros(10, device=device))
    nj = tpl.parents.shape[0]
    w = torch.rand(n, nj, generator=g) ** 6
    w = w / w.sum(1, keepdim=True)
    frames = P.Frames(
        go=torch.randn(b, 6, generator=g), bp=torch.randn(b, 138,
                                                          generator=g),
        go6=True, bp6=True, betas=torch.randn(10, generator=g) * 0.3,
        transl=torch.randn(b, 3, generator=g),
        smpl_scale=torch.rand(b, generator=g) + 0.5)
    gauss = (torch.randn(n, 3, generator=g) * 0.3,
             torch.rand(n, 3, generator=g) * 0.02,
             rotation_6d_to_matrix(torch.randn(n, 6, generator=g)), w)
    move = lambda x: x if x is None else x.to(device)  # noqa: E731
    frames = frames._replace(**{k: move(v) for k, v in frames._asdict().items()
                                if isinstance(v, torch.Tensor)})
    return dt, cache, frames, tuple(move(x) for x in gauss)


def _static(dt, cache, frames, w):
    return P._Static(dt, cache.inv_A_t2cano, w)


def _check_args(dt, cache, frames, gauss, **edits):
    xyz, scales, rotmat, w = gauss
    go, bp = P.axis_angle_rows(frames)
    args = dict(go=go, bp=bp,
                joints=P.shaped_joints(dt, frames.betas), xyz=xyz,
                scales=scales, rotmat=rotmat, transl=frames.transl,
                sscale=frames.smpl_scale, etrans=None, erot=None,
                escale=None)
    args.update(edits)
    P._check(_static(dt, cache, frames, w), **args)


@pytest.mark.parametrize("name,edits", [
    ("float64 xyz", lambda c: dict(xyz=c[3][0].double())),
    ("short scales", lambda c: dict(scales=c[3][1][:-1])),
    ("(B, 3) 6D rows", lambda c: dict(bp=c[2].bp[:, :3])),
    ("(B, 6) root rows", lambda c: dict(go=c[2].go)),
    ("short body pose", lambda c: dict(bp=c[2].bp[:, :60])),
    ("a joint short", lambda c: dict(
        joints=P.shaped_joints(c[0], c[2].betas)[:-1])),
    ("(N, 9) rotmat", lambda c: dict(rotmat=c[3][2].reshape(-1, 9))),
    ("half an ext_tfs", lambda c: dict(etrans=torch.zeros(2, 3))),
    ("(B, 1) smpl_scale", lambda c: dict(sscale=c[2].smpl_scale[:, None])),
])
def test_check_refuses(name, edits):
    case = small_case()
    _check_args(*case)
    with pytest.raises(ValueError, match="pose"):
        _check_args(*case, **edits(case))


def test_check_takes_every_option():
    dt, cache, frames, gauss = small_case(hands=False, b=3)
    ext = (torch.zeros(3, 3), torch.eye(3).expand(3, 3, 3).contiguous(),
           torch.ones(3))
    for rotmat in (gauss[2], None):
        for sscale in (frames.smpl_scale, None):
            for e in (ext, (None, None, None)):
                _check_args(dt, cache, frames, gauss[:2] + (rotmat,)
                            + gauss[3:], sscale=sscale, etrans=e[0],
                            erot=e[1], escale=e[2])
    aa = frames._replace(go=torch.zeros(3, 3), bp=torch.zeros(3, 69),
                         go6=False, bp6=False)
    _check_args(dt, cache, aa, gauss)


def test_launchers_refuse_cpu_tensors_and_plain_launches_nothing():
    dt, cache, frames, gauss = small_case()
    st = _static(dt, cache, frames, gauss[3])
    with pytest.raises(ValueError, match="CUDA"):
        P.skeleton_fwd_cuda(st, *P.axis_angle_rows(frames),
                            P.shaped_joints(dt, frames.betas), frames.transl)
    with pytest.raises(ValueError, match="CUDA"):
        P.skin_fwd_cuda(st, torch.zeros(2, 52, 12), torch.zeros(2, 24),
                        *gauss[:3], False, False)
    P.reset_launches()
    xyz, rotq, scales = P.pose_gaussians(dt, cache.inv_A_t2cano, frames,
                                         *gauss)
    assert xyz.shape == (2, 50, 3) and rotq.shape == (2, 50, 4)
    assert set(P.LAUNCHES.values()) == {0}
    assert "pose" not in cuda_build._LIBS


@pytest.mark.parametrize("go6,bp6", [(True, True), (True, False),
                                     (False, True), (False, False)])
def test_axis_angle_rows_are_the_plain_rows(go6, bp6):
    """The kernels' axis-angle rows: 6D rows through one call of
    rotation_6d_to_axis_angle over the root's and the body's rows, each
    row where skeleton_plain's two calls put it, with the same value;
    axis-angle rows pass as they are."""
    g = torch.Generator().manual_seed(4)
    go = torch.randn(3, 6, generator=g) if go6 else torch.randn(3, 3,
                                                                 generator=g)
    bp = torch.randn(3, 138 if bp6 else 69, generator=g)
    frames = P.Frames(go=go, bp=bp, go6=go6, bp6=bp6, betas=None,
                      transl=torch.zeros(3, 3))
    got_go, got_bp = P.axis_angle_rows(frames)
    want_go = rotation_6d_to_axis_angle(go) if go6 else go
    want_bp = (rotation_6d_to_axis_angle(bp.reshape(3, -1, 6)).reshape(3, -1)
               if bp6 else bp)
    assert got_go.shape == (3, 3) and got_bp.shape == (3, 69)
    torch.testing.assert_close(got_go, want_go, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(got_bp, want_bp, rtol=1e-6, atol=1e-7)
    if not go6:
        assert got_go is go
    if not bp6:
        assert got_bp is bp


def test_from_host_refuses_a_parent_after_its_child():
    tpl = synthetic_template(num_betas=10, n_seg=4, n_ring=8)
    parents = np.array(tpl.parents)
    parents[3] = 5
    with pytest.raises(ValueError, match="parent"):
        DeviceTemplate.from_host(tpl._replace(parents=parents))


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: csrc/pose.cu runs only there (no "
                    "interpret mode)")
    return torch.device("cuda")


def cell_arrays(model_dir: str):
    """The cells' template (host arrays; model_dir holds no model, so the
    synthetic one) and gaussians: the subdivided template's vertices and
    weights, the dead slots at 0 riding the root joint, seeded offsets,
    scales and canonical rotations."""
    tpl = load_template(model_dir, "smplh", num_betas=10, n_subdivision=2,
                        synthetic_res=2.0)
    n = tpl.num_verts
    rng = np.random.RandomState(22)
    xyz = np.zeros((SLOTS, 3), np.float32)
    xyz[:n] = tpl.v_template + rng.randn(n, 3) * 0.003
    w = np.zeros((SLOTS, tpl.lbs_weights.shape[1]), np.float32)
    w[:n] = tpl.lbs_weights
    w[n:, 0] = 1.0
    scales = np.exp(-7.0 + 3.0 * rng.rand(SLOTS, 3)).astype(np.float32)
    rot6 = rng.randn(SLOTS, 6).astype(np.float32)
    return tpl, xyz, w, scales, rot6


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    return cell_arrays(str(tmp_path_factory.mktemp("none")))


def _cuda_inputs(cell, dev, b, six, seed, ext):
    tpl, xyz, w, scales, rot6 = cell
    dt = DeviceTemplate.from_host(tpl, dev)
    nb = tpl.shapedirs.shape[2]
    cache = canonical_pose_cache(dt, torch.zeros(nb, device=dev))
    g = torch.Generator().manual_seed(seed)
    if six:
        go = axis_angle_to_rotation_6d(torch.randn(b, 3, generator=g))
        bp = axis_angle_to_rotation_6d(
            torch.randn(b, 23, 3, generator=g) * 0.4).reshape(b, 138)
        # a joint at the identity and one near pi
        bp[:, :6] = axis_angle_to_rotation_6d(torch.zeros(3))
        bp[:, 6:12] = axis_angle_to_rotation_6d(
            torch.tensor([0.6, 0.0, 0.8]) * (np.pi - 1e-3))
    else:
        go = torch.randn(b, 3, generator=g) * 0.5
        bp = torch.randn(b, 69, generator=g) * 0.4
    ext_t = None
    if ext:
        ext_t = (torch.randn(b, 3, generator=g) * 0.1,
                 rotation_6d_to_matrix(torch.randn(b, 6, generator=g)),
                 torch.rand(b, generator=g) * 0.4 + 0.8)
    frames = P.Frames(go=go, bp=bp, go6=six, bp6=six,
                      betas=torch.randn(nb, generator=g) * 0.3,
                      transl=torch.randn(b, 3, generator=g),
                      smpl_scale=torch.rand(b, generator=g) * 0.2 + 0.9,
                      ext_tfs=ext_t)
    t = {k: (tuple(x.to(dev) for x in v) if isinstance(v, tuple) else
             v.to(dev) if isinstance(v, torch.Tensor) else v)
         for k, v in frames._asdict().items()}
    gauss = (torch.as_tensor(xyz, device=dev),
             torch.as_tensor(scales, device=dev),
             rotation_6d_to_matrix(torch.as_tensor(rot6, device=dev)),
             torch.as_tensor(w, device=dev))
    return dt, cache, P.Frames(**t), gauss


def _double(dt, cache, frames, gauss):
    """The same inputs in float64, for the plain version's reference."""
    d = lambda x: x if not isinstance(x, torch.Tensor) or not \
        x.is_floating_point() else x.double()  # noqa: E731
    dt64 = dt._replace(**{f: d(getattr(dt, f)) for f in (
        "v_template", "shapedirs", "j_regressor", "rest_pose")})
    fr = frames._replace(**{k: (tuple(d(x) for x in v) if isinstance(
        v, tuple) else d(v)) for k, v in frames._asdict().items()})
    return dt64, d(cache.inv_A_t2cano), fr, tuple(d(x) for x in gauss)


def rel_err(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


def _leaves(frames, gauss):
    """The differentiable inputs (pose rows, betas, gaussians, frame
    terms) as fresh leaves, and the inputs rebuilt from them."""
    ext = frames.ext_tfs or ()
    xs = [frames.go, frames.bp, frames.betas, gauss[0], gauss[1], gauss[2],
          frames.transl, frames.smpl_scale, *ext]
    leaves = [x if x is None else x.detach().clone().requires_grad_(True)
              for x in xs]
    fr = frames._replace(go=leaves[0], bp=leaves[1], betas=leaves[2],
                         transl=leaves[6], smpl_scale=leaves[7],
                         ext_tfs=tuple(leaves[8:]) if ext else None)
    return leaves, fr, (leaves[3], leaves[4], leaves[5], gauss[3])


def plain_pose(dt, inv_a, frames, *gauss):
    return P.skin_plain(P.skeleton_plain(dt, inv_a, frames), frames, *gauss)


def _grads(dt, inv_a, frames, gauss, cots, pose=P.pose_gaussians):
    """pose's outputs and the gradients, with respect to every input
    given, of a loss of xyz, scales and the quaternions that q and -q
    give alike (where the pivot is nearly tied, float32 and float64 may
    pick either sign)."""
    leaves, fr, g = _leaves(frames, gauss)
    xyz, rotq, scales = pose(dt, inv_a, fr, *g)
    c = [x.to(xyz.dtype) for x in cots]
    loss = ((xyz * c[0]).sum() + ((rotq * c[1]).sum(-1) ** 2).sum()
            + (scales * c[2]).sum())
    return [o.detach() for o in (xyz, rotq, scales)], torch.autograd.grad(
        loss, [x for x in leaves if x is not None])


def same_sign(q, ref):
    """q with each quaternion's sign turned to ref's."""
    return torch.where((q.double() * ref.double()).sum(-1, keepdim=True) < 0,
                       -q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [False, True])
def test_one_frame_and_its_backward_against_plain_on_the_card(
        cuda_device, cell, ext):
    """A training step's posing: one frame from 6D rows, every gradient;
    the kernels' error from the float64 plain version within 4x the
    float32 plain version's and under 1e-4 of each output's and
    gradient's scale."""
    dt, cache, frames, gauss = _cuda_inputs(cell, cuda_device, 1, True, 5,
                                            ext)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    cots = [torch.randn(1, SLOTS, k, device=cuda_device, generator=g)
            for k in (3, 4, 3)]
    P.reset_launches()
    out_k, grads_k = _grads(dt, cache.inv_A_t2cano, frames, gauss, cots)
    assert P.LAUNCHES == {"pose_skeleton_fwd": 1, "pose_skeleton_bwd": 1,
                          "pose_skin_fwd": 1, "pose_skin_bwd": 1}
    with torch.no_grad():
        st = _static(dt, cache, frames, gauss[3])
        a = P.skeleton_plain(dt, cache.inv_A_t2cano, frames)
        rows, _ = P.skeleton_fwd_cuda(st, *P.axis_angle_rows(frames),
                                      P.shaped_joints(dt, frames.betas),
                                      frames.transl, frames.smpl_scale,
                                      *(frames.ext_tfs or ()))
        assert rel_err(rows.reshape(1, -1, 3, 4), a[..., :3, :]) < 1e-5
    # the plain version under autograd, in float32 and float64
    out_p, grads_p = _grads(dt, cache.inv_A_t2cano, frames, gauss, cots,
                            plain_pose)
    dt64, inv64, fr64, gauss64 = _double(dt, cache, frames, gauss)
    out_e, grads_e = _grads(dt64, inv64, fr64, gauss64, cots, plain_pose)
    out_k[1], out_p[1] = same_sign(out_k[1], out_e[1]), same_sign(
        out_p[1], out_e[1])
    names = ["go", "bp", "betas", "xyz", "scales", "rotmat", "transl",
             "smpl_scale", "etrans", "erot", "escale"]
    for name, k, p, e in zip(["xyz", "rotq", "scales"] + names,
                             out_k + list(grads_k), out_p + list(grads_p),
                             out_e + list(grads_e)):
        kern, plain = rel_err(k, e), rel_err(p, e)
        assert kern < 1e-4 and kern <= 4 * plain + 1e-6, (name, kern, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [False, True])
def test_training_frame_forward_is_the_plain_bits_on_the_card(
        cuda_device, cell, scaled):
    """A training step's posing (one frame from 6D rows, no ext_tfs, an
    isotropic avatar as in every cell: no canonical rotations): xyz,
    rotq and scales equal the plain version's bit for bit, its
    torch ops' own rounding on the card (4 x 4 products as two fma halves
    summed, the blend one fma a joint in order, the 3 x 3 apply as an fma
    on the first product plus the last). Training is chaotic in these
    bits: a last-bit change of the posed centres grows to a loss 1.7e-3
    off the reference's in 8 steps."""
    dt, cache, frames, gauss = _cuda_inputs(cell, cuda_device, 1, True, 11,
                                            False)
    if not scaled:
        frames = frames._replace(smpl_scale=None)
    gauss = gauss[:2] + (None,) + gauss[3:]
    with torch.no_grad():
        # the rows as the reference converts them: root and body apart
        go, bp = P.axis_angle_rows(frames)
        assert torch.equal(go, rotation_6d_to_axis_angle(frames.go))
        assert torch.equal(bp, rotation_6d_to_axis_angle(
            frames.bp.reshape(-1, 6)).reshape(1, -1))
        got = P.pose_gaussians(dt, cache.inv_A_t2cano, frames, *gauss)
        want = plain_pose(dt, cache.inv_A_t2cano, frames, *gauss)
    for name, k, p in zip(("xyz", "rotq", "scales"), got, want):
        assert torch.equal(k, p), (name, int((k != p).sum()))


@pytest.mark.cuda
def test_sixteen_frames_forward_against_plain_on_the_card(cuda_device,
                                                          cell):
    """The animation's chunk: 16 frames of axis-angle with smpl_scale and
    ext_tfs, no grad; each output within 4x the plain float32 version's
    error from float64 (and under 1e-5)."""
    dt, cache, frames, gauss = _cuda_inputs(cell, cuda_device, 16, False,
                                            7, True)
    P.reset_launches()
    with torch.no_grad():
        got = P.pose_gaussians(dt, cache.inv_A_t2cano, frames, *gauss)
        again = P.pose_gaussians(dt, cache.inv_A_t2cano, frames, *gauss)
        assert P.LAUNCHES == {"pose_skeleton_fwd": 2, "pose_skeleton_bwd": 0,
                              "pose_skin_fwd": 2, "pose_skin_bwd": 0}
        want = P.skin_plain(P.skeleton_plain(dt, cache.inv_A_t2cano, frames),
                            frames, *gauss)
        dt64, inv64, fr64, gauss64 = _double(dt, cache, frames, gauss)
        exact = P.skin_plain(P.skeleton_plain(dt64, inv64, fr64), fr64,
                             *gauss64)
    for name, k, k2, p, e in zip(("xyz", "rotq", "scales"), got, again, want,
                                 exact):
        assert torch.equal(k, k2), name
        if name == "rotq":
            k, p = same_sign(k, e), same_sign(p, e)
        kern, plain = rel_err(k, e), rel_err(p, e)
        assert kern < 1e-5 and kern <= 4 * plain + 1e-7, (name, kern, plain)


@pytest.mark.cuda
def test_no_host_wait_and_the_same_bits(cuda_device, cell):
    """A forward and its backward never make the host wait, and two calls
    give the same gradients bit for bit (no atomics)."""
    dt, cache, frames, gauss = _cuda_inputs(cell, cuda_device, 1, True, 9,
                                            False)
    cots = [torch.ones(1, SLOTS, k, device=cuda_device) for k in (3, 4, 3)]
    _grads(dt, cache.inv_A_t2cano, frames, gauss, cots)  # builds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = _grads(dt, cache.inv_A_t2cano, frames, gauss, cots)
        second = _grads(dt, cache.inv_A_t2cano, frames, gauss, cots)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(first[0] + list(first[1]), second[0] + list(second[1])):
        assert torch.equal(a, b)



@pytest.mark.cuda
def test_root_row_at_pi_elementwise_on_the_card(cuda_device, cell):
    """The training kit's root row, a half turn about x (the 6D row
    (1, 0, 0, 0, -1, ~0)), entry by entry against the plain float32
    version: each entry within 1e-3 of its own size, and 0 where the
    plain version's is. At a half turn one entry is ~1e-9 of the others
    and Adam (eps 1e-15) steps it as far as any other, so its sign and
    size have to hold; the root row goes through the plain version's own
    ops to axis-angle on the CUDA path too."""
    dt, cache, frames, gauss = _cuda_inputs(cell, cuda_device, 1, True, 13,
                                            False)
    g = torch.Generator().manual_seed(13)
    go = axis_angle_to_rotation_6d(torch.tensor([[np.pi, 0.0, 0.0]]))
    bp = axis_angle_to_rotation_6d(
        torch.randn(1, 23, 3, generator=g) * 0.08).reshape(1, 138)
    frames = frames._replace(go=go.to(cuda_device), bp=bp.to(cuda_device),
                             smpl_scale=None)
    gd = torch.Generator(device=cuda_device).manual_seed(13)
    cots = [torch.randn(1, SLOTS, k, device=cuda_device, generator=gd)
            for k in (3, 4, 3)]
    _, grads_k = _grads(dt, cache.inv_A_t2cano, frames, gauss, cots)
    _, grads_p = _grads(dt, cache.inv_A_t2cano, frames, gauss, cots,
                        plain_pose)
    kern = grads_k[0].double().reshape(-1)
    plain = grads_p[0].double().reshape(-1)
    zero = plain == 0
    assert torch.equal(kern[zero], plain[zero]), (kern, plain)
    assert float(plain[~zero].abs().min()) < 1e-6 * float(
        plain.abs().max())  # the half turn's rounding-sized entry
    gap = ((kern - plain).abs() / plain.abs())[~zero]
    assert float(gap.max()) < 1e-3, (kern, plain)
