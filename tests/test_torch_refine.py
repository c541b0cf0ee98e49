"""The port's synthetic-template calibration held against sings_tpu.

ops/projection, the COCO mappings and face-anchor targets,
posed_smpl_joints, fit_skeleton (tests/test_skeleton_fit.py's scenes),
the silhouette render and its VJP, one refine step's gradient against
an oracle made of the JAX package's own functions, refine_smpl (a few
steps, with and without keypoints, and its non-finite guard),
Trainer._fit_synthetic_body and its cache, and cli.refine, on the same
numpy inputs. JAX renders with interpret=True and chunk 8, as its own
tests do; the port takes the plain composite versions on the CPU.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.cli.refine import load_sapiens_keypoints as jload_kps
from sings_tpu.kinematics.body_model import (
    _BONE_GROUPS, load_template as jload_template, synthetic_template as jsyn,
)
from sings_tpu.kinematics.template import (
    DeviceTemplate as JDT, smpl_forward as jsmpl_forward,
)
from sings_tpu.ops import projection as jproj
from sings_tpu.ops.graphics import make_camera as jcam
from sings_tpu.preprocess import refine as jr
from sings_tpu_torch.kinematics.body_model import (
    load_template as tload_template, synthetic_template as tsyn,
)
from sings_tpu_torch.kinematics.template import DeviceTemplate as TDT
from sings_tpu_torch.ops import projection as tproj
from sings_tpu_torch.ops.graphics import make_camera as tcam
from sings_tpu_torch.preprocess import refine as tr

N_BONE = len(_BONE_GROUPS) + 1
# tests/test_refine.py's raster settings (JAX interpreted)
JKW = dict(tile=16, chunk=8, max_span=8, interpret=True)
TKW = dict(tile=16, chunk=8, max_span=8)
# the rasterizer gradient tolerance of tests/test_torch_train_step.py
GRAD_ATOL_REL, GRAD_RTOL = 2e-4, 2e-3
HW = 64
K64 = np.array([[80.0, 0, HW / 2], [0, 80.0, HW / 2], [0, 0, 1]], np.float32)
PARAM_KEYS = ("betas", "global_orient", "body_pose", "transl")


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Thousands of small ops a fit: two threads a worker keep the
    parallel test run from oversubscribing the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@functools.lru_cache(maxsize=None)
def templates(n_bone: int = 0, hands: bool = False):
    """(JAX DeviceTemplate, port DeviceTemplate) of one synthetic body."""
    kw = dict(num_betas=4, n_seg=4, n_ring=6, n_bone_betas=n_bone,
              hands=hands)
    return JDT.from_host(jsyn(**kw)), TDT.from_host(tsyn(**kw))


def jtree(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def ttree(d):
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


def project(joints, K):
    uvw = joints @ K.T
    return (uvw[..., :2] / uvw[..., 2:]).astype(np.float32)


def scene64(f: int, seed: int = 0) -> dict:
    """tests/test_refine.py's body at 3 m in a 64x64 camera, f frames
    of small seeded poses."""
    rng = np.random.RandomState(seed)
    return {"betas": np.zeros(4, np.float32),
            "global_orient": (0.05 * rng.randn(f, 3)).astype(np.float32),
            "body_pose": (0.05 * rng.randn(f, 69)).astype(np.float32),
            "transl": np.tile(np.array([[0.0, 0.25, 3.0]], np.float32),
                              (f, 1))}


def masks64(jd, true: dict) -> np.ndarray:
    """Silhouette masks of the true poses, rendered by JAX."""
    cfg = jr.RefineConfig(splat_scale=0.03)
    out = jsmpl_forward(jd, jnp.asarray(true["betas"])[None],
                        jnp.asarray(true["body_pose"]),
                        jnp.asarray(true["global_orient"]))
    cam = jcam(np.eye(4, dtype=np.float32), HW, HW, K=K64)
    return np.stack([np.asarray(jr._silhouette(
        out.verts[i] + jnp.asarray(true["transl"][i])[None], cam, cfg, JKW)
        > 0.3, np.float32) for i in range(len(true["transl"]))])


def sapiens(jd, true: dict, K: np.ndarray, offsets=jr.FACE_ANCHOR_INIT):
    """(F, 133, 2) keypoints and (F, 133) scores of the true poses: the
    body joints through _COCO133_SMPL_PAIRS, the ears at the head, the
    face anchors at `offsets` in the head's frame."""
    joints, head_rot = jr.posed_smpl_joints(jd, jtree(true),
                                            return_head_rot=True)
    joints, head_rot = np.asarray(joints), np.asarray(head_rot)
    f = joints.shape[0]
    kp = np.zeros((f, 133, 2), np.float32)
    sc = np.full((f, 133), 0.3, np.float32)
    for sj, cj in jr._COCO133_SMPL_PAIRS:
        kp[:, cj] = project(joints[:, sj], K)
        sc[:, cj] = 0.95
    anchors = joints[:, 15][:, None] + np.einsum("fxy,ay->fax", head_rot,
                                                  offsets)
    kp[:, :5] = project(anchors, K)
    sc[:, :5] = 1.0
    return kp, sc


def assert_grads_close(got: dict, want: dict):
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].detach().numpy()
        tol = GRAD_ATOL_REL * np.abs(w).max() + GRAD_RTOL * np.abs(w)
        assert np.all(np.abs(g - w) <= tol), (k, np.abs(g - w).max(),
                                              np.abs(w).max())


def assert_run_close(got: dict, want: dict, lr: float, steps: int):
    """A few-step fit: step 0's loss at rtol 1e-5, later ones at 1e-3;
    each parameter within 0.1 lr per step taken."""
    np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3)
    for k in PARAM_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=0.1 * lr * steps, err_msg=k)


# ---------------------------------------------------------------------------
# projection, mappings, joints


@pytest.mark.parametrize("with_pose", [False, True],
                         ids=["camera_frame", "world_frame"])
def test_projection_matches_jax(with_pose):
    """rtol 1e-6, and an atol of 1e-6 of the largest magnitude:
    u = (fx x + cx z) / z cancels where x / z ~ -cx / fx, and the two
    packages' matmuls round their sums in different orders (1 ulp of a
    222 px sum moved a 2.7 px coordinate by 1.3e-5)."""

    def close(got, want):
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())

    rng = np.random.RandomState(1)
    pts = (rng.randn(64, 3) * 0.5 + [0, 0, 5]).astype(np.float32)
    K = np.array([[500.0, 0, 64.5], [0, 480.0, 60.25], [0, 0, 1]],
                 np.float32)
    w2c = c2w = None
    if with_pose:
        axis = rng.randn(3)
        axis /= np.linalg.norm(axis)
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        rot = np.eye(3) + np.sin(0.3) * k + (1 - np.cos(0.3)) * (k @ k)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = rot
        w2c[:3, 3] = rng.randn(3) * 0.1
        c2w = np.linalg.inv(w2c).astype(np.float32)
    j = jproj.project_points(jnp.asarray(pts), jnp.asarray(K),
                             None if w2c is None else jnp.asarray(w2c))
    t = tproj.project_points(torch.tensor(pts), torch.tensor(K),
                             None if w2c is None else torch.tensor(w2c))
    close(t.numpy(), np.asarray(j))
    uvd = np.asarray(j)
    ju = jproj.unproject_points(jnp.asarray(uvd), jnp.asarray(K),
                                None if c2w is None else jnp.asarray(c2w))
    tu = tproj.unproject_points(torch.tensor(uvd), torch.tensor(K),
                                None if c2w is None else torch.tensor(c2w))
    close(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(tu.numpy(), pts, atol=1e-4)


@pytest.mark.parametrize("name", ["coco17_to_smpl", "coco133_to_smpl",
                                  "coco133_body_targets",
                                  "face_anchor_targets"])
def test_keypoint_mappings_equal_jax(name):
    rng = np.random.RandomState(2)
    n = 17 if name == "coco17_to_smpl" else 133
    kp = (rng.rand(3, n, 2) * 200).astype(np.float32)
    args = (kp,)
    if name.endswith("targets"):
        # around the 0.8 threshold, and above 1 (clipped to 1)
        args = (kp, rng.uniform(0.5, 1.2, (3, n)).astype(np.float32))
    elif name == "coco17_to_smpl":
        args = (kp[0],)
    want = getattr(jr, name)(*args)
    got = getattr(tr, name)(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert tr._COCO133_SMPL_PAIRS == jr._COCO133_SMPL_PAIRS
    assert tr.FACE_ANCHOR_COCO == jr.FACE_ANCHOR_COCO
    np.testing.assert_array_equal(tr.FACE_ANCHOR_INIT, jr.FACE_ANCHOR_INIT)


@pytest.mark.parametrize("hands", [False, True], ids=["smpl", "smplh"])
def test_posed_smpl_joints_match_jax(hands):
    jd, td = templates(N_BONE, hands)
    f = 4
    rng = np.random.RandomState(3)
    nb = jd.shapedirs.shape[-1]
    params = {"betas": (0.5 * rng.randn(nb)).astype(np.float32),
              "global_orient": (0.3 * rng.randn(f, 3)).astype(np.float32),
              "body_pose": (0.2 * rng.randn(f, 69)).astype(np.float32),
              "transl": rng.randn(f, 3).astype(np.float32)}
    params["body_pose"][:, 3 * 14 + 1] = np.linspace(-0.6, 0.6, f)  # head
    params["body_pose"][0, :6] = 0.0  # zero-angle joints take the expansion
    jj, jrot = jr.posed_smpl_joints(jd, jtree(params), return_head_rot=True)
    tj, trot = tr.posed_smpl_joints(td, ttree(params), return_head_rot=True)
    assert tuple(tj.shape) == (f, 24, 3) and tuple(trot.shape) == (f, 3, 3)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=1e-5)
    np.testing.assert_allclose(trot.numpy(), np.asarray(jrot), atol=1e-5)
    np.testing.assert_allclose(
        tr.posed_smpl_joints(td, ttree(params)).numpy(), np.asarray(jj),
        atol=1e-5)


# ---------------------------------------------------------------------------
# stage A: the keypoint skeleton fit


def skeleton_case(case: str):
    """tests/test_skeleton_fit.py's bone-length scene (longer torso,
    shorter thighs, masked betas as the trainer masks them), 50 steps;
    "face_anchors" adds test_face_anchors_recover_head_yaw's head-yaw
    sweep, zeroed in the start, and its face keypoints at offsets off
    the default. Both start away from the keypoint optimum: where a
    start sits on it (the yaw test's own scene), the residuals are
    rounding and Adam's normalised first step turns their sign into a
    full +-lr step in any two float32 implementations."""
    jd, td = templates(N_BONE)
    nb = jd.shapedirs.shape[-1]
    K = np.array([[1000.0, 0, 128], [0, 1000.0, 224], [0, 0, 1]],
                 np.float32)
    f, rng = 4, np.random.RandomState(0)
    true = {"betas": np.zeros(nb, np.float32),
            "global_orient": np.zeros((f, 3), np.float32),
            "body_pose": (0.05 * rng.randn(f, 69)).astype(np.float32),
            "transl": np.tile(np.array([[0.0, 0.3, 8.0]], np.float32),
                              (f, 1))}
    true["betas"][4], true["betas"][4 + 6] = 1.2, -0.8
    mask = np.zeros(nb, np.float32)
    mask[0] = 1.0
    mask[-N_BONE:] = 1.0
    kw = {"beta_mask": mask}
    cfg = jr.SkeletonFitConfig(steps=50, lr=0.03, w_pose_prior=10.0)
    init = {k: np.copy(v) for k, v in true.items()}
    init["betas"] = np.zeros(nb, np.float32)
    if case == "face_anchors":
        true["body_pose"][:, 3 * 14 + 1] = np.linspace(-0.6, 0.6, f)
        init["body_pose"][:, 3 * 14:3 * 15] = 0.0
        kp, sc = sapiens(jd, true, K, jr.FACE_ANCHOR_INIT + np.float32(0.01))
        kw["face_targets"], kw["face_weights"] = jr.face_anchor_targets(kp,
                                                                        sc)
    targets = project(np.asarray(jr.posed_smpl_joints(jd, jtree(true))), K)
    weights = np.ones((f, 24), np.float32)
    return jd, td, K, init, targets, weights, cfg, kw


@pytest.mark.parametrize("case", ["bone_lengths", "face_anchors"])
def test_fit_skeleton_matches_jax(case):
    jd, td, K, init, targets, weights, cfg, kw = skeleton_case(case)
    want = jr.fit_skeleton(jd, K, init, targets, weights, cfg, **kw)
    got = tr.fit_skeleton(td, K, init, targets, weights,
                          tr.SkeletonFitConfig(*cfg), **kw)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    assert got["px_err"][-1] < got["px_err"][0]
    off = kw["beta_mask"] == 0
    # masked dims: no gradient, no Adam step, bit for bit the input
    assert np.array_equal(got["betas"][off], init["betas"][off])
    assert np.array_equal(want["betas"][off], init["betas"][off])
    assert ("face_offsets" in got) == (case == "face_anchors")


# ---------------------------------------------------------------------------
# stage B: the silhouette render, one step's gradient, a few steps


def silhouette_inputs():
    jd, td = templates()
    true = scene64(1)
    out = jsmpl_forward(jd, jnp.zeros((1, 4)), jnp.asarray(true["body_pose"]),
                        jnp.asarray(true["global_orient"]))
    verts = np.asarray(out.verts[0]) + true["transl"][0]
    cfg = jr.RefineConfig(splat_scale=0.03)
    cot = np.random.RandomState(4).randn(HW, HW).astype(np.float32)
    return verts, cfg, cot


def port_silhouette_vjp(verts, cfg, cot, clip=None):
    v = torch.tensor(verts, requires_grad=True)
    cam = tcam(np.eye(4, dtype=np.float32), HW, HW, K=K64)
    if clip is None:
        sil = tr._silhouette(v, cam, tr.RefineConfig(*cfg), TKW)
    else:
        pkg = tr.rasterize(v, v.new_full(v.shape, cfg.splat_scale),
                           torch.tensor([[1.0, 0, 0, 0]]).repeat(len(v), 1),
                           v.new_full((len(v),), cfg.splat_opacity),
                           v.new_ones(v.shape), cam, bg=v.new_zeros(3),
                           **TKW)
        sil = clip(pkg["render"][0])
    (g,) = torch.autograd.grad(sil, v, torch.tensor(cot))
    return sil.detach().numpy(), g.numpy()


def test_silhouette_and_its_vjp_match_jax():
    verts, cfg, cot = silhouette_inputs()
    cam = jcam(np.eye(4, dtype=np.float32), HW, HW, K=K64)
    @jax.jit
    def value_and_vjp(v, c):
        sil, vjp = jax.vjp(lambda v: jr._silhouette(v, cam, cfg, JKW), v)
        return sil, vjp(c)[0]

    want, want_g = value_and_vjp(jnp.asarray(verts), jnp.asarray(cot))
    got, got_g = port_silhouette_vjp(verts, cfg, cot)
    assert 50 < (got > 0.3).sum() < HW * HW
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    assert_grads_close({"v": torch.tensor(got_g)}, {"v": want_g})


def test_silhouette_clamp_tie_moves_no_gradient():
    """Empty pixels render exactly 0, where jnp.clip passes half the
    cotangent and torch.clamp all of it; no pair reaches those pixels,
    so the vertex gradient is the same bit for bit."""
    verts, cfg, cot = silhouette_inputs()
    sil, g_clamp = port_silhouette_vjp(verts, cfg, cot)
    _, g_tie = port_silhouette_vjp(
        verts, cfg, cot,
        clip=lambda x: torch.minimum(torch.maximum(x, torch.zeros_like(x)),
                                     torch.ones_like(x)))
    assert (sil == 0.0).sum() > HW * HW // 4
    assert np.abs(g_clamp).max() > 0
    np.testing.assert_array_equal(g_clamp, g_tie)


def refine_case(f: int, d: int, keypoints: bool):
    """A perturbed start on the 64x64 scene; masks rendered by JAX at
    the true poses; optional keypoints and face anchors."""
    jd, td = templates(N_BONE)
    true = scene64(f)
    true["betas"] = np.zeros(4 + N_BONE, np.float32)
    masks = masks64(jd, true)
    init = {k: np.copy(v) for k, v in true.items()}
    init["transl"] = init["transl"] + np.array([[0.06, -0.04, 0.0]],
                                               np.float32)
    init["body_pose"] = init["body_pose"] + np.float32(0.02)
    kw = {}
    cfg = jr.RefineConfig(steps=4, lr=0.02, render_downscale=d,
                          splat_scale=0.03, w_keypoints=0.0, w_prior=0.01,
                          batch_frames=2)
    if keypoints:
        kp, sc = sapiens(jd, true, K64)
        kw["keypoints2d"], kw["keypoint_valid"] = jr.coco133_body_targets(
            kp, sc)
        kw["face_targets"], kw["face_weights"] = jr.face_anchor_targets(kp,
                                                                        sc)
        kw["face_offsets"] = jr.FACE_ANCHOR_INIT + np.float32(0.005)
        cfg = cfg._replace(w_keypoints=0.5, w_face=0.5, optimize_betas=True)
    return jd, td, init, masks, cfg, kw


def jax_total_loss(jd, cam, masks, cfg, kw, prior, f, nb, kwr):
    """refine.py:446-491 composed of the JAX package's own functions."""
    Kj = jnp.asarray(K64)
    d = cfg.render_downscale
    if d > 1:
        Kj = Kj.at[:2].divide(d)
    masks = jnp.asarray(masks[:, ::d, ::d])

    def loss(params, step_i):
        joints, head_rot = jr.posed_smpl_joints(jd, params,
                                                return_head_rot=True)
        e = jnp.sqrt(jnp.sum((jr.project_px(joints, jnp.asarray(K64))
                              - kw["keypoints2d"]) ** 2, -1) + 1e-8)
        valid = kw["keypoint_valid"]
        l_kp = (jr._huber_px(e, 10.0) * valid).sum() / max(valid.sum(), 1.0)
        anchors = (joints[:, 15][:, None, :] + jnp.einsum(
            "fxy,ay->fax", head_rot, kw["face_offsets"]))
        fe = jnp.sqrt(jnp.sum((jr.project_px(anchors, jnp.asarray(K64))
                               - kw["face_targets"]) ** 2, -1) + 1e-8)
        fw = kw["face_weights"]
        l_face = (jr._huber_px(fe, 10.0) * fw).sum() / max(fw.sum(), 1.0)
        sils = []
        for i in [(step_i * nb + j) % f for j in range(nb)]:
            out = jsmpl_forward(jd, params["betas"].reshape(1, -1),
                                params["body_pose"][i].reshape(1, -1),
                                params["global_orient"][i].reshape(1, 3),
                                disable_posedirs=jd.posedirs is None)
            verts = out.verts[0] + params["transl"][i][None]
            sils.append(jnp.mean((jr._silhouette(verts, cam, cfg, kwr)
                                  - masks[i]) ** 2))
        l_prior = sum(jnp.mean((params[k] - prior[k]) ** 2)
                      for k in ("body_pose", "transl"))
        l_orient = jnp.mean((params["global_orient"]
                             - prior["global_orient"]) ** 2)
        return (cfg.w_keypoints * l_kp + cfg.w_face * l_face
                + cfg.w_silhouette * jnp.mean(jnp.stack(sils))
                + cfg.w_prior * l_prior + cfg.w_orient_prior * l_orient)
    return loss


def test_refine_step_gradient_matches_jax_oracle():
    """One step's loss and gradient, keypoints and face anchors on, the
    silhouettes at half resolution (the strided masks and the camera of
    K / 2), on the round robin's second batch (frames 2, 0)."""
    f, step_i, d = 3, 1, 2
    jd, td, init, masks, cfg, kw = refine_case(f, d, keypoints=True)
    Kd = K64.copy()
    Kd[:2] /= d
    cam = jcam(np.eye(4, dtype=np.float32), HW // d, HW // d, K=Kd)
    loss = jax_total_loss(jd, cam, masks, cfg, kw, jtree(init), f, 2, JKW)
    want, want_g = jax.jit(jax.value_and_grad(loss), static_argnums=1)(
        jtree(init), step_i)

    params, total = tr.refine_objective(
        td, tcam(np.eye(4, dtype=np.float32), HW, HW, K=K64), K64, init,
        masks, cfg=tr.RefineConfig(*cfg), raster_kw=TKW, **kw)
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    got = total(leaves, step_i)
    got_g = dict(zip(leaves, torch.autograd.grad(got, list(
        leaves.values()))))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert_grads_close(got_g, want_g)


@pytest.mark.parametrize("keypoints", [False, True],
                         ids=["silhouette", "keypoints_and_face"])
def test_refine_smpl_matches_jax(keypoints):
    jd, td, init, masks, cfg, kw = refine_case(2, 1, keypoints)
    cam = jcam(np.eye(4, dtype=np.float32), HW, HW, K=K64)
    want = jr.refine_smpl(jd, cam, K64, init, masks, cfg=cfg, raster_kw=JKW,
                          **kw)
    got = tr.refine_smpl(td, tcam(np.eye(4, dtype=np.float32), HW, HW,
                                  K=K64), K64, init, masks,
                         cfg=tr.RefineConfig(*cfg), raster_kw=TKW, **kw)
    assert sorted(got) == sorted(want)
    assert_run_close(got, want, cfg.lr, cfg.steps)
    assert got["losses"][-1] < got["losses"][0]
    if not keypoints:  # optimize_betas=False: Adam runs, betas stay put
        assert np.array_equal(got["betas"], init["betas"])


def test_refine_nonfinite_guard_matches_jax():
    """3 frames, 2 a step, frame 2's mask NaN: steps 1 and 2 see it. Their
    losses are NaN, every gradient is zeroed and Adam still runs (the
    parameters move by momentum alone)."""
    jd, td, init, masks, cfg, kw = refine_case(3, 1, keypoints=False)
    masks[2] = np.nan
    cam = jcam(np.eye(4, dtype=np.float32), HW, HW, K=K64)
    want = jr.refine_smpl(jd, cam, K64, init, masks, cfg=cfg, raster_kw=JKW)
    got = tr.refine_smpl(td, tcam(np.eye(4, dtype=np.float32), HW, HW,
                                  K=K64), K64, init, masks,
                         cfg=tr.RefineConfig(*cfg), raster_kw=TKW)
    nan = [not np.isfinite(x) for x in got["losses"]]
    assert nan == [not np.isfinite(x) for x in want["losses"]]
    assert nan == [False, True, True, False]
    np.testing.assert_allclose(got["losses"][[0, 3]], want["losses"][[0, 3]],
                               rtol=1e-3)
    for k in PARAM_KEYS:
        assert np.all(np.isfinite(got[k]))
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=0.1 * cfg.lr * cfg.steps, err_msg=k)


@pytest.mark.parametrize("error", [
    RuntimeError("UNAVAILABLE: TPU worker process crashed"),
    TypeError("not a device fault")], ids=["device_fault", "other"])
def test_refine_errors_propagate(monkeypatch, error):
    """No retry: an error raised mid-fit (on the second render) leaves
    refine_smpl, whatever its message (the JAX package retries device
    faults: tests/test_refine.py)."""
    jd, td, init, masks, cfg, kw = refine_case(1, 1, keypoints=False)
    calls = []
    real = tr.rasterize

    def failing(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise error
        return real(*a, **k)

    monkeypatch.setattr(tr, "rasterize", failing)
    with pytest.raises(type(error), match=str(error).split(":")[0]):
        tr.refine_smpl(td, tcam(np.eye(4, dtype=np.float32), HW, HW, K=K64),
                       K64, init, masks,
                       cfg=tr.RefineConfig(*cfg._replace(scan_chunk=1)),
                       raster_kw=TKW)
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# the trainer's calibration and the refine entry point


def tiny_kit_with_keypoints(frames=4):
    from test_torch_train_step import _tiny_kit

    kit = _tiny_kit(frames)
    # the template of _tiny_trainer_cfg (DEFAULTS' body_template "smpl")
    jtpl = jload_template(None, "smpl", num_betas=10, synthetic_res=0.5)
    smpl = dict(kit.smpl, betas=np.zeros(jtpl.num_betas, np.float32))
    K = np.array([[60.0, 0, 24.0], [0, 60.0, 24.0], [0, 0, 1]], np.float32)
    kp, sc = sapiens(JDT.from_host(jtpl), smpl, K)
    kp = kp + np.random.RandomState(5).randn(*kp.shape).astype(np.float32)
    return kit._replace(keypoints=kp, keypoint_scores=sc), jtpl


def jax_trainer_fit(kit, jtpl, skeleton_steps, refine_steps):
    """What the JAX trainer's _fit_synthetic_body computes for this kit
    (trainer.py:438-505): its d, K, beta mask and both configs."""
    nb = jtpl.num_betas
    hw = kit.masks.shape[1]
    cam = jcam(np.eye(4, dtype=np.float32), hw, hw,
               K=np.array([[60.0, 0, 24.0], [0, 60.0, 24.0], [0, 0, 1]]))
    K = np.array([[cam.width / (2 * cam.tan_fovx), 0, cam.width / 2],
                  [0, cam.height / (2 * cam.tan_fovy), cam.height / 2],
                  [0, 0, 1]], np.float32)
    jd = JDT.from_host(jtpl)
    init = {"betas": np.zeros(nb, np.float32),
            "global_orient": kit.smpl["global_orient"],
            "body_pose": kit.smpl["body_pose"],
            "transl": kit.smpl["transl"]}
    kp_t, kp_w = jr.coco133_body_targets(kit.keypoints, kit.keypoint_scores)
    face_t, face_w = jr.face_anchor_targets(kit.keypoints,
                                            kit.keypoint_scores)
    beta_mask = np.zeros(nb, np.float32)
    beta_mask[0] = 1.0
    beta_mask[-jtpl.n_bone_betas:] = 1.0
    res_a = jr.fit_skeleton(jd, K, init, kp_t, kp_w,
                            jr.SkeletonFitConfig(steps=skeleton_steps),
                            beta_mask=beta_mask, face_targets=face_t,
                            face_weights=face_w)
    cfg = jr.RefineConfig(steps=refine_steps, lr=0.01,
                          render_downscale=max(1, hw // 128),
                          w_keypoints=0.5, w_face=0.5, w_prior=0.05,
                          optimize_betas=True)
    res = jr.refine_smpl(jd, cam, K, {k: res_a[k] for k in init},
                         kit.masks, keypoints2d=kp_t, keypoint_valid=kp_w,
                         cfg=cfg, face_targets=face_t, face_weights=face_w,
                         face_offsets=res_a["face_offsets"])
    return res_a, res, cfg


def record_stages(monkeypatch):
    """Wrap the calibration's two stages where the trainer looks them
    up: {name: its numpy result} of each call."""
    from sings_tpu_torch.preprocess import refine as refine_mod

    results = {}
    for name in ("fit_skeleton", "refine_smpl"):
        def wrapped(*a, _fn=getattr(refine_mod, name), _name=name, **k):
            results[_name] = _fn(*a, **k)
            return results[_name]
        monkeypatch.setattr(refine_mod, name, wrapped)
    return results


def test_trainer_fit_synthetic_body_matches_jax(tmp_path, monkeypatch):
    from sings_tpu_torch.preprocess import refine as refine_mod
    from sings_tpu_torch.train.trainer import Trainer
    from test_torch_train_step import _tiny_trainer_cfg

    kit, jtpl = tiny_kit_with_keypoints()
    fit_kw = ["tpu.auto_fit_synthetic=True", "tpu.skeleton_fit_steps=5",
              "tpu.synthetic_fit_steps=3"]
    stages = record_stages(monkeypatch)
    tr1 = Trainer(_tiny_trainer_cfg(tmp_path, fit_kw), mode="anim",
                  device="cpu", kit=kit)
    assert tr1.tpl.num_joints == jtpl.num_joints
    np.testing.assert_array_equal(tr1.tpl.v_template, jtpl.v_template)
    res_a, res, cfg = jax_trainer_fit(kit, jtpl, 5, 3)
    got_a, got = stages["fit_skeleton"], stages["refine_smpl"]
    for k in list(PARAM_KEYS) + ["face_offsets", "losses", "px_err"]:
        np.testing.assert_allclose(got_a[k], res_a[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    assert_run_close(got, res, cfg.lr, cfg.steps)
    cache = dict(np.load(os.path.join(tr1.logdir, "synthetic_fit.npz")))
    assert sorted(cache) == sorted(PARAM_KEYS)
    for k in PARAM_KEYS:
        assert np.array_equal(cache[k], got[k])
        assert np.array_equal(tr1.kit.smpl[k], got[k])
    assert cache["betas"].shape == (jtpl.num_betas,)

    # a second run on the same directory loads the cache and fits nothing
    def no_fit(*a, **k):
        raise AssertionError("the calibration ran")

    monkeypatch.setattr(refine_mod, "fit_skeleton", no_fit)
    monkeypatch.setattr(refine_mod, "refine_smpl", no_fit)
    tr2 = Trainer(_tiny_trainer_cfg(tmp_path, fit_kw), mode="anim",
                  device="cpu", kit=kit)
    for k in PARAM_KEYS:
        assert np.array_equal(tr2.kit.smpl[k], cache[k])

    # eval without a cache keeps the kit's poses and zeroed betas
    tr3 = Trainer(_tiny_trainer_cfg(tmp_path / "eval", fit_kw + ["eval=True"]),
                  mode="anim", device="cpu", kit=kit)
    assert np.array_equal(tr3.kit.smpl["betas"],
                          np.zeros(jtpl.num_betas, np.float32))
    for k in ("global_orient", "body_pose", "transl"):
        assert np.array_equal(tr3.kit.smpl[k], kit.smpl[k])
    assert not os.path.exists(os.path.join(tr3.logdir, "synthetic_fit.npz"))


def test_cli_refine_writes_poses_optimized(tmp_path):
    """cli.refine.main on an in-memory kit: the keypoint JSONs (read as
    JAX's CLI reads them) and cameras.npz from --kit, poses_optimized.npz
    written there with the JAX CLI's keys and shapes.
    The synthetic template's betas are zeroed at its own dimension: the
    kit's 10 licensed-SMPL betas do not fit it (JAX raises on them)."""
    import json

    from sings_tpu_torch.cli.refine import load_sapiens_keypoints, main

    kit, _ = tiny_kit_with_keypoints(3)
    K = np.array([[60.0, 0, 24.0], [0, 60.0, 24.0], [0, 0, 1]], np.float32)
    smpl_dir = tmp_path / "score_demo_video"
    smpl_dir.mkdir()
    np.savez(smpl_dir / "cameras.npz", intrinsic=K, extrinsic=np.eye(4),
             height=48, width=48)
    kp_dir = tmp_path / "keypoints_coco133" / "sapiens_1b"
    kp_dir.mkdir(parents=True)
    for i in range(3):
        (kp_dir / f"{i:06d}.json").write_text(json.dumps({"instance_info": [
            {"keypoints": kit.keypoints[i].tolist(),
             "keypoint_scores": kit.keypoint_scores[i].tolist()}]}))
    argv = ["--kit", str(tmp_path), "--device", "cpu", "--steps", "2",
            "--downscale", "1", "--body_template", "smpl",
            "--smpl_model_dir", str(tmp_path / "no_models")]
    out = main(argv, kit=kit)
    saved = dict(np.load(smpl_dir / "poses_optimized.npz"))
    assert sorted(saved) == sorted(PARAM_KEYS)

    jtpl = jload_template(None, "smpl", num_betas=10)
    jd = JDT.from_host(jtpl)
    kps, valid = jload_kps(str(tmp_path), 3)
    for got, want in zip(load_sapiens_keypoints(str(tmp_path), 3),
                         (kps, valid)):
        np.testing.assert_array_equal(got, want)
    cfg = jr.RefineConfig(steps=2, render_downscale=1)
    cam = jcam(np.eye(4, dtype=np.float32), 48, 48, K=K)
    with pytest.raises(ValueError):  # the kit's own betas
        jr.refine_smpl(jd, cam, K, kit.smpl, kit.masks, kps, valid, cfg)
    # the CLI's run: refine_smpl (held against JAX above) on the kit's
    # masks, the JSON keypoints through coco133_to_smpl, cameras.npz's K
    smpl = dict(kit.smpl, betas=np.zeros(jtpl.num_betas, np.float32))
    tpl = TDT.from_host(tload_template(None, "smpl", num_betas=10))
    want = tr.refine_smpl(tpl, kit.camera, K, smpl, kit.masks, kps, valid,
                          tr.RefineConfig(*cfg))
    assert saved["betas"].shape == (jtpl.num_betas,)
    for k in PARAM_KEYS:
        assert saved[k].shape == smpl[k].shape and saved[k].dtype == np.float32
        np.testing.assert_array_equal(saved[k], out[k])
        np.testing.assert_array_equal(saved[k], want[k])
    np.testing.assert_array_equal(out["losses"], want["losses"])
