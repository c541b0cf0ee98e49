"""The exports and camera factories that the port's training run writes
and renders with, held against sings_tpu on the same seeded inputs:
save_ply and save_splat write the same bytes and load_ply reads them
back equal; save_ellipsoid_mesh writes the same header, colours and
faces, and vertices within 2e-7 (the two packages'
quaternion_to_matrix round differently); get_rotating_cameras and
get_smpl_static_params equal JAX's."""
import numpy as np
import pytest
import torch

from sings_tpu.data import cameras as jcams
from sings_tpu.export import ply as jply
from sings_tpu_torch.data import cameras as tcams
from sings_tpu_torch.export import ply as tply


def gaussians(n=80, seed=0, canonical=True):
    """A forward-output dict of n gaussians (both poses' keys)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(n, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    out = {"xyz": rng.randn(n, 3).astype(np.float32),
           "xyz_canon": rng.randn(n, 3).astype(np.float32),
           "shs": rng.randn(n, 16, 3).astype(np.float32) * 0.5,
           "opacity": rng.uniform(0, 1, (n, 1)).astype(np.float32),
           "scales": rng.uniform(1e-4, 0.05, (n, 3)).astype(np.float32),
           "rotq": q}
    if canonical:
        out["scales_canon"] = out["scales"] * 0.5
        out["rotq_canon"] = q[::-1].copy()
    return out


def alive_mask(n, seed):
    return (np.random.RandomState(seed).rand(n) > 0.3).astype(np.float32)


CASES = [("canonical", None, True), ("deformed", 7, True),
         ("deformed", None, False), ("canonical", 9, False)]
IDS = ["canonical", "deformed_alive", "deformed_no_canon_keys",
       "canonical_alive_no_canon_keys"]


@pytest.mark.parametrize("pose,alive_seed,canon", CASES, ids=IDS)
def test_save_ply_bytes_and_load_ply_match_jax(tmp_path, pose, alive_seed,
                                               canon):
    out = gaussians(canonical=canon)
    alive = None if alive_seed is None else alive_mask(80, alive_seed)
    jp, tp = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jply.save_ply(out, jp, pose=pose, alive=alive)
    tply.save_ply(out, tp, pose=pose, alive=alive)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    want, got = jply.load_ply(jp), tply.load_ply(tp)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    n = 80 if alive is None else int((alive > 0.5).sum())
    assert got["xyz"].shape == (n, 3)


@pytest.mark.parametrize("pose,alive_seed,canon", CASES, ids=IDS)
def test_save_splat_bytes_match_jax(tmp_path, pose, alive_seed, canon):
    out = gaussians(seed=1, canonical=canon)
    alive = None if alive_seed is None else alive_mask(80, alive_seed)
    jp, tp = str(tmp_path / "j.splat"), str(tmp_path / "t.splat")
    jply.save_splat(out, jp, pose=pose, alive=alive)
    tply.save_splat(out, tp, pose=pose, alive=alive)
    data = open(tp, "rb").read()
    assert data == open(jp, "rb").read()
    assert len(data) == 32 * (80 if alive is None
                              else int((alive > 0.5).sum()))


def read_mesh(path):
    """A save_ellipsoid_mesh .ply: header, vertices, colours, faces."""
    raw = open(path, "rb").read()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode("ascii").split("\n")
    nv = int(next(h for h in header if h.startswith("element vertex"))
             .split()[-1])
    vdt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
    v = np.frombuffer(raw, vdt, count=nv, offset=end)
    f = np.frombuffer(raw, np.dtype([("n", "u1"), ("idx", "<i4", 3)]),
                      offset=end + nv * vdt.itemsize)
    return header, v["xyz"], v["rgb"], f


@pytest.mark.parametrize("pose,alive_seed,max_gaussians", [
    ("deformed", None, 20000), ("canonical", 3, 20000),
    ("deformed", 5, 40)], ids=["deformed", "canonical_alive",
                               "subsampled"])
def test_save_ellipsoid_mesh_matches_jax(tmp_path, pose, alive_seed,
                                         max_gaussians):
    out = gaussians(seed=2)
    alive = None if alive_seed is None else alive_mask(80, alive_seed)
    jp, tp = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jply.save_ellipsoid_mesh(out, jp, pose=pose, alive=alive,
                             max_gaussians=max_gaussians)
    tply.save_ellipsoid_mesh(out, tp, pose=pose, alive=alive,
                             max_gaussians=max_gaussians)
    (jh, jv, jc, jf), (th, tv, tc, tf) = read_mesh(jp), read_mesh(tp)
    assert th == jh
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tf["n"], jf["n"])
    np.testing.assert_array_equal(tf["idx"], jf["idx"])
    np.testing.assert_allclose(tv, jv, rtol=0, atol=2e-7)
    n = min(max_gaussians, 80 if alive is None
            else int((alive > 0.5).sum()))
    assert tv.shape == (12 * n, 3) and tf.shape == (20 * n,)


@pytest.mark.parametrize("kw", [
    {}, dict(img_size=(48, 64), fov=0.5, dist=4.0, nframes=7,
             angle_limit=np.pi, znear=0.1, zfar=30.0)],
    ids=["defaults", "options"])
def test_rotating_cameras_match_jax(kw):
    want = jcams.get_rotating_cameras(**kw)
    got = tcams.get_rotating_cameras(**kw)
    assert len(got) == len(want) == kw.get("nframes", 40)
    for g, w in zip(got, want):
        for f in ("height", "width", "tan_fovx", "tan_fovy",
                  "clamp_tan_fovx", "clamp_tan_fovy"):
            assert getattr(g, f) == getattr(w, f), f
        for f in ("view", "proj", "cam_center"):
            assert getattr(g, f).dtype == torch.float32
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(w, f)))


@pytest.mark.parametrize("pose_type", ["da_pose", "a_pose", "t_pose",
                                       "little_a_pose"])
def test_smpl_static_params_match_jax(pose_type):
    betas = np.random.RandomState(4).randn(1, 20)
    want = jcams.get_smpl_static_params(betas, pose_type=pose_type)
    got = tcams.get_smpl_static_params(betas, pose_type=pose_type)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
