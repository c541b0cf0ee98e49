"""sings_tpu_torch ops held against sings_tpu: rotations, SH, camera
math, bilinear grid sampling. Inputs are drawn with numpy and given to
both packages; float32 tolerances."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.ops import graphics as jgr
from sings_tpu.ops import rotations as jrot
from sings_tpu.ops import sampling as jsmp
from sings_tpu.ops import sh as jsh
from sings_tpu_torch.ops import graphics as tgr
from sings_tpu_torch.ops import rotations as trot
from sings_tpu_torch.ops import sampling as tsmp
from sings_tpu_torch.ops import sh as tsh


def _close(t, j, atol=2e-6, rtol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=rtol)


def _aa(n=64, seed=0):
    rng = np.random.RandomState(seed)
    aa = (rng.randn(n, 3) * 1.2).astype(np.float32)
    aa[:4] = 0.0            # identity rows hit the small-angle branches
    aa[4] = [1e-9, 0, 0]
    aa[5] = [np.pi, 0, 0]  # 180 degrees
    return aa


@pytest.mark.parametrize("name", [
    "axis_angle_to_matrix", "axis_angle_to_quaternion",
    "axis_angle_to_rotation_6d"])
def test_from_axis_angle(name):
    aa = _aa()
    _close(getattr(trot, name)(torch.tensor(aa)),
           getattr(jrot, name)(jnp.asarray(aa)))


@pytest.mark.parametrize("name", [
    "matrix_to_quaternion", "matrix_to_axis_angle",
    "matrix_to_rotation_6d"])
def test_from_matrix(name):
    mats = np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(_aa(seed=1))))
    _close(getattr(trot, name)(torch.tensor(mats)),
           getattr(jrot, name)(jnp.asarray(mats)), atol=1e-5)


def test_quaternion_and_6d_roundtrips():
    rng = np.random.RandomState(2)
    q = rng.randn(50, 4).astype(np.float32)
    _close(trot.quaternion_to_matrix(torch.tensor(q)),
           jrot.quaternion_to_matrix(jnp.asarray(q)))
    _close(trot.quaternion_to_axis_angle(torch.tensor(q)),
           jrot.quaternion_to_axis_angle(jnp.asarray(q)), atol=1e-5)
    d6 = rng.randn(50, 6).astype(np.float32)
    _close(trot.rotation_6d_to_matrix(torch.tensor(d6)),
           jrot.rotation_6d_to_matrix(jnp.asarray(d6)))
    _close(trot.rotation_6d_to_axis_angle(torch.tensor(d6)),
           jrot.rotation_6d_to_axis_angle(jnp.asarray(d6)), atol=1e-5)
    b = rng.randn(50, 4).astype(np.float32)
    _close(trot.quaternion_multiply(torch.tensor(q), torch.tensor(b)),
           jrot.quaternion_multiply(jnp.asarray(q), jnp.asarray(b)),
           atol=1e-5)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_and_rgb(deg):
    rng = np.random.RandomState(deg)
    sh = rng.randn(40, 16, 3).astype(np.float32)
    d = rng.randn(40, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    _close(tsh.eval_sh(deg, torch.tensor(sh), torch.tensor(d)),
           jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d)), atol=1e-5)
    _close(tsh.sh_to_rgb(deg, torch.tensor(sh), torch.tensor(d)),
           jsh.sh_to_rgb(deg, jnp.asarray(sh), jnp.asarray(d)), atol=1e-5)
    rgb = rng.rand(40, 3).astype(np.float32)
    _close(tsh.rgb2sh(torch.tensor(rgb)), jsh.rgb2sh(jnp.asarray(rgb)))


@pytest.mark.parametrize("kind", ["fov", "K_centered", "K_offset"])
def test_make_camera(kind):
    rng = np.random.RandomState(3)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = np.asarray(jrot.axis_angle_to_matrix(
        jnp.asarray(rng.randn(3).astype(np.float32) * 0.3)))
    w2c[:3, 3] = rng.randn(3)
    if kind == "fov":
        kw = dict(fovx=0.9, fovy=0.7)
    elif kind == "K_centered":
        kw = dict(K=np.array([[500, 0, 40], [0, 480, 24], [0, 0, 1.0]]))
    else:
        kw = dict(K=np.array([[500, 0, 31], [0, 480, 20], [0, 0, 1.0]]))
    tc = tgr.make_camera(w2c, 48, 80, **kw)
    jc = jgr.make_camera(w2c, 48, 80, **kw)
    for f in ("view", "proj", "cam_center"):
        _close(getattr(tc, f), getattr(jc, f), atol=0, rtol=0)
    assert (tc.height, tc.width, tc.tan_fovx, tc.tan_fovy) == (
        jc.height, jc.width, jc.tan_fovx, jc.tan_fovy)


@pytest.mark.parametrize("hw", [(9, 13), (1, 7), (6, 1)])
def test_grid_sample_forward(hw):
    rng = np.random.RandomState(4)
    grid = rng.rand(5, *hw).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (200, 2)).astype(np.float32)
    coords[:4] = [[-1, -1], [1, 1], [1, -1], [-1, 1]]  # exact corners
    _close(tsmp.grid_sample_2d(torch.tensor(grid), torch.tensor(coords)),
           jsmp.grid_sample_2d(jnp.asarray(grid), jnp.asarray(coords)))
