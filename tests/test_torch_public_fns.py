"""The public functions the port's modules had left out, held against
sings_tpu on the same seeded numpy inputs, at the tolerances of the JAX
package's own tests for them: sample_patches (corners fed in: the port
draws from a torch.Generator, ROADMAP.md queue C), batch_rodrigues,
quaternion_apply (tests/test_rotations.py: atol 1e-5), sh2rgb
(tests/test_ops.py: atol 1e-6), fov2focal / focal2fov
(tests/test_reference_parity.py: pytest.approx), get_static_camera (the
projection's rtol / atol 1e-6 of tests/test_reference_parity.py) and
scan_kit_frames on directories of empty PNG files.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.data.cameras import get_static_camera as jstatic
from sings_tpu.data.kit import scan_kit_frames as jscan
from sings_tpu.kinematics.lbs import batch_rodrigues as jrod
from sings_tpu.losses.photometric import sample_patches as jsample
from sings_tpu.ops import graphics as jg
from sings_tpu.ops.rotations import quaternion_apply as jqa
from sings_tpu.ops.sh import sh2rgb as jsh2rgb
from sings_tpu_torch.data.cameras import get_static_camera
from sings_tpu_torch.data.kit import scan_kit_frames
from sings_tpu_torch.kinematics.lbs import batch_rodrigues
from sings_tpu_torch.losses.photometric import sample_patches
from sings_tpu_torch.ops import graphics as tg
from sings_tpu_torch.ops.rotations import axis_angle_to_matrix, quaternion_apply
from sings_tpu_torch.ops.sh import rgb2sh, sh2rgb


def jax_corners(rng, mask, num_patches, patch_size, ratio_mask=0.9):
    """The corners sings_tpu's sample_patches draws from `rng`."""
    h, w = mask.shape
    half = patch_size // 2
    k_in, k_u, k_choice = jax.random.split(rng, 3)
    interior = jax.lax.dynamic_slice(jnp.asarray(mask), (half, half),
                                     (h - patch_size, w - patch_size))
    logits = jnp.where(interior.reshape(-1) > 0, 0.0, -1e9)
    idx = jax.random.categorical(k_in, logits, shape=(num_patches,))
    ys_un = jax.random.randint(k_u, (num_patches,), 0, h - patch_size)
    xs_un = jax.random.randint(k_u, (num_patches,), 0, w - patch_size)
    use = jax.random.uniform(k_choice, ()) < ratio_mask
    ys = jnp.where(use, idx // (w - patch_size), ys_un)
    xs = jnp.where(use, idx % (w - patch_size), xs_un)
    return (torch.tensor(np.asarray(ys)).long(),
            torch.tensor(np.asarray(xs)).long())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sample_patches_matches_jax(seed):
    rng = np.random.RandomState(seed)
    h, w, p = 40, 56, 12
    mask = np.zeros((h, w), np.float32)
    mask[8:30, 20:40] = 1.0
    imgs = [rng.rand(3, h, w).astype(np.float32),
            rng.rand(1, h, w).astype(np.float32)]
    key = jax.random.PRNGKey(seed)
    want = jsample(key, jnp.asarray(mask), tuple(jnp.asarray(x) for x in imgs),
                   num_patches=5, patch_size=p)
    got = sample_patches(None, torch.tensor(mask),
                         tuple(torch.tensor(x) for x in imgs),
                         num_patches=5, patch_size=p,
                         corners=jax_corners(key, mask, 5, p))
    assert len(got) == 2
    for g, wnt in zip(got, want):
        assert tuple(g.shape) == tuple(wnt.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_sample_patches_draws_inside_the_mask():
    """Its own draws: with ratio_mask 1 every patch centre lies in the
    mask, and the crops are the image at those corners."""
    h, w, p = 40, 56, 12
    mask = torch.zeros((h, w))
    mask[10:22, 30:44] = 1.0
    img = torch.arange(h * w, dtype=torch.float32).reshape(1, h, w)
    gen = torch.Generator().manual_seed(0)
    (patches,) = sample_patches(gen, mask, (img,), num_patches=16,
                                patch_size=p, ratio_mask=1.0)
    assert patches.shape == (16, 1, p, p)
    ys = (patches[:, 0, 0, 0] // w).long()
    xs = (patches[:, 0, 0, 0] % w).long()
    assert bool((mask[ys + p // 2, xs + p // 2] > 0).all())
    for i in range(16):
        assert torch.equal(patches[i, 0], img[0, ys[i]:ys[i] + p,
                                              xs[i]:xs[i] + p])


def test_batch_rodrigues_and_quaternion_apply_match_jax():
    rng = np.random.RandomState(5)
    aa = (rng.randn(4, 7, 3) * 1.5).astype(np.float32)
    aa[0, 0] = 0.0  # the zero rotation
    np.testing.assert_allclose(batch_rodrigues(torch.tensor(aa)).numpy(),
                               np.asarray(jrod(jnp.asarray(aa))), atol=1e-5)
    assert torch.equal(batch_rodrigues(torch.tensor(aa)),
                       axis_angle_to_matrix(torch.tensor(aa)))
    q = rng.randn(16, 4).astype(np.float32)
    pts = rng.randn(16, 3).astype(np.float32)
    got = quaternion_apply(torch.tensor(q), torch.tensor(pts)).numpy()
    np.testing.assert_allclose(got, np.asarray(jqa(jnp.asarray(q),
                                                   jnp.asarray(pts))),
                               atol=1e-5)
    # a rotation keeps lengths
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1),
                               np.linalg.norm(pts, axis=-1), atol=1e-5)


def test_sh2rgb_matches_jax():
    rng = np.random.RandomState(1)
    sh = rng.randn(10, 3).astype(np.float32)
    np.testing.assert_allclose(sh2rgb(torch.tensor(sh)).numpy(),
                               np.asarray(jsh2rgb(jnp.asarray(sh))),
                               atol=1e-6)
    rgb = torch.tensor(rng.rand(10, 3).astype(np.float32))
    np.testing.assert_allclose(sh2rgb(rgb2sh(rgb)).numpy(), rgb.numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("fov,pixels", [(0.9, 512), (0.4, 1080),
                                        (1.3, 96)])
def test_fov_focal_match_jax(fov, pixels):
    assert tg.fov2focal(fov, pixels) == pytest.approx(
        jg.fov2focal(fov, pixels))
    focal = tg.fov2focal(fov, pixels)
    assert tg.focal2fov(focal, pixels) == pytest.approx(
        jg.focal2fov(focal, pixels))
    assert tg.focal2fov(focal, pixels) == pytest.approx(fov)


@pytest.mark.parametrize("size,fov", [(512, 0.4), (96, 0.9)])
def test_get_static_camera_matches_jax(size, fov):
    got = get_static_camera(size, fov)
    want = jstatic(size, fov)
    for k in ("view", "proj", "cam_center"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert (got.height, got.width) == (want.height, want.width) == (size,
                                                                    size)
    assert got.tan_fovx == pytest.approx(want.tan_fovx)
    assert got.tan_fovy == pytest.approx(want.tan_fovy)


@pytest.mark.parametrize("n_files,skip_first,max_frames", [
    (10, 2, None), (10, 2, 5), (10, 0, None), (10, 3, 20), (1, 2, None),
    (0, 2, 4), (2, 2, None), (6, 1, 5)])
def test_scan_kit_frames_matches_jax(tmp_path, n_files, skip_first,
                                     max_frames):
    images = tmp_path / "images"
    images.mkdir()
    for i in range(n_files):
        (images / f"{i:05d}.png").write_bytes(b"")
    (images / "notes.txt").write_text("not an image")
    got = scan_kit_frames(str(tmp_path), skip_first=skip_first,
                          max_frames=max_frames)
    assert got == jscan(str(tmp_path), skip_first=skip_first,
                        max_frames=max_frames)
    assert got == max(min(n_files - skip_first,
                          max_frames if max_frames is not None else 10**9),
                      0)
