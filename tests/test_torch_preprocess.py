"""The port's host preprocess stages (sings_tpu_torch/preprocess/{fit,
frames,masks}.py) held against sings_tpu's on the same inputs: each
case of tests/test_preprocess_{fit,frames,masks}.py, run through both
packages, with the written files compared byte for byte (the .npz
archives, whose zip headers carry a time stamp, array by array) and the
returned values and error messages equal. The bundled-kit cases of those
files read a kit that is not in the repository; here a seeded kit and a
seeded AlphaPose halpe-26 file take its place.
"""
import json
import os

import numpy as np
import pytest

from sings_tpu.data.kit import load_smpl_param as jload_smpl
from sings_tpu.preprocess import fit as jfit
from sings_tpu.preprocess import frames as jframes
from sings_tpu.preprocess import masks as jmasks
from sings_tpu_torch.data.kit import load_smpl_param as tload_smpl
from sings_tpu_torch.preprocess import fit as tfit
from sings_tpu_torch.preprocess import frames as tframes
from sings_tpu_torch.preprocess import masks as tmasks

cv2 = pytest.importorskip("cv2")


def same_files(a, b):
    """Every file under a and b: the same names and bytes (.npz: the
    same arrays, dtypes included)."""
    names_a = sorted(os.path.relpath(os.path.join(d, f), a)
                     for d, _, fs in os.walk(a) for f in fs)
    names_b = sorted(os.path.relpath(os.path.join(d, f), b)
                     for d, _, fs in os.walk(b) for f in fs)
    assert names_a == names_b
    for name in names_a:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".npz"):
            da, db = dict(np.load(pa)), dict(np.load(pb))
            assert sorted(da) == sorted(db), name
            for k in da:
                assert da[k].dtype == db[k].dtype, (name, k)
                np.testing.assert_array_equal(da[k], db[k])
        else:
            assert open(pa, "rb").read() == open(pb, "rb").read(), name
    return names_a


def write_frames(kit_dir, f=6, h=8, w=8):
    os.makedirs(os.path.join(kit_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(kit_dir, "masks"), exist_ok=True)
    for i in range(f):
        img = np.full((h, w, 3), 128, np.uint8)
        cv2.imwrite(os.path.join(kit_dir, "images", f"{i:06d}.png"), img)
        cv2.imwrite(os.path.join(kit_dir, "masks", f"{i:06d}.png"),
                    img[..., 0])


def both(tmp_path, fn):
    """fn(module, kit_dir) through each package in its own directory;
    the two results (or raised messages) and directories."""
    out = []
    for name, mod in (("jax", jfit), ("port", tfit)):
        kit = str(tmp_path / name)
        os.makedirs(kit, exist_ok=True)
        try:
            out.append(fn(mod, kit))
        except ValueError as e:
            out.append(("ValueError", str(e).replace(kit, "<kit>")))
    return out, str(tmp_path / "jax"), str(tmp_path / "port")


# ---------------------------------------------------------------------------
# fit.py: the kit contract writers and the validator


def test_writers_roundtrip_matches_jax(tmp_path):
    f = 6
    rng = np.random.RandomState(0)
    betas = rng.randn(f, 10).astype(np.float32)
    go = rng.randn(f, 3).astype(np.float32)
    bp = rng.randn(f, 69).astype(np.float32)
    tr = rng.randn(f, 3).astype(np.float32)

    def run(mod, kit):
        path = mod.write_poses_npz(kit, betas, go, bp, tr)
        mod.write_cameras_npz(kit, height=8, width=8, focal=5000.0)
        write_frames(kit, f=f)
        info = dict(mod.validate_kit(kit))
        mod.write_poses_npz(kit, betas, go, bp, tr, optimized=True)
        return (os.path.relpath(path, kit), info,
                dict(mod.validate_kit(kit)))

    (want, got), jdir, tdir = both(tmp_path, run)
    for w, g in zip(want[1:], got[1:]):
        w.pop("kit_dir"), g.pop("kit_dir")
    assert got == want
    assert got[1]["num_frames"] == f and got[2]["optimized_poses"]
    same_files(jdir, tdir)
    # the port's kit loader reads what the port wrote as JAX's reads JAX's
    js = jload_smpl(os.path.join(jdir, want[0]))
    ts = tload_smpl(os.path.join(tdir, got[0]))
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k])
    np.testing.assert_allclose(ts["betas"], betas.mean(0), atol=1e-6)


@pytest.mark.parametrize("case", ["missing_mask", "pose_shortfall"])
def test_validate_kit_problems_match_jax(tmp_path, case):
    rng = np.random.RandomState(1)

    def run(mod, kit):
        if case == "missing_mask":
            write_frames(kit, f=4)
            os.remove(os.path.join(kit, "masks", "000003.png"))
        else:
            write_frames(kit, f=5)
            mod.write_poses_npz(kit, rng.randn(10), rng.randn(3, 3),
                                rng.randn(3, 69), rng.randn(3, 3))
            mod.write_cameras_npz(kit, height=8, width=8, focal=100.0)
        return mod.validate_kit(kit)

    (want, got), _, _ = both(tmp_path, run)
    assert want[0] == "ValueError" and got == want
    if case == "missing_mask":
        assert "4 images vs 3 masks" in got[1] and "poses.npz" in got[1]
    else:
        assert "pose frames" in got[1]


def test_validate_main_prints_what_jax_prints(tmp_path, capsys):
    def run(mod, kit):
        mod.write_poses_npz(kit, np.zeros(10), np.zeros((5, 3)),
                            np.zeros((5, 69)), np.zeros((5, 3)))
        mod.write_cameras_npz(kit, height=8, width=8, focal=100.0)
        write_frames(kit, f=5)
        mod.main([kit, "--skip-first", "1"])
        return json.loads(capsys.readouterr().out.replace(kit, "<kit>"))

    (want, got), jdir, tdir = both(tmp_path, run)
    assert got == want and got["usable_frames"] == 4
    same_files(jdir, tdir)


def test_patch_phalp_smpl_cache_matches_jax(tmp_path):
    src = tmp_path / "SMPL_NEUTRAL.pkl"
    src.write_bytes(b"pkl")
    want = jfit.patch_phalp_smpl_cache(str(src), cache_dir=str(tmp_path / "j"))
    got = tfit.patch_phalp_smpl_cache(str(src), cache_dir=str(tmp_path / "t"))
    assert os.path.relpath(got, tmp_path / "t") == os.path.relpath(
        want, tmp_path / "j")
    same_files(str(tmp_path / "j"), str(tmp_path / "t"))
    assert open(got, "rb").read() == b"pkl"


# ---------------------------------------------------------------------------
# frames.py: video -> images/%06d.png


def write_video(path, n_frames=12, hw=64, fps=10):
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (hw, hw))
    assert vw.isOpened()
    for i in range(n_frames):
        frame = np.full((hw, hw, 3), i * 20 % 255, np.uint8)
        frame[:8, :8] = (255, 0, 0)
        vw.write(frame)
    vw.release()


@pytest.mark.parametrize("kw", [
    {}, dict(frame_interval=3, img_center=(32, 32), crop_hw=(32, 32),
             resize_to=48)], ids=["every_frame", "interval_and_crop"])
def test_extract_frames_matches_jax(tmp_path, kw):
    vid = str(tmp_path / "v.mp4")
    write_video(vid)
    want = jframes.extract_frames(vid, str(tmp_path / "j"), **kw)
    got = tframes.extract_frames(vid, str(tmp_path / "t"), **kw)
    assert got == want == (4 if kw else 12)
    names = same_files(str(tmp_path / "j"), str(tmp_path / "t"))
    assert names[0] == os.path.join("images", "000000.png")
    first = cv2.imread(str(tmp_path / "t" / "images" / "000000.png"))
    assert first.shape == ((48, 48, 3) if kw else (64, 64, 3))


def test_extract_frames_main_and_missing_video_match_jax(tmp_path, capsys):
    vid = str(tmp_path / "v.mp4")
    write_video(vid, n_frames=5)
    for mod, out in ((jframes, "j"), (tframes, "t")):
        mod.main(["-v", vid, "-o", str(tmp_path / out), "--frame_interval",
                  "2", "--img_center", "30", "34", "--img_h", "40",
                  "--img_w", "24", "--resize_to", "32"])
    printed = capsys.readouterr().out.splitlines()
    assert printed == [f"saved 3 frames to {tmp_path / d / 'images'}"
                       for d in ("j", "t")]
    same_files(str(tmp_path / "j"), str(tmp_path / "t"))
    for mod in (jframes, tframes):
        with pytest.raises(FileNotFoundError):
            mod.extract_frames(str(tmp_path / "nope.mp4"),
                               str(tmp_path / "kit"))
        with pytest.raises(ValueError, match="crop_hw"):
            mod.extract_frames(vid, str(tmp_path / "kit"),
                               img_center=(1, 1))


# ---------------------------------------------------------------------------
# masks.py: AlphaPose prompts -> SAM2 (a fake predictor) -> masks


def alphapose_json(path, n_frames=6, seed=3):
    """A seeded halpe-26 results file: person 0 in every frame (its idx
    nested in lists on some, the AlphaPose quirk), person 1 in two."""
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n_frames):
        for person in ((0, 1) if i in (2, 4) else (0,)):
            kp = np.concatenate([rng.uniform(0, 100, (26, 2)),
                                 rng.uniform(0, 1, (26, 1))], axis=1)
            idx = [[person]] if i % 3 == 1 else person
            rows.append({"image_id": f"{i}.jpg", "idx": idx,
                         "keypoints": kp.reshape(-1).round(3).tolist(),
                         "box": rng.uniform(0, 100, 4).round(2).tolist()})
    with open(path, "w") as fh:
        json.dump(rows, fh)
    return path


def test_check_poses_and_point_prompts_match_jax(tmp_path):
    apj = alphapose_json(str(tmp_path / "alphapose-results.json"))
    want = jmasks.check_poses(apj)
    got = tmasks.check_poses(apj)
    assert got == want and sorted(got) == [0, 1] and len(got[0]) == 6
    for pose in got[0] + got[1]:
        (tp, tl), (jp, jl) = (tmasks.build_point_prompt(pose),
                              jmasks.build_point_prompt(pose))
        assert tp.shape == (20, 2)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("box", [(100, 200, 300, 400), (0, 0, 1080, 1080),
                                 (10.5, 20.25, 30.75, 1079.5),
                                 (900, 5, 1075, 60)])
def test_resize_bbox_matches_jax(box):
    for args in ((box,), (box, 1080, 1080, 1.2), (box, 960, 720, 1.5)):
        got, want = tmasks.resize_bbox(*args), jmasks.resize_bbox(*args)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("erode_size", [0, 1, 3])
def test_postprocess_mask_matches_jax(erode_size):
    rng = np.random.RandomState(erode_size)
    m = rng.rand(1, 17, 13) > 0.3
    m[0, 2:12, 2:10] = True
    got = tmasks.postprocess_mask(m, erode_size=erode_size)
    want = jmasks.postprocess_mask(m, erode_size=erode_size)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tmasks.postprocess_mask(m[0], erode_size),
        jmasks.postprocess_mask(m[0], erode_size))


class FakePredictor:
    """The SAM2 video-predictor protocol the stage drives."""

    def __init__(self, n_frames, h, w):
        self.n, self.h, self.w = n_frames, h, w
        self.prompts = []

    def init_state(self, video_path):
        return {"dir": video_path}

    def add_new_points_or_box(self, inference_state, frame_idx, obj_id,
                              points, labels):
        self.prompts.append((frame_idx, obj_id, np.asarray(points),
                             np.asarray(labels)))
        return frame_idx, [obj_id], None

    def propagate_in_video(self, state):
        for i in range(self.n):
            mask = np.zeros((1, self.h, self.w), np.float32) - 1.0
            mask[:, 4:-4 - i, 3 + i:-4] = 1.0
            yield i, [1], [mask]


@pytest.mark.parametrize("only_first_frame", [True, False],
                         ids=["first_frame", "all_frames"])
def test_run_sam2_video_matches_jax(tmp_path, only_first_frame):
    n = 3
    apj = str(tmp_path / "alphapose-results.json")
    with open(alphapose_json(apj, n)) as fh:
        rows = [r for r in json.load(fh) if r["idx"] not in (1, [[1]])]
    with open(apj, "w") as fh:
        json.dump(rows, fh)  # one person: the stage's contract
    runs = {}
    for name, mod in (("j", jmasks), ("t", tmasks)):
        vdir = tmp_path / name / "images"
        vdir.mkdir(parents=True)
        for i in range(n):
            cv2.imwrite(str(vdir / f"{i:06d}.png"),
                        np.full((16, 16, 3), 40 * i, np.uint8))
        pred = FakePredictor(n, 16, 16)
        out = mod.run_sam2_video(str(vdir), apj, predictor=pred,
                                 only_first_frame=only_first_frame,
                                 erode_size=3, cleanup_jpg=True)
        assert out == str(tmp_path / name / "masks")
        runs[name] = pred.prompts
    want, got = runs["j"], runs["t"]
    assert [p[:2] for p in got] == [p[:2] for p in want]
    assert [p[0] for p in got] == ([0, 1] if only_first_frame else [0, 1, 2])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_array_equal(g[3], w[3])
    names = same_files(str(tmp_path / "j"), str(tmp_path / "t"))
    assert [x for x in names if x.endswith(".jpg")] == []
    for mod in (jmasks, tmasks):
        with pytest.raises(ImportError, match="sam2"):
            mod.run_sam2_video(str(tmp_path / "t" / "images"), apj)
        with pytest.raises(ValueError, match="single-person"):
            mod.run_sam2_video(str(tmp_path / "t" / "images"),
                               alphapose_json(str(tmp_path / "two.json")),
                               predictor=FakePredictor(n, 16, 16))
