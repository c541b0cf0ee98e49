"""The port's simultaneous multi-case pool (train/trainer_cases.py) and
batch CLI (cli/train_batch.py) held against sings_tpu.

JAX's CasePool methods on stubs, as tests/test_torch_train_loop.py holds
the Trainer's: the per-case frame streams (40 draws a case), the
laplacian-width unification, and the padded frame count from kit
directories. Then the port's whole CasePool.train() at tiny size on the
CPU (two in-memory kits of 8 and 6 frames, 3 steps, a validation event
at step 2) with the asserts of tests/test_case_pool.py; the laplacian
type and the mesh the pool refuses, and the pool built with
tpu.laplacian_backend banded; and cli.train_batch.main in both modes.
"""
import json
import os
import types

import numpy as np
import pytest
import torch

from sings_tpu.config.core import load_config as jload_config
from sings_tpu.config.defaults import DEFAULTS as JDEFAULTS
from sings_tpu.data.kit import scan_kit_frames as jscan
from sings_tpu.train.trainer_cases import CasePool as JCasePool
from sings_tpu_torch.cli import train_batch
from sings_tpu_torch.config.core import load_config
from sings_tpu_torch.config.defaults import DEFAULTS
from sings_tpu_torch.train import trainer_cases as TC
from sings_tpu_torch.train.trainer_cases import CasePool
from sings_tpu_torch.tree import tree_leaves
from test_torch_train_step import _tiny_kit, _tiny_trainer_cfg

POOL = ["train.num_steps=3", "train.val_interval=2",
        "train.save_ckpt_interval=100000", "train.viz_interval=100000",
        "tpu.val_pose_refine_steps=2"]


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _no_images(path, img):
    return None


# ---------------------------------------------------------------------------
# JAX's methods on stubs


def _stub_trainers(seeds, n_train):
    return [types.SimpleNamespace(
        cfg=types.SimpleNamespace(seed=s),
        kit=types.SimpleNamespace(train_split=list(range(0, 2 * n, 2))))
        for s, n in zip(seeds, n_train)]


@pytest.mark.parametrize("seeds", [(0, 0), (3, 11)])
def test_frame_streams_match_jax(seeds):
    n_train = (7, 5)
    tstub = types.SimpleNamespace(trainers=_stub_trainers(seeds, n_train))
    CasePool._init_frame_streams(tstub)
    # JAX's constructor lines (sings_tpu/train/trainer_cases.py:96-101)
    jstub = types.SimpleNamespace(trainers=_stub_trainers(seeds, n_train))
    jstub._frame_rand = [np.random.RandomState(int(t.cfg.seed) + 7919 * c)
                         for c, t in enumerate(jstub.trainers)]
    jstub._orders = [list(range(len(t.kit.train_split)))
                     for t in jstub.trainers]
    for r, o in zip(jstub._frame_rand, jstub._orders):
        r.shuffle(o)
    jstub._cursors = [0, 0]
    for c in range(2):
        got = [CasePool._next_frame(tstub, c) for _ in range(40)]
        want = [int(JCasePool._next_frame(jstub, c)) for _ in range(40)]
        assert got == want
        # every training frame once per pass of the stream
        split = tstub.trainers[c].kit.train_split
        assert sorted(got[:len(split)]) == split
    assert tstub._orders[0] != tstub._orders[1] or seeds[0] != seeds[1]


def _lap_stubs(widths):
    def make(w):
        t = types.SimpleNamespace(_lap_pad=None, rebuilt=0)
        t.region_lap = types.SimpleNamespace(neighbors=np.zeros((16, w)))

        def rebuild(t=t):
            t.rebuilt += 1
            t.region_lap = types.SimpleNamespace(
                neighbors=np.zeros((16, t._lap_pad)))
        t._rebuild_laplacians = rebuild
        return t
    return types.SimpleNamespace(trainers=[make(w) for w in widths])


@pytest.mark.parametrize("widths", [(8, 11, 9), (8, 8), (12, 7)])
def test_unify_laps_matches_jax(widths):
    tstub, jstub = _lap_stubs(widths), _lap_stubs(widths)
    CasePool._unify_laps(tstub)
    JCasePool._unify_laps(jstub)
    got = [(t.region_lap.neighbors.shape[1], t._lap_pad, t.rebuilt)
           for t in tstub.trainers]
    want = [(t.region_lap.neighbors.shape[1], t._lap_pad, t.rebuilt)
            for t in jstub.trainers]
    assert got == want
    assert {g[0] for g in got} == {max(widths)}


@pytest.mark.parametrize("max_frames", [None, 7, 4])
def test_pad_frames_to_matches_jax(tmp_path, max_frames):
    """From kit directories of 8 and 6 frames (after skip_first 2): the
    count JAX's pool takes, per case and its maximum; from kits held in
    memory, their frame counts."""
    counts, jcounts = [], []
    for name, n in (("a", 8), ("b", 6)):
        images = tmp_path / name / "images"
        images.mkdir(parents=True)
        for i in range(n + 2):
            (images / f"{i:05d}.png").write_bytes(b"")
        dot = [f"dataset.root_dir={tmp_path}", f"dataset.name={name}"] + (
            [] if max_frames is None else [f"dataset.max_frames={max_frames}"])
        cfg = load_config(DEFAULTS, None, dot)
        counts.append(TC.case_frame_count(cfg))
        jcfg = jload_config(JDEFAULTS, None, dot)
        # JAX's constructor lines (sings_tpu/train/trainer_cases.py:41-48)
        kit_dir = os.path.normpath(os.path.join(
            jcfg.dataset.root_dir, jcfg.dataset.batch or "",
            jcfg.dataset.name, jcfg.dataset.seq or ""))
        jcounts.append(jscan(kit_dir,
                             max_frames=jcfg.dataset.get("max_frames")))
        kit_n = TC.case_frame_count(cfg, _tiny_kit(n))
        assert kit_n == (n if max_frames is None else min(n, max_frames))
    assert counts == jcounts and max(counts) == min(8, max_frames or 8)


# ---------------------------------------------------------------------------
# the whole pool


def _case_cfg(tmp_path, i, extra=()):
    return _tiny_trainer_cfg(tmp_path, POOL + [f"exp_name=case{i}",
                                               *extra])


def test_case_pool_two_cases(tmp_path):
    """Two cases of one kit name (8 and 6 frames) train 3 steps in
    lockstep on the CPU: the per-frame parameters padded to the longer
    case, the validation event at step 2 run per case, checkpoints and
    results in each case's logdir, the cases apart and finite (the
    asserts of tests/test_case_pool.py)."""
    cfgs = [_case_cfg(tmp_path, i) for i in range(2)]
    pool = CasePool(cfgs, device="cpu", kits=[_tiny_kit(8), _tiny_kit(6)],
                    image_writer=_no_images)
    ta, tb = pool.trainers
    assert ta.params.body_pose.shape == tb.params.body_pose.shape
    assert ta.params.body_pose.shape[0] == 8
    assert len(tb.kit.images) == 6  # the data itself is not padded
    assert [t.cfg.dataset.pad_frames_to for t in pool.trainers] == [8, 8]
    assert pool._rlap.neighbors.shape[0] == 2

    steps, validated = [], []
    orig_step = pool.step_fn

    def counted(*a, **k):
        out = orig_step(*a, **k)
        steps.append(a[7])
        return out

    pool.step_fn = counted
    for c, t in enumerate(pool.trainers):
        orig_val = t.validate

        def val(iter_s="final", _c=c, _v=orig_val):
            validated.append((_c, iter_s))
            return _v(iter_s)
        t.validate = val
    results = pool.train()
    assert pool.step == 3 and steps == [0, 1, 2]
    assert validated == [(0, "000002"), (1, "000002"), (0, "final"),
                         (1, "final")]
    assert sorted(results) == ["kit", "kit#1"]  # one kit name, deduped
    for t in pool.trainers:
        assert t.step == 3 and int(t.opt_state.count) == 3
        assert os.path.exists(os.path.join(t.logdir_ckpt, "human_final.npz"))
        with open(os.path.join(t.logdir, "results_train.json")) as fh:
            assert sorted(json.load(fh)) == ["000002", "final"]
    # other frames and other draws: the cases move apart
    assert not torch.allclose(ta.params.xyz, tb.params.xyz)
    for t in pool.trainers:
        for leaf in tree_leaves(t.params):
            assert bool(torch.isfinite(leaf).all())
        assert np.isfinite(results["kit"]["psnr"])


@pytest.mark.parametrize("extra,err,match", [
    (["human.loss.laplacian.type=cotangent"], NotImplementedError,
     "pool fails here too"),
    (["tpu.mesh={'dp': 1, 'gs': 2}"], ValueError, "exclusive"),
])
def test_case_pool_refusals(tmp_path, extra, err, match):
    cfgs = [_case_cfg(tmp_path, 0), _case_cfg(tmp_path, 1, extra)]
    with pytest.raises(err, match=match):
        CasePool(cfgs, device="cpu", kits=[_tiny_kit(4), _tiny_kit(4)])
    # gs > 1 needs a process group of gs ranks (tests/test_torch_dist_gs2)
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        CasePool(cfgs[:1], gs=2, device="cpu", kits=[_tiny_kit(4)])


def test_case_pool_builds_with_banded_backend(tmp_path):
    """tpu.laplacian_backend banded on a case: the port builds the
    gather laplacian for it, so the pool stacks both cases' tables
    (JAX's pool fails here: its banded laplacian has no neighbour
    table)."""
    cfgs = [_case_cfg(tmp_path, 0),
            _case_cfg(tmp_path, 1, ["tpu.laplacian_backend=banded"])]
    pool = CasePool(cfgs, device="cpu", kits=[_tiny_kit(4), _tiny_kit(4)])
    ta, tb = pool.trainers
    assert tb.cfg.tpu.laplacian_backend == "banded"
    assert type(ta.region_lap) is type(tb.region_lap)
    assert torch.equal(tb.region_lap.neighbors, ta.region_lap.neighbors)
    assert pool._rlap.neighbors.shape[0] == 2


# ---------------------------------------------------------------------------
# the CLI

CLI_BASE = ["--device", "cpu"]


def _cli_opts(tmp_path):
    cfg = _tiny_trainer_cfg(tmp_path)
    path = tmp_path / "base.json"
    cfg.dataset.pop("name")
    path.write_text(json.dumps(cfg.to_dict()))
    return ["-c", str(path), "train.num_steps=2", "train.init_steps=0",
            "human.canon_nframes=1", "tpu.val_pose_refine_steps=1"]


def _kits(names):
    return {n: _tiny_kit(4)._replace(name=n) for n in names}


@pytest.mark.parametrize("shard,trained", [("0/1", ["a", "b", "c"]),
                                           ("1/2", ["b"])])
def test_train_batch_sequential_selects_the_shard(monkeypatch, shard,
                                                  trained):
    """--shard i/n trains cases i, i+n, ... one after another, each
    through cli.train.main with its name, its kit and the device."""
    calls = []

    def fake_train(argv, *, kit=None, image_writer=None):
        calls.append((argv, kit.name, image_writer))
        return {"psnr": float(len(calls))}

    from sings_tpu_torch.cli import train as cli_train

    monkeypatch.setattr(cli_train, "main", fake_train)
    res = train_batch.main(CLI_BASE + ["--cases", "a", "b", "c", "--shard",
                                       shard, "x.y=1"],
                           kits=_kits("abc"), image_writer=_no_images)
    assert list(res) == trained
    assert [c[1] for c in calls] == trained
    for (argv, name, writer) in calls:
        assert argv == ["--device", "cpu", f"dataset.name={name}", "x.y=1"]
        assert writer is _no_images


def test_train_batch_sequential_trains(tmp_path):
    """The sequential mode end to end: shard 1/2 of three cases trains
    the middle one only (cli.train.main with the kit in memory)."""
    res = train_batch.main(
        CLI_BASE + ["--cases", "a", "b", "c", "--shard", "1/2"]
        + _cli_opts(tmp_path), kits=_kits("abc"), image_writer=_no_images)
    assert list(res) == ["b"] and np.isfinite(res["b"]["psnr"])
    root = os.path.join(str(tmp_path), "t")
    assert sorted(os.listdir(root)) == ["b"]
    assert os.path.exists(os.path.join(root, "b", "ckpt", "human_final.npz"))
    assert os.path.exists(os.path.join(root, "b", "showcase.splat"))


def test_train_batch_simultaneous(tmp_path):
    res = train_batch.main(
        CLI_BASE + ["--simultaneous", "--cases", "a", "b"]
        + _cli_opts(tmp_path), kits=_kits("ab"), image_writer=_no_images)
    assert sorted(res) == ["a", "b"]
    for name in ("a", "b"):
        d = os.path.join(str(tmp_path), "t", name)
        with open(os.path.join(d, "config_train.yaml")) as fh:
            cfg = json.load(fh)
        assert cfg["dataset"]["name"] == name
        assert cfg["dataset"]["pad_frames_to"] == 4
        assert os.path.exists(os.path.join(d, "ckpt", "human_final.npz"))
        assert os.path.exists(os.path.join(d, "showcase.splat"))
        assert np.isfinite(res[name]["psnr"])
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        train_batch.main(CLI_BASE + ["--simultaneous", "--gs", "2",
                                     "--cases", "a"] + _cli_opts(tmp_path),
                         kits=_kits("a"))
