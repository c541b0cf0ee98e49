"""The port's spans (ops/profiling.py::span) at its layer boundaries.

With no profiler running a span is one shared no-op and never reaches
record_function. Under profiling.trace() one training step of the tiny
Trainer writes the step's five spans (and step.draws where the step
draws its own randoms), the rasterizer's forward spans inside
step.rasterize and its backward spans and the triplane's inside
step.backward; a 2-frame animation chunk writes one anim.pose, two
anim.frame and one anim.readback. A step traced and a step untraced
give the same state bit for bit.
"""
import json

import numpy as np
import pytest
import torch

from sings_tpu_torch.losses.photometric import draw_step_randoms
from sings_tpu_torch.ops import profiling
from sings_tpu_torch.tree import tree_leaves
from test_torch_train_step import STEP, _tiny_kit, _tiny_trainer_cfg

STEP_SPANS = ("step.decode", "step.rasterize", "step.losses",
              "step.backward", "step.update")
RASTER_FWD = ("raster.preprocess", "raster.bin", "raster.gather",
              "raster.composite_fwd")
BACKWARD = ("raster.composite_bwd", "raster.unsort", "triplane.bwd")


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    from sings_tpu_torch.train.trainer import Trainer

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("spans")
    tr = Trainer(_tiny_trainer_cfg(tmp, ["train.init_steps=0"]),
                 mode="train", device="cpu", kit=_tiny_kit(),
                 image_writer=lambda path, img: None)
    yield tr
    torch.set_num_threads(saved)


def _one_step(tr):
    """One train_step on the first training frame with fixed draws:
    (params, opt_state, metrics)."""
    f = int(tr.kit.train_split[0])
    batch = {"rgb": tr.images[f], "mask": tr.masks[f], "idx": f,
             "smpl_scale": torch.ones(1)}
    draws = draw_step_randoms(torch.Generator().manual_seed(5),
                              batch["mask"], tr.step_cfg.weights.photometric)
    p, _b, o, m, _r = tr.train_step(
        tr.params, tr.buffers, tr.opt_state, tr.cache, batch,
        tr.step_generator, STEP, 0, tr.region_lap, tr.region_lap,
        tr.lap_pos_w, tr.lap_color_w, draws=draws)
    return p, o, m


def _ranges(tmp_path) -> dict:
    """name -> [(start, end)] of the trace's user_annotation ranges."""
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    out: dict = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            out.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return out


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_span_without_a_profiler_is_one_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first = profiling.span("step.decode")
    assert all(profiling.span(n) is first
               for n in STEP_SPANS + RASTER_FWD + BACKWARD)
    with first as entered:
        with profiling.span("raster.bin"):
            assert entered is None


def test_span_under_a_profiler_is_a_record_function():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        s = profiling.span("raster.bin")
        assert isinstance(s, torch.profiler.record_function)
        with s:
            torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert names.count("raster.bin") == 1


def test_train_step_writes_its_spans(trainer, tmp_path):
    with profiling.trace(str(tmp_path)):
        _one_step(trainer)
    r = _ranges(tmp_path)
    for name in STEP_SPANS:
        assert len(r.get(name, [])) == 1, name
    assert "step.knn_stat" not in r  # only a scan's chunk head takes it
    assert "step.draws" not in r  # the caller passed the draws
    (rast,), (back,) = r["step.rasterize"], r["step.backward"]
    for name in RASTER_FWD:
        assert len(r[name]) == 1 and _inside(r[name][0], rast), name
    for name in BACKWARD:
        assert r.get(name) and all(_inside(iv, back) for iv in r[name]), name
    # the step's stages in order, none overlapping the next
    order = [r[n][0] for n in STEP_SPANS]
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))


def test_scan_writes_the_statistic_once_a_chunk(trainer, tmp_path):
    tr = trainer
    frames = [int(f) for f in tr.kit.train_split[:2]]
    batches = {"rgb": tr.images[frames], "mask": tr.masks[frames],
               "idx": frames, "smpl_scale": torch.ones((2, 1))}
    assert tr.step_cfg.knn_backend == "chunk"
    with profiling.trace(str(tmp_path)):
        tr.train_scan(tr.params, tr.buffers, tr.opt_state, tr.cache,
                      batches, tr.step_generator, STEP, 0, tr.region_lap,
                      tr.region_lap, tr.lap_pos_w, tr.lap_color_w)
    r = _ranges(tmp_path)
    assert len(r["step.knn_stat"]) == 1
    assert len(r["step.decode"]) == len(r["step.update"]) == 2
    assert r["step.knn_stat"][0][1] <= min(a for a, _ in r["step.decode"])
    # each step draws its own randoms before its decode
    assert len(r["step.draws"]) == 2
    assert all(d[1] <= a for d, (a, _) in zip(sorted(r["step.draws"]),
                                              sorted(r["step.decode"])))


def test_render_chunk_writes_pose_frames_and_readback(trainer, tmp_path):
    from sings_tpu_torch.data.anim import load_anim_dataset
    from sings_tpu_torch.model.avatar import get_gs_attrs

    tr = trainer
    # a custom motion's last frame is cut (motion_end -1): two are left
    pose = np.zeros((3, 72), np.float32)
    pose[:, 0] = np.pi
    pose[1, 3] = 0.3
    motion = tmp_path / "motion.npz"
    np.savez(motion, body_pose=pose, transl=np.zeros((3, 3), np.float32))
    saved = tr.anim_dataset
    tr.anim_dataset = load_anim_dataset(str(motion), "custom",
                                        render_size=(48, 48), fx=60.0,
                                        fy=60.0)
    got = []
    try:
        with profiling.trace(str(tmp_path / "render")):
            with torch.no_grad():
                gs_attrs = get_gs_attrs(tr.params, tr.buffers,
                                        tr.avatar_cfg)
            frames = tr.render_chunk(gs_attrs,
                                     tr.anim_dataset.get_chunk(0, 2))
        with profiling.trace(str(tmp_path / "anim")):
            tr.animate_chunk(chunk_size=2, save_video=False,
                             writer=lambda f, s: got.append(f.shape))
    finally:
        tr.anim_dataset = saved
    assert tuple(frames.shape) == (2, 48, 48, 3) and got == [(2, 48, 48, 3)]
    r = _ranges(tmp_path / "render")
    assert len(r["anim.pose"]) == 1 and len(r["anim.frame"]) == 2
    assert "anim.readback" not in r
    pose_iv = r["anim.pose"][0]
    assert all(pose_iv[1] <= a for a, _ in r["anim.frame"])
    assert all(any(_inside(b, f) for f in r["anim.frame"])
               for b in r["raster.bin"]) and len(r["raster.bin"]) == 2
    r = _ranges(tmp_path / "anim")
    assert [len(r[n]) for n in ("anim.pose", "anim.frame",
                                "anim.readback")] == [1, 2, 1]


def test_a_traced_step_equals_an_untraced_one(trainer, tmp_path):
    plain = _one_step(trainer)
    with profiling.trace(str(tmp_path)):
        traced = _one_step(trainer)
    p0, o0, m0 = plain
    p1, o1, m1 = traced
    for name, a, b in (("params", p0, p1), ("mu", o0.mu, o1.mu),
                       ("nu", o0.nu, o1.nu)):
        la, lb = tree_leaves(a), tree_leaves(b)
        assert len(la) == len(lb) > 0
        assert all(torch.equal(x, y) for x, y in zip(la, lb)), name
    assert m0.keys() == m1.keys()
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
