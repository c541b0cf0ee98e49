"""Closed-loop animation traffic: Trainer.animate_chunk over the seeded
motion, whole passes one after another until the window has passed,
each chunk's frames going to an in-memory sink. The benchmark wraps the
trainer's render_chunk to stamp each chunk's start; a chunk's latency
runs from that call to its frames reaching the sink, readback included.

Set-up: Trainer(mode="anim") with the seeded weights, then one warm
chunk. `correct` compares chunks of the window drawn from the seed with
the reference's render of the same motion frames.

Traffic keys: chunk_frames, motion_frames (before the skip),
motion_skip, render_size, focal, check_chunks (chunks compared),
kit_frames, kit_size.
"""
from __future__ import annotations

import os
import statistics
import time

import numpy as np
import torch
from torch.profiler import record_function

import inputs
from common import capture_first, profile_start, profile_stop
from compare import frame_numbers, judge


class State:
    pass


def program_dotlist(ctx, anim_cfg: str) -> list:
    return list(ctx.config["dotlist"]) + [
        f"output_path={ctx.tmp}", "exp_name=bench", "dataset.name=kit",
        f"anim_cfg_path={anim_cfg}", f"seed={ctx.seed % (1 << 31)}",
        "eval=True", f"tpu.smpl_model_dir={ctx.tmp}/no_licensed_models"]


def reference_inputs(ctx) -> dict:
    """The cell's inputs: the seeded motion and its animation config in
    the run's directory, the seeded weights and the kit's poses."""
    from reference import build as RB

    tf, dev = ctx.traffic, ctx.device
    motion = os.path.join(ctx.tmp, "motion.npz")
    inputs.write_motion(motion, int(tf["motion_frames"]), ctx.seed, dev)
    anim_cfg = os.path.join(ctx.tmp, "anim.json")
    inputs.write_anim_cfg(anim_cfg, motion, tf)
    dotlist = program_dotlist(ctx, anim_cfg)
    rcfg = RB.config(dotlist)
    return {"cfg": rcfg, "dotlist": dotlist, "motion": motion,
            "weights": inputs.seeded_weights(RB.weight_layout(rcfg),
                                             ctx.seed, dev),
            "smpl": inputs.kit_smpl(int(tf["kit_frames"]), ctx.seed, dev,
                                    jitter=False)}


def check_starts(ctx, num_frames: int, size: int) -> list:
    """The starts of the compared chunks: check_chunks - 1 drawn from the
    seed and the padded last chunk."""
    starts = list(range(0, num_frames, size))
    g = inputs.generator(ctx.seed, inputs.STREAM_DRAWS, "cpu")
    k = int(ctx.traffic["check_chunks"])
    pick = torch.randperm(len(starts) - 1, generator=g)[:k - 1].tolist()
    return sorted({starts[i] for i in pick} | {starts[-1]})


def setup(ctx) -> State:
    from sings_tpu_torch.config.core import load_config
    from sings_tpu_torch.config.defaults import DEFAULTS
    from sings_tpu_torch.data.kit import TrainingKit, get_data_splits
    from sings_tpu_torch.ops.graphics import make_camera
    from sings_tpu_torch.train.trainer import Trainer

    tf, dev = ctx.traffic, ctx.device
    st = State()
    st.ctx = ctx
    ri = reference_inputs(ctx)
    n_frames, size = int(tf["kit_frames"]), int(tf["kit_size"])
    train, val = get_data_splits(n_frames)
    kit = TrainingKit(
        images=np.zeros((n_frames, 3, size, size), np.float32),
        masks=np.zeros((n_frames, size, size), np.float32), smpl=ri["smpl"],
        camera=make_camera(np.eye(4), size, size,
                           K=inputs.kit_intrinsics(size)),
        train_split=train, val_split=val, name="kit")
    cfg = load_config(DEFAULTS, None, ri["dotlist"])
    tr = Trainer(cfg, mode="anim", device=dev, kit=kit,
                 image_writer=lambda path, img: None)
    tr.params = tr.params._replace(**inputs.clone_weights(ri["weights"]))
    st.trainer, st.ri = tr, ri
    st.size = int(tf["chunk_frames"])
    n = tr.anim_dataset.num_frames
    st.check_starts = check_starts(ctx, n, st.size)
    st.kept = {}
    st.stamps = []
    render = tr.render_chunk

    def stamped(gs_attrs, chunk):
        st.stamps.append(time.perf_counter())
        with record_function("render_chunk"):
            return render(gs_attrs, chunk)

    tr.render_chunk = stamped
    st.latencies, st.frames = [], 0

    def sink(frames, start):
        with record_function("writer"):
            st.latencies.append(time.perf_counter() - st.stamps.pop(0))
            st.frames += frames.shape[0]
            if start in st.check_starts:
                st.kept[start] = frames.copy()

    st.sink = sink
    # ---- one warm chunk
    tr.animate_chunk(chunk_size=st.size, save_video=False, writer=sink,
                     max_frames=st.size)
    st.latencies, st.frames, st.kept = [], 0, {}
    ctx.note(f"[setup] {int(tr.buffers.alive.sum())} live gaussians, "
             f"{n} motion frames in chunks of {st.size}, compared chunks "
             f"at {st.check_starts}")
    return st


def _pass(st) -> None:
    st.trainer.animate_chunk(chunk_size=st.size, save_video=False,
                             writer=st.sink)


def window(st, seconds: float) -> dict:
    """Whole passes over the motion until `seconds` have passed; every
    frame that reached the sink over the whole window, and the 95th
    percentile of every chunk's latency."""
    t0 = time.perf_counter()
    ends = []
    while True:
        _pass(st)
        t1 = time.perf_counter()
        ends.append(t1)
        if t1 - t0 >= seconds:
            break
    passes = [b - a for a, b in zip([t0] + ends[:-1], ends)]
    st.ctx.note(f"[window] {len(passes)} passes of "
                f"{[round(p, 3) for p in passes]} s")
    lat = sorted(st.latencies)
    p95 = statistics.quantiles(lat, n=100, method="inclusive")[94]
    return {"attempted": st.frames, "failed": 0,
            "metrics": {"anim_frames_per_s": (st.frames / (t1 - t0),
                                               "frames/s"),
                        "anim_chunk_p95_ms": (1e3 * p95, "ms")}}


def traced(st, path: str) -> dict:
    """One whole pass over the motion with the device traced alone (the
    window by the host's clock), the first frame's composite launch
    captured for the roofline reader; then one more pass with the host
    traced too, for the idle gaps by what the host was doing."""
    from sings_tpu_torch.ops.rasterizer import kernels as K

    prof = profile_start(host=False)
    with capture_first(K, {"fwd": "composite_fwd_cuda"}) as captured:
        t0 = time.perf_counter()
        _pass(st)
        window_s = time.perf_counter() - t0
    trace = profile_stop(prof, path, window_s=window_s)
    frames = st.frames
    prof = profile_start(host=True)
    _pass(st)
    gaps = profile_stop(prof, path, window="render_chunk").idle_gaps()
    return {"attempted": st.frames, "failed": 0, "trace": trace,
            "units": frames, "captured": captured, "gaps": gaps}


def release(st) -> None:
    st.trainer = None


def check(st) -> tuple:
    """The reference's frames of the compared chunks against the
    program's."""
    from reference import build as RB
    from reference.anim import chunk_frames
    from reference.plain.data.anim import load_anim_dataset

    dev = st.ctx.device
    tf = st.ctx.traffic
    missing = [s for s in st.check_starts if s not in st.kept]
    if missing:
        return judge({"off_share": 1.0, "max_levels": 255.0}, st.ctx.limits)
    ri = st.ri
    av = RB.avatar(ri["cfg"], ri["smpl"], ri["weights"], dev)
    ds = load_anim_dataset(ri["motion"], "custom", 0, -1,
                           int(tf["motion_skip"]),
                           tuple(tf["render_size"]),
                           fx=float(tf["focal"]), fy=float(tf["focal"]),
                           device=dev)
    bg = (torch.ones(3, device=dev) if ri["cfg"].bg_color == "white"
          else torch.zeros(3, device=dev))
    prog, ref = [], []
    for s in st.check_starts:
        prog.append(st.kept[s])
        ref.append(chunk_frames(av, ds, s, st.size, bg))
    return judge(frame_numbers(prog, ref), st.ctx.limits)
