"""Closed-loop training of C avatars in lockstep (configuration
human_complex_pool2, C = its "cases"): the port's case pool,
train/trainer_cases.py::CasePool, driven through CasePool.train_scan
alone, in chunks of K lockstep steps as CasePool.train() makes them
between host events (each case's frames by the pool's own per-case
frame stream, each case's draws by its own step generator, one readback
of the chunk's losses and skipped flags), each chunk sent when the last
one has been read back. Every lockstep step is C case-steps: the case
step (dist/train_cases.py) runs each case's single-card step with the
exact KNN statistic, one case after the other, then stacks every
case's state again.

Set-up: case c's inputs (weights, kit poses, targets, checked frames
and draws) are runners/train.py's, drawn from the seed case_seed(seed,
c), a stream of the case's own; the reference renders each case's
targets (its seconds are left out of setup_s). The pool is built from
the in-memory kits, one configuration a case (the run's seed in each,
so that the pool's frame streams and generators differ by its case
stride); each case's seeded weights and fresh Adam moments are copied
into that case's Trainer and the pool stacks them again. The first
checked call, one lockstep step of train_scan from step `step0` with
each case's frames and draws, reads the first gradients and warms
every kernel; the window's first chunk, K lockstep steps, is the other
checked call, after which copies of each case's parameters and moments
are kept. After the window the reference takes each case's same steps
alone (reference/pool.py).

What differs from runners/train.py, whose inputs, copies and
comparison this module takes by import:
  * the unit is the case-step, counted in State.frames (C a lockstep
    step: the unit counts/spans.py reads of a runner other than "train",
    to which this module adds its entry, UNITS: _chunk, the "chunk"
    range, steps/s), and _chunk returns each case's losses and skipped
    flags flattened, so that train_steps_per_s counts case-steps a
    second;
  * window() and traced() are runners/train.py's, on this module's
    _chunk (runners/train.py's call its own);
  * check() takes each of the five numbers of compare.train_numbers at
    its worst over the cases.

Traffic keys: runners/train.py's; the configuration's "cases" is C.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch
from torch.profiler import record_function

import inputs
from common import capture_first, profile_start, profile_stop
from compare import judge, train_numbers
from counts import spans
from runners import train as base

spans.UNITS.setdefault("pool", ("_chunk", "chunk", "steps/s"))

# case c's inputs are drawn from the seed seed * CASE_STREAMS + c
CASE_STREAMS = 16
# the pool's per-case frame streams: numpy RandomState(the configuration's
# seed + CASE_SEED_STRIDE * c), shuffled once (train/trainer_cases.py)
CASE_SEED_STRIDE = 7919

State = base.State


def case_seed(seed: int, c: int) -> int:
    if not 0 <= c < CASE_STREAMS:
        raise ValueError(f"case {c}: the cell draws at most {CASE_STREAMS} "
                         "cases")
    return int(seed) * CASE_STREAMS + c


def pool_frame_order(seed: int, c: int, n: int) -> list:
    """The first order of case c's training split in the pool's frame
    stream."""
    order = list(range(n))
    np.random.RandomState(seed + CASE_SEED_STRIDE * c).shuffle(order)
    return order


def program_dotlist(ctx, c: int) -> list:
    return base.program_dotlist(ctx) + [f"exp_name=bench_case{c}",
                                        f"dataset.name=kit{c}"]


def case_inputs(ctx, c: int) -> dict:
    """Case c's inputs: runners/train.py's reference_inputs at the case's
    seed (weights, poses, camera, the targets the reference renders),
    with the checked calls' frames in the pool's order for case c and
    their draws from the case's seed."""
    from reference import build as RB
    from reference.plain.losses.photometric import draw_step_randoms

    seed = case_seed(ctx.seed, c)
    ri = base.reference_inputs(dataclasses.replace(ctx, seed=seed))
    ri["cfg"] = RB.config(program_dotlist(ctx, c))
    sizes = [int(s) for s in ctx.traffic["check_chunks"]]
    train = ri["train"]
    order = pool_frame_order(ctx.seed % (1 << 31), c, len(train))
    frames = [int(train[i]) for i in order[:sum(sizes)]]
    photometric = RB.training_weights(ri["cfg"], ri["camera"])
    draws = inputs.step_draws(draw_step_randoms, seed,
                              [ri["masks"][f].to(ctx.device) for f in frames],
                              photometric, ctx.device)
    chunks, pos = [], 0
    for s_ in sizes:
        chunks.append((frames[pos:pos + s_], draws[pos:pos + s_]))
        pos += s_
    ri["chunks"] = chunks
    return ri


def _case_leaves(tree, c: int, device=None) -> list:
    """Copies of case c's leaves of a stacked tree."""
    from sings_tpu_torch.dist.train_cases import pick_case

    return base._leaves(pick_case(tree, c), device)


def setup(ctx) -> State:
    from sings_tpu_torch.config.core import load_config
    from sings_tpu_torch.config.defaults import DEFAULTS
    from sings_tpu_torch.data.kit import TrainingKit
    from sings_tpu_torch.ops.graphics import make_camera
    from sings_tpu_torch.train.trainer_cases import CasePool

    if not hasattr(CasePool, "train_scan"):
        raise RuntimeError("the program's CasePool has no train_scan, "
                           "through which this cell drives the pool")
    tf, dev = ctx.traffic, ctx.device
    st = State()
    st.ctx = ctx
    st.n = int(ctx.config["cases"])
    t_inputs = time.perf_counter()
    st.cases = [case_inputs(ctx, c) for c in range(st.n)]
    t_pool = time.perf_counter()
    size = int(tf["kit_size"])
    kits = [TrainingKit(images=ri["images"].numpy(),
                        masks=ri["masks"].numpy(), smpl=ri["smpl"],
                        camera=make_camera(np.eye(4), size, size, K=ri["K"]),
                        train_split=ri["train"], val_split=ri["val"],
                        name=f"kit{c}")
            for c, ri in enumerate(st.cases)]
    # ---- the program: the pool, each case's Trainer with its seeded
    # weights and fresh Adam, stacked again
    cfgs = [load_config(DEFAULTS, None, program_dotlist(ctx, c))
            for c in range(st.n)]
    pool = CasePool(cfgs, device=dev, kits=kits,
                    image_writer=lambda path, img: None)
    for t, ri in zip(pool.trainers, st.cases):
        t.params = t.params._replace(**inputs.clone_weights(ri["weights"]))
        t.opt_state = t.tx.init(t.params)
    pool._stack_state()
    st.pool = pool
    st.k = int(tf["chunk_steps"])
    t0 = pool.trainers[0]
    if t0.inner_steps != st.k:
        raise RuntimeError(f"the configuration gives {t0.inner_steps}-step "
                           f"chunks, the traffic {st.k}-step chunks")
    if t0.step_cfg.knn_backend != "dense":
        raise RuntimeError(f"the configuration states the "
                           f"{t0.step_cfg.knn_backend} statistic; the case "
                           "step takes the exact one every step (dense)")
    pool.step = int(tf["step0"])
    st.frames = 0
    t_first = time.perf_counter()
    # ---- the first checked call, through train_scan with the
    # benchmark's frames and draws; the others are the window's first
    # chunks
    st.prog = [{"losses": [], "p0": _case_leaves(pool._params, c)}
               for c in range(st.n)]
    first, *st.pending = _calls(st.cases)
    losses, _sk = _checked(st, *first)
    for c, prog in enumerate(st.prog):
        prog["losses"] += [float(x) for x in losses[c].cpu()]
        prog["mu1"] = _case_leaves(pool._opt.mu, c)
    st.reference_s = sum(ri["reference_s"] for ri in st.cases)
    t_end = time.perf_counter()
    ctx.note(f"[setup] {st.n} cases, live gaussians "
             f"{pool._buffers.alive.sum(dim=1).int().tolist()} in "
             f"{t0.avatar_cfg.capacity} slots each, {st.k} lockstep steps a "
             f"chunk, the exact statistic every case-step; s: the inputs "
             f"{t_pool - t_inputs:.3f} (the reference's target renders "
             f"{st.reference_s:.3f} of them, left out of setup_s), the pool "
             f"{t_first - t_pool:.3f}, the first checked call "
             f"{t_end - t_first:.3f}")
    return st


def _calls(cases: list) -> list:
    """The checked calls: each call's (frames, draws), each a list of
    the cases' lists."""
    return [([ri["chunks"][i][0] for ri in cases],
             [ri["chunks"][i][1] for ri in cases])
            for i in range(len(cases[0]["chunks"]))]


def _checked(st, frames: list, draws: list) -> tuple:
    """One checked call on the device: each case's next frames in the
    pool's stream have to be the benchmark's."""
    pool = st.pool
    k = len(frames[0])
    drawn = [[pool._next_frame(c) for _ in range(k)] for c in range(st.n)]
    if drawn != [list(f) for f in frames]:
        raise RuntimeError("the pool's frame order is not the benchmark's")
    return pool.train_scan(k, frames=frames, draws=draws)


def _chunk(st) -> tuple:
    """One chunk of the window: the next checked call while any is left
    (after the last, copies of each case's parameters and moments are
    kept on the card until the window has closed), else K lockstep steps
    on the pool's own frames and draws. Returns the case-steps' losses
    and skipped flags, read back, case after case."""
    checked = st.pending.pop(0) if st.pending else None
    pool = st.pool
    with record_function("chunk"):
        if checked is None:
            losses, skipped = pool.train_scan(st.k)
        else:
            losses, skipped = _checked(st, *checked)
    with record_function("readback"):
        losses_h, skipped_h = losses.cpu(), skipped.cpu()
    st.frames += losses_h.numel()
    if checked is not None:
        dev = st.ctx.device
        for c, prog in enumerate(st.prog):
            prog["losses"] += [float(x) for x in losses_h[c]]
            if not st.pending:
                prog.update(p1=_case_leaves(pool._params, c, dev),
                            mu=_case_leaves(pool._opt.mu, c, dev),
                            nu=_case_leaves(pool._opt.nu, c, dev))
    return losses_h.reshape(-1), skipped_h.reshape(-1)


def window(st, seconds: float) -> dict:
    """Chunks until `seconds` have passed and the checked chunks are
    done; every case-step completed in the window over the whole window,
    which ends in a readback."""
    steps, failed = 0, 0
    t0 = time.perf_counter()
    chunks = []
    while True:
        losses, skipped = _chunk(st)
        steps += len(losses)
        failed += int(skipped.sum())
        t1 = time.perf_counter()
        chunks.append(t1)
        if t1 - t0 >= seconds and not st.pending:
            break
    times = [b - a for a, b in zip([t0] + chunks[:-1], chunks)]
    st.ctx.note(f"[window] {len(times)} chunks of {st.n} x {st.k} "
                f"case-steps, s min {min(times):.4f} median "
                f"{sorted(times)[len(times) // 2]:.4f} max {max(times):.4f}")
    return {"attempted": steps, "failed": failed,
            "metrics": {"train_steps_per_s": (steps / (t1 - t0),
                                               "steps/s")}}


def traced(st, path: str) -> dict:
    """runners/train.py's traced window on the pool: trace_chunks whole
    chunks (the checked chunks first) with the device traced alone, the
    first case-step's composite launches captured for the operation
    count; then one more chunk with the host traced too, for the idle
    gaps. The units are case-steps."""
    from sings_tpu_torch.ops.rasterizer import kernels as K

    n = max(int(st.ctx.traffic["trace_chunks"]), len(st.pending))
    steps, failed = 0, 0
    prof = profile_start(host=False)
    with capture_first(K, {"fwd": "composite_fwd_cuda",
                           "bwd": "composite_bwd_cuda"}) as captured:
        t0 = time.perf_counter()
        for _ in range(n):
            losses, skipped = _chunk(st)
            steps += len(losses)
            failed += int(skipped.sum())
        window_s = time.perf_counter() - t0
    trace = profile_stop(prof, path, window_s=window_s)
    prof = profile_start(host=True)
    losses, skipped = _chunk(st)
    gaps = profile_stop(prof, path, window="chunk").idle_gaps()
    return {"attempted": steps + len(losses),
            "failed": failed + int(skipped.sum()), "trace": trace,
            "units": steps, "captured": captured, "gaps": gaps}


def release(st) -> None:
    """Free the program's state before the reference runs."""
    st.pool = None


def _worst(values: list) -> float:
    """The largest of values, a NaN before any number."""
    return max(values, key=lambda v: (math.isnan(v), v))


def check(st) -> tuple:
    """Each case's checked steps by the reference, alone, against the
    program's; each number at its worst over the cases."""
    from reference.pool import case_steps

    if st.pending:
        raise RuntimeError("the checked chunks did not run")
    step0 = int(st.ctx.traffic["step0"])
    per_case, notes = [], []
    for c, (prog, ri) in enumerate(zip(st.prog, st.cases)):
        for k in ("p1", "mu", "nu"):
            prog[k] = [x.cpu() for x in prog[k]]
        ref = case_steps(ri["cfg"], ri["smpl"],
                         inputs.clone_weights(ri["weights"]), ri["camera"],
                         ri["images"], ri["masks"], ri["chunks"], step0,
                         st.ctx.device)
        where = {}
        per_case.append(train_numbers(prog, ref, where))
        shapes = [tuple(x.shape) for x in prog["p0"]]
        notes.append(f"case {c}: " + ", ".join(
            f"{k} {v:.3e} at {where[k]}" if k == "loss_gap"
            else f"{k} {v:.3e} at {where[k]} {shapes[where[k]]}"
            for k, v in per_case[-1].items()))
        del ref
        if st.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
    st.ctx.note("[check] each number and the step or leaf (index, shape) "
                "behind it: " + "; ".join(notes))
    numbers = {k: _worst([n[k] for n in per_case]) for k in per_case[0]}
    return judge(numbers, st.ctx.limits)
