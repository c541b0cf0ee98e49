"""Closed-loop training traffic with the port's options (configuration
human_complex_options): runners/train.py's loop, whose chunks,
readbacks, timed window and traced window this runner takes by import,
with the LPIPS term, the windowed statistic every step and the
cotangent laplacian in each step.

What differs from runners/train.py:
  * set-up accepts the "window" statistic, and the reference's side is
    reference/options.py;
  * the LPIPS-VGG16 weights are drawn here from the seed (lpips_weights)
    and copied into the Trainer's own tensors before the first checked
    call, so that both sides compute with the benchmark's draw and
    neither with the program's;
  * the Trainer's train_scan is wrapped to keep each checked step's
    values of TERMS (on the card until the check) and to count the
    steps taken in State.frames: the unit
    counts/spans.py reads of a runner other than "train", to which this
    module adds its entry (UNITS: _chunk, the "chunk" range, steps/s);
  * check() compares, besides runners/train.py's five numbers, the
    largest relative gap of a checked step's weighted LPIPS term
    (lpips_gap) and of its KNN edge term (connect_gap), and the relative
    gap of the norm of the screen-space gradient norms accumulated over
    the checked steps (screen_grad_gap: the densification statistic,
    which only the photometric terms reach, LPIPS's backward among
    them; the laplacians' gradients dwarf them in every leaf).

Traffic keys: runners/train.py's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

import inputs
from compare import judge, rel_gap, train_numbers
from counts import spans
from runners import train as base

# runners/train.py's unit, under this runner's name
spans.UNITS.setdefault("train_options", spans.UNITS["train"])

# the per-step terms the options add, compared besides train_numbers:
# number -> the step's metric (losses/photometric.py's weighted LPIPS
# term; the KNN edge term from the windowed statistic). The loss's
# laplacian terms, cotangent weights applied raw, are 1e5 times the
# photometric ones, so loss_gap sees the laplacian alone.
TERMS = {"lpips_gap": "photo_lpips_patch", "connect_gap": "connect"}
# the numbers of compare.train_numbers behind which stands a leaf
LEAF_NUMBERS = ("grad_gap", "change_gap", "mu_gap", "nu_gap")

# the LPIPS weights' generator stream, beside inputs.py's five
STREAM_LPIPS = 5

# runners/train.py's loop, on this runner's state
program_dotlist = base.program_dotlist
_chunk = base._chunk
window = base.window
traced = base.traced
release = base.release


def reference_inputs(ctx) -> dict:
    """runners/train.py's inputs (weights, kit, targets, frames, draws)
    with the options' configuration.

    runners/train.py's reference_inputs builds the configuration's
    photometric weights through reference/build.py, which refuses the
    LPIPS term: it is given the dotlist with the term at factor 0, and
    the configuration is then read again without it. The draws read only
    the patches' number and size, which the factor leaves as they are.
    The LPIPS weights are not among them: lpips_weights(seed)."""
    from reference import build as RB

    cfg = dict(ctx.config, dotlist=list(ctx.config["dotlist"])
               + ["tpu.random_lpips_factor=0.0"])
    ri = base.reference_inputs(dataclasses.replace(ctx, config=cfg))
    ri["cfg"] = RB.config(base.program_dotlist(ctx))
    return ri


def lpips_weights(seed: int, device):
    """The LPIPS-VGG16 weights of the seed, in the reference's form (HWIO
    convolutions (3, 3, cin, cout), biases (cout,), heads (C,)), drawn
    on `device` from the seed's own stream: each of the 13 convolutions
    He-normal (std sqrt(2 / (9 cin))), zero biases and uniform 1/C heads,
    the distribution of the program's random features
    (losses/lpips.py::init_random) but not its draw."""
    from reference.plain.losses.lpips import (
        SLICE_ENDS, VGG_PLAN, LPIPSParams,
    )

    g = inputs.generator(seed, STREAM_LPIPS, device)
    convs, cin = [], 3
    for cout, _pool in VGG_PLAN:
        w = torch.randn((3, 3, cin, cout), generator=g, device=device)
        convs.append((w * math.sqrt(2.0 / (9 * cin)),
                      torch.zeros(cout, device=device)))
        cin = cout
    lins = tuple(torch.full((VGG_PLAN[i][0],), 1.0 / VGG_PLAN[i][0],
                            device=device) for i in sorted(SLICE_ENDS))
    return LPIPSParams(convs=tuple(convs), lins=lins)


def load_lpips(params, drawn) -> None:
    """Copy the drawn weights into the program's LPIPSParams in place:
    the program's step holds those tensors. Raises where a tensor's
    shape is not the drawn one's."""
    if (len(params.convs), len(params.lins)) != (len(drawn.convs),
                                                  len(drawn.lins)):
        raise RuntimeError(f"the program's LPIPS network has "
                           f"{len(params.convs)} convolutions and "
                           f"{len(params.lins)} heads, the draw "
                           f"{len(drawn.convs)} and {len(drawn.lins)}")
    pairs = [(dst, src) for (w, b), (dw, db) in zip(params.convs, drawn.convs)
             for dst, src in ((w, dw), (b, db))]
    pairs += list(zip(params.lins, drawn.lins))
    with torch.no_grad():
        for dst, src in pairs:
            if dst.shape != src.shape:
                raise RuntimeError(f"the program's LPIPS tensor of shape "
                                   f"{tuple(dst.shape)} is drawn "
                                   f"{tuple(src.shape)}")
            dst.copy_(src)


def _keep_checked(st, scan):
    """The Trainer's train_scan, keeping each checked call's values of
    the compared terms (a checked call passes the benchmark's draws)
    and counting steps."""
    def kept(*args, **kw):
        out = scan(*args, **kw)
        if kw.get("draws") is not None:
            # a step without the term reads 0
            st.prog["terms_dev"].append({
                name: out[5].get(name, torch.zeros_like(out[3]))
                for name in TERMS.values()})
            st.prog["screen_grad_dev"] = out[1].xyz_grad_accum.clone()
        st.frames += len(out[3])
        return out
    return kept


def setup(ctx) -> base.State:
    from sings_tpu_torch.config.core import load_config
    from sings_tpu_torch.config.defaults import DEFAULTS
    from sings_tpu_torch.data.kit import TrainingKit
    from sings_tpu_torch.ops.graphics import make_camera
    from sings_tpu_torch.train.trainer import Trainer

    tf, dev = ctx.traffic, ctx.device
    st = base.State()
    st.ctx = ctx
    ri = reference_inputs(ctx)
    size = int(tf["kit_size"])
    kit = TrainingKit(images=ri["images"].cpu().numpy(),
                      masks=ri["masks"].cpu().numpy(), smpl=ri["smpl"],
                      camera=make_camera(np.eye(4), size, size, K=ri["K"]),
                      train_split=ri["train"], val_split=ri["val"],
                      name="kit")
    # ---- the program: a Trainer with the seeded weights and fresh Adam
    cfg = load_config(DEFAULTS, None, base.program_dotlist(ctx))
    tr = Trainer(cfg, mode="train", device=dev, kit=kit,
                 image_writer=lambda path, img: None)
    tr.params = tr.params._replace(**inputs.clone_weights(ri["weights"]))
    tr.opt_state = tr.tx.init(tr.params)
    st.trainer = tr
    st.k = int(tf["chunk_steps"])
    if tr.inner_steps != st.k or tr.step_cfg.knn_backend != "window":
        raise RuntimeError(f"the configuration gives {tr.inner_steps}-step "
                           f"chunks and the {tr.step_cfg.knn_backend} "
                           f"statistic, the traffic {st.k}-step chunks and "
                           "the window statistic")
    if tr.step_cfg.weights.photometric.lpips <= 0:
        raise RuntimeError("the configuration runs no LPIPS term")
    ri["lpips"] = lpips_weights(ctx.seed, dev)
    load_lpips(tr.lpips_params, ri["lpips"])
    st.step = int(tf["step0"])
    st.order = list(range(len(tr.kit.train_split)))
    tr.order_rng.shuffle(st.order)
    st.cursor = 0
    st.frames = 0
    # ---- the first checked call, through train_scan with the
    # benchmark's draws; the others are the window's first chunks
    st.prog = {"losses": [], "terms_dev": [], "p0": base._leaves(tr.params)}
    tr.train_scan = _keep_checked(st, tr.train_scan)
    first, *st.pending = ri["chunks"]
    losses, _sk = base._checked(st, *first)
    st.prog["losses"] += [float(x) for x in losses.cpu()]
    st.prog["mu1"] = base._leaves(tr.opt_state.mu)
    st.ri = ri
    st.reference_s = ri["reference_s"]
    ctx.note(f"[setup] {int(tr.buffers.alive.sum())} live gaussians in "
             f"{tr.avatar_cfg.capacity} slots, {st.k} steps a chunk, the "
             f"window statistic, LPIPS at "
             f"{tr.step_cfg.weights.photometric.lpips:g}, "
             f"{type(tr.region_lap).__name__}; the reference's target "
             f"renders {st.reference_s:.3f} s (left out of setup_s)")
    return st


def reference_steps(ri: dict, device) -> dict:
    """The reference's checked steps from the cell's inputs, with each
    step's compared terms."""
    from reference import build as RB
    from reference import options as RO

    av = RB.avatar(ri["cfg"], ri["smpl"], inputs.clone_weights(ri["weights"]),
                   device)
    tr = RO.training(av, ri["camera"], device, ri["lpips"])
    return RO.checked_steps(av, tr, ri["images"].to(device),
                            ri["masks"].to(device), ri["chunks"],
                            int(ri["step0"]), tuple(TERMS.values()))


def numbers(prog: dict, ref: dict, where: dict | None = None) -> dict:
    """compare.train_numbers; for each of TERMS the largest relative gap
    of a checked step's value of that term; screen_grad_gap, the
    relative gap of the accumulated screen-space gradients' norm."""
    out = train_numbers(prog, ref, where)
    out["screen_grad_gap"] = rel_gap(prog["screen_grad"], ref["screen_grad"],
                                     0.0)
    for key, term in TERMS.items():
        a, b = prog["terms"][term], ref["terms"][term]
        if len(a) != len(b) or not a:
            raise ValueError(f"the two sides kept different {term} terms")
        gaps = [rel_gap(x, y, 0.0) for x, y in zip(a, b)]
        i = max(range(len(gaps)), key=gaps.__getitem__)
        out[key] = gaps[i]
        if where is not None:
            where[key] = i
    return out


def check(st) -> tuple:
    """The reference's checked steps from the same inputs, against the
    program's."""
    if st.pending:
        raise RuntimeError("the checked chunks did not run")
    for k in ("p1", "mu", "nu"):
        st.prog[k] = [x.cpu() for x in st.prog[k]]
    kept = st.prog.pop("terms_dev")
    st.prog["screen_grad"] = float(torch.linalg.norm(
        st.prog.pop("screen_grad_dev")))
    st.prog["terms"] = {name: [float(x) for d in kept for x in d[name].cpu()]
                        for name in TERMS.values()}
    ref = reference_steps(dict(st.ri, step0=st.ctx.traffic["step0"]),
                          st.ctx.device)
    where = {}
    nums = numbers(st.prog, ref, where)
    shapes = [tuple(x.shape) for x in st.prog["p0"]]
    st.ctx.note("[check] the step or leaf (index, shape) behind each "
                "number: " + ", ".join(
                    f"{k} {i} {shapes[i]}" if k in LEAF_NUMBERS
                    else f"{k} {i}" for k, i in where.items()))
    return judge(nums, st.ctx.limits)
