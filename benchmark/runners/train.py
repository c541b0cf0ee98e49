"""Closed-loop training traffic: Trainer.train_scan in K-step chunks,
called as Trainer.train() calls it between host events (frames drawn by
the trainer's order_rng over the training split, the same laplacians,
one readback of the chunk's losses), each chunk sent when the last one
has been read back.

Set-up: the reference renders the kit's targets from the starting
avatar (its seconds are left out of setup_s); Trainer(mode="train")
gets that kit and the seeded weights; the first checked call, one step
of train_scan with the benchmark's draws from step `step0`, reads the
first gradient and warms every kernel of the step. The window's first
chunks are the other checked calls: whole K-step chunks with the
benchmark's draws, timed like every other chunk, after which copies
of the parameters and both Adam moments are kept. The reference takes
the same steps from the same inputs after the window, for `correct`.

Traffic keys: chunk_steps (K), step0, kit_frames, kit_size,
check_chunks (the steps of the checked calls: one step in set-up, then
whole chunks of the window, all on distinct frames), trace_chunks
(chunks in a traced window).
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

import inputs
from common import capture_first, profile_start, profile_stop
from compare import judge, train_numbers
from reference.train import checked_steps, render_targets


class State:
    pass


def _next_frames(st, k: int) -> list:
    """The next k training frames in Trainer.train()'s order: a shuffle
    of the split by the trainer's order_rng, reshuffled when used up."""
    out = []
    for _ in range(k):
        if st.cursor >= len(st.order):
            st.trainer.order_rng.shuffle(st.order)
            st.cursor = 0
        out.append(int(st.trainer.kit.train_split[st.order[st.cursor]]))
        st.cursor += 1
    return out


def _scan(st, frames: list, draws=None):
    """One train_scan call on the trainer's state, as train() makes it;
    returns the chunk's losses and skipped flags, on the device."""
    tr = st.trainer
    k = len(frames)
    batches = {"rgb": tr.images[frames], "mask": tr.masks[frames],
               "idx": frames,
               "smpl_scale": torch.ones((k, 1), device=tr.device)}
    (tr.params, tr.buffers, tr.opt_state, losses, skipped,
     _metrics) = tr.train_scan(
        tr.params, tr.buffers, tr.opt_state, tr.cache, batches,
        tr.step_generator, st.step, tr.active_sh_degree, tr.region_lap,
        tr.region_lap, tr.lap_pos_w, tr.lap_color_w, draws=draws)
    st.step += k
    return losses, skipped


def _leaves(tree, device=None) -> list:
    """Copies of the tree's leaves, on the host or on `device` (a copy
    on the card takes a fraction of a millisecond inside a window)."""
    from sings_tpu_torch.tree import tree_leaves

    return [x.detach().to(device or "cpu", copy=True)
            for x in tree_leaves(tree)]


def frame_order(seed: int, n: int) -> list:
    """Trainer.train()'s first order of the split: order_rng is
    random.Random(cfg.seed), shuffled once."""
    import random

    order = list(range(n))
    random.Random(seed).shuffle(order)
    return order


def program_dotlist(ctx) -> list:
    return list(ctx.config["dotlist"]) + [
        f"output_path={ctx.tmp}", "exp_name=bench", "dataset.name=kit",
        f"seed={ctx.seed % (1 << 31)}",
        f"tpu.smpl_model_dir={ctx.tmp}/no_licensed_models"]


def reference_inputs(ctx) -> dict:
    """The cell's inputs: seeded weights, the kit's poses and camera, the
    targets the reference renders from the starting avatar (on the host;
    the seconds of that render in 'reference_s'), the checked calls'
    frames and draws."""
    from reference import build as RB
    from reference.plain.data.kit import get_data_splits
    from reference.plain.losses.photometric import draw_step_randoms
    from reference.plain.ops.graphics import make_camera

    tf, dev = ctx.traffic, ctx.device
    n_frames, size = int(tf["kit_frames"]), int(tf["kit_size"])
    rcfg = RB.config(program_dotlist(ctx))
    weights = inputs.seeded_weights(RB.weight_layout(rcfg), ctx.seed, dev)
    smpl = inputs.kit_smpl(n_frames, ctx.seed, dev, jitter=True)
    K = inputs.kit_intrinsics(size)
    rcam = make_camera(np.eye(4), size, size, K=K).to(dev)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    noise = inputs.target_noise((n_frames, 3, size, size), ctx.seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    av = RB.avatar(rcfg, smpl, inputs.clone_weights(weights), dev)
    images, masks = render_targets(av, rcam, noise)
    images, masks = images.cpu(), masks.cpu()
    del av
    reference_s = time.perf_counter() - t0
    train, val = get_data_splits(n_frames)
    sizes = [int(s) for s in tf["check_chunks"]]
    k = int(tf["chunk_steps"])
    if sizes[0] != 1 or any(s_ != k for s_ in sizes[1:]):
        raise ValueError("the first checked call takes one step, the "
                         "others whole chunks")
    order = frame_order(ctx.seed % (1 << 31), len(train))
    if sum(sizes) > len(order):
        raise ValueError("the checked steps need distinct frames")
    frames = [train[i] for i in order[:sum(sizes)]]
    photometric = RB.training_weights(rcfg, rcam)
    draws = inputs.step_draws(draw_step_randoms, ctx.seed,
                              [masks[f].to(dev) for f in frames],
                              photometric, dev)
    chunks, pos = [], 0
    for s_ in sizes:
        chunks.append((frames[pos:pos + s_], draws[pos:pos + s_]))
        pos += s_
    return {"cfg": rcfg, "weights": weights, "smpl": smpl, "K": K,
            "camera": rcam, "images": images, "masks": masks,
            "train": train, "val": val, "chunks": chunks,
            "reference_s": reference_s}


def setup(ctx) -> State:
    from sings_tpu_torch.config.core import load_config
    from sings_tpu_torch.config.defaults import DEFAULTS
    from sings_tpu_torch.data.kit import TrainingKit
    from sings_tpu_torch.ops.graphics import make_camera
    from sings_tpu_torch.train.trainer import Trainer

    tf, dev = ctx.traffic, ctx.device
    st = State()
    st.ctx = ctx
    ri = reference_inputs(ctx)
    size = int(tf["kit_size"])
    kit = TrainingKit(images=ri["images"].cpu().numpy(),
                      masks=ri["masks"].cpu().numpy(), smpl=ri["smpl"],
                      camera=make_camera(np.eye(4), size, size, K=ri["K"]),
                      train_split=ri["train"], val_split=ri["val"],
                      name="kit")
    # ---- the program: a Trainer with the seeded weights and fresh Adam
    cfg = load_config(DEFAULTS, None, program_dotlist(ctx))
    tr = Trainer(cfg, mode="train", device=dev, kit=kit,
                 image_writer=lambda path, img: None)
    tr.params = tr.params._replace(**inputs.clone_weights(ri["weights"]))
    tr.opt_state = tr.tx.init(tr.params)
    st.trainer = tr
    st.k = int(tf["chunk_steps"])
    if tr.inner_steps != st.k or tr.step_cfg.knn_backend != "chunk":
        raise RuntimeError(f"the configuration gives {tr.inner_steps}-step "
                           f"chunks and the {tr.step_cfg.knn_backend} "
                           f"statistic, the traffic {st.k}-step chunks")
    st.step = int(tf["step0"])
    st.order = list(range(len(tr.kit.train_split)))
    tr.order_rng.shuffle(st.order)
    st.cursor = 0
    # ---- the first checked call, through train_scan with the
    # benchmark's draws; the others are the window's first chunks
    st.prog = {"losses": [], "p0": _leaves(tr.params)}
    first, *st.pending = ri["chunks"]
    losses, _sk = _checked(st, *first)
    st.prog["losses"] += [float(x) for x in losses.cpu()]
    st.prog["mu1"] = _leaves(tr.opt_state.mu)
    st.ri = ri
    st.reference_s = ri["reference_s"]
    ctx.note(f"[setup] {int(tr.buffers.alive.sum())} live gaussians in "
             f"{tr.avatar_cfg.capacity} slots, {st.k} steps a chunk, "
             f"the reference's target renders {st.reference_s:.3f} s "
             "(left out of setup_s)")
    return st


def _checked(st, frames: list, draws: list) -> tuple:
    """One checked call on the device: the trainer's next frames have to
    be the benchmark's."""
    if _next_frames(st, len(frames)) != frames:
        raise RuntimeError("the trainer's frame order is not the "
                           "benchmark's")
    return _scan(st, frames, draws)


def reference_steps(ri: dict, device) -> dict:
    """The reference's checked steps from the cell's inputs."""
    from reference import build as RB

    av = RB.avatar(ri["cfg"], ri["smpl"], inputs.clone_weights(ri["weights"]),
                   device)
    tr = RB.training(av, ri["camera"], device)
    return checked_steps(av, tr, ri["images"].to(device),
                         ri["masks"].to(device), ri["chunks"],
                         int(ri["step0"]))


def _chunk(st) -> tuple:
    """One chunk of the window: the next checked call while any is left
    (the benchmark's frames and draws; after the last, copies of the
    parameters and Adam moments are kept on the card until the window
    has closed), else the trainer's own frames and draws."""
    checked = st.pending.pop(0) if st.pending else None
    with record_function("chunk"):
        if checked is None:
            losses, skipped = _scan(st, _next_frames(st, st.k))
        else:
            losses, skipped = _checked(st, *checked)
    with record_function("readback"):
        losses_h, skipped_h = losses.cpu(), skipped.cpu()
    if checked is not None:
        st.prog["losses"] += [float(x) for x in losses_h]
        if not st.pending:
            tr = st.trainer
            dev = st.ctx.device
            st.prog.update(p1=_leaves(tr.params, dev),
                           mu=_leaves(tr.opt_state.mu, dev),
                           nu=_leaves(tr.opt_state.nu, dev))
    return losses_h, skipped_h


def window(st, seconds: float) -> dict:
    """Chunks until `seconds` have passed and the checked chunks are
    done; every step completed in the window over the whole window,
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
    st.ctx.note(f"[window] {len(times)} chunks, s min "
                f"{min(times):.4f} median {sorted(times)[len(times) // 2]:.4f}"
                f" max {max(times):.4f}")
    return {"attempted": steps, "failed": failed,
            "metrics": {"train_steps_per_s": (steps / (t1 - t0),
                                               "steps/s")}}


def traced(st, path: str) -> dict:
    """trace_chunks whole chunks with the device traced alone (the
    window by the host's clock; the checked chunks first, as in a timed
    window), the first step's composite launches captured for the
    roofline readers; then one more chunk with the host traced too, for
    the idle gaps by what the host was doing."""
    from sings_tpu_torch.ops import grid_grad as GG
    from sings_tpu_torch.ops.rasterizer import kernels as K

    n = max(int(st.ctx.traffic["trace_chunks"]), len(st.pending))
    steps, failed = 0, 0
    g0 = GG.LAUNCHES["triplane_bwd"]
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
    launches = GG.LAUNCHES["triplane_bwd"] - g0
    prof = profile_start(host=True)
    losses, skipped = _chunk(st)
    gaps = profile_stop(prof, path, window="chunk").idle_gaps()
    return {"attempted": steps + len(losses),
            "failed": failed + int(skipped.sum()), "trace": trace,
            "units": steps, "captured": captured, "gaps": gaps,
            "triplane_bwd_launches": launches}


def release(st) -> None:
    """Free the program's state before the reference runs."""
    st.trainer = None


def check(st) -> tuple:
    """The reference's checked steps from the same inputs, against the
    program's."""
    if st.pending:
        raise RuntimeError("the checked chunks did not run")
    for k in ("p1", "mu", "nu"):
        st.prog[k] = [x.cpu() for x in st.prog[k]]
    ref = reference_steps(dict(st.ri, step0=st.ctx.traffic["step0"]),
                          st.ctx.device)
    where = {}
    numbers = train_numbers(st.prog, ref, where)
    shapes = [tuple(x.shape) for x in st.prog["p0"]]
    st.ctx.note("[check] the step or leaf (index, shape) behind each "
                "number: " + ", ".join(
                    f"{k} {i}" if k == "loss_gap" else f"{k} {i} {shapes[i]}"
                    for k, i in where.items()))
    return judge(numbers, st.ctx.limits)
