"""A gloo process group of N ranks for the port's distributed tests, and
the functions its ranks run.

World(n) spawns n processes that join one gloo group on localhost and
then serve jobs: world.run(fn, **kw) calls fn(**kw) on every rank at
once and returns the per-rank results (a rank's exception fails the
call with its traceback). fn must live in a module the ranks can import
without JAX (this one), and take and return picklable values: numpy
arrays and the port's NamedTuples of them. The test files hold one
module-scoped World each and the JAX side runs in the pytest process.
"""
from __future__ import annotations

import datetime
import importlib
import multiprocessing as mp
import os
import pickle
import queue
import socket
import traceback

import numpy as np

# seconds a job may take before the world is torn down
JOB_TIMEOUT = 600


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _serve(rank: int, n: int, port: int, tasks, results, threads: int):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=n, timeout=datetime.timedelta(seconds=JOB_TIMEOUT))
    while True:
        job = tasks.get()
        if job is None:
            break
        mod, name, kw = job
        try:
            out = getattr(importlib.import_module(mod), name)(**kw)
            pickle.dumps(out)  # an unpicklable result fails here, loudly
            results.put((rank, True, out))
        except Exception:  # reported to the test, which fails
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class World:
    def __init__(self, n: int, threads: int = 1):
        ctx = mp.get_context("spawn")
        self.n = n
        self.tasks = [ctx.Queue() for _ in range(n)]
        self.results = ctx.Queue()
        port = _free_port()
        self.procs = [ctx.Process(target=_serve, daemon=True, args=(
            r, n, port, self.tasks[r], self.results, threads))
            for r in range(n)]
        for p in self.procs:
            p.start()

    def run(self, fn, **kw) -> list:
        for q in self.tasks:
            q.put((fn.__module__, fn.__name__, kw))
        outs, errors = [None] * self.n, []
        for _ in range(self.n):
            try:
                r, ok, out = self.results.get(timeout=JOB_TIMEOUT)
            except queue.Empty:
                self.close()
                raise AssertionError(f"{fn.__name__}: a rank timed out")
            if ok:
                outs[r] = out
            else:
                errors.append(f"rank {r}:\n{out}")
                if len(errors) == 1:
                    # the other ranks may wait in a collective: stop them
                    self.close()
                    break
        if errors:
            raise AssertionError("\n".join(errors))
        return outs

    def close(self):
        for q, p in zip(self.tasks, self.procs):
            if p.is_alive():
                q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()


def world_fixture(n: int, threads: int = 1):
    """A module-scoped World of n ranks (threads torch threads each) for
    a test file."""
    import pytest

    @pytest.fixture(scope="module")
    def world():
        w = World(n, threads)
        yield w
        w.close()

    return world


def _two_torch_threads():
    import pytest
    import torch

    @pytest.fixture(scope="module", autouse=True)
    def two_torch_threads():
        """The pytest process's own torch work on 2 threads: a suite
        run's workers share the cores (oversubscribed pools slow many
        small ops by far more than the threads save)."""
        saved = torch.get_num_threads()
        torch.set_num_threads(2)
        yield
        torch.set_num_threads(saved)

    return two_torch_threads


two_torch_threads = _two_torch_threads()


# ---------------------------------------------------------------------------
# functions the ranks run

def _np_tree(tree):
    import torch

    from sings_tpu_torch.tree import tree_map

    return tree_map(lambda x: x.detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else x, tree)


def _t_tree(tree):
    import torch

    from sings_tpu_torch.tree import tree_map

    return tree_map(lambda x: torch.tensor(x)
                    if isinstance(x, np.ndarray) else x, tree)


def rank_info() -> tuple:
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size(), dist.get_backend()


def collectives(x: np.ndarray) -> dict:
    """all_gather_rows and ppermute with their gradients, psum / pmean /
    pmax, broadcast_tree and trees_equal on the world, each rank's x
    its rank's slice of x (4 rows each)."""
    import torch
    import torch.distributed as dist

    from sings_tpu_torch.dist import collectives as C

    g = dist.group.WORLD
    r, n = dist.get_rank(), dist.get_world_size()
    mine = torch.tensor(x[4 * r: 4 * r + 4], requires_grad=True)
    full = C.all_gather_rows(mine, g)
    w = torch.arange(full.numel(), dtype=torch.float32).reshape(full.shape)
    # each rank's local term; the group's sum is sum(w * full) * n
    (ga,) = torch.autograd.grad((full * w).sum(), [mine])
    shifted = C.ppermute(mine, g, [(i, (i + 1) % n) for i in range(n)])
    (gp,) = torch.autograd.grad((shifted * (r + 1)).sum(), [mine])
    v = torch.tensor([float(r), -float(r)])
    b = C.broadcast_tree({"a": torch.tensor([float(r)])}, g, src=n - 1)
    return {"full": full.detach().numpy(), "grad_gather": ga.numpy(),
            "shifted": shifted.detach().numpy(), "grad_ppermute": gp.numpy(),
            "psum": C.psum(v, g).numpy(), "pmean": C.pmean(v, g).numpy(),
            "pmax": C.pmax(v, g).numpy(), "bcast": b["a"].numpy(),
            "equal": C.trees_equal([torch.ones(3)], g),
            "unequal": C.trees_equal([torch.full((3,), float(r))], g)}


def mesh_helpers() -> dict:
    """make_mesh's layout, replicate, shard_batch and make_sharded_step on
    a (2, 2) mesh of the world: the loss of strip s of frame f is
    sum((s + 1) * p * frame), its mean over the ranks and its gradient."""
    import torch

    from sings_tpu_torch.dist.shard import (
        make_mesh, make_sharded_step, replicate, shard_batch,
    )

    mesh = make_mesh(dp=2)
    r = torch.distributed.get_rank()
    params = replicate({"p": torch.full((3,), float(r + 1))}, mesh)
    frame = shard_batch({"x": torch.arange(6.0).reshape(2, 3)}, mesh)
    step = make_sharded_step(
        mesh, lambda p, fr, s: ((s + 1) * p["p"] * fr["x"]).sum(), 2)
    loss, grads = step(params, frame)
    return {"coords": (mesh.dp_idx, mesh.gs_idx), "shape": mesh.shape,
            "ranks": mesh.ranks.tolist(), "params": params["p"].numpy(),
            "frame": frame["x"].numpy(), "loss": float(loss),
            "grad": grads["p"].numpy()}


def strip_ssim(pred: np.ndarray, gt: np.ndarray, bounds=None,
               h_max: int | None = None, ranks=None) -> dict:
    """Each rank's strip (equal strips, or balanced windows of h_max rows
    owning bounds[i]..bounds[i+1]) through strip_ssim_local(_bounded):
    its local value, the value summed over the strips (strip_ssim), and
    the gradient of the summed loss with respect to this rank's strip."""
    import torch

    from sings_tpu_torch.dist import halo
    from sings_tpu_torch.dist.collectives import psum
    from sings_tpu_torch.dist.shard import make_mesh

    mesh = make_mesh(dp=1, ranks=ranks)
    if mesh is None:
        return None
    g, i = mesh.gs_group, mesh.gs_idx
    h = pred.shape[1]
    if bounds is None:
        sh = h // mesh.gs
        p = torch.tensor(pred[:, i * sh: (i + 1) * sh], requires_grad=True)
        local = halo.strip_ssim_local(p, torch.tensor(
            gt[:, i * sh: (i + 1) * sh]), g)
        total = halo.strip_ssim(p.detach(), torch.tensor(
            gt[:, i * sh: (i + 1) * sh]), g)
    else:
        y0, y1 = int(bounds[i]), int(bounds[i + 1])
        # garbage in the window's padding rows, as tests/test_dist.py
        win_p = np.full((pred.shape[0], h_max, pred.shape[2]), 0.777,
                        np.float32)
        win_g = win_p.copy()
        win_p[:, : y1 - y0] = pred[:, y0:y1]
        win_g[:, : y1 - y0] = gt[:, y0:y1]
        p = torch.tensor(win_p, requires_grad=True)
        local = halo.strip_ssim_local_bounded(
            p, torch.tensor(win_g), g, y1 - y0, float(h * pred.shape[2]))
        total = psum(local, g)
    (grad,) = torch.autograd.grad(local, [p])
    return {"local": float(local), "total": float(total),
            "grad": grad.numpy()}


def sharded_step(setup: dict, dp: int, gs: int, draws: list, step: int,
                 grads_only: bool = False, strip_bounds=None,
                 strip_h_max: int | None = None, ranks=None,
                 runs: int = 1, frames: list | None = None) -> dict | None:
    """make_sharded_train_step on a (dp, gs) mesh over `ranks` (all by
    default), SGD at learning rate 1 keeping the gradients, every dp
    rank on frames[dp_idx] (the setup's frame when frames is None) with
    draws[dp_idx]. Returns this rank's (params, buffers, grads,
    metrics) of each run, as numpy."""
    from sings_tpu_torch.dist.shard import make_mesh
    from sings_tpu_torch.dist.train_sharded import make_sharded_train_step
    from sings_tpu_torch.losses.regularizers import shard_region_laplacian

    s = _t_tree(setup)
    mesh = make_mesh(dp * gs, dp=dp, ranks=ranks)
    if mesh is None:
        return None
    tx = SGD()
    fn = make_sharded_train_step(
        mesh, s["cfg"], s["step_cfg"], s["template"], s["camera"], tx,
        s["lpips"], s["raster"], strip_bounds=strip_bounds,
        strip_h_max=strip_h_max)
    srl = shard_region_laplacian(s["lap"], gs)
    frame = s["frame"] if frames is None else _t_tree(frames[mesh.dp_idx])
    args = (s["cache"], frame, None, step, 0, srl, srl, s["lap_w"],
            s["lap_w"])
    out = []
    for _ in range(runs):
        d = _t_tree(draws[mesh.dp_idx])
        if grads_only:
            loss, g = fn.grads_fn(s["params"], s["buffers"], *args, draws=d)
            out.append({"loss": float(loss), "grads": _np_tree(g)})
        else:
            p, b, o, m = fn(s["params"], s["buffers"],
                            tx.init(s["params"]), *args, draws=d)
            out.append(_np_tree({"params": p, "buffers": b,
                                 "grads": o["g"], "metrics": m}))
    return {"mesh": (mesh.dp_idx, mesh.gs_idx), "runs": out}


class SGD:
    """SGD at learning rate 1 that keeps the gradients in its state
    (train/optim.py's interface), so that they are compared as
    computed."""

    def init(self, params):
        import torch

        from sings_tpu_torch.tree import tree_map

        return {"g": tree_map(torch.zeros_like, params)}

    def update(self, grads, state, params):
        from sings_tpu_torch.tree import tree_map

        return tree_map(lambda p, g: p - g, params, grads), {"g": grads}


# ---------------------------------------------------------------------------
# the Trainer and the case pool on the world (tests/test_torch_train_step.
# py's tiny configuration and kit, rebuilt here without JAX)

HW = 48


def tiny_opts(tmp: str, extra=()) -> list:
    return [
        f"output_path={tmp}", "exp_name=t", "dataset.name=kit", "seed=0",
        "human.sh_degree=0", "human.n_subdivision=0",
        "human.optim_pose=True", "human.optim_trans=True",
        "human.kplanes.output_coordinate_dim=8",
        "human.kplanes.resolution=[16,16,16]", "human.kplanes.multires=[1,2]",
        "human.loss.patch_size=16", "human.loss.grad_pyramid_w=0.2",
        "human.loss.silhouette_w=1.0", "tpu.random_lpips_factor=0.0",
        "tpu.synthetic_res=0.5", f"tpu.smpl_model_dir={tmp}/models",
        "tpu.triplane_nested=True", "tpu.raster.pair_cap=4",
        "tpu.auto_fit_synthetic=False", "train.init_steps=3",
        "tpu.inner_steps=2", *extra]


def tiny_cfg(tmp: str, extra=()):
    from sings_tpu_torch.config.core import load_config
    from sings_tpu_torch.config.defaults import DEFAULTS

    return load_config(DEFAULTS, None, tiny_opts(tmp, extra))


def tiny_kit(frames: int = 4, seed: int = 0, name: str = "kit"):
    from sings_tpu_torch.data.kit import TrainingKit, get_data_splits
    from sings_tpu_torch.ops.graphics import make_camera

    rng = np.random.RandomState(seed)
    K = np.array([[60.0, 0, HW / 2], [0, 60.0, HW / 2], [0, 0, 1]])
    masks = np.zeros((frames, HW, HW), np.float32)
    masks[:, 6:44, 16:32] = 1.0
    smpl = {"betas": np.zeros(10, np.float32),
            "body_pose": (rng.randn(frames, 69) * 0.05).astype(np.float32),
            "global_orient": np.tile([[np.pi, 0, 0]], (frames, 1)).astype(
                np.float32),
            "transl": np.tile([[0, 0.2, 4.0]], (frames, 1)).astype(
                np.float32)}
    train, val = get_data_splits(frames)
    return TrainingKit(images=rng.rand(frames, 3, HW, HW).astype(np.float32),
                       masks=masks, smpl=smpl,
                       camera=make_camera(np.eye(4), HW, HW, K=K),
                       train_split=train, val_split=val, name=name)


def _digest(tree) -> str:
    import hashlib

    from sings_tpu_torch.tree import tree_leaves

    h = hashlib.sha256()
    for x in tree_leaves(tree):
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def train_mesh(tmp: str, extra: list) -> dict:
    """cli.train.main on every rank (the process group exists already),
    recording each step's metrics and the live counts around each
    density event; then a second Trainer resumes from the run's final
    checkpoint."""
    from sings_tpu_torch.cli import train as cli_train
    from sings_tpu_torch.train import trainer as T
    from sings_tpu_torch.train.trainer import Trainer

    rec = {"losses": [], "counts": [], "io": []}
    orig_init, orig_apply = Trainer._init_mesh, Trainer._apply_density_result

    def init_mesh(self, capacity):
        orig_init(self, capacity)
        step = self.train_step_sharded

        def recorded(*a, **k):
            out = step(*a, **k)
            rec["losses"].append(float(out[3]["loss"]))
            rec["skipped"] = float(out[3]["skipped"])
            return out
        self.train_step_sharded = recorded
        rec["mesh"] = (self.mesh.dp_idx, self.mesh.gs_idx)
        rec["strip_bounds"] = (None if self.strip_bounds is None
                               else self.strip_bounds.tolist())
        rec["trainer"] = self

    def apply(self, res):
        before = int(self.buffers.alive.sum())
        orig_apply(self, res)
        rec["counts"].append((before, int(self.buffers.alive.sum())))

    T.Trainer._init_mesh, T.Trainer._apply_density_result = init_mesh, apply
    try:
        result = cli_train.main(
            ["--device", "cpu", *tiny_opts(tmp, extra)], kit=tiny_kit(),
            image_writer=lambda path, img: rec["io"].append(path))
        tr = rec.pop("trainer")
        again = Trainer(tiny_cfg(tmp, extra), mode="train", device="cpu",
                        kit=tiny_kit(), image_writer=lambda p, i: None)
        rec.pop("trainer")
    finally:
        T.Trainer._init_mesh, T.Trainer._apply_density_result = (
            orig_init, orig_apply)
    state = (tr.params, tr.buffers, tr.opt_state)
    rec.update(
        result=result, step=tr.step, digest=_digest(state),
        resumed=_digest((again.params, again.buffers, again.opt_state)),
        resumed_step=again.step, ckpts=sorted(os.listdir(tr.logdir_ckpt)),
        alive=int(tr.buffers.alive.sum()),
        lap_rows=tuple(tr.region_lap_mesh.neighbors.shape))
    return rec



def _perturbed(tree):
    """tests/test_dist.py's _perturb: x * 1.02 + 0.001 on float leaves."""
    from sings_tpu_torch.tree import tree_map

    return tree_map(lambda x: x * 1.02 + 0.001 if x.is_floating_point()
                    else x, tree)


def case_step_gs(setup: dict, draws: list) -> dict:
    """make_case_train_step at gs = the world's size on two cases (the
    setup's state and its perturbed copy, the second seen through
    another camera) against each case's sharded step at (dp 1, gs):
    whether every output leaf is bit for bit equal, and the metrics."""
    import torch

    from sings_tpu_torch.dist import train_cases as TC
    from sings_tpu_torch.dist.shard import make_mesh
    from sings_tpu_torch.dist.train_sharded import make_sharded_train_step
    from sings_tpu_torch.losses.regularizers import shard_region_laplacian
    from sings_tpu_torch.ops.graphics import make_camera
    from sings_tpu_torch.tree import tree_leaves

    s = _t_tree(setup)
    gs = torch.distributed.get_world_size()
    cam = s["camera"]
    w2c = np.eye(4)
    w2c[0, 3] = 0.05
    cams = [cam, make_camera(w2c, cam.height, cam.width, fovx=0.95,
                             fovy=0.9)]
    params = [s["params"], _perturbed(s["params"])]
    tx = SGD()
    mesh = make_mesh(gs, dp=1)
    srl = shard_region_laplacian(s["lap"], gs).shard(mesh.gs_idx)
    laps = TC.stack_cases([srl, srl])
    step = TC.make_case_train_step(
        s["cfg"], s["step_cfg"], s["template"], cam.height, cam.width, tx,
        s["lpips"], s["raster"], gs=gs)
    frames = {k: [v, v] for k, v in s["frame"].items()}
    batch = {k: (torch.stack(v) if k != "idx" else v)
             for k, v in frames.items()}
    dr = [_t_tree(d) for d in draws]
    cp, cb, co, cm = step(
        TC.stack_cases(params), TC.stack_cases([s["buffers"]] * 2),
        TC.stack_cases([tx.init(p) for p in params]),
        TC.stack_cases([s["cache"]] * 2),
        TC.stack_cases([TC.camera_arrays(c) for c in cams]), batch,
        [None, None], 0, 0, laps, laps, s["lap_w"], s["lap_w"], draws=dr)
    body = make_sharded_train_step(mesh, s["cfg"], s["step_cfg"],
                                   s["template"], cam, tx, s["lpips"],
                                   s["raster"])
    equal = []
    for c in range(2):
        p, b, o, m = body(params[c], s["buffers"], tx.init(params[c]),
                          s["cache"], s["frame"], None, 0, 0, srl, srl,
                          s["lap_w"], s["lap_w"], draws=dr[c],
                          camera=cams[c])
        got = tree_leaves((cp, cb, co)) + [cm[k] for k in sorted(m)]
        want = tree_leaves((p, b, o)) + [m[k] for k in sorted(m)]
        equal.append(sorted(cm) == sorted(m) and all(
            torch.equal(g[c], w) for g, w in zip(got, want)))
    return {"equal": equal, "loss": cm["loss"].numpy(),
            "skipped": cm["skipped"].numpy(), "digest": _digest((cp, cb, co))}


def case_pool_gs(tmp: str, steps: int) -> dict:
    """CasePool(gs = the world's size) over two 4-frame kits, `steps`
    lockstep steps with a validation at step 2, through
    cli.train_batch --simultaneous: each case's losses, final state
    digest and results."""
    import torch

    from sings_tpu_torch.cli import train_batch
    from sings_tpu_torch.train import trainer_cases as TCP

    gs = torch.distributed.get_world_size()
    rec = {"losses": []}
    orig_train = TCP.CasePool.train

    def train(pool):
        rec["pool"] = pool
        fn = pool.step_fn

        def step(*a, **k):
            out = fn(*a, **k)
            rec["losses"].append(out[3]["loss"].tolist())
            return out
        pool.step_fn = step
        return orig_train(pool)

    TCP.CasePool.train = train
    try:
        res = train_batch.main(
            ["--simultaneous", "--gs", str(gs), "--device", "cpu",
             *[o for o in tiny_opts(tmp, [f"train.num_steps={steps}",
                                          "train.val_interval=2",
                                          "tpu.val_pose_refine_steps=0"])
               if not o.startswith("dataset.name=")],
             "--cases", "a", "b"],
            kits={"a": tiny_kit(4, 0, "a"), "b": tiny_kit(4, 1, "b")},
            image_writer=lambda path, img: None)
    finally:
        TCP.CasePool.train = orig_train
    pool = rec.pop("pool")
    rec.update(results=res, step=pool.step, digests=[
        _digest((t.params, t.buffers, t.opt_state)) for t in pool.trainers],
        ckpts=[sorted(os.listdir(t.logdir_ckpt)) for t in pool.trainers],
        gs_idx=pool.mesh.gs_idx)
    return rec
