"""Simultaneous multi-case training pool (port of
sings_tpu/train/trainer_cases.py).

C independent avatar cases train in lockstep: one call of the case step
(dist/train_cases.py) updates every case, while the host-side work
(frame sampling, periodic checkpoint / validation / visualisation,
density control, laplacian rebuilds) runs per case between calls with
the single-case Trainer's semantics: the pool owns one Trainer per case
and unstacks the stacked state into them only at event steps. train()
runs train_scan chunks of up to tpu.inner_steps lockstep steps between
events (Trainer.train's rule) and reads the skipped flags back once a
chunk. The JAX package runs the cases over a (case, gs) device mesh;
the port runs them one after another, on one card (gs = 1) or, at
gs > 1, on each of the gs ranks of a torch.distributed process group,
which splits every case's step into image strips and gaussian shards
(make_case_mesh).
Rank 0 alone writes; every event ends with each case's state from rank
0 on every rank.

Requirements across cases (checked): the same recipe (schedules, loss
weights), image resolution, body template and capacity. Frame counts
may differ: the per-frame pose parameters are padded to the longest
case (dataset.pad_frames_to, set here before any Trainer is built, so
checkpoints keep their shapes).

Deviations from the JAX signatures:
  * CasePool(cfgs, gs=1, device=None, kits=None, image_writer=None)
    takes the device, optional in-memory kits (one per config) and the
    image sink, as Trainer does;
  * the step draws come from one torch.Generator per case, seeded from
    the case's seed and its index (JAX folds the case index into one
    pool key);
  * laplacian.type cotangent raises (JAX's pool fails there too: its
    stacking reads the gather tables). tpu.laplacian_backend banded
    trains, on the gather tables every backend builds in the port.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..dist.collectives import broadcast_object, world_rank
from ..dist.train_cases import (
    camera_arrays, make_case_mesh, make_case_train_step, pick_case,
    shard_cameras, shard_cases, stack_cases,
)
from ..losses.regularizers import shard_region_laplacian

# the frame streams' seed stride between cases (JAX's)
CASE_SEED_STRIDE = 7919


def case_frame_count(cfg, kit=None) -> int:
    """The frame count a case's Trainer will see: an in-memory kit's
    frames, else the kit directory's (scan_kit_frames), both cut to
    dataset.max_frames."""
    from ..data.kit import scan_kit_frames

    max_frames = cfg.dataset.get("max_frames")
    if kit is None:
        kit_dir = os.path.normpath(os.path.join(
            cfg.dataset.root_dir, cfg.dataset.batch or "", cfg.dataset.name,
            cfg.dataset.seq or ""))
        return scan_kit_frames(kit_dir, max_frames=max_frames)
    n = int(np.asarray(kit.smpl["body_pose"]).shape[0])
    return n if max_frames is None else min(n, int(max_frames))


def check_case_cfg(cfg) -> None:
    """What the pool cannot run, refused before any Trainer is built."""
    mesh = dict(cfg.tpu.get("mesh", {}) or {})
    if int(mesh.get("dp", 1) or 1) * int(mesh.get("gs", 1) or 1) > 1:
        raise ValueError("tpu.mesh and simultaneous cases are exclusive - "
                         "the pool lays out the cases itself")
    if str(cfg.human.loss.laplacian.type) == "cotangent":
        raise NotImplementedError(
            "laplacian.type='cotangent': the case pool stacks the standard "
            "gather laplacian's tables only; the JAX package's pool fails "
            "here too (shard_region_laplacian reads nbr_valid, which the "
            "cotangent laplacian lacks)")


class CasePool:
    def __init__(self, cfgs: list, gs: int = 1, device=None,
                 kits: list | None = None, image_writer=None):
        from .trainer import Trainer

        if not cfgs:
            raise ValueError("need at least one case config")
        kits = list(kits) if kits is not None else [None] * len(cfgs)
        if len(kits) != len(cfgs):
            raise ValueError(f"{len(kits)} kits for {len(cfgs)} cases")
        for cfg in cfgs:
            check_case_cfg(cfg)
        # the gs ranks that split every case's step (refused before any
        # Trainer is built without a process group of gs ranks)
        self.mesh = make_case_mesh(len(cfgs), gs)
        # size the shared per-frame parameter axis before building any
        # Trainer, so checkpoint shapes are stable across runs
        f_max = max(case_frame_count(cfg, kit)
                    for cfg, kit in zip(cfgs, kits))
        for cfg in cfgs:
            cfg.dataset.pad_frames_to = int(f_max)

        self.trainers = [Trainer(cfg, mode="train", device=device, kit=kit,
                                 image_writer=image_writer)
                         for cfg, kit in zip(cfgs, kits)]
        t0 = self.trainers[0]
        self.device = t0.device
        for t in self.trainers[1:]:
            if (t.camera.height, t.camera.width) != (t0.camera.height,
                                                     t0.camera.width):
                raise ValueError("all cases must share one image resolution "
                                 "(use dataset.downscale)")
            if t.avatar_cfg != t0.avatar_cfg:
                raise ValueError("cases disagree on AvatarConfig (body "
                                 "template / capacity / recipe must match)")
            if t.step_cfg != t0.step_cfg:
                raise ValueError("cases disagree on recipe")
            if int(t.cfg.train.num_steps) != int(t0.cfg.train.num_steps):
                raise ValueError("cases disagree on train.num_steps")
            np.testing.assert_allclose(t.lap_pos_w.cpu().numpy(),
                                       t0.lap_pos_w.cpu().numpy())
            np.testing.assert_allclose(t.lap_color_w.cpu().numpy(),
                                       t0.lap_color_w.cpu().numpy())

        lpips = (t0.lpips_params
                 if float(t0.cfg.human.loss.lpips_w) > 0 else None)
        self.gs = gs
        self.step_fn = make_case_train_step(
            t0.avatar_cfg, t0.step_cfg, t0.template, t0.camera.height,
            t0.camera.width, t0.tx, lpips, t0.raster_kw, gs=gs,
            mesh=self.mesh)
        # one step generator per case: cases that share a seed draw apart
        self.generators = [
            torch.Generator(device=self.device).manual_seed(
                int(t.cfg.seed) + CASE_SEED_STRIDE * c)
            for c, t in enumerate(self.trainers)]
        self.active_sh_degree = min(t.active_sh_degree for t in self.trainers)
        self.step = min(t.step for t in self.trainers)

        # static per-case inputs
        self._cams = shard_cameras(stack_cases(
            [camera_arrays(t.camera) for t in self.trainers]), self.device)
        self._caches = shard_cases(stack_cases(
            [t.cache for t in self.trainers]), self.device)

        self._sync_from_rank0()
        self._unify_laps()
        self._stack_state()

        self._init_frame_streams()

    # ------------------------------------------------------------------
    def _init_frame_streams(self):
        """Per-case frame shuffles (the single-case Trainer has its own
        random.Random; the pool needs independent streams)."""
        self._frame_rand = [
            np.random.RandomState(int(t.cfg.seed) + CASE_SEED_STRIDE * c)
            for c, t in enumerate(self.trainers)]
        self._orders = [list(range(len(t.kit.train_split)))
                        for t in self.trainers]
        for r, o in zip(self._frame_rand, self._orders):
            r.shuffle(o)
        self._cursors = [0] * len(self.trainers)

    def _unify_laps(self):
        """All cases share one laplacian neighbour-table width (the
        stacked tables are one tensor)."""
        w = max(t.region_lap.neighbors.shape[1] for t in self.trainers)
        for t in self.trainers:
            if t.region_lap.neighbors.shape[1] != w:
                t._lap_pad = w
                t._rebuild_laplacians()

    def _stack_state(self):
        ts = self.trainers

        def sc(xs):
            return shard_cases(stack_cases(xs), self.device)

        self._params = sc([t.params for t in ts])
        self._buffers = sc([t.buffers for t in ts])
        self._opt = sc([t.opt_state for t in ts])
        if self.mesh is None:
            self._rlap = sc([t.region_lap for t in ts])
            return
        # this rank's laplacian rows of every case, one transposed-table
        # width across cases so that they stack
        srls = [shard_region_laplacian(t.region_lap, self.gs) for t in ts]
        dt = max(x.t_neighbors.shape[-1] for x in srls)
        srls = [x if x.t_neighbors.shape[-1] == dt else
                shard_region_laplacian(t.region_lap, self.gs,
                                       pad_t_width_to=dt)
                for x, t in zip(srls, ts)]
        self._rlap = stack_cases([x.shard(self.mesh.gs_idx) for x in srls])

    def _sync_from_rank0(self):
        """Every case's state from rank 0 (gs > 1, Trainer.
        _sync_from_rank0)."""
        if self.mesh is not None:
            for t in self.trainers:
                t._sync_from_rank0(self.mesh.group)

    def _unstack_state(self, t_iter: int):
        for c, t in enumerate(self.trainers):
            t.params = pick_case(self._params, c)
            t.buffers = pick_case(self._buffers, c)
            t.opt_state = pick_case(self._opt, c)
            t.step = t_iter
            t.active_sh_degree = self.active_sh_degree

    def _next_frame(self, c: int) -> int:
        if self._cursors[c] >= len(self._orders[c]):
            self._frame_rand[c].shuffle(self._orders[c])
            self._cursors[c] = 0
        t = self.trainers[c]
        frame = t.kit.train_split[self._orders[c][self._cursors[c]]]
        self._cursors[c] += 1
        return int(frame)

    # ------------------------------------------------------------------
    def train_scan(self, k: int, frames=None, draws=None):
        """k lockstep steps from self.step with no host event and no read
        of their results in between; advances self.step by k. Each
        case's frames come from its stream (_next_frame) unless given:
        frames[c] is case c's k frame indices. draws: None to draw from
        each case's generator, else draws[c] is case c's list of k draw
        dicts (draw_step_randoms' layout). Returns each case's losses
        and skipped flags as (C, k) tensors, on the device."""
        ts = self.trainers
        n = len(ts)
        if frames is None:
            frames = [[self._next_frame(c) for _ in range(k)]
                      for c in range(n)]
        if len(frames) != n or any(len(f) != k for f in frames):
            raise ValueError(f"frames: {n} cases of {k} steps each")
        if draws is not None and (len(draws) != n
                                  or any(len(d) != k for d in draws)):
            raise ValueError(f"draws: {n} cases of {k} steps each")
        t0 = ts[0]
        ones = torch.ones((n, 1), device=self.device)
        losses, skipped = [], []
        for i in range(k):
            step_frames = [int(f[i]) for f in frames]
            batch = {
                "rgb": torch.stack([t.images[f]
                                    for t, f in zip(ts, step_frames)]),
                "mask": torch.stack([t.masks[f]
                                     for t, f in zip(ts, step_frames)]),
                "idx": step_frames,
                "smpl_scale": ones,
            }
            (self._params, self._buffers, self._opt,
             metrics) = self.step_fn(
                self._params, self._buffers, self._opt, self._caches,
                self._cams, batch, self.generators, self.step,
                self.active_sh_degree, self._rlap, self._rlap,
                t0.lap_pos_w, t0.lap_color_w,
                draws=None if draws is None else [d[i] for d in draws])
            losses.append(metrics["loss"])
            skipped.append(metrics["skipped"])
            self.step += 1
        return torch.stack(losses, dim=1), torch.stack(skipped, dim=1)

    def _is_event(self, t: int) -> bool:
        """Any case's host event after step t (Trainer._is_event)."""
        return any(t_._is_event(t) for t_ in self.trainers)

    def train(self):
        """The lockstep loop: train_scan chunks of up to tpu.inner_steps
        steps between host events (Trainer.train's rule: a chunk ends
        before an event step, which runs alone), one read of the skipped
        flags a chunk, then each case's final checkpoint and
        validation."""
        ts = self.trainers
        t0 = ts[0]
        num_steps = int(t0.cfg.train.num_steps)
        inner = t0.inner_steps
        names = [t.kit.name for t in ts]
        io = world_rank() == 0
        if io:
            print(f"[pool] {len(ts)} cases {names} (case={len(ts)}, "
                  f"gs={self.gs}), one case step after another, chunks of "
                  f"up to {inner} lockstep steps")
        log_every, steps_since_log, tlog = 50, 0, time.time()

        while self.step < num_steps:
            t_iter = self.step
            k = 1
            if inner > 1 and not self._is_event(t_iter):
                while (k < inner and t_iter + k < num_steps
                       and not self._is_event(t_iter + k)):
                    k += 1
            losses, skipped = self.train_scan(k)

            skipped = skipped.cpu().numpy()
            if skipped.any() and io:
                for i in range(k):
                    bad = [n for n, s in zip(names, skipped[:, i]) if s > 0]
                    if bad:
                        print(f"[{t_iter + i}] WARNING: non-finite "
                              f"gradients, update skipped for {bad}")

            steps_since_log += k
            if steps_since_log >= log_every and io:
                last = losses[:, -1].cpu().numpy().round(4).tolist()
                n_gs = self._buffers.alive.sum(dim=1).cpu().numpy().astype(
                    int).tolist()
                dt = time.time() - tlog
                print(f"[{self.step - 1:6d}] losses={last} n_gs={n_gs} "
                      f"({steps_since_log / max(dt, 1e-9):.2f} it/s)",
                      flush=True)
                tlog, steps_since_log = time.time(), 0

            last_t = self.step - 1
            if self._is_event(last_t):
                self._unstack_state(last_t)
                for t in ts:
                    t._periodic_check(last_t, None)
                    t._adjust_density(last_t)
                # one SH schedule for the pool (the rule of
                # Trainer._periodic_check)
                if (last_t % 1000 == 0 and last_t > 0
                        and self.active_sh_degree < t0.cfg.human.sh_degree):
                    self.active_sh_degree += 1
                self._sync_from_rank0()
                self._unify_laps()
                self._stack_state()

        self._unstack_state(num_steps)
        results = {}
        if io:
            for c, t in enumerate(ts):
                t.save_ckpt("final")
                key = t.kit.name if t.kit.name not in results else (
                    f"{t.kit.name}#{c}")
                results[key] = t.validate("final")
        return broadcast_object(results, None if self.mesh is None
                                else self.mesh.group)
