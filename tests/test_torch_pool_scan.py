"""The case pool's chunk entry point (train/trainer_cases.py::
CasePool.train_scan) and the chunked CasePool.train() on the CPU, at
tests/test_torch_train_step.py's tiny synthetic-template avatar with
two cases (kits of 6 and 5 frames).

train_scan(k) against k calls of the pool's case step on the same
frames and draws, bit for bit; train() across a host event against the
one-step-at-a-time loop it replaced, with the same events; the spans a
lockstep step opens under a CPU profiler (losses.knn_exact once a
case-step inside step.losses, pool.stack once a lockstep step); and a
traced scan against an untraced one; and the case cameras' tangents
kept on the host.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sings_tpu_torch.losses.photometric import draw_step_randoms
from sings_tpu_torch.train.trainer_cases import CasePool
from sings_tpu_torch.tree import tree_leaves
from test_torch_train_step import _tiny_kit, _tiny_trainer_cfg

POOL = ["train.num_steps=6", "train.save_ckpt_interval=3",
        "train.val_interval=100000", "train.viz_interval=100000",
        "tpu.val_pose_refine_steps=0", "tpu.inner_steps=4"]
FRAMES = (6, 5)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _pool(tmp_path, name: str) -> CasePool:
    cfgs = [_tiny_trainer_cfg(tmp_path / name, POOL + [f"exp_name=case{c}"])
            for c in range(len(FRAMES))]
    return CasePool(cfgs, device="cpu", kits=[_tiny_kit(n) for n in FRAMES],
                    image_writer=lambda path, img: None)


def _state(pool: CasePool) -> list:
    return tree_leaves((pool._params, pool._buffers, pool._opt))


def _assert_same_state(a: CasePool, b: CasePool) -> None:
    xs, ys = _state(a), _state(b)
    assert len(xs) == len(ys) > 0
    for i, (x, y) in enumerate(zip(xs, ys)):
        assert torch.equal(x, y), i


def _step(pool: CasePool, frames: list, draws=None) -> dict:
    """One call of the pool's case step on the given frames (one a case),
    as the loop before train_scan made it."""
    ts = pool.trainers
    batch = {"rgb": torch.stack([t.images[f] for t, f in zip(ts, frames)]),
             "mask": torch.stack([t.masks[f] for t, f in zip(ts, frames)]),
             "idx": frames, "smpl_scale": torch.ones((len(ts), 1))}
    (pool._params, pool._buffers, pool._opt, metrics) = pool.step_fn(
        pool._params, pool._buffers, pool._opt, pool._caches, pool._cams,
        batch, pool.generators, pool.step, pool.active_sh_degree,
        pool._rlap, pool._rlap, ts[0].lap_pos_w, ts[0].lap_color_w,
        draws=draws)
    pool.step += 1
    return metrics


def _draws(pool: CasePool, frames: list, seed: int) -> list:
    """Each case's draws for its frames, from a generator of its own."""
    out = []
    for c, (t, fs) in enumerate(zip(pool.trainers, frames)):
        g = torch.Generator().manual_seed(seed + c)
        w = t.step_cfg.weights.photometric
        out.append([draw_step_randoms(g, t.masks[f], w) for f in fs])
    return out


@pytest.mark.parametrize("given", [False, True])
def test_train_scan_is_k_case_steps(tmp_path, given):
    """train_scan(3) from step 2000 against three case steps: on each
    case's own frame stream and generator, or on frames and draws the
    caller gives; the losses and skipped flags (C, k), on the device."""
    a, b = _pool(tmp_path, "a"), _pool(tmp_path, "b")
    a.step = b.step = 2000
    k, n = 3, len(FRAMES)
    frames = draws = None
    if given:
        frames = [[1, 0, 1], [2, 2, 0]]
        draws = _draws(a, frames, 11)
    losses, skipped = a.train_scan(k, frames=frames, draws=draws)
    assert a.step == b.step + k
    assert losses.shape == skipped.shape == (n, k)
    want = []
    for i in range(k):
        fs = ([b._next_frame(c) for c in range(n)] if frames is None
              else [f[i] for f in frames])
        want.append(_step(b, fs, None if draws is None
                          else [d[i] for d in draws]))
    assert torch.equal(losses, torch.stack([m["loss"] for m in want], 1))
    assert torch.equal(skipped, torch.stack([m["skipped"] for m in want], 1))
    assert not skipped.any() and torch.isfinite(losses).all()
    _assert_same_state(a, b)
    # the frame streams advanced only where train_scan drew from them
    assert a._cursors == ([0] * n if given else b._cursors)


def _events(pool: CasePool) -> list:
    """Record each case's _periodic_check calls, in order."""
    seen = []
    for c, t in enumerate(pool.trainers):
        orig = t._periodic_check

        def check(t_iter, render, _c=c, _orig=orig):
            seen.append((_c, t_iter))
            return _orig(t_iter, render)
        t._periodic_check = check
    return seen


def test_train_in_chunks_is_the_step_by_step_loop(tmp_path):
    """train() over 6 steps with a checkpoint event at step 3, in chunks
    of up to 4 lockstep steps ([0, 2], [3], [4, 5]), against one case
    step at a time with the event after step 3: the same calls of the
    step, the same events and the same state, bit for bit."""
    a, b = _pool(tmp_path, "a"), _pool(tmp_path, "b")
    ev_a, ev_b = _events(a), _events(b)
    calls, scans = [], []
    fn, scan = a.step_fn, a.train_scan

    def counted(*args, **kw):
        calls.append(args[7])
        return fn(*args, **kw)

    def scanned(k, **kw):
        scans.append(k)
        return scan(k, **kw)

    a.step_fn, a.train_scan = counted, scanned
    a.train()
    assert scans == [3, 1, 2] and calls == list(range(6))
    # the loop train() had before its chunks
    ts, n = b.trainers, len(FRAMES)
    while b.step < 6:
        t_iter = b.step
        _step(b, [b._next_frame(c) for c in range(n)])
        if any(t._is_event(t_iter) for t in ts):
            b._unstack_state(t_iter)
            for t in ts:
                t._periodic_check(t_iter, None)
                t._adjust_density(t_iter)
            b._sync_from_rank0()
            b._unify_laps()
            b._stack_state()
    b._unstack_state(6)
    assert ev_a == ev_b == [(0, 3), (1, 3)]
    assert a._cursors == b._cursors
    for ta, tb in zip(a.trainers, b.trainers):
        assert ta.step == tb.step == 6
        xs = tree_leaves((ta.params, ta.buffers, ta.opt_state))
        ys = tree_leaves((tb.params, tb.buffers, tb.opt_state))
        assert len(xs) == len(ys) > 0
        assert all(torch.equal(x, y) for x, y in zip(xs, ys))
        assert int(ta.opt_state.count) == 6


def _ranges(prof, names) -> dict:
    out = {n: [] for n in names}
    for e in prof.events():
        if e.name in out:
            out[e.name].append((e.time_range.start, e.time_range.end))
    return out


def test_a_lockstep_step_opens_the_pool_spans(tmp_path):
    """Under a CPU profiler one lockstep step of two cases opens
    losses.knn_exact once a case, each inside a step.losses, and
    pool.stack once, after both cases' step.update."""
    pool = _pool(tmp_path, "a")
    pool.step = 2000
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pool.train_scan(1)
    r = _ranges(prof, ("losses.knn_exact", "step.losses", "step.update",
                       "pool.stack"))
    assert len(r["step.losses"]) == len(r["losses.knn_exact"]) == 2
    for a, b in r["losses.knn_exact"]:
        assert sum(s <= a and b <= e for s, e in r["step.losses"]) == 1
    assert len(r["pool.stack"]) == 1
    assert r["pool.stack"][0][0] >= max(e for _s, e in r["step.update"])


def test_a_traced_scan_is_the_untraced_scan(tmp_path):
    a, b = _pool(tmp_path, "a"), _pool(tmp_path, "b")
    a.step = b.step = 2000
    with profile(activities=[ProfilerActivity.CPU]):
        la, sa = a.train_scan(2)
    lb, sb = b.train_scan(2)
    assert torch.equal(la, lb) and torch.equal(sa, sb)
    _assert_same_state(a, b)


def test_the_case_cameras_keep_their_tangents_on_the_host():
    """shard_cameras moves the stacked matrices to the device and leaves
    the tangents on the host, where a case step reads them without
    waiting for the card; the pool's cameras are laid out so."""
    from sings_tpu_torch.dist.train_cases import (
        camera_arrays, shard_cameras, stack_cases,
    )

    cam = _tiny_kit(4).camera
    arr = stack_cases([camera_arrays(cam)] * 2)
    out = shard_cameras(arr, torch.device("meta"))
    for k in ("view", "proj", "cam_center"):
        assert out[k].device.type == "meta" and out[k].shape[0] == 2
    for k in ("tan_fovx", "tan_fovy"):
        assert out[k].device.type == "cpu" and out[k].dtype == torch.float64
        assert [float(x) for x in out[k]] == [getattr(cam, k)] * 2
