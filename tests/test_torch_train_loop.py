"""The port's training entry point held against sings_tpu.

The host pieces on identical numpy inputs: the event schedule
(_is_event for every step of the recipe), the gauge alignment of
validation, hybrid density control (densify_and_subdivide and
prune_and_simplify, every DensityResult field, with the native and the
numpy edge collapse), zero_moments_for_slots on a carried-over Adam
state, the LPIPS metric with JAX's random features carried over, and
checkpoints across the two packages. Then the port's whole
Trainer.train() at tiny size with tpu.raster.layout=panel (the plain
panel versions on the CPU): losses, validation metrics, a density event
that changes the live count, checkpoints, auto-resume, exports, and the
shape-mismatch rules.
"""
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sings_tpu.model.density as jdensity
from sings_tpu.config.core import load_config as jload_config
from sings_tpu.config.defaults import DEFAULTS as JDEFAULTS
from sings_tpu.fields.decoders import DecoderConfig as JDec
from sings_tpu.fields.triplane import TriplaneConfig as JTri
from sings_tpu.kinematics.body_model import load_template as jload_template
from sings_tpu.kinematics.template import (
    DeviceTemplate as JDT, canonical_pose_cache as jcache,
)
from sings_tpu.losses import lpips as jlpips
from sings_tpu.mesh.ops import collapse_edges as jcollapse_numpy
from sings_tpu.model import avatar as jav
from sings_tpu.train import checkpoint as jck
from sings_tpu.train import optim as joptim
from sings_tpu.train.trainer import Trainer as JTrainer
import sings_tpu_torch.model.density as tdensity
from sings_tpu_torch.config.core import load_config
from sings_tpu_torch.config.defaults import DEFAULTS
from sings_tpu_torch.losses import lpips as tlpips
from sings_tpu_torch.mesh import native as tnative
from sings_tpu_torch.mesh.ops import collapse_edges as tcollapse_numpy
from sings_tpu_torch.model.avatar import AvatarConfig
from sings_tpu_torch.ops.rasterizer import kernels as tk
from sings_tpu_torch.train import checkpoint as tck
from sings_tpu_torch.train import optim as toptim
from sings_tpu_torch.train.trainer import Trainer
from sings_tpu_torch.fields.decoders import DecoderConfig
from sings_tpu_torch.fields.triplane import TriplaneConfig
from sings_tpu_torch.tree import tree_leaves
from test_torch_train_step import _tiny_kit, _tiny_trainer_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "configs", "human_complex.yaml")


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """The tiny trainer runs thousands of small ops: two threads a worker
    keep the parallel test run from oversubscribing the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _round_up(x, m):
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# event schedule and gauge alignment (JAX's unbound methods on stubs)


@pytest.mark.parametrize("with_anim", [False, True], ids=["no_anim", "anim"])
def test_is_event_matches_jax_for_the_recipe(with_anim):
    jcfg = jload_config(JDEFAULTS, RECIPE)
    tcfg = load_config(DEFAULTS, RECIPE)
    anim = object() if with_anim else None
    jstub = types.SimpleNamespace(
        cfg=jcfg, anim_dataset=anim,
        density_cfg=dict(jcfg.human.density_control.hybrid))
    tstub = types.SimpleNamespace(
        cfg=tcfg, anim_dataset=anim,
        density_cfg=dict(tcfg.human.density_control.hybrid))
    want = [JTrainer._is_event(jstub, t) for t in range(12000)]
    got = [Trainer._is_event(tstub, t) for t in range(12000)]
    assert got == want
    # the recipe's own prune step and its first densify are events
    assert got[1998] and got[3999 + 1500] and sum(got) > 10


def test_val_gauge_alignment_matches_jax():
    rng = np.random.RandomState(3)
    frames = 9
    go6 = rng.randn(frames, 6).astype(np.float32)
    transl = rng.randn(frames, 3).astype(np.float32)
    kit = types.SimpleNamespace(
        train_split=[0, 1, 2, 3, 5, 6, 7, 8],
        smpl={"global_orient": (rng.randn(frames, 3) * 0.5).astype(
            np.float32),
              "transl": rng.randn(frames, 3).astype(np.float32)})
    jstub = types.SimpleNamespace(kit=kit, params=types.SimpleNamespace(
        global_orient=jnp.asarray(go6), transl=jnp.asarray(transl)))
    tstub = types.SimpleNamespace(kit=kit, params=types.SimpleNamespace(
        global_orient=torch.tensor(go6), transl=torch.tensor(transl)))
    jdr, jdt = JTrainer._val_gauge_alignment(jstub)
    tdr, tdt = Trainer._val_gauge_alignment(tstub)
    np.testing.assert_allclose(tdr, jdr, atol=1e-5)
    np.testing.assert_allclose(tdt, jdt, atol=1e-5)
    np.testing.assert_allclose(tdr @ tdr.T, np.eye(3), atol=1e-5)


# ---------------------------------------------------------------------------
# density control and the optimizer moments


@pytest.fixture(scope="module")
def jax_state(tmp_path_factory):
    """A tiny JAX avatar (synthetic template at res 0.5, no
    subdivision), its buffers as numpy, and a forward dict."""
    tmp = str(tmp_path_factory.mktemp("models"))
    tpl = jload_template(os.path.join(tmp, "smplh"), "smplh", num_betas=10,
                         n_subdivision=0, synthetic_res=0.5)
    cap = _round_up(int(tpl.num_verts * 2.0), 256)
    tri = JTri(resolution=(16, 16, 16), out_dim=8, multires=(1, 2),
               nested=True)
    jcfg = jav.AvatarConfig(
        capacity=cap, face_capacity=_round_up(cap * 3, 256),
        edge_capacity=_round_up(cap * 4, 256), num_frames=4,
        num_betas=tpl.num_betas, sh_degree=0, disable_posedirs=True,
        body_template="smplh", triplane=tri,
        decoder=JDec(n_features=tri.feat_dim), offset_clamp=0.05,
        scale_clamp=0.05)
    cache = jcache(JDT.from_host(tpl), jnp.zeros(tpl.num_betas), "da_pose")
    smpl = {"betas": np.zeros(tpl.num_betas, np.float32),
            "global_orient": np.tile([[np.pi, 0, 0]], (4, 1)),
            "body_pose": np.zeros((4, 69), np.float32),
            "transl": np.tile([[0, 0.2, 4.0]], (4, 1)).astype(np.float32)}
    state = jav.init_avatar(jax.random.PRNGKey(3), jcfg, tpl, cache, smpl)
    return types.SimpleNamespace(tpl=tpl, jcfg=jcfg, state=state,
                                 n=tpl.num_verts)


def _density_inputs(s, seed):
    """Numpy buffers with seeded density statistics and a forward dict
    whose opacities and scales select slots for both operations."""
    rng = np.random.RandomState(seed)
    b = {f: np.array(getattr(s.state.buffers, f))
         for f in s.state.buffers._fields}
    alive = b["alive"] > 0.5
    c = alive.shape[0]
    b["xyz_grad_accum"] = (rng.rand(c) * 0.004 * alive).astype(np.float32)
    b["grad_denom"] = alive.astype(np.float32) * 2
    b["max_radii2d"] = (rng.rand(c) * 30 * alive).astype(np.float32)
    xyz = np.array(s.state.params.xyz)
    fwd = {"xyz_canon": xyz + rng.randn(c, 3).astype(np.float32) * 1e-3,
           "scales_canon": rng.uniform(0.002, 0.02, (c, 3)).astype(
               np.float32),
           "scales": rng.uniform(0.0001, 0.02, (c, 3)).astype(np.float32),
           "shs": rng.randn(c, 16, 3).astype(np.float32),
           "opacity": rng.uniform(0.0, 1.0, (c, 1)).astype(np.float32)}
    return b, xyz, fwd


def _assert_results_equal(got, want):
    assert got.changed == want.changed and got.num_alive == want.num_alive
    for f in want._fields:
        a, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert a is None, f
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(a, w, err_msg=f)
        else:
            assert a == w, f


@pytest.mark.parametrize("collapse", ["native", "numpy"])
def test_density_control_matches_jax(jax_state, collapse, monkeypatch):
    s = jax_state
    if collapse == "numpy":
        monkeypatch.setattr(jdensity, "collapse_edges", jcollapse_numpy)
        monkeypatch.setattr(tdensity, "collapse_edges", tcollapse_numpy)
    else:
        from sings_tpu.native import get_lib

        assert get_lib() is not None and tnative.get_lib() is not None
    caps = dict(face_capacity=s.jcfg.face_capacity,
                edge_capacity=s.jcfg.edge_capacity)
    b, xyz, fwd = _density_inputs(s, 5)
    kw = dict(grad_threshold=0.001, scale_threshold=0.005,
              max_screen_size=20, max_n_gs=200000, **caps)
    want = jdensity.densify_and_subdivide(b, xyz, fwd, **kw)
    got = tdensity.densify_and_subdivide(b, xyz, fwd, **kw)
    _assert_results_equal(got, want)
    assert got.changed and got.num_alive > s.n
    runs = dict(tnative.COLLAPSE_RUNS)
    kw = dict(opacity_threshold=0.3, scale_threshold=0.01,
              prune_max_n_gs_once=5000, min_n_gs=10, collapse_rate=0.5,
              **caps)
    want = jdensity.prune_and_simplify(b, xyz, fwd, **kw)
    got = tdensity.prune_and_simplify(b, xyz, fwd, **kw)
    _assert_results_equal(got, want)
    assert got.changed and got.num_alive < s.n
    if collapse == "native":
        assert tnative.COLLAPSE_RUNS["native"] == runs["native"] + 1
    # below min_n_gs nothing changes
    kw["min_n_gs"] = s.n
    assert not tdensity.prune_and_simplify(b, xyz, fwd, **kw).changed


def test_zero_moments_for_slots_matches_jax(jax_state):
    s = jax_state
    tx = joptim.make_optimizer(joptim.LRConfig(), joptim.TrainFlags())
    opt = tx.init(s.state.params)
    rng = np.random.RandomState(1)
    opt = jax.tree.map(
        lambda x: jnp.asarray(rng.rand(*x.shape).astype(np.float32))
        if x.dtype == jnp.float32 else x + 7, opt)
    c = s.jcfg.capacity
    slots = (rng.rand(c) < 0.1).astype(np.float32)
    want = joptim.zero_moments_for_slots(opt, jnp.asarray(slots))
    got = toptim.zero_moments_for_slots(
        tck.adam_state_from_numpy(jax.tree.map(np.asarray, opt)),
        torch.tensor(slots))
    wa = tck.adam_state_from_numpy(jax.tree.map(np.asarray, want))
    assert int(got.count) == int(wa.count) == 7
    for a, b in zip(tree_leaves((got.mu, got.nu)), tree_leaves((wa.mu,
                                                                 wa.nu))):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float(got.mu.xyz[slots > 0].abs().max()) == 0.0
    assert float(got.mu.xyz[slots == 0].abs().min()) > 0.0


# ---------------------------------------------------------------------------
# LPIPS and checkpoints


def test_lpips_distance_matches_jax():
    jp = jlpips.get_lpips(None, seed=0)
    tp = tlpips.lpips_params_from_numpy(
        [(np.asarray(w), np.asarray(b)) for w, b in jp.convs],
        [np.asarray(x) for x in jp.lins], jp.pretrained)
    rng = np.random.RandomState(0)
    x = rng.rand(2, 3, 32, 32).astype(np.float32)
    y = np.clip(x + rng.randn(2, 3, 32, 32).astype(np.float32) * 0.1, 0, 1)
    want = np.asarray(jlpips.lpips_distance(jp, jnp.asarray(x),
                                            jnp.asarray(y)))
    got = tlpips.lpips_distance(tp, torch.tensor(x), torch.tensor(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert want.min() > 0
    # the port's own random features: same shapes, same heads
    own = tlpips.get_lpips(None, seed=0)
    assert [tuple(w.shape) for w, _ in own.convs] == [
        tuple(np.shape(w)) for w, _ in jp.convs]
    assert not own.pretrained and float(own.lins[0][0]) == 1 / 64


def _port_cfg(s):
    j = s.jcfg
    return AvatarConfig(**{**j._asdict(),
                           "triplane": TriplaneConfig(*j.triplane),
                           "decoder": DecoderConfig(*j.decoder)})


def test_checkpoints_cross_packages(jax_state, tmp_path):
    s = jax_state
    rng = np.random.RandomState(2)
    tx = joptim.make_optimizer(joptim.LRConfig(), joptim.TrainFlags())
    opt = jax.tree.map(
        lambda x: jnp.asarray(rng.rand(*x.shape).astype(np.float32))
        if x.dtype == jnp.float32 else x + 5, tx.init(s.state.params))
    path = str(tmp_path / "human_000042.npz")
    jck.save_checkpoint(path, params=s.state.params, buffers=s.state.buffers,
                        opt_state=opt, step=42, active_sh_degree=1)
    nj = s.tpl.lbs_weights.shape[1]
    res = tck.load_checkpoint(path, _port_cfg(s), num_joints=nj,
                              with_opt=True)
    assert res["step"] == 42 and res["active_sh_degree"] == 1
    want = (s.state.params, s.state.buffers, opt[0].count, opt[0].mu,
            opt[0].nu)
    got = (res["params"], res["buffers"], res["opt_state"].count,
           res["opt_state"].mu, res["opt_state"].nu)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # and back: the port's file loads in the JAX package
    path2 = str(tmp_path / "human_000043.npz")
    tck.save_checkpoint(path2, params=res["params"], buffers=res["buffers"],
                        opt_state=res["opt_state"], step=43,
                        active_sh_degree=1)
    back = jck.load_checkpoint(path2, params_template=s.state.params,
                               buffers_template=s.state.buffers,
                               opt_template=opt)
    assert back["step"] == 43
    for a, b in zip(jax.tree.leaves(back["opt_state"]),
                    jax.tree.leaves(opt)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves((back["params"], back["buffers"])),
                    jax.tree.leaves((s.state.params, s.state.buffers))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a checkpoint without an optimizer state does not resume training
    tck.save_checkpoint(path2, params=res["params"], buffers=res["buffers"],
                        step=43, active_sh_degree=1)
    with pytest.raises(tck.CheckpointShapeMismatch):
        tck.load_checkpoint(path2, _port_cfg(s), num_joints=nj,
                            with_opt=True)


# ---------------------------------------------------------------------------
# the whole training entry point at tiny size, panel layout

LOOP = ["tpu.raster.layout=panel", "train.num_steps=12", "train.init_steps=3",
        "tpu.inner_steps=4", "train.val_interval=6", "train.viz_interval=6",
        "train.save_ckpt_interval=10", "tpu.val_pose_refine_steps=2",
        "human.density_control.min_n_gaussians=10",
        "human.density_control.hybrid.prune_from_iter=3",
        "human.density_control.hybrid.prune_interval=100",
        "human.density_control.hybrid.prune_opacity_threshold=0.9",
        "human.density_control.hybrid.prune_scale_threshold=0.05",
        "human.density_control.hybrid.densify_from_iter=8",
        "human.density_control.hybrid.densify_interval=100",
        "human.density_control.hybrid.densify_grad_threshold=0.0",
        "human.density_control.hybrid.densify_scale_threshold=0.0"]


def test_trainer_train_loop_panel_layout(tmp_path):
    saved = []
    writer = lambda path, img: saved.append((path, img.shape, img.dtype))  # noqa: E731,E501
    cfg = _tiny_trainer_cfg(tmp_path, LOOP)
    tr = Trainer(cfg, mode="train", device="cpu", kit=_tiny_kit(),
                 image_writer=writer)
    assert tr.raster_kw["layout"] == "panel" and tr.step == 0
    n0 = int(tr.buffers.alive.sum())
    events = [t for t in range(12) if tr._is_event(t)]
    assert events == [3, 6, 8, 10]
    losses, counts = [], []
    orig_step, orig_scan, orig_apply = (tr.train_step, tr.train_scan,
                                        tr._apply_density_result)

    def step(*a, **k):
        out = orig_step(*a, **k)
        losses.append(float(out[3]["loss"]))
        return out

    def scan(*a, **k):
        out = orig_scan(*a, **k)
        losses.extend(out[3].tolist())
        return out

    def apply(res):
        before = int(tr.buffers.alive.sum())
        orig_apply(res)
        counts.append((before, int(tr.buffers.alive.sum())))
        changed = torch.as_tensor(res.changed_slots) > 0.5
        for m in (tr.opt_state.mu.xyz, tr.opt_state.nu.xyz):
            assert float(m[changed].abs().max()) == 0.0

    tr.train_step, tr.train_scan, tr._apply_density_result = step, scan, apply
    result = tr.train()
    assert tr.step == 12 and len(losses) == 12
    assert np.isfinite(losses).all()
    for key in ("psnr", "ssim", "lpips", "psnr_masked", "psnr_composite",
                "psnr_masked_refined", "psnr_masked_aligned",
                "psnr_masked_train", "scales_p99", "opacity_mean"):
        assert np.isfinite(result[key]), key
    assert not result["lpips_pretrained"]
    # the prune at 3 and the densify at 8 both changed the live count
    assert len(counts) == 2 and counts[0][1] < n0 < counts[1][1]
    with open(os.path.join(tr.logdir, "results_train.json")) as fh:
        assert sorted(json.load(fh)) == ["000006", "final"]
    ck = tr.logdir_ckpt
    assert sorted(os.listdir(ck)) == ["human_000010.npz", "human_final.npz"]
    assert any("val/full_000006_000.png" in p for p, _, _ in saved)
    assert tk.LAUNCHES["composite_fwd_panel"] == 0  # CPU: plain versions

    # exports
    tr.visualize("final")
    ply = os.path.join(tr.logdir, "meshes", "human_pcd_final_splat.ply")
    from sings_tpu_torch.export.ply import load_ply

    assert load_ply(ply)["xyz"].shape == (int(tr.buffers.alive.sum()), 3)
    splat = tr.save_splat_file()
    assert os.path.getsize(splat) == 32 * int(tr.buffers.alive.sum())
    tr.render_canonical("final", nframes=2, img_size=32, pose_type="a_pose")
    assert sum("canon/a_pose_" in p for p, _, _ in saved) == 2

    # auto-resume from the final checkpoint, Adam state included
    tr2 = Trainer(cfg, mode="train", device="cpu", kit=_tiny_kit(),
                  image_writer=writer)
    assert tr2.step == 12 and int(tr2.opt_state.count) == int(
        tr.opt_state.count) == 12
    for a, b in zip(tree_leaves((tr2.params, tr2.opt_state.mu,
                                 tr2.buffers.alive)),
                    tree_leaves((tr.params, tr.opt_state.mu,
                                 tr.buffers.alive))):
        assert torch.equal(a, b)

    # a checkpoint of another capacity: train from scratch, or refuse
    small = LOOP + ["human.density_control.max_n_gaussians=300"]
    tr3 = Trainer(_tiny_trainer_cfg(tmp_path, small), mode="train",
                  device="cpu", kit=_tiny_kit(), image_writer=writer)
    assert tr3.step == 0 and tr3.avatar_cfg.capacity != tr.avatar_cfg.capacity
    with pytest.raises(RuntimeError, match="incompatible"):
        Trainer(_tiny_trainer_cfg(tmp_path, small + ["eval=True"]),
                mode="train", device="cpu", kit=_tiny_kit())
    with pytest.raises(RuntimeError, match="incompatible"):
        Trainer(_tiny_trainer_cfg(tmp_path, small), mode="anim",
                device="cpu", kit=_tiny_kit())
