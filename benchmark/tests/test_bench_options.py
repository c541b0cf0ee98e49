"""The options cell (complex-options) on the CPU: the new plain copies in
benchmark/reference against the port, the whole run at tiny shapes, the
faults the comparison has to see, and the new operation counts against
torch.utils.flop_counter.

The plain copies and the port's functions are the same float32
operations in the same order, so on one device they agree bit for bit:
each comparison below asserts equality, which is its tolerance. Across
devices they would not: chip_smoke.py's phase 17 holds the card's LPIPS
input gradient against a float64 one because two float32 convolution
algorithms give gradients 1.8% of the largest element apart on clipped
flat patches; the cell's limits (PERF.md section 2) are set from card
runs for that reason.
"""
import argparse
import json

import numpy as np
import pytest
import torch

from bench_tiny import SMALL_CONFIG, run_cell, tiny

CELL = "complex-options"


def _lpips_params(seed=3):
    from sings_tpu_torch.losses.lpips import init_random

    return init_random(torch.Generator().manual_seed(seed))


def _plain(p):
    from reference.plain.losses.lpips import LPIPSParams

    return LPIPSParams(convs=p.convs, lins=p.lins)


def _patches(seed, n=2, size=32, grad=False):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, 3, size, size), generator=g)
    # clipped flat areas, as the step's clip(pred, hi=1) makes them
    x[:, :, : size // 4] = 1.0
    return x.requires_grad_(grad)


def test_the_plain_lpips_distance_and_its_input_gradient_are_the_ports(
        one_thread):
    from reference.plain.losses.lpips import lpips_distance as plain
    from sings_tpu_torch.losses.lpips import lpips_distance as port

    p = _lpips_params()
    outs = []
    for fn, params in ((port, p), (plain, _plain(p))):
        x, y = _patches(1, grad=True), _patches(2)
        d = fn(params, x, y)
        (g,) = torch.autograd.grad(d.mean(), x)
        outs.append((d.detach(), g))
    assert outs[0][0].min() > 0
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_the_cell_draws_the_lpips_weights_from_the_seed(one_thread):
    """runners/train_options.py::lpips_weights: the same seed gives the
    same He-normal VGG16 and 1/C heads, another seed others."""
    from runners import train_options

    seed = 2 ** 31 + 17
    got = train_options.lpips_weights(seed, "cpu")
    again = train_options.lpips_weights(seed, "cpu")
    other = train_options.lpips_weights(seed + 1, "cpu")
    assert len(got.convs) == 13 and len(got.lins) == 5
    cin = 3
    for (w, b), (w2, b2), (w3, _b3) in zip(got.convs, again.convs,
                                           other.convs):
        assert w.shape == (3, 3, cin, b.shape[0])
        assert torch.equal(w, w2) and torch.equal(b, b2)
        assert not torch.equal(w, w3)
        assert not b.any()
        std = float(w.std()) * np.sqrt(9 * cin / 2.0)
        assert 0.9 < std < 1.1, std
        cin = w.shape[3]
    for lin, c in zip(got.lins, (64, 128, 256, 512, 512)):
        assert lin.shape == (c,) and torch.equal(lin, torch.full((c,), 1 / c))


def test_the_programs_lpips_tensors_take_the_draw_in_place(one_thread):
    """load_lpips writes the draw into the program's own tensors (the
    step holds them), and refuses a tensor laid out otherwise."""
    from runners import train_options
    from sings_tpu_torch.losses.lpips import LPIPSParams, get_lpips

    drawn = train_options.lpips_weights(9, "cpu")
    prog = get_lpips(None, seed=9)
    held = [w for w, _b in prog.convs]
    assert not torch.equal(held[0], drawn.convs[0][0])
    train_options.load_lpips(prog, drawn)
    for w, (dw, db), (pw, pb) in zip(held, drawn.convs, prog.convs):
        assert pw is w and torch.equal(pw, dw) and torch.equal(pb, db)
    assert all(torch.equal(a, b) for a, b in zip(prog.lins, drawn.lins))
    oihw = LPIPSParams(
        convs=tuple((w.permute(3, 2, 0, 1).contiguous(), b)
                    for w, b in prog.convs),
        lins=prog.lins, pretrained=False)
    with pytest.raises(RuntimeError, match="shape"):
        train_options.load_lpips(oihw, drawn)


def test_the_plain_window_statistic_is_the_ports(one_thread):
    from reference.plain.ops.knn_window import knn_window_stat as plain
    from sings_tpu_torch.ops.knn import knn, knn_window_stat as port

    g = torch.Generator().manual_seed(4)
    pts = torch.randn((2048, 3), generator=g)
    valid = torch.rand(2048, generator=g) > 0.2
    a = port(pts, 9, valid=valid)
    b = plain(pts, 9, valid=valid)
    assert torch.equal(a, b)
    # the windows hide neighbours here, so the exact statistic differs
    d, _ = knn(pts, 9, valid=valid)
    exact = torch.sqrt(torch.clamp_min(d[:, 1:], 1e-24)).mean(1) * valid
    assert (b >= exact - 1e-6).all() and (b > exact + 1e-4).any()


def _cot_inputs(tmp_path):
    """A tiny avatar's anchors, faces, labels and region weights."""
    tr, _ri = _trainer(tmp_path, 5)
    b = tr.buffers
    labels = np.where(b.alive.numpy() > 0.5, b.vertex_label.numpy(), -1)
    faces = b.faces.numpy()[b.face_valid.numpy() > 0.5]
    return tr.params.xyz.detach().numpy(), faces, labels, \
        tr.lap_pos_w.numpy()


def test_the_plain_cotangent_laplacian_is_the_ports(tmp_path, one_thread):
    from reference.plain.losses.cotangent import (
        build_cot_region_laplacian as plain_build,
    )
    from sings_tpu_torch.losses.regularizers import (
        build_cot_region_laplacian as port_build,
    )

    verts, faces, labels, w = _cot_inputs(tmp_path)
    a = port_build(verts, faces, labels, w, num_regions=15, pad_width_to=8)
    b = plain_build(verts, faces, labels, w, num_regions=15, pad_width_to=8)
    for name in b._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    g = torch.Generator().manual_seed(6)
    x0 = torch.randn((verts.shape[0], 6), generator=g)
    outs = []
    for lap in (a, b):
        x = x0.clone().requires_grad_(True)
        terms = lap.loss_fused([(x[:, :3], None, None),
                                (x[:, 3:], torch.ones(15), [6, 7])])
        (grad,) = torch.autograd.grad(terms[0] + terms[1], x)
        outs.append((torch.stack(terms).detach(), grad))
    assert outs[0][0][0] > 0
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def _trainer(tmp_path, seed):
    """The program's Trainer at the cell's tiny shapes with the cell's
    seeded weights, and the cell's inputs."""
    import inputs
    import run
    from sings_tpu_torch.config.core import load_config
    from sings_tpu_torch.config.defaults import DEFAULTS
    from sings_tpu_torch.data.kit import TrainingKit
    from sings_tpu_torch.ops.graphics import make_camera
    from sings_tpu_torch.train.trainer import Trainer

    files = run.cell_files(run.ROOT, run.manifest(run.ROOT), CELL)
    ctx, runner = run.make_ctx(
        files, argparse.Namespace(seed=seed, seconds=0.0, trace=0),
        torch.device("cpu"), tiny(CELL), run.ROOT, 0.0)
    inputs.remove(ctx.tmp)
    ctx.tmp = str(tmp_path)
    ri = runner.reference_inputs(ctx)
    size = int(ctx.traffic["kit_size"])
    kit = TrainingKit(images=ri["images"].numpy(), masks=ri["masks"].numpy(),
                      smpl=ri["smpl"],
                      camera=make_camera(np.eye(4), size, size, K=ri["K"]),
                      train_split=ri["train"], val_split=ri["val"],
                      name="kit")
    tr = Trainer(load_config(DEFAULTS, None, runner.program_dotlist(ctx)),
                 mode="train", device="cpu", kit=kit,
                 image_writer=lambda p, i: None)
    tr.params = tr.params._replace(**inputs.clone_weights(ri["weights"]))
    tr.opt_state = tr.tx.init(tr.params)
    ri["lpips"] = runner.lpips_weights(ctx.seed, "cpu")
    runner.load_lpips(tr.lpips_params, ri["lpips"])
    return tr, ri


def test_one_options_step_is_the_ports(tmp_path, one_thread):
    """Losses, gradients (the first moment after one Adam step) and both
    moments of one step of each side from the same state and draws."""
    import inputs
    from reference import build as RB
    from reference import options as RO
    from reference.plain.train.step_options import make_train_step
    from sings_tpu_torch.tree import tree_leaves

    tr, ri = _trainer(tmp_path, 7)
    av = RB.avatar(ri["cfg"], ri["smpl"], inputs.clone_weights(ri["weights"]),
                   "cpu")
    rt = RO.training(av, ri["camera"], "cpu", ri["lpips"])
    assert torch.equal(rt.region_lap.neighbors, tr.region_lap.neighbors)
    assert torch.equal(rt.region_lap.nbr_w, tr.region_lap.nbr_w)
    (f,), (d,) = ri["chunks"][0]
    batch = {"rgb": tr.images[f], "mask": tr.masks[f], "idx": f,
             "smpl_scale": torch.ones(1)}
    args = (tr.buffers, tr.opt_state, tr.cache, batch, None, 2000, 0)
    _p, _b, o_port, m_port, _r = tr.train_step(
        tr.params, *args, tr.region_lap, tr.region_lap, tr.lap_pos_w,
        tr.lap_color_w, draws=d)
    ref_step = make_train_step(av.acfg, rt.step_cfg, av.template,
                               ri["camera"], rt.tx, ri["lpips"],
                               RB.raster_kw(ri["cfg"]))
    _p, _b, o_ref, m_ref, _r = ref_step(
        av.params, av.buffers, rt.tx.init(av.params), av.cache, batch,
        None, 2000, 0, rt.region_lap, rt.region_lap, rt.lap_pos_w, rt.lap_color_w,
        draws=d)
    assert float(m_port["photo_lpips_patch"]) > 0
    assert float(m_port["connect"]) > 0 and float(m_port["lap_pos"]) > 0
    assert m_port.keys() == m_ref.keys()
    for k in m_port:
        assert torch.equal(m_port[k], m_ref[k]), k
    for name in ("mu", "nu"):
        a = tree_leaves(getattr(o_port, name))
        b = tree_leaves(getattr(o_ref, name))
        assert len(a) == len(b) > 0
        assert all(torch.equal(x, y) for x, y in zip(a, b)), name


def test_a_tiny_run_of_the_cell_is_correct(capsys, one_thread):
    rc, line, err = run_cell(CELL, 2 ** 31 + 17, capsys)
    assert rc == 0, err
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                   "mu_gap", "nu_gap", "lpips_gap",
                                   "connect_gap", "screen_grad_gap"}
    assert set(line["metrics"]) == {"train_steps_per_s", "setup_s"}


def _no_lpips(monkeypatch):
    """The program's step drops the LPIPS term."""
    from sings_tpu_torch.train import step

    loss = step.photometric_loss

    def without(*args, **kw):
        return loss(*args[:6])

    monkeypatch.setattr(step, "photometric_loss", without)


def _exact_statistic(monkeypatch):
    """The program's step takes the exact statistic for the windowed
    one."""
    from sings_tpu_torch.train import step

    loss = step.gaussians_edge_loss

    def exact(*args, **kw):
        return loss(*args, **dict(kw, backend="dense"))

    monkeypatch.setattr(step, "gaussians_edge_loss", exact)


def _standard_laplacian(monkeypatch):
    """The program's Trainer builds the standard laplacian (over the
    faces' edges) for the cotangent one."""
    from sings_tpu_torch.losses.regularizers import build_region_laplacian
    from sings_tpu_torch.train import trainer

    def standard(verts, faces, labels, w, *, device, **_kw):
        e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]])
        edges = np.unique(np.sort(e, axis=1), axis=0)
        return build_region_laplacian(edges, labels, w, num_regions=15,
                                      pad_to=8, device=device)

    monkeypatch.setattr(trainer, "build_cot_region_laplacian", standard)


# the windowed fault at SMALL_CONFIG: at the tiny template one window
# covers every point (N <= block + window), where both statistics agree
@pytest.mark.parametrize("fault,small", [
    (_no_lpips, False), (_exact_statistic, True),
    (_standard_laplacian, False)])
def test_a_fault_of_each_option_is_not_correct(fault, small, capsys,
                                               monkeypatch, one_thread):
    import time

    import run

    fault(monkeypatch)
    ov = tiny(CELL)
    if small:
        ov["config"] += SMALL_CONFIG
    rc = run.main(["--workload", CELL, "--seed", "5", "--seconds", "0.5"],
                  device=torch.device("cpu"), overrides=ov,
                  t_start=time.time())
    out = capsys.readouterr().out
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]


def test_half_of_the_patches_fails_the_cell(capsys, one_thread):
    import control_options
    import run

    limits = run.cell_files(run.ROOT, run.manifest(run.ROOT), CELL)[
        "limits"]
    assert control_options.main(["--kind", "half_batch", "--seeds", "1",
                                 "2"], device=torch.device("cpu"),
                                overrides=tiny(CELL)) == 0
    out = capsys.readouterr().out
    readings = json.loads(out.strip().splitlines()[-1])["readings"]
    for seed, numbers in readings.items():
        assert numbers["lpips_gap"] > limits["lpips_gap"], (seed, numbers)


def test_a_cut_lpips_gradient_fails_the_cell(capsys, one_thread):
    """The LPIPS term's value kept and its gradient cut: the screen-space
    gradients see it; the leaves' gradients, under the laplacians',
    do not."""
    import control_options
    import run

    limits = run.cell_files(run.ROOT, run.manifest(run.ROOT), CELL)[
        "limits"]
    assert control_options.main(["--kind", "lpips_no_grad", "--seeds",
                                 "1"], device=torch.device("cpu"),
                                overrides=tiny(CELL)) == 0
    out = capsys.readouterr().out
    readings = json.loads(out.strip().splitlines()[-1])["readings"]
    for seed, numbers in readings.items():
        assert numbers["screen_grad_gap"] > limits["screen_grad_gap"], (
            seed, numbers)


def test_the_tf32_control_keeps_the_lpips_gradient(one_thread):
    """control_options' VGG16-in-TF32 wrapper gives the distance and its
    input gradient of the plain call (on the CPU TF32 changes nothing),
    the gradient through its own backward."""
    import control_options
    from reference.plain.losses.lpips import lpips_distance as plain

    p = _plain(_lpips_params())
    outs = []
    for fn in (plain, control_options._vgg_in_tf32(plain)):
        x, y = _patches(1, grad=True), _patches(2)
        d = fn(p, x, y)
        (g,) = torch.autograd.grad((d * torch.tensor([1.0, 3.0])).sum(), x)
        outs.append((d.detach(), g))
    assert outs[0][1].abs().max() > 0
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.card
@pytest.mark.parametrize("kind", ("tf32", "tf32_vgg"))
def test_tf32_fails_the_cell(kind, card, capsys):
    """The reference with TF32 on, whole or in the VGG convolutions
    alone, against itself, at a small size on the card."""
    import control_options
    import run

    limits = run.cell_files(run.ROOT, run.manifest(run.ROOT), CELL)[
        "limits"]
    small = {"config": list(SMALL_CONFIG), "traffic": {}}
    assert control_options.main(["--kind", kind, "--seeds", "1", "2"],
                                device=card, overrides=small) == 0
    out = capsys.readouterr().out
    readings = json.loads(out.strip().splitlines()[-1])["readings"]
    for seed, numbers in readings.items():
        assert any(v > limits[k] for k, v in numbers.items()), (seed,
                                                                numbers)


# ---------------------------------------------------------------------------
# the counts against torch.utils.flop_counter


def _counted(fn) -> dict:
    """torch.utils.flop_counter's operations of fn() by aten operation."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return {str(op): n for op, n in fc.get_flop_counts()["Global"].items()}


def test_the_lpips_count_is_the_flop_counters_convolutions(one_thread):
    """A step's LPIPS at 2 patches of 32x32: the forward of both sides
    and the predicted patches' input gradient (the features constant)."""
    from counts import lpips
    from reference.plain.losses.lpips import lpips_distance

    p = _plain(_lpips_params())
    x, y = _patches(1, n=2, size=32, grad=True), _patches(2, n=2, size=32)

    def step():
        d = lpips_distance(p, x, y).mean()
        torch.autograd.grad(d, x)

    got = _counted(step)
    conv = sum(v for k, v in got.items() if "convolution" in k)
    fwd = sum(v for k, v in got.items()
              if "convolution" in k and "backward" not in k)
    assert fwd == 2 * 2 * sum(lpips.conv_ops(32))
    assert conv == lpips.step_ops(2, 32)


def test_the_window_count_is_the_flop_counters_matmuls(one_thread):
    """The windowed statistic's batched matmuls count 2 * 3 operations a
    distance, N * min(block + window, N) distances."""
    from counts import flops, options
    from reference.plain.ops.knn_window import knn_window_stat

    pts = torch.randn((1024, 3), generator=torch.Generator().manual_seed(8))
    got = _counted(lambda: knn_window_stat(pts, 9, block=128, window=128))
    bmm = sum(v for k, v in got.items() if "bmm" in k)
    assert bmm == 2 * 3 * options.window_distances(1024, 128, 128)
    assert options.window_distances(1024, 128, 128) == 1024 * 256
    assert options.window_distances(300, 256, 256) == 300 * 300
    assert options.window_stat_ops(1024, 128, 128) == (
        flops.KNN_OPS * 1024 * 256)


def test_the_options_step_trades_the_exact_statistic_for_its_own():
    from counts import flops, lpips, options

    s = {"n_live": 200, "n_edges": 3, "geo": {"a": (1, 1)},
         "app": {"b": (1, 2)}, "c": 1, "scales": 1, "joints": 1,
         "patches": 4, "patch": 128, "height": 1, "width": 1, "params": 5,
         "k": 8, "composite_fwd_ops": 7, "composite_bwd_ops": 11,
         "capacity": 512}
    want = (flops.train_step(s) - flops.KNN_OPS * 200 * 200 / 8
            + flops.KNN_OPS * 512 * 512 + lpips.step_ops(4, 128))
    assert options.train_step(s) == pytest.approx(want)
    # VGG16 at a 128x128 patch: 5.01e9 multiply-adds
    assert sum(lpips.conv_ops(128)) == 2 * 5011144704
