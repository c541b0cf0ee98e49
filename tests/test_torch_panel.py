"""The port's panel layout (tpu.raster.layout=panel) held against
sings_tpu.

composite_fwd_plain / composite_bwd_plain with pw (the panel planes)
against the Pallas composite_fwd_panel / composite_bwd_panel (interpret
mode) on the
same feats, offsets, forward planes and cotangents: a square scene, the
56x40 scene whose last panel has padding columns (ntx 4 < pw 8), tiles
8 (pw 16) and 32 (pw 4), and a saturating stack that ends the walks
early. The forward at TOL, the backward at every slot the un-sort glue
reads at the rasterizer's gradient tolerance; the panel plain versions
against the tiled ones, bit for bit. test_torch_panel_edges.py holds
the tile-8 and saturating cases, test_torch_panel_grads.py
rasterize(layout="panel"). On the CPU the port runs the plain versions;
chip_smoke.py holds the CUDA kernels against them on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.ops.graphics import make_camera as jcam
from sings_tpu.ops.rasterizer import api as japi
from sings_tpu.ops.rasterizer import common as jcom
from sings_tpu.ops.rasterizer import pallas_kernels as jpk
from sings_tpu.ops.rasterizer import tiles as jtiles
from sings_tpu_torch.ops.graphics import make_camera as tcam
from sings_tpu_torch.ops.rasterizer import api as tapi
from sings_tpu_torch.ops.rasterizer import kernels as tk
from test_torch_rasterizer import make_scene

TOL = 2e-5  # tests/test_rasterizer.py:52


def _t(x):
    return torch.tensor(np.array(x))


def _stack_scene(n=64):
    """tests/test_rasterizer.py:423: opaque gaussians stacked on one
    spot, so every pixel saturates and the walks stop early."""
    means = np.tile([[0.0, 0.0, 3.0]], (n, 1)).astype(np.float32)
    means[:, 2] += np.linspace(0, 0.5, n).astype(np.float32)
    arrays = (means, np.full((n, 3), 0.2, np.float32),
              np.tile([1.0, 0, 0, 0], (n, 1)).astype(np.float32),
              np.full(n, 0.95, np.float32),
              np.random.RandomState(0).rand(n, 3).astype(np.float32))
    cams = (jcam(np.eye(4), height=32, width=32, fovx=0.9, fovy=0.9),
            tcam(np.eye(4), height=32, width=32, fovx=0.9, fovy=0.9))
    return cams, arrays, np.ones(3, np.float32), np.ones(n, bool)


CASES = {
    "square": dict(scene=dict(n=60, h=48, w=48), tile=16),
    "56x40_padding": dict(scene=dict(n=60, h=40, w=56, seed=1), tile=16),
    "tile8": dict(scene=dict(n=60, h=48, w=48, seed=2), tile=8),
    "tile32": dict(scene=dict(n=60, h=48, w=48, seed=3), tile=32),
    "saturating": dict(scene=None, tile=16),
}


def _panel_inputs(case):
    c = CASES[case]
    tile = c["tile"]
    if c["scene"] is None:
        (jc, _), arrays, _, alive = _stack_scene()
        deg = 0
    else:
        (jc, _), arrays, _, alive = make_scene(**c["scene"])
        deg = 3
    gj = jcom.preprocess(*[jnp.asarray(a) for a in arrays], jc,
                         sh_degree=deg, alive=jnp.asarray(alive), tile=tile)
    ntx, nty = -(-jc.width // tile), -(-jc.height // tile)
    kw = dict(tile=tile, n_tiles_x=ntx, n_tiles_y=nty)
    b = jtiles.bin_gaussians(gj, max_span=8, align=8, main_width=4, **kw)
    feats, _ = japi._gather_feats(b, gj.means2d, gj.conics, gj.colors,
                                  gj.opacities, 8)
    return b, feats, dict(kw, chunk=8, pw=tk.panel_width(tile))


def check_against_pallas(case):
    b, feats, kw = _panel_inputs(case)
    want = np.asarray(jpk.composite_fwd_panel(feats, b.tile_offsets,
                                              interpret=True, **kw))
    got = tk.composite_fwd(_t(feats), _t(b.tile_offsets), **kw)
    assert got.shape == want.shape == (4,) + tk.panel_shape(
        tile=kw["tile"], n_tiles_x=kw["n_tiles_x"],
        n_tiles_y=kw["n_tiles_y"], pw=kw["pw"])
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    ntx, tile = kw["n_tiles_x"], kw["tile"]
    if want.shape[2] > ntx * tile:  # padding sub-tiles: colour 0, T = 1
        np.testing.assert_array_equal(got[:3, :, ntx * tile:].numpy(), 0.0)
        np.testing.assert_array_equal(got[3, :, ntx * tile:].numpy(), 1.0)
    if case == "saturating":
        assert float(got[3].min()) < 1e-3

    rng = np.random.RandomState(5)
    gout = rng.randn(*want.shape).astype(np.float32)
    cap = b.pair_slot_capacity
    bwd_kw = {k: v for k, v in kw.items()}
    gw = np.asarray(jpk.composite_bwd_panel(
        feats, b.tile_offsets, b.grad_offsets, jnp.asarray(want),
        jnp.asarray(gout), grad_cap=cap, interpret=True, **bwd_kw))
    gt = tk.composite_bwd(_t(feats), _t(b.tile_offsets), _t(b.grad_offsets),
                          _t(want), _t(gout), grad_cap=cap, **bwd_kw).numpy()
    assert gt.shape == (9, cap)
    slots = np.unique(np.concatenate([np.asarray(b.main_slot).ravel(),
                                      np.asarray(b.tail_slot).ravel()]))
    for r in range(9):
        scale = max(1e-3, float(np.abs(gw[r, slots]).max()))
        np.testing.assert_allclose(gt[r, slots], gw[r, slots],
                                   atol=2e-4 * scale, rtol=2e-3,
                                   err_msg=f"row {r}")
    np.testing.assert_array_equal(gt[:, cap - 8:], 0.0)  # spare window
    assert tk.LAUNCHES["composite_fwd_panel"] == 0
    assert tk.LAUNCHES["composite_bwd_panel"] == 0


# tile 8 and the saturating stack run in test_torch_panel_edges.py, so
# that each file stays within a minute of interpret-mode compiles
@pytest.mark.parametrize("case", ["square", "56x40_padding", "tile32"])
def test_panel_plain_versions_match_pallas_interpret(case):
    check_against_pallas(case)


@pytest.mark.parametrize("case", ["square", "56x40_padding", "tile32"])
def test_panel_plain_equals_tiled_plain(case):
    """The panel plain versions are the tiled ones relaid out: the
    forward planes bit for bit, the backward on relaid cotangents too."""
    b, feats, kw = _panel_inputs(case)
    f, o = _t(feats), _t(b.tile_offsets)
    tkw = {k: kw[k] for k in ("tile", "chunk", "n_tiles_x", "n_tiles_y")}
    tiled = tk.composite_fwd_plain(f, o, **tkw)
    panel = tk.composite_fwd_plain(f, o, **kw)
    lay = {k: kw[k] for k in ("tile", "n_tiles_x", "n_tiles_y")}
    assert torch.equal(panel, tk.tiles_to_planes(tiled, pw=kw["pw"], **lay))
    assert torch.equal(tk.planes_to_tiles(panel, **lay)[:, :4], tiled[:, :4])
    gout = torch.randn(panel.shape, generator=torch.Generator().manual_seed(0))
    cap = b.pair_slot_capacity
    g_panel = tk.composite_bwd_plain(
        f, o, _t(b.grad_offsets), panel, gout, grad_cap=cap, **kw)
    g_tiled = tk.composite_bwd_plain(
        f, o, _t(b.grad_offsets), tiled, tk.planes_to_tiles(gout, **lay),
        grad_cap=cap, **tkw)
    assert torch.equal(g_panel, g_tiled)


def test_unknown_layout_and_cuda_wrappers_refuse():
    (jc, tc), arrays, bg, alive = make_scene(n=10)
    ta = [torch.tensor(np.array(a)) for a in arrays]
    with pytest.raises(NotImplementedError, match="layout"):
        tapi.rasterize(*ta, tc, sh_degree=3, chunk=8, layout="strips")
    b, feats, kw = _panel_inputs("square")
    f, o = _t(feats), _t(b.tile_offsets)
    with pytest.raises(ValueError, match="CUDA"):
        tk.composite_fwd_cuda(f, o, **kw)
    planes = tk.composite_fwd(f, o, **kw)
    assert planes.shape == tk.out_shape(**{k: v for k, v in kw.items()
                                           if k != "chunk"})
    with pytest.raises(ValueError, match="CUDA"):
        tk.composite_bwd_cuda(f, o, _t(b.grad_offsets), planes, planes,
                              grad_cap=b.pair_slot_capacity, **kw)
    assert tk.LAUNCHES["composite_fwd_panel"] == 0
