"""The forward's window hand-off held against sings_tpu.

The CUDA forward walks the windows of a tile on separate CTAs: window c
starts from the T and colour sums that window c - 1 left in row c of the
window-entry state, and hands its own exit on in row c + 1 (the tile's
last window writes the output instead). The contract that relies on: a
window walked alone from its row of the state gives the next row, or the
tile's output, bit for bit. Here the plain forward (the kernel's plain
version on the CPU) writes the state, and each window of every tile is
walked again from its own row with the plain version's arithmetic
(kernels._walk_windows from the state, as the backward walks); each
exit must equal the next row or the output exactly, a tile's first row
must be (1, 0, 0, 0), and tiles without a window must hold colour 0,
T = 1. The output is also held against the Pallas composite_fwd
(interpret mode) at the JAX package's forward tolerance
(tests/test_rasterizer.py:52), in both layouts.

Scenes (chunk 8): a saturating stack whose pixels saturate in the
first window of a three-window segment; padding sub-tiles (56x40, four
tile columns under an eight-tile panel) and empty tiles, some with no
window and some with one empty window; a deep stack of faint splats
with tiles of >= 40 windows that saturate mid-segment. The tile exit
itself (every pixel of a tile at T < 1e-4 at a window's top) cannot
fire: a pair composites only while T (1 - alpha) >= 1e-4 and T then
takes that value, so every window here is walked, as the checks show.
Then the CUDA wrapper's refusals, and rasterize passing grad_offsets
on every path.
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
from sings_tpu_torch.ops.rasterizer import api as tapi
from sings_tpu_torch.ops.rasterizer import kernels as tk
from test_torch_rasterizer import make_scene

TOL = 2e-5  # tests/test_rasterizer.py:52
CHUNK = 8


def _t(x):
    return torch.tensor(np.array(x))


def _scene(arrays, h, w, max_span):
    """JAX binning, pair features and Pallas forward (interpret mode) of
    numpy splats (means, scales, quats, opacities, rgb) in front of an
    identity camera."""
    jc = jcam(np.eye(4), height=h, width=w, fovx=0.9, fovy=0.9 * h / w)
    gj = jcom.preprocess(*[jnp.asarray(a) for a in arrays], jc, sh_degree=0)
    kw = dict(tile=16, n_tiles_x=-(-w // 16), n_tiles_y=-(-h // 16))
    b = jtiles.bin_gaussians(gj, max_span=max_span, align=CHUNK,
                             main_width=4, **kw)
    feats, _ = japi._gather_feats(b, gj.means2d, gj.conics, gj.colors,
                                  gj.opacities, CHUNK)
    fwd = jpk.composite_fwd(feats, b.tile_offsets, chunk=CHUNK,
                            interpret=True, **kw)
    return b, feats, fwd, dict(kw, chunk=CHUNK)


def _stack(n, xy, scale, opacity, seed):
    rng = np.random.RandomState(seed)
    means = np.tile([[xy[0], xy[1], 3.0]], (n, 1)).astype(np.float32)
    means[:, :2] += (0.005 * rng.randn(n, 2)).astype(np.float32)
    means[:, 2] += np.linspace(0, 0.5, n).astype(np.float32)
    return (means, np.full((n, 3), scale, np.float32),
            np.tile([1.0, 0, 0, 0], (n, 1)).astype(np.float32),
            np.full(n, opacity, np.float32),
            rng.rand(n, 3).astype(np.float32))


def _saturating():
    return _scene(_stack(24, (0.0, 0.0), 0.2, 0.95, 0), 32, 32, 2)


def _padding():
    _, arrays, _, _ = make_scene(n=30, h=40, w=56, seed=7, sh=False)
    means = arrays[0].copy()
    means[:, :2] = np.abs(means[:, :2]) * 0.5  # one corner: empty tiles
    return _scene((means,) + tuple(arrays[1:4]) + (arrays[4],), 40, 56, 3)


def _deep():
    return _scene(_stack(400, (0.05, 0.05), 0.1, 0.05, 3), 32, 32, 2)


SCENES = {"saturating": _saturating, "padding_and_empty": _padding,
          "deep": _deep}


def _windows(b):
    """Per tile: its first window's row in the state and its window
    count (the gradient buffer's regions)."""
    g = np.asarray(b.grad_offsets) // CHUNK
    return g[:-1], np.diff(g)


def _resumed(feats, offsets, grad_offsets, state, kw):
    """Every window of every tile walked alone from its own row of the
    state, with composite_fwd_plain's arithmetic: {c: (walking (T,),
    exit (T, 4, npx) as rows T, r, g, b)}."""
    exits = {}
    for win in tk._walk_windows(feats, offsets, entry=(state, grad_offsets),
                                **kw):
        w = torch.where(win.flag, win.alpha,
                        torch.zeros_like(win.alpha)) * win.t_bef
        acc = win.entry[:, 1:4].clone()
        for i in range(3):
            acc[:, i:i + 1] += torch.sum(w * win.f[5 + i], dim=1,
                                         keepdim=True)
        exits[win.c] = (win.walking, torch.cat([win.t_after, acc], dim=1))
    return exits


@pytest.mark.parametrize("layout", ["tiled", "panel"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_forward_resumes_from_every_window(scene, layout):
    b, feats, fwd_jax, kw = SCENES[scene]()
    lay = {k: kw[k] for k in ("tile", "n_tiles_x", "n_tiles_y")}
    pw = tk.panel_width(16) if layout == "panel" else None
    f, offs, goffs = _t(feats), _t(b.tile_offsets), _t(b.grad_offsets)
    out, state = tk.composite_fwd(f, offs, grad_offsets=goffs,
                                  grad_cap=b.pair_slot_capacity, pw=pw, **kw)
    if pw is not None:
        wp = out.shape[2]
        assert wp > lay["n_tiles_x"] * 16 or scene != "padding_and_empty"
        np.testing.assert_array_equal(out[:3, :, lay["n_tiles_x"] * 16:], 0)
        np.testing.assert_array_equal(out[3, :, lay["n_tiles_x"] * 16:], 1)
        out = tk.planes_to_tiles(out, **lay)
    np.testing.assert_allclose(out.numpy(), np.asarray(fwd_jax), rtol=0,
                               atol=TOL)
    first, count = _windows(b)
    exits = _resumed(f, offs, goffs, state, kw)
    assert set(exits) == set(range(int(count.max())))
    npx = 256
    for t in range(count.shape[0]):
        if count[t] == 0:
            want = torch.zeros(8, npx)
            want[3] = 1.0
            assert torch.equal(out[t], want), t
            continue
        assert torch.equal(state[first[t]], torch.tensor(
            [1.0, 0.0, 0.0, 0.0])[:, None].expand(4, npx)), t
        for c in range(count[t]):
            walking, ex = exits[c]
            assert bool(walking[t]), (t, c)  # the tile exit never fires
            nxt = (state[first[t] + c + 1] if c + 1 < count[t]
                   else out[t, [3, 0, 1, 2]])
            assert torch.equal(ex[t], nxt), (t, c)
        assert not out[t, 4:].any()
    if scene == "saturating":
        t = int(np.argmax(count))
        assert count[t] >= 3 and float(state[first[t] + 1, 0].min()) < 2e-4
    if scene == "padding_and_empty":
        offsets = np.asarray(b.tile_offsets)
        empty = offsets[1:] == offsets[:-1]
        assert (count[empty] == 0).any() and (count[empty] == 1).any()
    if scene == "deep":
        t = int(np.argmax(count))
        tops = state[first[t]:first[t] + count[t], 0].amin(dim=1)
        sat = int(np.argmax(tops.numpy() < 2e-4))
        assert count[t] >= 40 and 0 < sat < count[t] - 1, (count[t], sat)
    assert tk.LAUNCHES["composite_fwd"] == tk.LAUNCHES[
        "composite_fwd_panel"] == 0


@pytest.mark.parametrize("layout", ["tiled", "panel"])
def test_cuda_wrapper_refuses_cpu_and_a_missing_grad_offsets(layout):
    b, feats, _, kw = _saturating()
    kw = dict(kw, pw=tk.panel_width(16) if layout == "panel" else None)
    f, offs = _t(feats), _t(b.tile_offsets)
    tk.reset_launches()
    with pytest.raises(ValueError, match="grad_offsets"):
        tk.composite_fwd_cuda(f, offs, **kw)
    with pytest.raises(ValueError, match="grad_offsets"):
        tk.composite_fwd_cuda(f, offs, grad_offsets=_t(b.grad_offsets), **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        tk.composite_fwd_cuda(f, offs, grad_offsets=_t(b.grad_offsets),
                              grad_cap=b.pair_slot_capacity,
                              return_state=False, **kw)
    assert set(tk.LAUNCHES.values()) == set(tk.STATE_WRITES.values()) == {0}
    # the plain version needs no grad_offsets, and keeps the state only
    # when asked
    out = tk.composite_fwd(f, offs, grad_offsets=_t(b.grad_offsets),
                           grad_cap=b.pair_slot_capacity, return_state=False,
                           **kw)
    assert torch.equal(out, tk.composite_fwd(f, offs, **kw))


def test_rasterize_passes_grad_offsets_on_every_path(monkeypatch):
    """The animation's render under no_grad, a render of inputs without
    grad and the training step's render all give the forward
    grad_offsets and grad_cap; only the last keeps the state."""
    calls = []

    def fwd(*a, **k):
        calls.append((k.get("grad_offsets") is not None,
                      k.get("grad_cap") is not None, k["return_state"]))
        return tk.composite_fwd(*a, **k)

    monkeypatch.setattr(tapi, "composite_fwd", fwd)
    (_, tc), arrays, bg, alive = make_scene(n=30, h=32, w=32, seed=1)
    ta = [torch.tensor(np.array(a), requires_grad=True) for a in arrays]
    kw = dict(sh_degree=3, bg=torch.tensor(bg), alive=torch.tensor(alive),
              chunk=CHUNK)
    with torch.no_grad():
        tapi.rasterize(*ta, tc, **kw)
        tapi.rasterize(*ta, tc, **dict(kw, layout="panel"))
    tapi.rasterize(*[a.detach() for a in ta], tc, **kw)
    tapi.rasterize(*ta, tc, **kw)
    assert calls == [(True, True, False)] * 3 + [(True, True, True)]
