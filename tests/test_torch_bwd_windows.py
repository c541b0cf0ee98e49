"""The window-entry state and the window-parallel backward held against
sings_tpu.

composite_fwd(grad_offsets=, grad_cap=) also returns each pixel's T and
colour sums at the top of every window of every tile. The JAX package
gives the same numbers: for window c, zero the opacity of every pair at
or after window c of its tile (those pairs are then skipped and change
neither T nor the colour), and the Pallas composite_fwd (interpret mode)
returns each tile's state at window c as its T_final and colour; held at
the JAX package's forward tolerance (tests/test_rasterizer.py:52), in
both layouts. Scenes with tiles of 3 and 10 windows (chunk 8).

The backward starts every window from that state, so its windows are
independent: a state whose later windows are zeroed (what a tile exit
leaves) makes the plain backward and every form skip exactly those
windows and leaves the others bit for bit. On these scenes the exit
itself never fires: a pair composites only while T (1 - alpha) >= 1e-4
and T then takes that value, so T never falls below 1e-4 at a window's
top; the check below shows it. The plain backward and the forms from the
state against the Pallas backward are tests/test_torch_rasterizer_bwd.py
and tests/test_torch_bwd_variants.py (scenes with up to 12 windows in a
tile). Then the wrappers' refusal of CPU tensors, and rasterize asking
for the state only when a backward can follow.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.ops.rasterizer import pallas_kernels as jpk
from sings_tpu_torch.ops.rasterizer import api as tapi
from sings_tpu_torch.ops.rasterizer import kernels as tk
from sings_tpu_torch.ops.rasterizer import variants as tv
from test_torch_bwd_variants import _saturating
from test_torch_rasterizer import make_scene
from test_torch_rasterizer_bwd import _bwd_inputs

TOL = 2e-5  # tests/test_rasterizer.py:52
CHUNK = 8
SCENES = {"span5": _bwd_inputs, "saturating": _saturating}


def _t(x):
    return torch.tensor(np.array(x))


def _windows(b):
    """Per tile: its first window's index in the state and its window
    count (the gradient buffer's regions)."""
    g = np.asarray(b.grad_offsets) // CHUNK
    return g[:-1], np.diff(g)


def _pair_window(b, n_cols):
    """The window of each sorted pair within its tile's walk (-1 for
    columns outside every segment)."""
    offs = np.asarray(b.tile_offsets)
    win = np.full(n_cols, -1)
    for t in range(offs.shape[0] - 1):
        base = offs[t] // CHUNK * CHUNK
        idx = np.arange(offs[t], offs[t + 1])
        win[idx] = (idx - base) // CHUNK
    return win


@pytest.mark.parametrize("pw", [None, "panel"], ids=["tiled", "panel"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_state_matches_jax_per_window(scene, pw):
    b, feats, _, _, kw = SCENES[scene]()
    cap = b.pair_slot_capacity
    fkw = dict(kw, chunk=CHUNK, pw=tk.panel_width(16) if pw else None)
    out, state = tk.composite_fwd(_t(feats), _t(b.tile_offsets),
                                  grad_offsets=_t(b.grad_offsets),
                                  grad_cap=cap, **fkw)
    assert state.shape == (cap // CHUNK, 4, 256)
    first, count = _windows(b)
    assert count.max() >= 3
    pair_win = _pair_window(b, feats.shape[1])
    state = state.numpy()
    written = np.zeros(state.shape[0], bool)
    for c in range(int(count.max())):
        cut = feats.at[8].set(jnp.where(jnp.asarray(pair_win >= c), 0.0,
                                        feats[8]))
        fwd_c = np.asarray(jpk.composite_fwd(cut, b.tile_offsets,
                                             chunk=CHUNK, interpret=True,
                                             **kw))
        tiles = np.nonzero(count > c)[0]
        got = state[first[tiles] + c]                    # (n, 4, npx)
        want = fwd_c[tiles][:, [3, 0, 1, 2]]
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL,
                                   err_msg=f"window {c}")
        # the exit never fires: T >= 1e-4 at every window's top
        assert (got[:, 0].max(axis=1) >= 1e-4).all()
        written[first[tiles] + c] = True
    np.testing.assert_array_equal(state[~written], 0.0)
    assert tk.LAUNCHES["composite_fwd"] == tk.LAUNCHES[
        "composite_fwd_panel"] == 0


def _bwd_args(scene):
    b, feats, fwd, gout, kw = SCENES[scene]()
    cap = b.pair_slot_capacity
    args = [_t(feats), _t(b.tile_offsets), _t(b.grad_offsets)]
    _, state = tk.composite_fwd_plain(args[0], args[1],
                                      grad_offsets=args[2], grad_cap=cap,
                                      chunk=CHUNK, **kw)
    return b, args + [_t(fwd), _t(gout), state], dict(kw, chunk=CHUNK,
                                                       grad_cap=cap)


BACKWARDS = {"composite_bwd": tk.composite_bwd,
             "moments": tv.composite_bwd_moments,
             **{v: (lambda *a, v=v, **k: tv.composite_bwd_variant(
                 *a, variant=v, **k)) for v in tv.VARIANTS}}


@pytest.mark.parametrize("form", list(BACKWARDS))
@pytest.mark.parametrize("scene", list(SCENES))
def test_backward_windows_are_independent(scene, form):
    """Zero the state of every tile's windows from its second on (what a
    tile exit after the first window would leave) and poison the rows
    of no tile: the zeroed windows' slots stay zero and every other slot
    keeps its value bit for bit."""
    b, args, kw = _bwd_args(scene)
    fn = BACKWARDS[form]
    full = fn(*args, **kw)
    first, count = _windows(b)
    cut = args[5].clone()
    dropped = np.zeros(kw["grad_cap"], bool)
    for t in np.nonzero(count > 1)[0]:
        cut[first[t] + 1:first[t] + count[t]] = 0.0
        dropped[(first[t] + 1) * CHUNK:(first[t] + count[t]) * CHUNK] = True
    assert dropped.any()
    cut[int(args[2][-1]) // CHUNK:] = float("nan")  # rows of no tile
    part = fn(*args[:5], cut, **kw)
    assert torch.equal(part[:, dropped], torch.zeros_like(part[:, dropped]))
    assert torch.equal(part[:, ~dropped], full[:, ~dropped])
    assert float(full[:, dropped].abs().max()) > 0.0


def test_cuda_wrappers_refuse_cpu_tensors():
    b, args, kw = _bwd_args("saturating")
    fkw = {k: v for k, v in kw.items() if k != "grad_cap"}
    tk.reset_launches()
    tv.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        tk.composite_fwd_cuda(args[0], args[1], grad_offsets=args[2],
                              grad_cap=kw["grad_cap"], **fkw)
    with pytest.raises(ValueError, match="CUDA"):
        tk.composite_bwd_cuda(*args, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        tv.composite_bwd_moments_cuda(*args, **kw)
    for v in tv.VARIANTS:
        with pytest.raises(ValueError, match="CUDA"):
            tv.composite_bwd_variant_cuda(*args, variant=v, **kw)
    assert set(tk.LAUNCHES.values()) == set(tk.STATE_WRITES.values()) == {0}
    assert set(tv.LAUNCHES.values()) == {0}


def test_rasterize_asks_for_the_state_only_before_a_backward(monkeypatch):
    """The composite's forward writes the state when grad mode is on and
    an input requires grad (the training step), not under no_grad (the
    animation, validation renders) or for inputs without grad. (The
    kernel's windows hand on their entry state on every call, so every
    call passes grad_offsets: tests/test_torch_fwd_windows.py.)"""
    calls = []

    def fwd(*a, **k):
        calls.append(k.get("grad_offsets") is not None
                     and k.get("return_state", True))
        return tk.composite_fwd(*a, **k)

    monkeypatch.setattr(tapi, "composite_fwd", fwd)
    (_, tc), arrays, bg, alive = make_scene(n=30, h=32, w=32, seed=1)
    ta = [torch.tensor(np.array(a), requires_grad=True) for a in arrays]
    kw = dict(sh_degree=3, bg=torch.tensor(bg), alive=torch.tensor(alive),
              chunk=CHUNK)
    with torch.no_grad():
        tapi.rasterize(*ta, tc, **kw)
    tapi.rasterize(*[a.detach() for a in ta], tc, **kw)
    out = tapi.rasterize(*ta, tc, **dict(kw, layout="panel"))
    assert calls == [False, False, True]
    out["render"].sum().backward()
    assert all(a.grad is not None and bool(torch.isfinite(a.grad).all())
               for a in ta)
