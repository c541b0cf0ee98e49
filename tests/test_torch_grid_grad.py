"""The port's sampling and triplane gradients held against jax.grad of
the JAX package's functions (its custom backwards) on the same numpy
inputs, at the tolerance of tests/test_triplane_nested.py: rtol 5e-5,
atol 3e-5 * max|g|. On the CPU the grid gradients run
ops/grid_grad.py's plain version (the CUDA kernel's arithmetic); the
plain segmented reduction is also held against a dense numpy sum."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.fields import triplane as jtri
from sings_tpu.ops import sampling as jsmp
from sings_tpu_torch.fields import triplane as ttri
from sings_tpu_torch.ops import grid_grad as GG
from sings_tpu_torch.ops import sampling as tsmp

# make()'s points of tests/test_triplane_nested.py: exact boundaries and
# out-of-range points (the border clip's ties)
EDGE_PTS = np.array([[0, 0, 0], [1, 1, 1], [-1, -1, -1], [0.5, 0.5, 0.5],
                     [1.3, 0, 0], [0, -1.3, 0], [0.25, -0.75, 0.125],
                     [0.999, 0.999, -0.999]], np.float32)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch ops: one thread each in the parallel suite."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), want, rtol=5e-5,
                               atol=3e-5 * scale, err_msg=what)


def _loss_j(f):
    return jnp.sum(jnp.sin(3.0 * f) * f)


def _loss_t(f):
    return torch.sum(torch.sin(3.0 * f) * f)


def _points(n, seed, skew=False):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    if skew:
        # all but a few queries in one cell (the avatar's dead slots at
        # xyz = 0), so most cells are empty
        pts[: n - 5] = 0.0
    elif n >= len(EDGE_PTS):
        pts[:len(EDGE_PTS)] = EDGE_PTS
    return pts


@functools.lru_cache(maxsize=None)
def _jax_grad(cfg_j, fused):
    """One jitted gradient per configuration: cases of equal shapes
    share its compile."""
    def loss(params, pts):
        return _loss_j(jtri.triplane_features(params, pts, cfg_j,
                                              fused=fused))

    return jax.jit(jax.grad(loss, argnums=(0, 1)))


def _triplane_grads(cfg_kw, pts, seed=0, fused=True):
    cfg_j = jtri.TriplaneConfig(**cfg_kw)
    cfg_t = ttri.TriplaneConfig(**cfg_kw)
    params = jtri.init_triplane(jax.random.PRNGKey(seed), cfg_j)
    g_params, g_pts = _jax_grad(cfg_j, fused)(params, jnp.asarray(pts))
    tp = jax.tree.map(lambda x: torch.tensor(np.array(x),
                                             requires_grad=True), params)
    tpts = torch.tensor(pts, requires_grad=True)
    feats = ttri.triplane_features(tp, tpts, cfg_t, fused=fused)
    assert feats.shape == (len(pts), cfg_t.feat_dim)
    _loss_t(feats).backward()
    got = [p.grad.numpy() for s in tp["grids"] for p in s]
    want = [np.asarray(p) for s in g_params["grids"] for p in s]
    return got, want, tpts.grad.numpy(), np.asarray(g_pts)


@pytest.mark.parametrize("hw", [(9, 13), (2, 2), (1, 7), (6, 1)])
def test_grid_sample_grads(hw):
    rng = np.random.RandomState(4)
    grid = rng.rand(5, *hw).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (300, 2)).astype(np.float32)
    coords[:6] = [[-1, -1], [1, 1], [1, -1], [-1, 1], [0, 1], [-1, 0.5]]
    want = jax.jit(jax.grad(lambda g, c: _loss_j(jsmp.grid_sample_2d(g, c)),
                            argnums=(0, 1)))(jnp.asarray(grid),
                                             jnp.asarray(coords))
    tg = torch.tensor(grid, requires_grad=True)
    tc = torch.tensor(coords, requires_grad=True)
    _loss_t(tsmp.grid_sample_2d(tg, tc)).backward()
    _close(tg.grad.numpy(), want[0], "grid")
    _close(tc.grad.numpy(), want[1], "coords")


N_PTS = 400


def _cfg(nested, multires=(1, 2, 4), res=4):
    return dict(resolution=(res, res, res), out_dim=8, multires=multires,
                nested=nested)


@pytest.mark.parametrize("nested,multires,res,fused", [
    (True, (1, 2), 4, True),
    (True, (1, 2, 4), 4, True),
    (True, (1, 2, 4, 8), 2, True),
    (False, (1, 2, 4), 4, True),        # the combined-key fused path
    (True, (1, 2), 4, False),           # fused=False: per-plane samples
], ids=["nested12", "nested124", "nested1248", "fused", "unfused"])
def test_triplane_grads(nested, multires, res, fused):
    got, want, gp, wp = _triplane_grads(
        _cfg(nested, multires, res), _points(N_PTS, 1), fused=fused)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, f"plane {i}")
    _close(gp, wp, "pts")


def _bound_points(n):
    """Every point on a bound or outside on at least one axis: make()'s
    eight, then each coordinate drawn from {-1.3, -1, 0, 0.5, 1, 1.3}."""
    rng = np.random.RandomState(5)
    pts = rng.choice(np.array([-1.3, -1, 0, 0.5, 1, 1.3], np.float32),
                     (n, 3))
    pts[:len(EDGE_PTS)] = EDGE_PTS
    return pts


@pytest.mark.parametrize("nested,fused", [(True, True), (False, True),
                                          (True, False)])
def test_clip_tie_gradient_at_bounds(nested, fused):
    """d/dpts at points exactly on the bounds: jnp.clip passes half the
    cotangent there (torch.clamp all of it: 0.77-1.09 apart before)."""
    for x, lo, hi in [(0.0, 0.0, 3.0), (3.0, 0.0, 3.0), (0.0, 0.0, 0.0),
                      (-1.0, 0.0, 3.0), (1.0, 0.0, 3.0), (4.0, 0.0, 3.0)]:
        want = float(jax.grad(lambda v: jnp.clip(v, lo, hi))(x))
        t = torch.tensor(x, requires_grad=True)
        tsmp._Clip.apply(t, lo, hi).backward()
        assert float(t.grad) == want, (x, lo, hi)
    multires = (1, 2) if not fused else (1, 2, 4)
    got, want, gp, wp = _triplane_grads(
        _cfg(nested, multires), _bound_points(N_PTS), fused=fused)
    _close(gp, wp, "pts")
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("nested,n", [(True, N_PTS), (False, N_PTS),
                                      (True, 1)])
def test_skewed_and_single_query(nested, n):
    """All but five queries in one cell (most cells empty), or one
    query: the long segment splits over blocks of sorted rows, and an
    empty cell's corners read zero."""
    got, want, gp, wp = _triplane_grads(
        _cfg(nested), _points(n, 2, skew=n > 1))
    for a, b in zip(got, want):
        _close(a, b)
    _close(gp, wp, "pts")


def _dense_grads(skeys, orders, tx, ty, gout, layout):
    """numpy float64: every sorted row's four corner products added at
    the four grid points they belong to."""
    p_, n, c = gout.shape
    outs = [np.zeros((c, h, w)) for h, w in layout.planes]
    for gi, plane0, shift2, morton, cx, _ in GG.problems(layout):
        for key, j in zip(skeys[gi].numpy(), orders[gi].numpy()):
            p = plane0 + j // n
            q = j % n
            seg = int(key) >> shift2
            if morton:
                x = y = 0
                for bit in range(16):
                    x |= ((seg >> (2 * bit)) & 1) << bit
                    y |= ((seg >> (2 * bit + 1)) & 1) << bit
            else:
                base = sum((h - 1) * (w - 1) for h, w in
                           layout.planes[plane0:p])
                y, x = divmod(seg - base, layout.planes[p][1] - 1)
            t_x, t_y = float(tx[p, q]), float(ty[p, q])
            g = gout[p, q].numpy().astype(np.float64)
            for (dy, dx), wk in zip(
                    [(0, 0), (0, 1), (1, 0), (1, 1)],
                    [(1 - t_x) * (1 - t_y), t_x * (1 - t_y),
                     (1 - t_x) * t_y, t_x * t_y]):
                outs[p][:, y + dy, x + dx] += wk * g
    return outs


def test_plain_reduction_against_dense_sum():
    rng = np.random.RandomState(3)
    n, c = 200, 3
    # planes 0-1: a cells group; planes 2-4: a morton tower (cells 2,
    # 4, 8 square) at shifts 2, 1, 0
    layout = GG.Layout(planes=((5, 4), (3, 6), (3, 3), (5, 5), (9, 9)),
                       groups=(GG.Group("cells", (0, 1)),
                               GG.Group("morton", (2, 3, 4), (2, 1, 0))))
    cells = [torch.tensor(rng.randint(0, 12, n)),
             torch.tensor(rng.randint(0, 10, n))]
    cells[0][:150] = 5                         # one long segment
    keys = [torch.cat([cells[0], cells[1] + 12]).to(torch.int32)]
    x0 = torch.tensor(rng.randint(0, 8, n))
    y0 = torch.tensor(rng.randint(0, 8, n))
    keys.append(GG.morton_codes(x0, y0))
    tx = torch.tensor(rng.rand(5, n).astype(np.float32))
    ty = torch.tensor(rng.rand(5, n).astype(np.float32))
    gout = torch.tensor(rng.randn(5, n, c).astype(np.float32))
    skeys, orders = GG.sort_keys(keys)
    before = GG.LAUNCHES["grid_grad"]
    got = GG.grid_grad(skeys, orders, tx, ty, gout, layout)
    assert GG.LAUNCHES["grid_grad"] == before    # CPU: the plain version
    want = _dense_grads(skeys, orders, tx, ty, gout, layout)
    for p, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6,
                                   err_msg=f"plane {p}")
    # the morton decode at each shift is the fine cell shifted
    for p, s in zip((2, 3, 4), (2, 1, 0)):
        seg = skeys[1].long() >> (2 * s)
        cx = layout.planes[p][1] - 1
        j = orders[1]
        assert torch.equal(GG._decode(seg, 1, cx),
                           (y0[j] >> s) * cx + (x0[j] >> s))
    # the CUDA wrapper refuses CPU tensors
    with pytest.raises(ValueError, match="CUDA"):
        GG.grid_grad_cuda(skeys, orders, tx, ty, gout, layout)


def _graph_nodes(t):
    seen, stack = [], [t.grad_fn]
    while stack:
        n = stack.pop()
        if n is None or n in seen:
            continue
        seen.append(n)
        stack.extend(f for f, _ in n.next_functions)
    return seen


@pytest.mark.parametrize("nested,fused,node", [
    (True, True, "_TriplaneNestedBackward"),
    (False, True, "_TriplaneFusedBackward"),
    (True, False, "_SampleGridBackward"),
])
def test_no_autograd_scatter_of_the_corner_gathers(nested, fused, node):
    """The field's backward is its Function's, never autograd's scatter
    of the corner gathers (IndexBackward: indexing_backward_kernel on
    the card). The per-plane path's only gathers are of the points'
    two coordinate columns."""
    cfg = ttri.TriplaneConfig(**_cfg(nested))
    field = ttri.init_triplane(torch.Generator().manual_seed(0), cfg)
    for planes in field["grids"]:
        for p in planes:
            p.requires_grad_(True)
    pts = torch.tensor(_points(50, 3), requires_grad=True)
    nodes = _graph_nodes(ttri.triplane_features(field, pts, cfg,
                                                fused=fused))
    assert node in [n.name() for n in nodes]
    gathered = [tuple(n._saved_self_sym_sizes) for n in nodes
                if "Index" in n.name()]
    assert all(size == tuple(pts.shape) for size in gathered), gathered
