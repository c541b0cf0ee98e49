"""The port's sampling and triplane gradients held against the JAX
package's custom backwards (_triplane_nested_bwd, _triplane_fused_bwd,
_sample_bwd, called directly and through jax.grad) on the same numpy
inputs, at the tolerance of tests/test_triplane_nested.py: rtol 5e-5,
atol 3e-5 * max|g|. On the CPU the backward runs ops/grid_grad.py's
plain version (the CUDA kernel's arithmetic, triplane_bwd_plain); the
plain segmented reduction is also held against a dense numpy sum, and
the forwards' saved sets hold no corner rows."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.fields import triplane as jtri
from sings_tpu.ops import sampling as jsmp
from sings_tpu_torch.fields import triplane as ttri
from sings_tpu_torch.ops import clip as tclip
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
        tclip.clip(t, lo, hi).backward()
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
    got = GG.grid_grad_plain(skeys, orders, tx, ty, gout, layout)
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


# ---------------------------------------------------------------------------
# triplane_backward against JAX's custom backwards, called directly

def _backward_case(points, n=N_PTS, seed=7):
    """Normalized query points and a cotangent whose dead rows (the
    avatar's slots at xyz = 0) are exactly zero."""
    rng = np.random.RandomState(seed)
    if points == "edge":
        q = _points(n, seed)
    elif points == "bounds":
        q = _bound_points(n)
    else:                               # "dead": a fifth at 0, zero rows
        q = _points(n, seed)
        q[::5] = 0.0
    return q, rng


@pytest.mark.parametrize("points", ["edge", "bounds", "dead"])
@pytest.mark.parametrize("kind", ["nested", "fused"])
def test_triplane_backward_against_jax_bwd(kind, points):
    """GG.triplane_backward (plain, the CPU) against _triplane_nested_bwd
    / _triplane_fused_bwd on the same residuals and cotangent: every
    plane's gradient and dq."""
    cfg_j = jtri.TriplaneConfig(**_cfg(kind == "nested"))
    params = jtri.init_triplane(jax.random.PRNGKey(3), cfg_j)
    q, rng = _backward_case(points)
    flat = [np.asarray(p) for s in params["grids"] for p in s]
    meta = tuple((a, b, p.shape[1], p.shape[2]) for s in params["grids"]
                 for p, (a, b) in zip(s, jtri.COO_COMBS))
    gout = rng.randn(len(q), cfg_j.feat_dim).astype(np.float32)
    if points == "dead":
        gout[::5] = 0.0
    fwd, bwd = ((jtri._triplane_nested_fwd, jtri._triplane_nested_bwd)
                if kind == "nested" else
                (jtri._triplane_fused_fwd, jtri._triplane_fused_bwd))
    _, res = fwd(meta, tuple(jnp.asarray(p) for p in flat), jnp.asarray(q))
    want_grids, want_dq = bwd(meta, res, jnp.asarray(gout))
    forward = ttri.nested_forward if kind == "nested" else ttri.fused_forward
    tgrids = [torch.tensor(p) for p in flat]
    _, saved = forward(meta, torch.tensor(q), tgrids)
    dq, dgrids = GG.triplane_backward(meta, torch.tensor(q), tgrids, saved,
                                      torch.tensor(gout))
    for i, (a, b) in enumerate(zip(dgrids, want_grids)):
        _close(a.numpy(), b, f"plane {i}")
    _close(dq.numpy(), want_dq, "dq")
    if points == "dead":
        assert not dq[::5].any()


@pytest.mark.parametrize("points", ["edge", "bounds", "dead"])
def test_sample_backward_against_jax_bwd(points):
    """One plane without the product rule (grid_sample_2d's backward)
    against _sample_bwd."""
    rng = np.random.RandomState(8)
    grid = rng.rand(5, 9, 13).astype(np.float32)
    q, _ = _backward_case(points)
    coords = np.ascontiguousarray(q[:, :2])
    gout = rng.randn(len(coords), 5).astype(np.float32)
    if points == "dead":
        gout[::5] = 0.0
    _, res = jsmp._sample_fwd(jnp.asarray(grid), jnp.asarray(coords))
    want_grid, want_dc = jsmp._sample_bwd(res, jnp.asarray(gout))
    tc = torch.tensor(coords)
    _, _, cell, _, _ = tsmp._sample_main(torch.tensor(grid), tc)
    layout = GG.Layout(planes=((9, 13),), groups=(GG.Group("cells", (0,)),))
    dc, (dg,) = GG.triplane_backward(
        ((0, 1, 9, 13),), tc, [torch.tensor(grid)],
        GG.Saved([], [cell.to(torch.int32)], layout), torch.tensor(gout),
        product=False)
    _close(dg.numpy(), want_grid, "grid")
    _close(dc.numpy(), want_dc, "coords")


@pytest.mark.parametrize("nested,fused", [(True, True), (False, True),
                                          (True, False)])
def test_dead_rows_zero_cotangent(nested, fused):
    """Through triplane_features: a fifth of the points at xyz = 0 whose
    features get an exactly zero cotangent (the avatar's dead slots),
    against jax.grad of the same masked loss."""
    cfg_kw = _cfg(nested)
    cfg_j = jtri.TriplaneConfig(**cfg_kw)
    cfg_t = ttri.TriplaneConfig(**cfg_kw)
    pts = _points(N_PTS, 9)
    pts[::5] = 0.0
    live = np.ones((N_PTS, 1), np.float32)
    live[::5] = 0.0
    params = jtri.init_triplane(jax.random.PRNGKey(4), cfg_j)

    def loss_j(p, x):
        return _loss_j(jtri.triplane_features(p, x, cfg_j, fused=fused)
                       * live)

    g_params, g_pts = jax.grad(loss_j, argnums=(0, 1))(params,
                                                       jnp.asarray(pts))
    tp = jax.tree.map(lambda x: torch.tensor(np.array(x),
                                             requires_grad=True), params)
    tpts = torch.tensor(pts, requires_grad=True)
    _loss_t(ttri.triplane_features(tp, tpts, cfg_t, fused=fused)
            * torch.tensor(live)).backward()
    for a, b in zip([p.grad for s in tp["grids"] for p in s],
                    [p for s in g_params["grids"] for p in s]):
        _close(a.numpy(), b)
    _close(tpts.grad.numpy(), g_pts, "pts")
    assert not tpts.grad[::5].any()


@pytest.mark.parametrize("nested,fused", [(True, True), (False, True),
                                          (True, False)])
def test_forward_saves_no_corner_rows(nested, fused):
    """What the field's Functions keep for the backward (the same set on
    the card and on the CPU): q or the coordinates, the planes, the
    (N, C) samples and the int32 keys, never (N, 4, C) corner rows or
    per-plane weights."""
    cfg = ttri.TriplaneConfig(**_cfg(nested))
    field = ttri.init_triplane(torch.Generator().manual_seed(0), cfg)
    planes = [p.requires_grad_(True) for s in field["grids"] for p in s]
    n = 60
    pts = torch.tensor(_points(n, 3), requires_grad=True)
    feats = ttri.triplane_features(field, pts, cfg, fused=fused)
    saved = [t for node in _graph_nodes(feats)
             if node.name() in ("_TriplaneNestedBackward",
                                "_TriplaneFusedBackward",
                                "_SampleGridBackward")
             for t in node.saved_tensors]
    assert saved
    c = cfg.out_dim
    plane_shapes = {tuple(p.shape) for p in planes}
    for t in saved:
        shape = tuple(t.shape)
        assert shape != (n, 4, c) and t.dim() <= 3, shape
        assert (shape in plane_shapes or shape in ((n, 3), (n, 2), (n, c))
                or (t.dtype == torch.int32 and t.dim() == 1)), shape


def test_kernel_tables_and_refusals():
    """The kernel's problem and plane tables (built once per layout) and
    the wrapper's refusals, on the CPU."""
    cfg = ttri.TriplaneConfig(**_cfg(True, res=4))
    field = ttri.init_triplane(torch.Generator().manual_seed(1), cfg)
    grids = [p for s in field["grids"] for p in s]
    meta = tuple((a, b, p.shape[1], p.shape[2]) for s in field["grids"]
                 for p, (a, b) in zip(s, ttri.COO_COMBS))
    n = 600
    q = torch.tensor(_points(n, 4))
    _, saved = ttri.nested_forward(meta, q, grids)
    st = GG._static(meta, saved.layout, n, cfg.out_dim, True)
    assert st is GG._static(meta, saved.layout, n, cfg.out_dim, True)
    blocks = -(-n // GG.BLOCK_ROWS)
    assert st.n_blocks == 9 * blocks
    assert list(st.prob_tab[:, 7]) == [blocks * i for i in range(9)]
    for p in range(9):
        s = p // 3
        h, w, a, b, base, gcol, f1, f2 = st.plane_tab[p, :8]
        assert (a, b, h, w) == meta[p]
        assert base == GG.cell_bases(saved.layout)[p]
        assert gcol == s * cfg.out_dim
        assert sorted((f1, f2, p)) == [3 * s, 3 * s + 1, 3 * s + 2]
    assert st.out_floats == sum(g.numel() for g in grids)
    gout = torch.zeros((n, cfg.feat_dim))
    skeys, orders = GG.sort_keys(saved.keys)
    with pytest.raises(ValueError, match="CUDA"):
        GG.triplane_bwd_cuda(meta, q, grids, saved, skeys, orders, gout,
                             True)
