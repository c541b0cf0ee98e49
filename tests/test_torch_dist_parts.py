"""The pieces of the port's sharded step held against sings_tpu's, in one
process (no process group): camera_strip, strips rendered through it
against the full frame, rasterize(valid_rows=), balanced_strip_bounds,
knn_rows, gaussians_edge_loss_rows and the row-split region laplacian
(shard_region_laplacian, ShardedRegionLaplacian.loss_fused).

Tolerances: the cameras and the strip bounds exactly; strips against
the full render at tests/test_dist.py's atol 2e-4; renders against JAX
at tests/test_torch_rasterizer.py's atol 2e-5 and their gradients at
tests/test_rasterizer.py's (atol 2e-4 max|g|, rtol 2e-3); knn_rows bit
for bit the rows of the port's knn and at float32 rounding of JAX's
(its neighbours in JAX's order but where two distances tie to that
rounding);
the row-split terms at float32 rounding (rtol 1e-5) of JAX's and of
the full terms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sings_tpu.dist import shard as jshard
from sings_tpu.losses import regularizers as jreg
from sings_tpu.ops import knn as jknn
from sings_tpu.ops.graphics import make_camera as jcam
from sings_tpu.ops.rasterizer import api as japi
from sings_tpu_torch.dist import shard as tshard
from sings_tpu_torch.losses import regularizers as treg
from sings_tpu_torch.ops import knn as tknn
from sings_tpu_torch.ops.graphics import make_camera as tcam
from sings_tpu_torch.ops.rasterizer import api as tapi
from torch_dist_work import two_torch_threads  # noqa: F401

HW = 64
KW = dict(tile=16, chunk=8, max_span=8)
RENDER_TOL = 2e-5
STRIP_TOL = 2e-4
ROW_RTOL = 1e-5


def _cams(K=None):
    kw = dict(K=K) if K is not None else dict(fovx=0.9, fovy=0.9)
    return (jcam(np.eye(4), HW, HW, **kw), tcam(np.eye(4), HW, HW, **kw))


def _scene(n=40, seed=0):
    """tests/test_dist.py::make_scene's gaussians, numpy."""
    rng = np.random.RandomState(seed)
    means = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                      rng.uniform(2.0, 6.0, n)], -1).astype(np.float32)
    scales = rng.uniform(0.02, 0.12, (n, 3)).astype(np.float32)
    quats = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))
    opac = rng.uniform(0.3, 1.0, n).astype(np.float32)
    rgb = rng.rand(n, 3).astype(np.float32)
    return means, scales, quats, opac, rgb


BG = np.asarray([0.2, 0.4, 0.6], np.float32)


@pytest.mark.parametrize("y0,h", [(0, 16), (16, 16), (48, 16), (16, 48),
                                  (32, 48), (0, 64)])
@pytest.mark.parametrize("centered", [True, False])
def test_camera_strip_matches_jax(y0, h, centered):
    K = None if centered else np.array([[70.0, 0, 30.0], [0, 66.0, 35.0],
                                        [0, 0, 1]])
    jc, tc = _cams(K)
    js, ts = jshard.camera_strip(jc, y0, h), tshard.camera_strip(tc, y0, h)
    for f in ("view", "proj", "cam_center"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    for f in ("height", "width", "tan_fovx", "tan_fovy", "clamp_tan_fovx",
              "clamp_tan_fovy"):
        assert getattr(ts, f) == pytest.approx(float(getattr(js, f)),
                                               rel=1e-7), f
    # the full camera is untouched
    np.testing.assert_array_equal(tc.proj.numpy(), np.asarray(jc.proj))


def _render(cam, arrays, pkg="torch", **kw):
    if pkg == "torch":
        a = [torch.tensor(x) for x in arrays]
        return tapi.rasterize(*a, cam, bg=torch.tensor(BG), **KW, **kw)
    a = [jnp.asarray(x) for x in arrays]
    return japi.rasterize(*a, cam, bg=jnp.asarray(BG), interpret=True,
                          **KW, **kw)


def test_strips_reassemble_the_full_render():
    """tests/test_dist.py:34 in the port: 4 strips of 16 rows through
    camera_strip, concatenated, against the full frame (and JAX's)."""
    jc, tc = _cams()
    arrays = _scene()
    full = _render(tc, arrays)["render"]
    strips = torch.cat([_render(tshard.camera_strip(tc, i * 16, 16),
                                arrays)["render"] for i in range(4)], dim=1)
    np.testing.assert_allclose(strips.numpy(), full.numpy(), atol=STRIP_TOL)
    np.testing.assert_allclose(full.numpy(), np.asarray(
        _render(jc, arrays, "jax")["render"]), atol=RENDER_TOL)


@pytest.mark.parametrize("valid_rows", [16, 32, 40])
def test_rasterize_valid_rows_matches_jax(valid_rows):
    """A 48-row strip window from row 16 owning valid_rows of them:
    render, transmittance and the gradients against JAX's; the owned
    tile rows bit for bit the unrestricted render, the rest bg."""
    jc, tc = _cams()
    js, ts = jshard.camera_strip(jc, 16, 48), tshard.camera_strip(tc, 16, 48)
    arrays = _scene(60, seed=1)
    w = np.random.RandomState(2).rand(3, 48, HW).astype(np.float32)

    def tloss(*a):
        r = tapi.rasterize(*a, ts, bg=torch.tensor(BG),
                           valid_rows=valid_rows, **KW)
        return (r["render"] * torch.tensor(w)).sum() + r[
            "transmittance"].sum(), r

    def jloss(*a):
        r = japi.rasterize(*a, js, bg=jnp.asarray(BG),
                           valid_rows=float(valid_rows), interpret=True,
                           **KW)
        return (r["render"] * jnp.asarray(w)).sum() + r[
            "transmittance"].sum(), r

    ta = [torch.tensor(x, requires_grad=True) for x in arrays]
    (tl, rt) = tloss(*ta)
    tg = torch.autograd.grad(tl, ta)
    (jl, rj), jg = jax.value_and_grad(jloss, argnums=tuple(range(5)),
                                      has_aux=True)(
        *[jnp.asarray(x) for x in arrays])
    for k in ("render", "transmittance"):
        np.testing.assert_allclose(rt[k].detach().numpy(),
                                   np.asarray(rj[k]), atol=RENDER_TOL,
                                   err_msg=k)
    for name, a, b in zip(("means", "scales", "quats", "opac", "rgb"), tg,
                          jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-3,
                                   atol=2e-4 * max(np.abs(b).max(), 1e-12),
                                   err_msg=name)
    owned = -(-valid_rows // 16) * 16
    with torch.no_grad():
        free = _render(ts, arrays)["render"]
        lim = rt["render"].detach()
    assert torch.equal(lim[:, :owned], free[:, :owned])
    if owned < 48:
        bg = torch.tensor(BG)[:, None, None].expand(3, 48 - owned, HW)
        assert torch.equal(lim[:, owned:], bg)
        assert float((free[:, owned:] - bg).abs().max()) > 0.01


@pytest.mark.parametrize("n_gs", [2, 3, 4])
@pytest.mark.parametrize("pad_mult", [1.0, 1.3])
@pytest.mark.parametrize("profile", ["gauss", "uniform", "random"])
def test_balanced_strip_bounds_match_jax(n_gs, pad_mult, profile):
    h = 512
    rows = np.arange(h)
    w = {"gauss": np.exp(-((rows - 256) / 60.0) ** 2),
         "uniform": np.ones(h),
         "random": np.random.RandomState(n_gs).rand(h) ** 4}[profile]
    tb, th = tshard.balanced_strip_bounds(w, n_gs, tile=16,
                                          pad_mult=pad_mult)
    jb, jh = jshard.balanced_strip_bounds(w, n_gs, tile=16,
                                          pad_mult=pad_mult)
    np.testing.assert_array_equal(tb, jb)
    assert tb.dtype == jb.dtype and th == jh


def _cloud(n=700, seed=0):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(n, 3) * [0.2, 0.5, 0.1] + [0.0, 0.3, 3.0]).astype(
        np.float32)
    alive = rng.rand(n) > 0.1
    return pts, alive


@pytest.mark.parametrize("row_start,rows", [(0, 175), (175, 175),
                                            (350, 350), (612, 88)])
def test_knn_rows_matches_jax_and_knn(row_start, rows):
    pts, alive = _cloud()
    tp, tv = torch.tensor(pts), torch.tensor(alive)
    d, i = tknn.knn_rows(tp, 9, row_start=row_start, rows=rows, valid=tv,
                         block=64)
    fd, fi = tknn.knn(tp, 9, valid=tv, block=64)
    assert torch.equal(d, fd[row_start: row_start + rows])
    assert torch.equal(i, fi[row_start: row_start + rows])
    jd, ji = jknn.knn_rows(jnp.asarray(pts), 9, row_start=row_start,
                           rows=rows, valid=jnp.asarray(alive), block=64)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=ROW_RTOL,
                               atol=1e-7)
    # the two packages' matmuls round apart by an ulp: neighbours may
    # swap ranks only where their distances tie to that rounding
    dn = d.numpy()
    for r, c in zip(*np.nonzero(i.numpy() != np.asarray(ji))):
        near = [dn[r, cc] for cc in (c - 1, c + 1) if 0 <= cc < dn.shape[1]]
        assert min(abs(dn[r, c] - x) for x in near) <= ROW_RTOL * dn[r, c], (
            r, c)


def test_gaussians_edge_loss_rows_sum_to_the_full_term():
    """4 row ranges: each range's value and d/dscales against JAX's
    (approx=True, exact on the CPU), their sums against the full
    gaussians_edge_loss and its gradient."""
    pts, alive = _cloud(768, seed=3)
    scales = np.random.RandomState(4).uniform(0.01, 0.1, (768, 3)).astype(
        np.float32)
    ta, tpts = torch.tensor(alive.astype(np.float32)), torch.tensor(pts)
    ts = torch.tensor(scales, requires_grad=True)
    full = treg.gaussians_edge_loss(tpts, ts, ta)
    (gfull,) = torch.autograd.grad(full, [ts])
    total, gsum = 0.0, torch.zeros_like(ts)
    for r in range(4):
        loc = treg.gaussians_edge_loss_rows(tpts, ts, ta, row_start=192 * r,
                                            rows=192)
        (g,) = torch.autograd.grad(loc, [ts])
        jv, jg = jax.value_and_grad(
            lambda s: jreg.gaussians_edge_loss_rows(
                jnp.asarray(pts), s, jnp.asarray(alive.astype(np.float32)),
                row_start=192 * r, rows=192))(jnp.asarray(scales))
        np.testing.assert_allclose(float(loc.detach()), float(jv),
                                   rtol=ROW_RTOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=ROW_RTOL,
                                   atol=1e-9)
        total, gsum = total + loc, gsum + g
    np.testing.assert_allclose(float(total.detach()), float(full.detach()),
                               rtol=ROW_RTOL)
    np.testing.assert_allclose(gsum.numpy(), gfull.numpy(), rtol=ROW_RTOL,
                               atol=1e-9)


@pytest.fixture(scope="module")
def laplacians():
    import __graft_entry__ as ge

    _, _, _, cfg, state, _ = ge._tiny_setup()
    b = state.buffers
    edges = np.asarray(b.edges)[np.asarray(b.edge_valid) > 0.5]
    labels = np.where(np.asarray(b.alive) > 0.5, np.asarray(b.vertex_label),
                      -1)
    w = np.linspace(0.5, 2.0, 15).astype(np.float32)
    args = (edges, labels, w)
    return (jreg.build_region_laplacian(*args, num_regions=15, pad_to=8),
            treg.build_region_laplacian(*args, num_regions=15, pad_to=8),
            cfg.capacity)


@pytest.mark.parametrize("n_gs", [1, 2, 4])
def test_shard_region_laplacian_tables_match_jax(laplacians, n_gs):
    jl, tl, _ = laplacians
    js = jreg.shard_region_laplacian(jl, n_gs)
    ts = treg.shard_region_laplacian(tl, n_gs)
    for f in treg.ShardedRegionLaplacian._fields:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    wide = treg.shard_region_laplacian(tl, n_gs, pad_t_width_to=40)
    assert wide.t_neighbors.shape[-1] == 40
    np.testing.assert_array_equal(
        wide.t_neighbors[..., : ts.t_neighbors.shape[-1]].numpy(),
        ts.t_neighbors.numpy())


@pytest.mark.parametrize("n_gs", [2, 4])
def test_sharded_laplacian_loss_sums_to_the_full_term(laplacians, n_gs):
    """Three fused terms (weighted position, the hand regions [6, 7],
    colour), each rank's values and gradients against JAX's, their sums
    against the full RegionLaplacian.loss_fused."""
    jl, tl, cap = laplacians
    rng = np.random.RandomState(n_gs)
    xs = [rng.randn(cap, 3).astype(np.float32) for _ in range(3)]
    w_pos = np.linspace(1.0, 3.0, 15).astype(np.float32)
    w_col = np.linspace(2.0, 0.5, 15).astype(np.float32)
    spec = [(w_pos, None), (np.ones(15, np.float32), [6, 7]), (w_col, None)]

    def tterms(x):
        return [(xi, torch.tensor(w), r) for xi, (w, r) in zip(x, spec)]

    def jterms(x):
        return [(xi, jnp.asarray(w), r) for xi, (w, r) in zip(x, spec)]

    tx = [torch.tensor(x, requires_grad=True) for x in xs]
    full = tl.loss_fused(tterms(tx))
    gfull = torch.autograd.grad(sum(full), tx)
    js = jreg.shard_region_laplacian(jl, n_gs)
    ts = treg.shard_region_laplacian(tl, n_gs)
    sums = [0.0] * 3
    gsum = [torch.zeros_like(x) for x in tx]
    for r in range(n_gs):
        loc = ts.shard(r).loss_fused(tterms(tx))
        g = torch.autograd.grad(sum(loc), tx)
        jshard_r = jax.tree.map(lambda a: a[r: r + 1], js)
        jv, jg = jax.value_and_grad(
            lambda *x: sum(jshard_r.loss_fused(jterms(x))),
            argnums=(0, 1, 2))(*[jnp.asarray(x) for x in xs])
        jloc = jshard_r.loss_fused(jterms([jnp.asarray(x) for x in xs]))
        for a, b in zip(loc, jloc):
            np.testing.assert_allclose(float(a), float(b), rtol=ROW_RTOL)
        for a, b in zip(g, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=ROW_RTOL, atol=1e-7)
        sums = [s + float(v) for s, v in zip(sums, loc)]
        gsum = [s + v for s, v in zip(gsum, g)]
    for s, f in zip(sums, full):
        np.testing.assert_allclose(s, float(f), rtol=ROW_RTOL)
    for a, b in zip(gsum, gfull):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=ROW_RTOL,
                                   atol=1e-7)
