"""The backward's experiment formulas of the port held against sings_tpu.

composite_bwd_moments_plain against the Pallas composite_bwd_moments of
scripts/exp_bwd_moments.py (interpret mode); each of v1 / v3 / v4 / v2
of composite_bwd_variant_plain against the Pallas composite_bwd
(interpret mode), the function scripts/exp_bwd_variants.py claims
equivalence with (its own kernel is frozen at an older layout and does
not import), and v4 / v2 also against the moments kernel (the two
differ only in dl_dop's guard, for opacities below 1e-6). All at
tests/test_torch_rasterizer_bwd.py's tolerance (atol 2e-4 * max|g|,
rtol 2e-3, per gradient row) on the slots the kernels write: the
un-sort tables' slots minus the spare, which the moments kernel leaves
undefined. Scenes: a small seeded one, a saturating stack, and the
bench scene of the scripts at a small size, built by both packages
from the same draws. Then the entry points at a small size on the CPU.
On the CPU the port runs the plain versions; chip_smoke.py holds the
CUDA kernel against them on the card.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import compilation_cache
from jax.experimental.pallas import tpu as pltpu

from sings_tpu.ops.graphics import make_camera as jcam
from sings_tpu.ops.rasterizer import api as japi
from sings_tpu.ops.rasterizer import common as jcom
from sings_tpu.ops.rasterizer import pallas_kernels as jpk
from sings_tpu.ops.rasterizer import tiles as jtiles
from sings_tpu_torch.ops.rasterizer import variants as tv
from sings_tpu_torch.scripts import _scene
from sings_tpu_torch.scripts import exp_bwd_moments as t_moments
from sings_tpu_torch.scripts import exp_bwd_variants as t_variants
from test_torch_rasterizer_bwd import (
    GLUE, _bwd_inputs, _glue_read_slots, _grad_close, entry_state,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_KEYS = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_entry_size_bytes",
              "jax_persistent_cache_min_compile_time_secs")


def import_script(name: str):
    """Import scripts/<name>.py as a module, then undo the persistent
    compilation cache it switches on at import (a cache written on
    another machine can hold code this CPU cannot run)."""
    saved = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    try:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()
    return mod


@pytest.fixture(scope="module")
def jax_moments():
    return import_script("exp_bwd_moments").composite_bwd_moments


def _jax_scene(arrays, jc, *, chunk, max_span, gout, max_pairs=None):
    gj = jcom.preprocess(*[jnp.asarray(a) for a in arrays], jc, sh_degree=3)
    ntx, nty = -(-jc.width // 16), -(-jc.height // 16)
    kw = dict(tile=16, n_tiles_x=ntx, n_tiles_y=nty)
    b = jtiles.bin_gaussians(gj, max_span=max_span, align=chunk,
                             max_pairs=max_pairs, **kw)
    feats, _ = japi._gather_feats(b, gj.means2d, gj.conics, gj.colors,
                                  gj.opacities, chunk)
    fwd = jpk.composite_fwd(feats, b.tile_offsets, chunk=chunk,
                            interpret=True, **kw)
    return b, feats, fwd, jnp.asarray(gout), kw


def _saturating():
    n = 24
    means = np.tile([[0.0, 0.0, 3.0]], (n, 1)).astype(np.float32)
    means[:, 2] += np.linspace(0, 0.5, n).astype(np.float32)
    arrays = (means, np.full((n, 3), 0.2, np.float32),
              np.tile([1.0, 0, 0, 0], (n, 1)).astype(np.float32),
              np.full(n, 0.95, np.float32),
              np.random.RandomState(0).rand(n, 3).astype(np.float32))
    gout = np.random.RandomState(5).randn(4, 8, 256).astype(np.float32)
    gout[:, 4:] = 0.0
    jc = jcam(np.eye(4), height=32, width=32, fovx=0.9, fovy=0.9)
    return _jax_scene(arrays, jc, chunk=8, max_span=2, gout=gout)


def _bench(n=300, hw=64, chunk=8, max_pairs=2048):
    """The scripts' bench scene from _scene's draws, built by the JAX
    package (small windows for the interpret-mode references)."""
    arrays, rng = _scene.scene_draws(n, 0)
    nt = (-(-hw // 16)) ** 2
    gout = rng.rand(nt, 8, 256).astype(np.float32) * 0.1
    gout[:, 4:] = 0.0
    jc = jcam(np.eye(4), height=hw, width=hw, fovx=0.9, fovy=0.9)
    return _jax_scene(arrays, jc, chunk=chunk, max_span=3, gout=gout,
                      max_pairs=max_pairs)


SCENES = {"span5": _bwd_inputs, "saturating": _saturating, "bench": _bench}
_CACHE = {}


def scene_refs(name, jax_moments):
    """JAX inputs and both Pallas outputs of a scene, computed once."""
    if name not in _CACHE:
        b, feats, fwd, gout, kw = SCENES[name]()
        cap = b.pair_slot_capacity
        args = (feats, b.tile_offsets, b.grad_offsets, fwd, gout)
        ref = np.asarray(jpk.composite_bwd(*args, chunk=8, grad_cap=cap,
                                           interpret=True, **kw))
        with pltpu.force_tpu_interpret_mode():
            mom = np.asarray(jax_moments(*args, chunk=8, grad_cap=cap,
                                         **kw))
        slots = _glue_read_slots(b)
        _CACHE[name] = (args + (entry_state(feats, b, kw),),
                        dict(kw, chunk=8, grad_cap=cap),
                        slots[slots < cap - 1], ref, mom)
    return _CACHE[name]


def _rows_close(got, want, slots, what):
    assert np.isfinite(got).all()
    for r in range(9):
        _grad_close(got[r, slots], want[r, slots], f"{what} row {r}")


def _torch_args(args):
    return [torch.tensor(np.array(a)) for a in args]


@pytest.mark.parametrize("scene", list(SCENES))
def test_moments_plain_matches_pallas_interpret(scene, jax_moments):
    args, kw, slots, _, mom = scene_refs(scene, jax_moments)
    got = tv.composite_bwd_moments(*_torch_args(args), **kw).numpy()
    assert got.shape == (9, kw["grad_cap"]) and slots.size > 10
    _rows_close(got, mom, slots, f"moments {scene}")
    assert tv.LAUNCHES["composite_bwd_moments"] == 0


@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("variant", tv.VARIANTS)
def test_variant_plain_matches_pallas_interpret(variant, scene,
                                                jax_moments):
    args, kw, slots, ref, mom = scene_refs(scene, jax_moments)
    got = tv.composite_bwd_variant(*_torch_args(args), variant=variant,
                                   **kw).numpy()
    _rows_close(got, ref, slots, f"{variant} {scene} vs composite_bwd")
    if variant in ("v4", "v2"):
        _rows_close(got, mom, slots, f"{variant} {scene} vs moments")
    np.testing.assert_array_equal(got[:, kw["grad_cap"] - 8:], 0.0)
    assert tv.LAUNCHES[f"composite_bwd_{variant}"] == 0


def test_v2_is_v4_and_saturating_scene_saturates(jax_moments):
    args, kw, slots, ref, _ = scene_refs("saturating", jax_moments)
    t = _torch_args(args)
    v4 = tv.composite_bwd_variant(*t, variant="v4", **kw)
    assert torch.equal(v4, tv.composite_bwd_variant(*t, variant="v2",
                                                    **kw))
    assert float(np.asarray(args[3])[:, 3].min()) < 1e-3  # T saturates
    with pytest.raises(ValueError, match="variant"):
        tv.composite_bwd_variant(*t, variant="v5", **kw)


def test_cuda_wrappers_refuse_cpu_tensors():
    b, feats, fwd, gout, kw = _bwd_inputs()
    args = _torch_args((feats, b.tile_offsets, b.grad_offsets, fwd, gout,
                        entry_state(feats, b, kw)))
    kw = dict(kw, chunk=8, grad_cap=b.pair_slot_capacity)
    tv.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        tv.composite_bwd_moments_cuda(*args, **kw)
    for v in tv.VARIANTS:
        with pytest.raises(ValueError, match="CUDA"):
            tv.composite_bwd_variant_cuda(*args, variant=v, **kw)
    assert set(tv.LAUNCHES.values()) == {0}


def test_moment_basis():
    basis = tv.moment_basis(4).numpy()
    px, py = np.meshgrid(np.arange(4.0), np.arange(4.0))
    px, py = px.ravel(), py.ravel()
    want = np.stack([np.ones(16), px, py, px * px, px * py, py * py,
                     np.zeros(16), np.zeros(16)], 1)
    np.testing.assert_array_equal(basis, want)


def test_bench_scene_matches_jax():
    """_scene.bench_scene and the scripts' JAX pipeline on the same
    draws: binning integer for integer, feats and forward output equal
    to rounding, the same cotangents."""
    b, feats, fwd, gout, _ = _bench(chunk=_scene.CHUNK,
                                    max_pairs=_scene.MAX_PAIRS)
    sc = _scene.bench_scene("cpu", n=300, hw=64)
    for f in GLUE + ("tile_offsets", "sorted_gauss"):
        np.testing.assert_array_equal(np.asarray(getattr(sc.binning, f)),
                                      np.asarray(getattr(b, f)), f)
    np.testing.assert_allclose(sc.feats.numpy(), np.asarray(feats),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sc.fwd_out.numpy(), np.asarray(fwd),
                               atol=1e-5)
    np.testing.assert_array_equal(sc.gout.numpy(), np.asarray(gout))
    ones = _scene.bench_scene("cpu", n=300, hw=64, gout="ones")
    assert bool((ones.gout == 1).all()) and ones.kw["chunk"] == 128


# the entry points' bench scene cut to 200 gaussians at 32x32 (4 tiles,
# 275 pairs, a tile of 2 windows): each test runs ~150 plain backwards
ENTRY_ARGS = ["--device", "cpu", "--n", "200", "--hw", "32"]


@pytest.fixture
def one_torch_thread():
    """Run the test's torch ops on one thread. The entry points time
    ~150 plain backwards of a few thousand small ops each; with the
    suite's parallel workers each holding a full thread pool, every
    op's parallel region waits on oversubscribed cores (a second alone
    took minutes in the parallel suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_torch_thread")
def test_exp_bwd_moments_entry_point():
    out = t_moments.main(ENTRY_ARGS)
    assert out["device"] == "cpu" and out["pairs"] > 100
    assert out["max_abs_diff"] < 2e-4 * max(out["scale"], 1.0)
    assert out["composite_bwd_ms"] > 0 and out["composite_bwd_moments_ms"] > 0


@pytest.mark.usefixtures("one_torch_thread")
def test_exp_bwd_variants_entry_point():
    out = t_variants.main(ENTRY_ARGS)
    assert sorted(out["ms"]) == sorted(tv.VARIANTS)
    assert all(t > 0 for t in out["ms"].values())
    assert out["composite_bwd_ms"] > 0
    assert sorted(out["rel_err_vs_v1"]) == ["v2", "v3", "v4"]
    assert max(out["rel_err_vs_v1"].values()) < 2e-4
    assert out["rel_err_vs_v1"]["v2"] == out["rel_err_vs_v1"]["v4"]
