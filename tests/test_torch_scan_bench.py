"""The port's in-window prefix-sum micro-benchmark held against sings_tpu.

Each mode's plain version (ops/scan_bench.py) against the Pallas kernel
of scripts/exp_cumsum_kernel.py, run through
pl.pallas_call(make_kernel(mode), interpret=True) at STEPS = 4 on the
same seeded x. Tolerance: 1e-6 of the largest output, f32 sums of
~1e4 reassociated (the two sides agree to ~2e-7 of it); the modes
against each other over 259 steps at 1e-5. The script runs
its TPU benchmark when imported: on the CPU each mode fails at once and
is reported, and its persistent compilation cache is switched off
again. Then the wrappers' refusal of CPU tensors on the CUDA path, the
CPU timing helper, and the entry point at a small size on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sings_tpu_torch.ops import scan_bench as sb
from sings_tpu_torch.ops.timing import device_time
from sings_tpu_torch.scripts import exp_cumsum_kernel as t_cumsum
from test_torch_bwd_variants import import_script

STEPS = 4
RTOL = 1e-6
# between modes over a few hundred steps, each step's row sums taken in
# another order (chip_smoke.py's SCAN_RTOL, kernel against plain)
MODES_RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_script():
    mod = import_script("exp_cumsum_kernel")
    mod.STEPS = STEPS  # make_kernel reads the module's STEPS when traced
    return mod


def _x():
    return np.random.RandomState(0).randn(sb.CHUNK, sb.NPX).astype(
        np.float32)


@pytest.mark.parametrize("mode", sb.MODES)
def test_plain_matches_pallas_interpret(mode, jax_script):
    x = _x()
    want = np.asarray(pl.pallas_call(
        jax_script.make_kernel(mode),
        out_shape=jax.ShapeDtypeStruct((1, sb.NPX), jnp.float32),
        interpret=True)(jnp.asarray(x)))
    sb.reset_launches()
    got = sb.chunk_scan_bench(torch.from_numpy(x), mode=mode,
                              steps=STEPS).numpy()
    assert got.shape == (1, sb.NPX)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())
    assert sb.LAUNCHES["chunk_scan_bench"] == 0


def test_plain_modes_agree():
    """The modes compute one function (tri3 six times it: la + 2 la +
    3 la), across the plain version's step blocks."""
    x = torch.from_numpy(_x())
    steps = sb._BLOCK + 3
    one = sb.chunk_scan_bench_plain(x, mode="cumsum", steps=steps)
    for mode in sb.MODES:
        got = sb.chunk_scan_bench_plain(x, mode=mode, steps=steps)
        want = one * (6.0 if mode == "tri3" else 1.0)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=MODES_RTOL * float(want.abs().max()))
    with pytest.raises(ValueError, match="mode"):
        sb.chunk_scan_bench(x, mode="roll", steps=1)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        sb.chunk_scan_bench_cuda(torch.from_numpy(_x()), mode="tri")
    assert sb.LAUNCHES["chunk_scan_bench"] == 0
    assert set(sb.MODE_LAUNCHES.values()) == {0}


def test_device_time_on_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    t = device_time(fn, (torch.zeros(4),), k1=1, k2=3, repeats=2)
    assert t >= 0.0 and len(calls) == 1 + 2 * (1 + 3)
    with pytest.raises(ValueError, match="k2"):
        device_time(fn, (torch.zeros(4),), k1=3, k2=3)


def test_exp_cumsum_kernel_entry_point():
    out = t_cumsum.main(["--device", "cpu", "--steps", "8"])
    assert out["device"] == "cpu" and out["steps"] == 8
    assert sorted(out["modes"]) == sorted(sb.MODES)
    for m in out["modes"].values():
        assert m["ms"] > 0 and m["us_per_chunk"] == m["ms"] / 8 * 1e3
