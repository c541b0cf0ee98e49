"""Row 6 spread over the card: the CTA split of the port's in-window
prefix-sum micro-benchmark (ops/scan_bench.py).

chunk_scan_bench_plain(ctas=P) gives CTA p the contiguous steps
[steps p // P, steps (p + 1) // P), accumulates each CTA's steps and then
the CTAs' partials in float64, and rounds once, as the kernel does. The
steps' float32 row sums are the same numbers for every P, so P moves the
result by the order of float64 additions alone: within ORDER_RTOL (two
float32 ulps) of the largest output, for every mode, for splits that do
not divide the steps and for more CTAs than steps. Against the JAX
script's kernel: tests/test_torch_scan_bench.py. Then the CUDA wrapper's
refusal of CPU tensors and the entry point's --ctas on the CPU.
"""
import numpy as np
import pytest
import torch

from sings_tpu_torch.ops import scan_bench as sb
from sings_tpu_torch.scripts import exp_cumsum_kernel as t_cumsum
from test_torch_bwd_variants import one_torch_thread  # noqa: F401

STEPS = sb._BLOCK + 45  # two step blocks of the plain version
ORDER_RTOL = 2 ** -22
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _x():
    return torch.from_numpy(np.random.RandomState(1).randn(
        sb.CHUNK, sb.NPX).astype(np.float32))


# splits that do not divide the steps, and more CTAs than steps
@pytest.mark.parametrize("ctas,steps", [(3, STEPS), (16, STEPS), (12, 7)])
@pytest.mark.parametrize("mode", sb.MODES)
def test_plain_cta_split_moves_only_the_order(mode, ctas, steps):
    x = _x()
    one = sb.chunk_scan_bench(x, mode=mode, steps=steps)
    got = sb.chunk_scan_bench(x, mode=mode, steps=steps, ctas=ctas)
    assert got.shape == (1, sb.NPX) and got.dtype == torch.float32
    torch.testing.assert_close(got, one, rtol=0,
                               atol=ORDER_RTOL * float(one.abs().max()))
    assert sb.LAUNCHES["chunk_scan_bench"] == 0


def test_step_ranges_cover_the_steps_in_order():
    for steps, ctas in ((4096, 132), (10, 3), (2, 5)):
        ranges = sb.step_ranges(steps, ctas)
        assert len(ranges) == ctas and ranges[0][0] == 0
        assert ranges[-1][1] == steps
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    with pytest.raises(ValueError, match="ctas"):
        sb.chunk_scan_bench_plain(_x(), mode="tri", steps=4, ctas=0)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        sb.chunk_scan_bench_cuda(_x(), mode="shift", ctas=132)
    assert sb.LAUNCHES["chunk_scan_bench"] == 0
    assert set(sb.MODE_LAUNCHES.values()) == {0}


def test_entry_point_ctas_on_cpu():
    out = t_cumsum.main(["--device", "cpu", "--steps", "6"])
    assert out["ctas"] == 1
    out3 = t_cumsum.main(["--device", "cpu", "--steps", "6", "--ctas", "4"])
    assert out3["ctas"] == 4 and sorted(out3["modes"]) == sorted(sb.MODES)
