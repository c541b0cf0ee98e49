"""The exact KNN's CUDA path around the kernel, on the CPU: the shared
argument check (_check_knn) refuses what the kernel does not take before
any device is touched, CPU tensors never launch csrc/knn_topk.cu, the
plain version's knn_rows over a split of the rows is knn's rows, and
that MAX_K is the kernel's. The kernel itself runs on the card
(chip_smoke.py's knn phase holds it against the torch path there)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sings_tpu_torch.losses import regularizers as treg
from sings_tpu_torch.ops import cuda_build
from sings_tpu_torch.ops import knn as tknn

CU = Path(tknn.__file__).resolve().parents[1] / "csrc" / "knn_topk.cu"


def _cloud(n=600, seed=0):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(n, 3) * [0.2, 0.5, 0.1] + [0.0, 0.3, 3.0]).astype(
        np.float32)
    return torch.tensor(pts), torch.tensor(rng.rand(n) > 0.15)


def _bad_args():
    """(name, kwargs of _check_knn) that the kernel does not take."""
    pts, valid = _cloud(40)
    return [
        ("float64 points", dict(points=pts.double(), k=4, valid=valid)),
        ("int points", dict(points=pts.int(), k=4, valid=valid)),
        ("(N, 2) points", dict(points=pts[:, :2].contiguous(), k=4,
                               valid=valid)),
        ("(N,) points", dict(points=pts[:, 0].contiguous(), k=4,
                             valid=valid)),
        ("(N, 3, 1) points", dict(points=pts[:, :, None], k=4, valid=valid)),
        ("no points", dict(points=pts[:0], k=1, valid=None)),
        ("non-contiguous points", dict(points=pts.T.contiguous().T, k=4,
                                       valid=valid)),
        ("strided rows", dict(points=pts[::2], k=4, valid=valid[::2])),
        ("a list", dict(points=pts.tolist(), k=4, valid=None)),
        ("float valid", dict(points=pts, k=4, valid=valid.float())),
        ("short valid", dict(points=pts, k=4, valid=valid[:-1])),
        ("non-contiguous valid", dict(
            points=pts, k=4, valid=torch.stack([valid, valid], 1)[:, 0])),
        ("k over the kernel's limit", dict(points=pts, k=tknn.MAX_K + 1,
                                           valid=valid)),
        ("k 0", dict(points=pts, k=0, valid=valid)),
        ("k over N", dict(points=pts[:5].contiguous(), k=6, valid=None)),
        ("float k", dict(points=pts, k=4.0, valid=valid)),
        ("bool k", dict(points=pts, k=True, valid=valid)),
        ("negative row start", dict(points=pts, k=4, valid=valid,
                                    row_start=-1, rows=5)),
        ("rows past N", dict(points=pts, k=4, valid=valid, row_start=30,
                             rows=11)),
        ("no rows", dict(points=pts, k=4, valid=valid, row_start=3,
                         rows=0)),
    ]


BAD = _bad_args()


@pytest.mark.parametrize("case", range(len(BAD)),
                         ids=[name for name, _ in BAD])
def test_check_knn_refuses(case):
    _, kw = BAD[case]
    with pytest.raises(ValueError, match="knn"):
        tknn._check_knn(**kw)


@pytest.mark.parametrize("case", range(len(BAD)),
                         ids=[name for name, _ in BAD])
def test_knn_refuses_before_the_device(case):
    """On the meta device (no data, no kernel, no plain version) a bad
    call raises _check_knn's error, not the device dispatch's."""
    _, kw = BAD[case]
    kw = dict(kw)
    meta = {name: (torch.empty_strided(v.shape, v.stride(), dtype=v.dtype,
                                       device="meta")
                   if isinstance(v, torch.Tensor) else v)
            for name, v in kw.items()}
    fn = tknn.knn_rows if "rows" in kw else tknn.knn
    args = dict(k=meta["k"], valid=meta["valid"])
    if "rows" in kw:
        args.update(row_start=meta["row_start"], rows=meta["rows"])
    with pytest.raises(ValueError) as err:
        fn(meta["points"], **args)
    assert "unsupported device" not in str(err.value)


@pytest.mark.parametrize("rows", [None, (0, 40), (7, 1), (39, 1)])
def test_check_knn_takes_good_calls_then_the_device_decides(rows):
    pts, valid = _cloud(40)
    kw = {} if rows is None else dict(row_start=rows[0], rows=rows[1])
    tknn._check_knn(pts, tknn.MAX_K, valid, **kw)
    tknn._check_knn(pts, 1, None, **kw)
    fn = tknn.knn if rows is None else tknn.knn_rows
    with pytest.raises(ValueError, match="unsupported device"):
        fn(pts.to("meta"), 9, valid=valid.to("meta"), **kw)


def test_cuda_launcher_refuses_cpu_tensors():
    pts, valid = _cloud(40)
    with pytest.raises(ValueError, match="CUDA"):
        tknn.knn_topk_cuda(pts, 9, valid, 0, 40)


def test_cpu_tensors_never_launch_the_kernel():
    pts, valid = _cloud()
    tknn.reset_launches()
    built = dict(cuda_build._LIBS)
    tknn.knn(pts, 9, valid=valid)
    tknn.knn_rows(pts, 9, row_start=100, rows=250, valid=valid)
    treg.edge_stat(pts, valid.float(), k=9)
    treg.gaussians_edge_loss_rows(pts, torch.rand(600, 3), valid.float(),
                                  row_start=0, rows=300, k=9)
    assert tknn.LAUNCHES == {"knn_topk": 0}
    assert "knn_topk" not in cuda_build._LIBS or "knn_topk" in built


SPLITS = [
    # three uneven ranges, the middle one shorter than the block, the
    # last one ragged against the block
    ([0, 250, 290, 600], 128),
    ([0, 2, 513, 600], 64),
    ([0, 300, 598, 600], 4096),
    ([0, 17, 200, 600], 200),
]


@pytest.mark.parametrize("bounds,block", SPLITS)
def test_knn_rows_split_is_knn(bounds, block):
    pts, valid = _cloud()
    want_d, want_i = tknn.knn(pts, 9, valid=valid, block=block)
    parts = [tknn.knn_rows(pts, 9, row_start=a, rows=b - a, valid=valid,
                           block=block) for a, b in zip(bounds, bounds[1:])]
    assert torch.equal(torch.cat([d for d, _ in parts]), want_d)
    assert torch.equal(torch.cat([i for _, i in parts]), want_i)


@pytest.mark.parametrize("row", [0, 1, 250, 599])
def test_knn_rows_one_row(row):
    """A one-row range: torch's CPU matmul takes its matrix-vector kernel
    for a single query row, which rounds q.p apart from the blocked
    product, so the plain version's distances there equal knn's only to
    the rounding of |q|^2 + |p|^2 (the self distance, ~0, moves most);
    the neighbours are knn's. (On the card one kernel serves both.)"""
    pts, valid = _cloud()
    want_d, want_i = tknn.knn(pts, 9, valid=valid, block=64)
    d, i = tknn.knn_rows(pts, 9, row_start=row, rows=1, valid=valid,
                         block=64)
    assert torch.equal(i[0], want_i[row])
    sq = tknn._sum_squares(pts)
    scale = sq[row] + sq[want_i[row]]
    assert bool(((d[0] - want_d[row]).abs() <= 4 * torch.finfo(
        torch.float32).eps * scale).all())


@pytest.mark.parametrize("k", [1, 4, 9, 16])
def test_plain_knn_self_first_and_valid(k):
    """The plain version's contract, kept: ascending, clamped at 0, every
    neighbour valid, and a valid point's own index among its nearest."""
    pts, valid = _cloud()
    d, i = tknn.knn(pts, k, valid=valid)
    assert d.shape == i.shape == (600, k)
    assert bool((d[:, 1:] >= d[:, :-1]).all()) and bool((d >= 0).all())
    assert bool(valid[i].all())
    rows = torch.nonzero(valid)[:, 0]
    assert bool((i[rows] == rows[:, None]).any(1).all())


def test_python_limit_is_the_kernels():
    m = re.search(r"constexpr int kMaxK = (\d+);", CU.read_text())
    assert m and int(m.group(1)) == tknn.MAX_K
