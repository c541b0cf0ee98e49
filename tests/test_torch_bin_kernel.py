"""The tile binning's CUDA path (csrc/bin_tiles.cu through
ops/rasterizer/tiles.py::bin_tiles_cuda).

On the CPU: the kernel's sort key, (tile << 32) | depth_bits(depth) sorted
stably over the flat (gaussian, slot) ids, orders every tile's pairs as
the plain version's tile * N + rank does, ties included; the argument
check refuses what the kernel does not take; CPU tensors never load the
library and take the plain version.

On the card (marker `cuda`, skipped without one; this file imports no
JAX, so it runs there as `python -m pytest tests/test_torch_bin_kernel.py
--noconftest -o addopts= -q`): every TileBinning field of the kernel
path equals the plain version's on the same CUDA inputs, integer for
integer, at the animation cell's settings and at every option, with one
launch counted a call.
"""
import math

import numpy as np
import pytest
import torch

from sings_tpu_torch.ops import cuda_build
from sings_tpu_torch.ops.graphics import make_camera
from sings_tpu_torch.ops.rasterizer import tiles as T
from sings_tpu_torch.ops.rasterizer.common import preprocess


def depth_bits(d: torch.Tensor) -> torch.Tensor:
    """csrc/bin_tiles.cu depth_bits in int64: the float's bits mapped to
    an order-preserving unsigned code, -0 as +0, every NaN last."""
    u = d.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    mag = u & 0x7FFFFFFF
    u = torch.where(mag == 0, torch.zeros_like(u), u)
    code = torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)
    return torch.where(mag > 0x7F800000, torch.full_like(u, 0xFFFFFFFF),
                       code)


def pair_table(n, cap, n_tiles, seed):
    """Seeded pairs as binning makes them: each gaussian a few distinct
    tiles (slots past its count invalid), depths with many exact ties,
    both zeros, negatives, an infinity and a NaN."""
    rng = np.random.RandomState(seed)
    depth = rng.choice([0.5, 1.25, 3.0, -2.0, 7.5], n).astype(np.float32)
    depth = np.where(rng.rand(n) < 0.3,
                     rng.uniform(-1.0, 9.0, n).astype(np.float32), depth)
    depth[:6] = [0.0, -0.0, np.inf, np.nan, -np.inf, 3.0]
    tiles = np.stack([rng.permutation(n_tiles)[:cap] for _ in range(n)])
    count = rng.randint(0, cap + 1, n)
    valid = np.arange(cap)[None, :] < count[:, None]
    return (torch.tensor(depth), torch.tensor(tiles, dtype=torch.int64),
            torch.tensor(valid))


@pytest.mark.parametrize("seed", range(6))
def test_depth_key_order_is_rank_order(seed):
    n, cap, n_tiles = 400, 4, 9
    depth, tiles, valid = pair_table(n, cap, n_tiles, seed)
    # tiles.py: rank from a stable depth argsort, key tile * N + rank
    rank = torch.empty(n, dtype=torch.int64)
    rank[torch.argsort(depth, stable=True)] = torch.arange(n)
    plain = torch.where(valid, tiles * n + rank[:, None],
                        torch.full_like(tiles, T.INVALID)).reshape(-1)
    # the kernel: (tile << 32) | depth_bits, invalid at 2^63 - 1
    kern = torch.where(valid, (tiles << 32) | depth_bits(depth)[:, None],
                       torch.full_like(tiles, 2**63 - 1)).reshape(-1)
    want = torch.sort(plain, stable=True).indices[:int(valid.sum())]
    got = torch.sort(kern, stable=True).indices[:int(valid.sum())]
    assert torch.equal(got, want)
    # the ties are there: equal depths share a tile
    pairs = torch.stack([tiles[valid], depth[:, None].expand(n, cap)[valid]
                         .view(torch.int32).long()], 1)
    assert torch.unique(pairs, dim=0).shape[0] < pairs.shape[0]


def test_depth_bits_orders_floats():
    vals = torch.tensor([-math.inf, -3.5, -1e-30, -0.0, 0.0, 1e-38, 0.2,
                         3.0, 3.0000002, math.inf, math.nan])
    bits = depth_bits(vals)
    assert bool((bits[1:-1] >= bits[:-2]).all())
    assert int(bits[3]) == int(bits[4]) == 0x80000000
    assert int(bits[-1]) == 0xFFFFFFFF > int(bits[-2])
    assert bool(((bits >= 0) & (bits <= 0xFFFFFFFF)).all())


def scene(n, h, w, seed, device="cpu", z=(2.0, 6.0), spread=0.6,
          alive_frac=0.9, tile=16):
    """A seeded screen-space scene through the port's preprocess: sizes
    from sub-pixel to several tiles, a tenth of the slots dead."""
    from sings_tpu_torch.ops.rotations import axis_angle_to_quaternion

    g = torch.Generator().manual_seed(seed)

    def u(*s):
        return torch.rand(*s, generator=g)

    means = torch.stack([(u(n) * 2 - 1) * spread, (u(n) * 2 - 1) * spread,
                         z[0] + u(n) * (z[1] - z[0])], -1)
    scales = 0.005 + 0.13 * u(n, 3) ** 2
    quats = axis_angle_to_quaternion(torch.randn(n, 3, generator=g) * 0.5)
    opac = 0.01 + 0.99 * u(n)
    rgb = u(n, 3)
    alive = u(n) < alive_frac
    cam = make_camera(np.eye(4), h, w, fovx=0.9, fovy=0.9 * h / w,
                      device=device)
    args = [x.to(device) for x in (means, scales, quats, opac, rgb, alive)]
    return preprocess(*args[:5], cam, alive=args[5], tile=tile)


def grid(h, w, tile=16):
    return dict(tile=tile, n_tiles_x=-(-w // tile), n_tiles_y=-(-h // tile))


CELL = dict(max_span=3, pair_cap=4, main_width=4, align=128)


def _bad_args():
    """(name, scene edit, keyword edit) that the kernel does not take."""
    g = scene(50, 48, 64, 0)
    n = g.means2d.shape[0]
    return [
        ("float64 means", dict(means2d=g.means2d.double()), {}),
        ("(N, 3) means", dict(means2d=torch.zeros(n, 3)), {}),
        ("float64 depths", dict(depths=g.depths.double()), {}),
        ("short depths", dict(depths=g.depths[:-1]), {}),
        ("(N, 2) conics", dict(conics=g.conics[:, :2]), {}),
        ("(N, 1) opacities", dict(opacities=g.opacities[:, None]), {}),
        ("int64 radii", dict(radii=g.radii.long()), {}),
        ("float mask", dict(mask=g.mask.float()), {}),
        ("numpy mask", dict(mask=g.mask.numpy()), {}),
        ("no gaussians", dict(means2d=g.means2d[:0], depths=g.depths[:0],
                              conics=g.conics[:0],
                              opacities=g.opacities[:0], radii=g.radii[:0],
                              mask=g.mask[:0]), {}),
        ("tile 0", {}, dict(tile=0)),
        ("float tile", {}, dict(tile=16.0)),
        ("no tiles across", {}, dict(n_tiles_x=0)),
        ("max_span 0", {}, dict(max_span=0)),
        ("bool max_span", {}, dict(max_span=True)),
        ("align 0", {}, dict(align=0)),
        ("pair_cap 0", {}, dict(pair_cap=0)),
        ("negative max_pairs", {}, dict(max_pairs=-1)),
        ("float max_pairs", {}, dict(max_pairs=100.0)),
        ("negative tail_capacity", {}, dict(tail_capacity=-2)),
        ("main_width None", {}, dict(main_width=None)),
        ("int64 valid_tiles_y", {}, dict(valid_tiles_y=torch.tensor(2))),
        ("float valid_tiles_y", {}, dict(valid_tiles_y=2.0)),
        ("two valid_tiles_y", {}, dict(valid_tiles_y=torch.tensor(
            [2, 3], dtype=torch.int32))),
        ("int32 overflow", {}, dict(n_tiles_x=2**16, n_tiles_y=2**15)),
    ]


BAD = _bad_args()


@pytest.mark.parametrize("case", range(len(BAD)),
                         ids=[name for name, _, _ in BAD])
def test_check_bin_refuses(case):
    _, edit, kw_edit = BAD[case]
    g = scene(50, 48, 64, 0)._replace(**edit)
    kw = dict(grid(48, 64), **CELL, max_pairs=None, tail_capacity=None,
              valid_tiles_y=None)
    kw.update(kw_edit)
    with pytest.raises(ValueError, match="bin_gaussians"):
        T._check_bin(g, **kw)


def test_check_bin_takes_every_option():
    g = scene(50, 48, 64, 0)
    base = dict(grid(48, 64), max_pairs=None, tail_capacity=None,
                valid_tiles_y=None)
    for kw in (dict(CELL), dict(max_span=3, pair_cap=None, main_width=4,
                                align=128),
               dict(max_span=5, pair_cap=9, main_width=6, align=8,
                    max_pairs=0, tail_capacity=0),
               dict(CELL, valid_tiles_y=2),
               dict(CELL, valid_tiles_y=torch.tensor(2, dtype=torch.int32))):
        T._check_bin(g, **dict(base, **kw))


def test_cuda_launcher_refuses_cpu_tensors():
    g = scene(50, 48, 64, 0)
    with pytest.raises(ValueError, match="CUDA"):
        T.bin_tiles_cuda(g, **grid(48, 64), **CELL)


def test_cpu_tensors_never_launch_the_kernel():
    """bin_gaussians on CPU tensors is the plain version, field for
    field, and neither counts a launch nor loads the library."""
    g = scene(300, 64, 96, 1)
    T.reset_launches()
    built = dict(cuda_build._LIBS)
    for kw in (CELL, dict(max_span=3, main_width=4, align=32,
                          tail_capacity=8),
               dict(CELL, valid_tiles_y=torch.tensor(2, dtype=torch.int32))):
        got = T.bin_gaussians(g, **grid(64, 96), **kw)
        want = T.bin_gaussians_plain(g, **grid(64, 96), **kw)
        for f in T.TileBinning._fields:
            a, b = getattr(got, f), getattr(want, f)
            assert (a == b) if f == "pair_slot_capacity" else torch.equal(
                a, b), f
    assert T.LAUNCHES == {"bin_tiles": 0}
    assert "bin_tiles" not in cuda_build._LIBS or "bin_tiles" in built


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: csrc/bin_tiles.cu runs only "
                    "there (no interpret mode)")
    return torch.device("cuda")


def _tie_scene(device):
    """Gaussians of equal depth sharing tiles: every third slot at one
    depth, a block of exact copies of one gaussian."""
    g = scene(3000, 128, 128, 7, device)
    d = g.depths.clone()
    d[::3] = 3.0
    fields = {}
    for name in ("means2d", "conics", "opacities", "radii", "mask"):
        v = getattr(g, name).clone()
        v[100:140] = v[99]
        fields[name] = v
    d[100:140] = d[99]
    return g._replace(depths=d, **fields)


# (name, scene maker (device -> Gaussians2D), (h, w), keywords)
CARD_CASES = [
    ("cell settings", lambda dev: scene(100000, 512, 512, 11, dev, spread=0.45),
     (512, 512), CELL),
    ("pair_cap None, tail overflow",
     lambda dev: scene(20000, 256, 320, 12, dev),
     (256, 320), dict(max_span=3, main_width=4, align=128,
                      tail_capacity=128)),
    ("pair_cap None, default tail",
     lambda dev: scene(20000, 256, 320, 12, dev),
     (256, 320), dict(max_span=3, main_width=4, align=128)),
    ("cull off", lambda dev: scene(20000, 256, 256, 13, dev), (256, 256),
     dict(CELL, cull=False)),
    ("truncating max_pairs", lambda dev: scene(20000, 256, 256, 14, dev),
     (256, 256), dict(CELL, max_pairs=5000)),
    ("max_pairs 0", lambda dev: scene(2000, 64, 64, 14, dev), (64, 64),
     dict(CELL, max_pairs=0)),
    ("valid_tiles_y int", lambda dev: scene(20000, 256, 256, 15, dev),
     (256, 256), dict(CELL, valid_tiles_y=7)),
    ("valid_tiles_y tensor", lambda dev: scene(20000, 256, 256, 15, dev),
     (256, 256), dict(CELL, valid_tiles_y="tensor 9")),
    ("equal depths sharing tiles", _tie_scene, (128, 128), CELL),
    ("empty tiles", lambda dev: scene(3000, 512, 512, 16, dev, spread=0.08),
     (512, 512), CELL),
    ("all masked", lambda dev: scene(3000, 128, 128, 17, dev,
                                     alive_frac=0.0), (128, 128), CELL),
    ("wide spans, padding", lambda dev: scene(7001, 380, 500, 18, dev),
     (380, 500), dict(max_span=8, main_width=6, align=128)),
    ("pair_cap over the span", lambda dev: scene(5000, 96, 96, 19, dev),
     (96, 96), dict(max_span=2, pair_cap=9, main_width=2, align=8)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(CARD_CASES)),
                         ids=[c[0] for c in CARD_CASES])
def test_kernel_equals_plain_on_the_card(cuda_device, case):
    name, make, (h, w), kw = CARD_CASES[case]
    kw = dict(kw)
    if kw.get("valid_tiles_y") == "tensor 9":
        kw["valid_tiles_y"] = torch.tensor(9, dtype=torch.int32,
                                           device=cuda_device)
    g = make(cuda_device)
    want = T.bin_gaussians_plain(g, **grid(h, w), **kw)
    T.reset_launches()
    got = T.bin_gaussians(g, **grid(h, w), **kw)
    again = T.bin_gaussians(g, **grid(h, w), **kw)
    torch.cuda.synchronize()
    assert T.LAUNCHES == {"bin_tiles": 2}
    for f in T.TileBinning._fields:
        a, b, c = getattr(got, f), getattr(want, f), getattr(again, f)
        if f == "pair_slot_capacity":
            assert a == b == c, f
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.is_contiguous(), f
        assert torch.equal(a, b), f"{name}: {f}"
        assert torch.equal(a, c), f"{name}: {f} (second call)"
    if name == "all masked":
        assert int(got.num_pairs) == 0
    if name == "truncating max_pairs":
        assert int(got.overflow) > 0
    if name == "empty tiles":
        seg = got.tile_offsets[1:] - got.tile_offsets[:-1]
        assert int((seg == 0).sum()) > 0 and int(got.num_pairs) > 0
