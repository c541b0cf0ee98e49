"""The yardstick's operation and byte counts on hand-checked shapes."""
import pytest
import torch

from counts import composite, flops, peaks, triplane


def test_composite_forward_counts():
    ops, nbytes = composite.fwd(walked=10, n_tiles=4, tile=16)
    assert ops == 16 * 10 * 256
    assert nbytes == 4 * (9 * 10 + 2 * 5 + 4 * 8 * 256)


def test_composite_backward_counts():
    ops, nbytes = composite.bwd(walked=10, composited=100, n_tiles=4,
                                tile=16, grad_cap=256)
    assert ops == 19 * 10 * 256 + 34 * 100
    assert nbytes == 4 * (9 * 10 + 2 * 5 + 2 * 4 * 4 * 256 + 9 * 256)


def test_triplane_bytes_at_the_recipe_field():
    """The nested 64^3 triplane at multires [1, 2, 4], 32 channels,
    127,744 points: 118,870,272 bytes (chip_smoke.py's phase 16)."""
    planes = [32 * (64 * m + 1) ** 2 for m in (1, 2, 4) for _ in range(3)]
    assert triplane.bwd_bytes(127744, 96, planes) == 118870272


def test_bound_takes_the_larger_time():
    assert peaks.bound_s(67e12, 0) == (1.0, "operations")
    assert peaks.bound_s(0, 3.35e12) == (1.0, "bytes")


def test_per_point_counts():
    assert flops.decoder_fwd({"a": (96, 128), "b": (128, 3)}) == (
        2 * 96 * 128 + 2 * 128 * 3)
    assert flops.triplane_fwd(32, 3) == 3 * (3 * 256 + 64)
    assert flops.triplane_bwd(32, 3) == 3 * 3 * (256 + 512 + 64)
    assert flops.lbs_fwd(52) == 52 * 24 + 21 + 54


def test_train_step_sum():
    s = {"n_live": 2, "n_edges": 3, "geo": {"a": (1, 1)},
         "app": {"b": (1, 2)}, "c": 1, "scales": 1, "joints": 1,
         "patches": 1, "patch": 1, "height": 1, "width": 1, "params": 5,
         "k": 2, "composite_fwd_ops": 7, "composite_bwd_ops": 11}
    per_point = (3 * (2 + 4 + flops.lbs_fwd(1) + flops.PREPROCESS_OPS
                      + flops.REG_OPS) + flops.triplane_fwd(1, 1)
                 + flops.triplane_bwd(1, 1))
    want = (2 * per_point + 3 * 8 * 3 + 3 * flops.PHOTO_OPS * 3 + 3 * 10
            + 8 * 4 / 2 + 14 * 5 + 7 + 11)
    assert flops.train_step(s) == pytest.approx(want)


def test_anim_frame_sum():
    s = {"n_live": 2, "geo": {"a": (1, 1)}, "app": {"b": (1, 2)}, "c": 1,
         "scales": 1, "joints": 1, "frames_per_decode": 4, "height": 1,
         "width": 1, "composite_fwd_ops": 7}
    want = (2 * (2 + 4 + flops.triplane_fwd(1, 1)) / 4
            + 2 * (flops.lbs_fwd(1) + flops.PREPROCESS_OPS) + 15 + 7)
    assert flops.anim_frame(s) == pytest.approx(want)


def test_the_plain_walk_counts_walked_and_composited_pairs():
    """One 16x16 tile, two faint pairs at its centre: both are walked,
    neither ends the walk, and each composites at the pixels where its
    alpha passes 1/255."""
    from reference.plain.ops.rasterizer.kernels import (
        NFEAT, composite_bwd_plain, composite_fwd_plain, state_shape,
    )

    chunk = 8
    feats = torch.zeros((NFEAT, 2 + chunk))
    feats[0, :2] = 7.5
    feats[1, :2] = 7.5
    feats[2, :2] = 0.5          # conic a
    feats[4, :2] = 0.5          # conic c
    feats[5:8, :2] = 0.5
    feats[8, :2] = 0.2
    offsets = torch.tensor([0, 2], dtype=torch.int32)
    kw = dict(tile=16, chunk=chunk, n_tiles_x=1, n_tiles_y=1)
    gof = torch.tensor([0, chunk], dtype=torch.int32)
    out, state, walked = composite_fwd_plain(
        feats, offsets, grad_offsets=gof, grad_cap=2 * chunk,
        return_walked=True, **kw)
    assert walked == 2
    assert state.shape == state_shape(grad_cap=2 * chunk, chunk=chunk,
                                      tile=16)
    gout = torch.zeros_like(out)
    gout[:, :4] = 1.0
    _g, walked_b, composited = composite_bwd_plain(
        feats, offsets, gof, out, gout, state, grad_cap=2 * chunk,
        return_counts=True, **kw)
    # alpha = 0.2 exp(-0.25 (dx^2 + dy^2)) >= 1/255 out to d^2 <= 6.4
    ys, xs = torch.meshgrid(torch.arange(16.0), torch.arange(16.0),
                            indexing="ij")
    d2 = (xs - 7.5) ** 2 + (ys - 7.5) ** 2
    inside = int((0.2 * torch.exp(-0.25 * d2) >= 1 / 255).sum())
    assert walked_b == 2
    assert composited == 2 * inside
