"""The port's collectives (sings_tpu_torch/dist/collectives.py) and halo
SSIM (dist/halo.py) on a module-scoped gloo world of 4 ranks
(tests/torch_dist_work.py), the SSIM held against sings_tpu's on a
4-device sub-mesh of the 8-device CPU backend.

Held: all_gather_rows and ppermute with their transposes (psum_scatter,
the inverse permutation), psum / pmean / pmax, broadcast_tree and
trees_equal, every value exact; make_mesh's row-major layout, replicate,
shard_batch and make_sharded_step on a (2, 2) mesh; strip_ssim over 4
equal strips against JAX's strip_ssim and the full image's ssim at
tests/test_dist.py:405's rtol 1e-5; the balanced form over bounds [0,
48, 64] (2 ranks, 48-row windows with garbage padding) against JAX's at
:486's rtol 2e-5 / atol 2e-6; the gradient through the halo exchange,
gathered over the ranks, against jax.grad of the full image's ssim at
the rasterizer's gradient tolerance (atol 2e-4 max|g|, rtol 2e-3) and
against the port's own full-image gradient at float32 rounding.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from sings_tpu.dist.halo import strip_ssim as jstrip_ssim
from sings_tpu.dist.halo import strip_ssim_local_bounded as jbounded
from sings_tpu.dist.shard import make_mesh as jmake_mesh
from sings_tpu.ops.ssim import ssim as jssim
from sings_tpu_torch.ops.ssim import ssim as tssim
from torch_dist_work import collectives, mesh_helpers, rank_info, \
    strip_ssim, two_torch_threads, world_fixture  # noqa: F401

world = world_fixture(4)


def _images(h, w, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(3, h, w).astype(np.float32),
            rng.rand(3, h, w).astype(np.float32))


def _grad_close(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-3,
                               atol=2e-4 * np.abs(want).max())


def _torch_grad(pred, gt):
    p = torch.tensor(pred, requires_grad=True)
    (g,) = torch.autograd.grad(tssim(p, torch.tensor(gt)), [p])
    return g.numpy()


def test_world_is_gloo(world):
    assert world.run(rank_info) == [(r, 4, "gloo") for r in range(4)]


def test_collectives_and_their_transposes(world):
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3) * 0.5
    outs = world.run(collectives, x=x)
    w = np.arange(x.size, dtype=np.float32).reshape(x.shape)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["full"], x)
        # the group's summed loss is 4 sum(w * full)
        np.testing.assert_array_equal(o["grad_gather"],
                                      4 * w[4 * r: 4 * r + 4])
        np.testing.assert_array_equal(o["shifted"],
                                      x[4 * ((r - 1) % 4): 4 * ((r - 1) % 4)
                                        + 4])
        # rank r's rows went to rank r + 1, whose term weighs them r + 2
        np.testing.assert_array_equal(o["grad_ppermute"],
                                      np.full((4, 3), (r + 1) % 4 + 1.0))
        np.testing.assert_array_equal(o["psum"], [6.0, -6.0])
        np.testing.assert_array_equal(o["pmean"], [1.5, -1.5])
        np.testing.assert_array_equal(o["pmax"], [3.0, 0.0])
        np.testing.assert_array_equal(o["bcast"], [3.0])
        assert o["equal"] and not o["unequal"]


def test_mesh_helpers_on_a_2x2_mesh(world):
    outs = world.run(mesh_helpers)
    x = np.arange(6.0).reshape(2, 3)
    # the loss averaged over the 4 ranks: frame d's row, strip s's weight
    want_grad = sum((s + 1) * x[d] for d in range(2) for s in range(2)) / 4
    for r, o in enumerate(outs):
        d, g = divmod(r, 2)
        assert o["coords"] == (d, g) and o["shape"] == {"dp": 2, "gs": 2}
        assert o["ranks"] == [[0, 1], [2, 3]]
        np.testing.assert_array_equal(o["params"], np.ones(3))
        np.testing.assert_array_equal(o["frame"], x[d])
        np.testing.assert_allclose(o["grad"], want_grad, rtol=1e-6)
        np.testing.assert_allclose(o["loss"], want_grad.sum(), rtol=1e-6)


def test_strip_ssim_matches_jax_and_the_full_image(world):
    pred, gt = _images(64, 32)
    full = float(jssim(jnp.asarray(pred), jnp.asarray(gt)))
    mesh = jmake_mesh(4, dp=1)
    fn = shard_map(lambda p, g: jstrip_ssim(p, g, "gs"), mesh=mesh,
                   in_specs=(P(None, "gs", None), P(None, "gs", None)),
                   out_specs=P(), check_vma=False)
    with mesh:
        jdist = float(fn(jnp.asarray(pred), jnp.asarray(gt)))
    outs = world.run(strip_ssim, pred=pred, gt=gt)
    for o in outs:
        np.testing.assert_allclose(o["total"], jdist, rtol=1e-5)
        np.testing.assert_allclose(o["total"], full, rtol=1e-5)
    np.testing.assert_allclose(sum(o["local"] for o in outs), full,
                               rtol=1e-5)
    grad = np.concatenate([o["grad"] for o in outs], axis=1)
    _grad_close(grad, np.asarray(jax.grad(
        lambda p: jssim(p, jnp.asarray(gt)))(jnp.asarray(pred))))
    np.testing.assert_allclose(grad, _torch_grad(pred, gt), rtol=1e-4,
                               atol=1e-6 * np.abs(grad).max())


def test_bounded_strip_ssim_matches_jax(world):
    """tests/test_dist.py:486 in the port, on ranks 0 and 1 of the world
    (the other two stay out of the mesh)."""
    h, wd = 64, 48
    pred, gt = _images(h, wd)
    bounds = np.asarray([0, 48, 64], np.int32)
    h_max = 48
    outs = world.run(strip_ssim, pred=pred, gt=gt, bounds=bounds,
                     h_max=h_max, ranks=[0, 1])
    assert outs[2] is None and outs[3] is None
    outs = outs[:2]

    def window(x, k):
        win = jnp.zeros((3, h_max, wd)) + 0.777
        own = jnp.asarray(x)[:, bounds[k]: bounds[k + 1]]
        return win.at[:, : own.shape[1]].set(own)

    mesh = jmake_mesh(2, dp=1)

    @partial(shard_map, mesh=mesh, in_specs=(P("gs"), P("gs"), P("gs")),
             out_specs=P("gs"), check_vma=False)
    def run(wa, wb, ho):
        return jbounded(wa[0], wb[0], "gs", ho[0, 0], float(h * wd))[None]

    with mesh:
        jloc = np.asarray(run(
            jnp.stack([window(pred, k) for k in range(2)]),
            jnp.stack([window(gt, k) for k in range(2)]),
            jnp.asarray(np.diff(bounds).astype(np.int32))[:, None]))
    for o, want in zip(outs, jloc):
        np.testing.assert_allclose(o["local"], want, rtol=2e-5, atol=2e-6)
    full = float(jssim(jnp.asarray(pred), jnp.asarray(gt)))
    np.testing.assert_allclose(outs[0]["total"], full, rtol=2e-5, atol=2e-6)
    # the owned rows' gradient; the padding rows belong to the next rank
    # (their cotangent is zeroed by the bounded exchange)
    grad = np.concatenate([o["grad"][:, : bounds[k + 1] - bounds[k]]
                           for k, o in enumerate(outs)], axis=1)
    assert not outs[1]["grad"][:, bounds[2] - bounds[1]:].any()
    _grad_close(grad, np.asarray(jax.grad(
        lambda p: jssim(p, jnp.asarray(gt)))(jnp.asarray(pred))))
    np.testing.assert_allclose(grad, _torch_grad(pred, gt), rtol=1e-4,
                               atol=1e-6 * np.abs(grad).max())
