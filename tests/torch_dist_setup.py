"""Both packages' inputs of the sharded step tests, from
tests/test_dist.py's _sharded_setup: the tiny synthetic avatar of
__graft_entry__._tiny_setup (64x64 frame, capacity 512), the JAX
package's step config (LPIPS on random features, 4 patches of 32,
gradient pyramid, silhouette), max_span 8 and main_width 64 so that
strips and the full frame bin the same pairs, and the region laplacian.
port_setup() is the port's side as numpy leaves (torch_dist_work.
sharded_step rebuilds the tensors on each rank); jax_step runs the JAX
package's sharded step on a mesh of the 8-device CPU backend, the
Pallas kernels in interpret mode, with SGD at learning rate 1 that
keeps the gradients (test_torch_case_step.jax_sgd).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sings_tpu.dist.shard import make_mesh as jmake_mesh
from sings_tpu.dist.shard import replicate, shard_batch
from sings_tpu.dist.train_sharded import make_sharded_train_step as jstep
from sings_tpu_torch.fields.decoders import DecoderConfig
from sings_tpu_torch.fields.triplane import TriplaneConfig
from sings_tpu_torch.kinematics.body_model import synthetic_template
from sings_tpu_torch.kinematics.template import (
    DeviceTemplate, canonical_pose_cache,
)
from sings_tpu_torch.losses.lpips import lpips_params_from_numpy
from sings_tpu_torch.losses.photometric import PhotometricWeights
from sings_tpu_torch.losses.regularizers import (
    L2NormConfig, build_region_laplacian,
)
from sings_tpu_torch.model.avatar import AvatarConfig
from sings_tpu_torch.ops.graphics import make_camera
from sings_tpu_torch.train import step as tstep
from sings_tpu_torch.train.checkpoint import (
    buffers_from_numpy, params_from_numpy,
)
from test_dist import _make_batch, _sharded_setup, _srl
from test_torch_case_step import jax_sgd
from test_torch_losses import jax_step_draws
from torch_dist_work import _np_tree

# tests/test_dist.py's tolerances: the sharded step at (1, 1) against
# the single-card one (and, the decompositions being equal, any mesh
# against JAX's same mesh)
METRIC_RTOL, METRIC_ATOL = 2e-4, 1e-7
PARAM_RTOL, PARAM_ATOL_REL = 1e-3, 1e-4
ACCUM_RTOL = 1e-3
# ... and gs > 1 against gs 1 (:200, :428): reassociation and T_EPS
# early-exit flips of deeply occluded gaussians
LOSS_RTOL_GS = 5e-4
GRAD_RTOL_GS = 0.05
METRICS = ("loss", "photo", "reg_l2", "connect", "lap_pos", "lap_color",
           "photo_l1", "photo_ssim", "photo_lpips_patch", "photo_sil",
           "photo_grad_pyr", "skipped")


@functools.lru_cache(maxsize=1)
def jax_setup():
    return _sharded_setup()


def port_step_cfg(jsc):
    jw = jsc.weights
    tw = tstep.LossWeights(**{
        **jw._asdict(),
        "photometric": PhotometricWeights(**jw.photometric._asdict()),
        "l2": L2NormConfig(**jw.l2._asdict())})
    return tstep.StepConfig(**{**jsc._asdict(), "weights": tw})


@functools.lru_cache(maxsize=1)
def port_setup() -> dict:
    (dt, cache, cfg, state, camera, kw, step_cfg, lpips_params, region_lap,
     lap_w) = jax_setup()
    tpl = synthetic_template(num_betas=10, n_seg=4, n_ring=8)
    tcfg = AvatarConfig(**{**cfg._asdict(),
                           "triplane": TriplaneConfig(*cfg.triplane),
                           "decoder": DecoderConfig(*cfg.decoder)})
    tdt = DeviceTemplate.from_host(tpl)
    b = state.buffers
    edges = np.asarray(b.edges)[np.asarray(b.edge_valid) > 0.5]
    labels = np.where(np.asarray(b.alive) > 0.5, np.asarray(b.vertex_label),
                      -1)
    frame = jax.tree.map(lambda x: np.asarray(x[0]), _make_batch(camera, 1))
    return _np_tree({
        "cfg": tcfg, "step_cfg": port_step_cfg(step_cfg), "template": tdt,
        "cache": canonical_pose_cache(tdt, torch.zeros(10), "da_pose"),
        "camera": make_camera(np.eye(4), height=camera.height,
                              width=camera.width, fovx=0.9, fovy=0.9),
        "lpips": lpips_params_from_numpy(
            [(np.asarray(w), np.asarray(bb)) for w, bb in lpips_params.convs],
            [np.asarray(x) for x in lpips_params.lins],
            lpips_params.pretrained),
        "raster": {k: v for k, v in kw.items() if k != "interpret"},
        "params": params_from_numpy(jax.tree.map(np.asarray, state.params)),
        "buffers": buffers_from_numpy(jax.tree.map(np.asarray, b)),
        "lap": build_region_laplacian(edges, labels, np.ones(15),
                                      num_regions=15, pad_to=8),
        "lap_w": torch.ones(15),
        "frame": {"rgb": frame["rgb"], "mask": frame["mask"], "idx": 0,
                  "smpl_scale": frame["smpl_scale"]}})


def draws(rng, dp: int) -> list:
    """The draws of JAX's sharded step for each dp rank:
    fold_in(rng, dp_idx), in the port's draw_step_randoms layout."""
    (_, _, _, _, camera, _, step_cfg, _, _, _) = jax_setup()
    mask = np.ones((camera.height, camera.width), np.float32)
    return [_np_tree(jax_step_draws(jax.random.fold_in(rng, d), mask,
                                    step_cfg.weights.photometric)[1])
            for d in range(dp)]


def frames(dp: int) -> list:
    """One frame per dp rank, as numpy: the setup's frame, then frames
    whose target rgb is seeded noise, so that every dp rank trains on
    its own objective."""
    f0 = port_setup()["frame"]
    rs = np.random.RandomState(5)
    return [f0] + [dict(f0, rgb=rs.uniform(0.0, 1.0, f0["rgb"].shape)
                        .astype(np.float32)) for _ in range(1, dp)]


def jax_step(rng, dp: int, gs: int, grads_only: bool = False,
             bounds=None, h_max=None, frames=None):
    """JAX's sharded step (or its grads_fn) on a (dp, gs) mesh, as
    numpy. frames: one frame per dp rank (frames()), or None for
    tests/test_dist.py's batch (the same frame on every dp rank)."""
    (dt, cache, cfg, state, camera, kw, step_cfg, lpips_params, region_lap,
     lap_w) = jax_setup()
    tx = jax_sgd()
    mesh = jmake_mesh(dp * gs, dp=dp)
    fn = jstep(mesh, cfg, step_cfg, dt, camera, tx, lpips_params, kw,
               strip_bounds=bounds, strip_h_max=h_max)
    if frames is None:
        batch = _make_batch(camera, dp)
    else:
        batch = {k: jnp.stack([jnp.asarray(f[k]) for f in frames])
                 for k in ("rgb", "mask", "smpl_scale")}
        batch["idx"] = jnp.asarray([f["idx"] for f in frames], jnp.int32)
    rl = _srl(region_lap, gs)
    with mesh:
        rep = functools.partial(replicate, mesh=mesh)
        if grads_only:
            loss, g = fn.grads_fn(
                rep(state.params), rep(state.buffers), rep(cache),
                shard_batch(batch, mesh), rng, jnp.asarray(0),
                jnp.asarray(0), rl, rl, rep(lap_w), rep(lap_w))
            return float(loss), jax.tree.map(np.asarray, g)
        p, b, o, m = fn(rep(state.params), rep(state.buffers),
                        tx.init(state.params), rep(cache),
                        shard_batch(batch, mesh), rng, 0, 0, rl, rl,
                        rep(lap_w), rep(lap_w))
    return jax.tree.map(np.asarray, (p, b, o["g"], m))


def check_metrics(got: dict, want: dict, rtol=METRIC_RTOL,
                  atol=METRIC_ATOL):
    for k in METRICS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


def check_grads(got, want, rtol=PARAM_RTOL, atol_rel=PARAM_ATOL_REL):
    """The port's gradient tree (AvatarParams of numpy) against JAX's,
    leaf by leaf in tree order, atol relative to the leaf's largest."""
    from sings_tpu_torch.tree import tree_leaves

    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for i, (a, b) in enumerate(zip(gl, wl)):
        b = np.asarray(b)
        assert not np.isnan(b).any(), f"NaN gradient, leaf {i}"
        scale = max(np.abs(b).max(), 1e-12)
        np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                                   atol=atol_rel * scale,
                                   err_msg=f"leaf {i}")


def check_density(got_b, want_b):
    """xyz_grad_accum and max_radii2d (tests/test_dist.py's (1, 1)
    check)."""
    np.testing.assert_allclose(np.asarray(got_b.xyz_grad_accum),
                               np.asarray(want_b.xyz_grad_accum),
                               rtol=ACCUM_RTOL, atol=1e-9)
    np.testing.assert_allclose(np.asarray(got_b.max_radii2d),
                               np.asarray(want_b.max_radii2d), atol=1e-4)
