"""The training step: forward -> render -> losses -> update (port of
sings_tpu/train/step.py).

make_train_step builds one step: avatar_forward with the decoder-warmup
gradient gates, rasterize forward and backward (composite_fwd /
composite_bwd), the photometric and silhouette losses, the regularisers
(l2, mesh edge, KNN edge from a statistic, the fused region
laplacian), Adam with per-field learning rates behind the non-finite
guard, and the density statistics from the screen_probe gradient.
make_train_scan chains K steps in a Python loop, with the KNN edge
statistic computed once at the head of the chunk when asked
(knn_backend "chunk"); "dense" and "window" compute it every step.
The step's output gates (gate_outputs), leaf gradient (grad_leaves,
leaf_grads) and guarded Adam update (guarded_update) are shared with
dist/train_sharded.py's step.
With an LPIPS network the photometric loss adds the LPIPS term on the
masked patches, its gradient by autograd through the VGG features.

The step number is a Python int here (the JAX step traces it), so the
warmup gates, the laplacian ramp and the opacity-norm switch are
decided on the host; the non-finite guard stays on the device
(torch.where), so it never makes the step wait for the card (the
decode's copies of host data to the card do; the posing,
kinematics/pose.py, and the binning, ops/rasterizer/tiles.py::
bin_gaussians, wait only in their plain versions). Every random
draw of a step comes from losses.photometric.draw_step_randoms; a step
also takes the draws as an argument.

Each stage runs in an ops/profiling.py span that a profiler records:
step.knn_stat at the chunk head, then step.draws (where the step draws
its own randoms), step.decode, step.rasterize, step.losses,
step.backward and step.update in every step. Inside step.losses,
losses.laplacian holds the fused laplacian terms, and the statistic
and the options hold their own: losses.knn_exact (the exact statistic,
where a step computes it; at a chunk's head it nests in
step.knn_stat), losses.lpips (the LPIPS term) and losses.knn_window
(the windowed statistic).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..losses.lpips import LPIPSParams, lpips_distance
from ..losses.photometric import (
    PhotometricWeights, draw_step_randoms, photometric_loss,
)
from ..losses.regularizers import (
    L2NormConfig, RegionLaplacian, gaussians_edge_loss,
    gaussians_edge_loss_from_stat, l2_norm_loss, mesh_edge_loss,
)
from ..model.avatar import AvatarBuffers, AvatarConfig, avatar_forward
from ..ops.graphics import Camera
from ..ops.profiling import span
from ..ops.rasterizer.api import rasterize
from ..tree import tree_leaves, tree_map


class LossWeights(NamedTuple):
    photometric: PhotometricWeights = PhotometricWeights()
    l2: L2NormConfig = L2NormConfig()
    # alpha-vs-mask supervision: mean (1 - T_final - mask)^2; 0 = off
    silhouette: float = 0.0
    mesh_edge: float = 1e4
    gaussian_connect: float = 5e3
    lap_position_strength: float = 1000.0
    lap_color_strength: float = 5.0
    lap_impose_from: int = 1000
    lap_double_after: int = 8000
    hand_lap_weight: float = 1e-5
    hand_strength: float = 1000.0


class StepConfig(NamedTuple):
    weights: LossWeights
    opt_geo_from: int
    opt_app_from: int
    opacity_norm_from: int        # max(prune_until, densify_until)
    knn_k: int = 9
    # "dense": the exact KNN statistic every step; "window": the
    # Morton-window statistic every step (approximate, opt-in); "chunk":
    # the exact statistic once per make_train_scan chunk, held across
    # its steps
    knn_backend: str = "dense"
    # region_lap_pos and region_lap_color are one laplacian: the colour
    # term joins the fused gather
    lap_shared: bool = False


def sh_degree_mask(active_degree: int, device="cpu") -> torch.Tensor:
    """(16,) mask zeroing SH bands above the active degree (coefficient
    i has band floor(sqrt(i)); built on the device, no host copy)."""
    band = torch.sqrt(torch.arange(16, dtype=torch.float32,
                                   device=device)).floor()
    return (band <= active_degree).to(torch.float32)


def _gate_grad(x: torch.Tensor, flag: bool) -> torch.Tensor:
    """Value-identical; the gradient flows only when flag is true (JAX's
    where(flag, x, stop_gradient(x)) with a host flag)."""
    return x if flag else x.detach()


def gate_outputs(out: dict, step_cfg: StepConfig, step: int) -> dict:
    """avatar_forward's outputs with the decoder-warmup gates: the
    geometry outputs pass a gradient from opt_geo_from on, the
    appearance outputs from opt_app_from on."""
    opt_geo = step >= step_cfg.opt_geo_from
    opt_app = step >= step_cfg.opt_app_from
    for k in ("xyz_canon", "xyz_offsets", "scales", "scales_canon"):
        out[k] = _gate_grad(out[k], opt_geo)
    for k in ("shs", "opacity"):
        out[k] = _gate_grad(out[k], opt_app)
    return out


def grad_leaves(params):
    """Detached copies of params' leaves that require a gradient: the
    leaves a step differentiates (leaf_grads)."""
    return tree_map(lambda x: x.detach().requires_grad_(True), params)


def leaf_grads(loss: torch.Tensor, p, probe: torch.Tensor | None = None):
    """d loss / d p as a tree like p (zeros for the leaves the loss does
    not use), and d loss / d probe when a screen probe is passed (else
    None). p: grad_leaves' tree."""
    leaves = tree_leaves(p) + ([] if probe is None else [probe])
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    probe_grad = grads.pop() if probe is not None else None
    it = iter(grads)
    return tree_map(lambda _: next(it), p), probe_grad


def guarded_update(tx, grads, opt_state, params, loss: torch.Tensor):
    """tx.update behind the non-finite guard: where the loss or any
    gradient is not finite, the whole update is skipped (parameters and
    moments), on the device (torch.where, no host wait). Returns
    (params, opt_state, finite)."""
    finite = torch.isfinite(loss.detach())
    for g in tree_leaves(grads):
        finite = finite & torch.isfinite(g).all()
    new_params, new_state = tx.update(grads, opt_state, params)

    def keep(new, old):
        return torch.where(finite, new.detach(), old)

    return (tree_map(keep, new_params, params),
            tree_map(keep, new_state, opt_state), finite)


def regularizer_terms(step_cfg: StepConfig, out: dict,
                      buffers: AvatarBuffers, step: int, region_lap_pos,
                      region_lap_color, lap_pos_w, lap_color_w, connect_fn,
                      n_rep: int = 1) -> dict:
    """The per-gaussian regularisers of the objective, from
    avatar_forward's gated outputs: l2 and mesh edge, divided by n_rep
    (the ranks that each compute them whole; 1 on one card), the KNN
    edge term as connect_fn(xyz_canon, scales, alive) gives it, and the
    region laplacians with the impose ramp and the hand term.
    region_lap_*: RegionLaplacian-like (loss_fused); the sharded step
    passes this rank's ShardedRegionLaplacian rows. Returns 0-d tensors
    under reg_l2, mesh_edge, connect, lap_pos, lap_color and hand_lap."""
    w = step_cfg.weights
    alive = buffers.alive
    zero = torch.zeros((), device=alive.device)
    # the opacity-norm term joins after density control ends
    reg = l2_norm_loss(w.l2, out["xyz_offsets"], out["scales"],
                       out["opacity"] if step >= step_cfg.opacity_norm_from
                       else None, alive) / n_rep
    edge = zero if w.mesh_edge == 0 else w.mesh_edge * mesh_edge_loss(
        out["xyz_canon"].detach(), buffers.edges, buffers.edge_valid) / n_rep
    connect = zero if w.gaussian_connect == 0 else (
        w.gaussian_connect * connect_fn(out["xyz_canon"].detach(),
                                        out["scales"], alive))

    pos_terms = []
    if w.lap_position_strength != 0:
        pos_terms.append((out["xyz_anchor_canon"], lap_pos_w, None))
    hand_on = w.hand_lap_weight * w.hand_strength != 0
    if hand_on:
        pos_terms.append((out["xyz_canon"], torch.ones_like(lap_pos_w),
                          [6, 7]))
    color_on = w.lap_color_strength != 0
    if color_on and step_cfg.lap_shared:
        pos_terms.append((out["shs"][:, 0], lap_color_w, None))
    with span("losses.laplacian"):
        fused = region_lap_pos.loss_fused(pos_terms) if pos_terms else []
        lap_pos = fused.pop(0) if w.lap_position_strength != 0 else zero
        hand_raw = fused.pop(0) if hand_on else zero
        if color_on:
            lap_color = (fused.pop(0) if step_cfg.lap_shared
                         else region_lap_color.loss_fused(
                             [(out["shs"][:, 0], lap_color_w, None)])[0])
        else:
            lap_color = zero
    ramp = min(max((step - w.lap_impose_from)
                   / max(w.lap_impose_from, 1), 0.0), 1.0)
    alpha = w.lap_position_strength * ramp * (
        2.0 if step > w.lap_double_after else 1.0)
    return {"reg_l2": reg, "mesh_edge": edge, "connect": connect,
            "lap_pos": alpha * lap_pos,
            "lap_color": w.lap_color_strength * lap_color,
            "hand_lap": w.hand_lap_weight * w.hand_strength * hand_raw}


def make_train_step(avatar_cfg: AvatarConfig, step_cfg: StepConfig,
                    template, camera: Camera | None, tx,
                    lpips_params: LPIPSParams | None, raster_kw: dict):
    """Build the step. tx: train.optim.Optimizer. lpips_params: the
    LPIPS network (losses/lpips.py), or None for no LPIPS term.

    step(params, buffers, opt_state, cache, batch, generator, step,
         active_sh_degree, region_lap_pos, region_lap_color, lap_pos_w,
         lap_color_w, edge_stat=None, draws=None, camera=None)
      -> (params, buffers, opt_state, metrics, render)

    batch: 'rgb' (3, H, W), 'mask' (H, W), 'idx' (int or 0-d tensor),
    optional 'smpl_scale'. draws: the output of draw_step_randoms, or
    None to draw from `generator`. camera: this call's Camera, or None
    for the one the step was built with (the case step passes each
    case's). metrics are 0-d tensors on the device.
    """
    w = step_cfg.weights
    built_camera = camera
    lpips_fn = None
    if lpips_params is not None:
        def lpips_fn(a, b):
            return lpips_distance(lpips_params, a, b)

    def train_step(params, buffers: AvatarBuffers, opt_state, cache,
                   batch: dict, generator, step: int, active_sh_degree: int,
                   region_lap_pos: RegionLaplacian,
                   region_lap_color: RegionLaplacian, lap_pos_w, lap_color_w,
                   edge_stat=None, draws=None, camera=None):
        dev = buffers.alive.device
        cam = built_camera if camera is None else camera
        if draws is None:
            with span("step.draws"):
                draws = draw_step_randoms(generator, batch["mask"],
                                          w.photometric)
        bg = draws["bg"]
        with span("step.decode"):
            deg_mask = sh_degree_mask(active_sh_degree, dev)

            p = grad_leaves(params)
            probe = torch.zeros((avatar_cfg.capacity, 2), device=dev,
                                requires_grad=True)
            out = gate_outputs(avatar_forward(
                p, buffers, avatar_cfg, template, cache,
                smpl_scale=batch.get("smpl_scale"),
                dataset_idx=batch["idx"]), step_cfg, step)

        with span("step.rasterize"):
            shs = out["shs"] * deg_mask[None, :, None]
            pkg = rasterize(out["xyz"], out["scales"], out["rotq"],
                            out["opacity"][:, 0], shs, cam, sh_degree=3,
                            bg=bg, alive=buffers.alive > 0.5,
                            screen_probe=probe, backend="pallas",
                            **raster_kw)
        # no clamp: the losses read the raw render
        render = pkg["render"]

        def connect_fn(xyz_canon, scales, alive):
            if edge_stat is not None:
                return gaussians_edge_loss_from_stat(edge_stat, scales, alive)
            return gaussians_edge_loss(
                xyz_canon, scales, alive, k=step_cfg.knn_k,
                backend=("dense" if step_cfg.knn_backend == "chunk"
                         else step_cfg.knn_backend))

        with span("step.losses"):
            photo, photo_d = photometric_loss(draws, render, batch["rgb"],
                                              batch["mask"], bg,
                                              w.photometric, lpips_fn)
            if w.silhouette != 0:
                sil = 1.0 - pkg["transmittance"]
                l_sil = torch.mean((sil - batch["mask"]) ** 2)
                photo = photo + w.silhouette * l_sil
                photo_d = dict(photo_d, sil=w.silhouette * l_sil)

            r = regularizer_terms(step_cfg, out, buffers, step,
                                  region_lap_pos, region_lap_color,
                                  lap_pos_w, lap_color_w, connect_fn)
            reg, edge, connect = r["reg_l2"], r["mesh_edge"], r["connect"]
            lap_pos_loss, lap_color_loss = r["lap_pos"], r["lap_color"]
            hand_lap = r["hand_lap"]

            total = (photo + reg + edge + connect + lap_pos_loss
                     + lap_color_loss + hand_lap)

        with span("step.backward"):
            grad_tree, probe_grad = leaf_grads(total, p, probe)

        with span("step.update"):
            params, opt_state, finite = guarded_update(
                tx, grad_tree, opt_state, params, total)

            # density-control statistics
            acc = pkg["visibility_filter"] & finite
            radii = pkg["radii"].to(torch.float32)
            buffers = buffers._replace(
                max_radii2d=torch.where(
                    acc, torch.maximum(buffers.max_radii2d, radii),
                    buffers.max_radii2d),
                xyz_grad_accum=buffers.xyz_grad_accum + torch.where(
                    acc, torch.linalg.norm(probe_grad, dim=-1),
                    torch.zeros_like(buffers.xyz_grad_accum)),
                grad_denom=buffers.grad_denom + acc.to(torch.float32),
            )
            metrics = {
                "loss": total, "photo": photo, "reg_l2": reg,
                "mesh_edge": edge, "connect": connect,
                "lap_pos": lap_pos_loss, "lap_color": lap_color_loss,
                **{f"photo_{k}": v for k, v in photo_d.items()},
            }
            metrics = {k: torch.as_tensor(v).detach()
                       for k, v in metrics.items()}
            metrics["skipped"] = (~finite).to(torch.float32)
        return params, buffers, opt_state, metrics, render.detach()

    return train_step


def make_train_scan(train_step, stat_fn=None):
    """Chain K steps: scan(params, buffers, opt_state, cache, batches,
    generator, step0, active_sh_degree, region_lap_pos,
    region_lap_color, lap_pos_w, lap_color_w, draws=None) ->
    (params, buffers, opt_state, losses (K,), skipped (K,), metrics of
    (K,) tensors).

    batches: dict of per-step stacks ('idx' a sequence of ints or a
    tensor). draws: optional list of K draw dicts. stat_fn(params,
    buffers) -> (capacity,) KNN statistic, computed once at the head of
    the chunk and held for its K steps.
    """
    def scan_steps(params, buffers, opt_state, cache, batches, generator,
                   step0: int, active_sh_degree: int, region_lap_pos,
                   region_lap_color, lap_pos_w, lap_color_w, draws=None):
        es = None
        if stat_fn is not None:
            with span("step.knn_stat"):
                es = stat_fn(params, buffers)
        k = len(batches["idx"])
        per_step = []
        for i in range(k):
            batch = {name: v[i] for name, v in batches.items()}
            params, buffers, opt_state, metrics, _ = train_step(
                params, buffers, opt_state, cache, batch, generator,
                step0 + i, active_sh_degree, region_lap_pos,
                region_lap_color, lap_pos_w, lap_color_w, edge_stat=es,
                draws=None if draws is None else draws[i])
            per_step.append(metrics)
        metrics = {name: torch.stack([m[name] for m in per_step])
                   for name in per_step[0]}
        return (params, buffers, opt_state, metrics["loss"],
                metrics["skipped"], metrics)

    return scan_steps
