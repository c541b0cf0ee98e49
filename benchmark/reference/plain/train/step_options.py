"""The training step with the port's options (port of
sings_tpu/train/step.py's make_train_step, with what the frozen
train/step.py leaves out): the LPIPS term on the masked patches
(losses/lpips.py, autograd through the VGG16 features), the windowed
KNN statistic every step (ops/knn_window.py) and any laplacian with
RegionLaplacian's loss_fused (the cotangent one, losses/cotangent.py).

Everything else is the frozen step's: regularizer_terms, the gates,
the SH mask, the non-finite guard, the density statistics, and its
make_train_scan, which chains the steps (no statistic at the chunk
head: the window backend computes its own every step). The
photometric objective is losses/photometric.py's with the LPIPS term
added between SSIM and the gradient pyramid, the port's order of
summation.
"""
from __future__ import annotations

import torch

from ..losses.lpips import LPIPSParams, lpips_distance
from ..losses.photometric import (
    PhotometricWeights, crop_patches, grad_pyramid_distance, masked_l1,
    ssim_loss,
)
from ..losses.regularizers import gaussians_edge_loss_from_stat
from ..model.avatar import AvatarBuffers, AvatarConfig, avatar_forward
from ..ops.clip import clip
from ..ops.graphics import Camera
from ..ops.knn_window import knn_window_stat
from ..ops.rasterizer.api import rasterize
from ..tree import tree_leaves, tree_map
from .step import (  # noqa: F401  (make_train_scan: the frozen chain)
    StepConfig, _gate_grad, _zeros_for_none, make_train_scan,
    regularizer_terms, sh_degree_mask,
)


def photometric_loss(draws: dict, pred: torch.Tensor, gt_rgb: torch.Tensor,
                     mask: torch.Tensor, bg_color: torch.Tensor,
                     weights: PhotometricWeights, lpips_fn=None):
    """The photometric objective with the LPIPS term: masked L1, SSIM,
    then on the patches (composited over the draws' noise) LPIPS and the
    gradient pyramid. Returns (total, {term: weighted value})."""
    m = mask[None]
    gt = gt_rgb * m + bg_color[:, None, None] * (1.0 - m)
    losses = {}
    total = 0.0
    if weights.l1 > 0:
        losses["l1"] = weights.l1 * masked_l1(pred, gt, mask)
        total = total + losses["l1"]
    if weights.ssim > 0:
        losses["ssim"] = weights.ssim * ssim_loss(pred, gt, mask)
        total = total + losses["ssim"]
    use_lpips = weights.lpips > 0 and lpips_fn is not None
    if use_lpips or weights.grad_pyramid > 0:
        noise = draws["noise"]
        pred_bg = pred * m + noise * (1.0 - m)
        gt_bg = gt * m + noise * (1.0 - m)
        pred_p = crop_patches(pred_bg, draws["ys"], draws["xs"],
                              weights.patch_size)
        gt_p = crop_patches(gt_bg, draws["ys"], draws["xs"],
                            weights.patch_size)
        if use_lpips:
            losses["lpips_patch"] = weights.lpips * lpips_fn(
                clip(pred_p, hi=1.0), gt_p).mean()
            total = total + losses["lpips_patch"]
        if weights.grad_pyramid > 0:
            losses["grad_pyr"] = weights.grad_pyramid * \
                grad_pyramid_distance(clip(pred_p, hi=1.0), gt_p,
                                      weights.grad_pyramid_levels)
            total = total + losses["grad_pyr"]
    return total, losses


def make_train_step(avatar_cfg: AvatarConfig, step_cfg: StepConfig,
                    template, camera: Camera, tx,
                    lpips_params: LPIPSParams | None, raster_kw: dict):
    """Build the step (the frozen make_train_step's contract, with the
    LPIPS network, or None for no LPIPS term). step_cfg.knn_backend is
    "window"."""
    w = step_cfg.weights
    if step_cfg.knn_backend != "window":
        raise ValueError("the options step takes the window statistic")
    lpips_fn = None
    if lpips_params is not None:
        def lpips_fn(a, b):
            return lpips_distance(lpips_params, a, b)

    def connect_fn(xyz_canon, scales, alive):
        stat = knn_window_stat(xyz_canon, step_cfg.knn_k,
                               valid=alive > 0)
        return gaussians_edge_loss_from_stat(stat, scales, alive)

    def train_step(params, buffers: AvatarBuffers, opt_state, cache,
                   batch: dict, generator, step: int, active_sh_degree: int,
                   region_lap_pos, region_lap_color, lap_pos_w, lap_color_w,
                   edge_stat=None, draws=None):
        dev = buffers.alive.device
        if draws is None:
            raise ValueError("the reference's steps take the benchmark's "
                             "draws")
        bg = draws["bg"]
        opt_geo = step >= step_cfg.opt_geo_from
        opt_app = step >= step_cfg.opt_app_from
        deg_mask = sh_degree_mask(active_sh_degree, dev)

        p = tree_map(lambda x: x.detach().requires_grad_(True), params)
        probe = torch.zeros((avatar_cfg.capacity, 2), device=dev,
                            requires_grad=True)
        out = avatar_forward(p, buffers, avatar_cfg, template, cache,
                             smpl_scale=batch.get("smpl_scale"),
                             dataset_idx=batch["idx"])
        for k in ("xyz_canon", "xyz_offsets", "scales", "scales_canon"):
            out[k] = _gate_grad(out[k], opt_geo)
        for k in ("shs", "opacity"):
            out[k] = _gate_grad(out[k], opt_app)

        shs = out["shs"] * deg_mask[None, :, None]
        pkg = rasterize(out["xyz"], out["scales"], out["rotq"],
                        out["opacity"][:, 0], shs, camera, sh_degree=3,
                        bg=bg, alive=buffers.alive > 0.5, screen_probe=probe,
                        backend="pallas", **raster_kw)
        # no clamp: the losses read the raw render
        render = pkg["render"]
        photo, photo_d = photometric_loss(draws, render, batch["rgb"],
                                          batch["mask"], bg, w.photometric,
                                          lpips_fn)
        if w.silhouette != 0:
            sil = 1.0 - pkg["transmittance"]
            l_sil = torch.mean((sil - batch["mask"]) ** 2)
            photo = photo + w.silhouette * l_sil
            photo_d = dict(photo_d, sil=w.silhouette * l_sil)

        r = regularizer_terms(step_cfg, out, buffers, step, region_lap_pos,
                              region_lap_color, lap_pos_w, lap_color_w,
                              connect_fn)
        total = (photo + r["reg_l2"] + r["mesh_edge"] + r["connect"]
                 + r["lap_pos"] + r["lap_color"] + r["hand_lap"])

        leaves = tree_leaves(p)
        grads = torch.autograd.grad(total, leaves + [probe],
                                    allow_unused=True)
        grads = _zeros_for_none(grads, leaves + [probe])
        probe_grad = grads.pop()
        it = iter(grads)
        grad_tree = tree_map(lambda _: next(it), p)

        # non-finite guard: skip the whole update (params and moments)
        finite = torch.isfinite(total.detach())
        for g in grads:
            finite = finite & torch.isfinite(g).all()
        new_params, new_state = tx.update(grad_tree, opt_state, params)

        def keep(new, old):
            return torch.where(finite, new.detach(), old)

        params = tree_map(keep, new_params, params)
        opt_state = tree_map(keep, new_state, opt_state)

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
        metrics = {"loss": total, "photo": photo,
                   **{k: r[k] for k in ("reg_l2", "mesh_edge", "connect",
                                        "lap_pos", "lap_color")},
                   **{f"photo_{k}": v for k, v in photo_d.items()}}
        metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
        metrics["skipped"] = (~finite).to(torch.float32)
        return params, buffers, opt_state, metrics, render.detach()

    return train_step
