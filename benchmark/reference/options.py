"""The reference's side of the options cell (configuration
human_complex_options): what reference/build.py refuses, built from the
frozen plain copies in reference/plain. The photometric weights with
the LPIPS term at lpips_w x tpu.random_lpips_factor (random features:
no pretrained weights), the windowed statistic every step, the
cotangent laplacian at the template's anchors, and the checked steps of
reference/train.py with each step's named loss terms kept besides.

Everything else (the avatar, the optimizer, the loss weights other than
the photometric ones) is reference/build.py's. The LPIPS weights are
the caller's: the benchmark draws seeded VGG16 features and hands the
same draw to the program and to the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build as RB
from .plain.config.defaults import (
    DEFAULT_COLOR_REGIONS_W, DEFAULT_POSITION_REGIONS_W,
    parse_region_weights,
)
from .plain.losses.cotangent import build_cot_region_laplacian
from .plain.losses.lpips import LPIPSParams
from .plain.losses.photometric import PhotometricWeights
from .plain.train.optim import LRConfig, TrainFlags, make_optimizer
from .plain.train.step import LossWeights, StepConfig
from .plain.train.step_options import make_train_scan, make_train_step
from .plain.losses.regularizers import L2NormConfig
from .train import checked_steps as _checked_steps


def training_weights(cfg, camera) -> PhotometricWeights:
    """The photometric loss weights with the LPIPS term: lpips_w scaled
    by tpu.random_lpips_factor, as the port's Trainer scales it for
    random features."""
    loss_cfg = cfg.human.loss
    if cfg.tpu.get("lpips_weights"):
        raise NotImplementedError("the reference runs random LPIPS "
                                  "features (no tpu.lpips_weights)")
    lpips_w = loss_cfg.lpips_w * float(cfg.tpu.get("random_lpips_factor",
                                                   0.05))
    return PhotometricWeights(
        l1=loss_cfg.l1_w, ssim=loss_cfg.ssim_w, lpips=lpips_w,
        num_patches=loss_cfg.num_patches,
        patch_size=min(loss_cfg.patch_size,
                       min(camera.height, camera.width) // 2 * 2),
        grad_pyramid=float(loss_cfg.get("grad_pyramid_w", 0.0)),
        grad_pyramid_levels=int(loss_cfg.get("grad_pyramid_levels", 3)))


def training(av: RB.Avatar, camera, device,
             lpips: LPIPSParams) -> RB.Training:
    """reference/build.py's training() for the options: the windowed
    statistic, the LPIPS term with the given weights and the cotangent
    laplacian (the port's Trainer on one card)."""
    cfg, hcfg = av.cfg, av.cfg.human
    loss_cfg = hcfg.loss
    knn_backend = str(cfg.tpu.get("knn_backend", "auto"))
    if knn_backend != "window" or str(loss_cfg.laplacian.type) != \
            "cotangent":
        raise NotImplementedError("the options reference runs the window "
                                  "statistic and the cotangent laplacian")
    lr = LRConfig(**{k: getattr(hcfg.lr, k) for k in LRConfig._fields})
    flags = TrainFlags(optim_pose=hcfg.optim_pose,
                       optim_betas=hcfg.optim_betas,
                       optim_trans=hcfg.optim_trans)
    tx = make_optimizer(
        lr, flags,
        grad_clip_norm=float(cfg.tpu.get("grad_clip_norm", 0.0) or 0.0))
    photometric = training_weights(cfg, camera)
    weights = LossWeights(
        photometric=photometric,
        silhouette=float(loss_cfg.get("silhouette_w", 0.0)),
        l2=L2NormConfig(**{k: float(v) for k, v in loss_cfg.l2_norm.items()}),
        mesh_edge=float(loss_cfg.mesh_edge),
        gaussian_connect=float(loss_cfg.gaussian_connect),
        lap_position_strength=float(loss_cfg.laplacian.position_strength),
        lap_color_strength=float(loss_cfg.laplacian.color_strength),
        lap_impose_from=int(loss_cfg.laplacian.impose_from_iter))
    dc = hcfg.density_control.hybrid
    step_cfg = StepConfig(
        weights=weights, opt_geo_from=hcfg.opt_geo_from,
        opt_app_from=hcfg.opt_app_from,
        opacity_norm_from=max(dc.prune_until_iter, dc.densify_until_iter),
        knn_backend="window", lap_shared=True)
    step = make_train_step(av.acfg, step_cfg, av.template, camera, tx,
                           lpips if photometric.lpips > 0 else None,
                           RB.raster_kw(cfg))
    b = av.buffers
    labels = np.where(b.alive.cpu().numpy() > 0.5,
                      b.vertex_label.cpu().numpy(), -1)
    faces = b.faces.cpu().numpy()[b.face_valid.cpu().numpy() > 0.5]
    lap_pos_w = torch.as_tensor(parse_region_weights(
        loss_cfg.laplacian.position_regions_w, DEFAULT_POSITION_REGIONS_W),
        device=device)
    lap_color_w = torch.as_tensor(parse_region_weights(
        loss_cfg.laplacian.color_regions_w, DEFAULT_COLOR_REGIONS_W),
        device=device)
    # the weights at the template's anchors, frozen, as the Trainer
    # builds them at its construction
    region_lap = build_cot_region_laplacian(
        av.params.xyz.detach().cpu().numpy(), faces, labels,
        lap_pos_w.cpu().numpy(), num_regions=15, pad_width_to=8,
        device=device)
    return RB.Training(tx=tx, step_cfg=step_cfg, photometric=photometric,
                       region_lap=region_lap, lap_pos_w=lap_pos_w,
                       lap_color_w=lap_color_w,
                       train_scan=make_train_scan(step))


def checked_steps(av, tr: RB.Training, images, masks, chunks: list,
                  step0: int, terms: tuple) -> dict:
    """reference/train.py's checked_steps, with each step's value of
    each named loss term (a key of the step's metrics, 0 where the step
    has no such term) under 'terms', by name, and under 'screen_grad'
    the norm of the screen-space gradient norms the steps accumulated
    (the buffers' xyz_grad_accum after the last call)."""
    kept = {name: [] for name in terms}
    last = {}

    def scan(*args, **kw):
        out = tr.train_scan(*args, **kw)
        for name in terms:
            kept[name].extend(float(x) for x in out[5].get(
                name, torch.zeros_like(out[3])).cpu())
        last["buffers"] = out[1]
        return out

    res = _checked_steps(av, tr._replace(train_scan=scan), images, masks,
                         chunks, step0)
    res["terms"] = kept
    res["screen_grad"] = float(torch.linalg.norm(
        last["buffers"].xyz_grad_accum))
    return res
