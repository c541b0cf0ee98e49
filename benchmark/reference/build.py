"""The reference's own avatar, worked out again from the benchmark's
inputs: the body template, the canonical cache, the avatar config and
buffers, the parameters (the template's anchors, the benchmark's seeded
weights, the kit's poses), the region laplacian, the optimizer and the
training step, all from the frozen plain copy in reference/plain.

It follows the port's Trainer constructor for the paths the benchmark's
configurations take (the synthetic template with its calibration off,
the standard laplacian by gather, one card) and refuses the others.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .plain.config.core import load_config
from .plain.config.defaults import (
    DEFAULT_COLOR_REGIONS_W, DEFAULT_POSITION_REGIONS_W, DEFAULTS,
    parse_region_weights,
)
from .plain.fields.decoders import (
    DecoderConfig, appearance_layer_shapes, geometry_layer_shapes,
)
from .plain.fields.triplane import TriplaneConfig, plane_shapes
from .plain.kinematics.body_model import load_template
from .plain.kinematics.template import DeviceTemplate, canonical_pose_cache
from .plain.losses.photometric import PhotometricWeights
from .plain.losses.regularizers import (
    L2NormConfig, build_region_laplacian, edge_stat,
)
from .plain.model.avatar import AvatarConfig, get_canon_xyz, init_avatar
from .plain.train.optim import LRConfig, TrainFlags, make_optimizer
from .plain.train.step import (
    LossWeights, StepConfig, make_train_scan, make_train_step,
)


def config(dotlist: list):
    """The run's configuration: the dotlist over the port's DEFAULTS, as
    the frozen copy of the config module reads it."""
    return load_config(DEFAULTS, None, list(dotlist))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def raster_kw(cfg) -> dict:
    """The rasterize keywords of the configuration (the Trainer's
    default_raster_kw on a card)."""
    r = cfg.tpu.raster
    return dict(tile=r.tile, chunk=r.chunk, max_span=r.max_span,
                max_pairs=r.max_pairs, main_width=r.main_width,
                tail_capacity=r.tail_capacity, pair_cap=r.get("pair_cap"),
                scan_roll=bool(r.get("scan_roll", False)),
                layout=r.get("layout", "tiled"))


def field_configs(cfg) -> tuple:
    """(TriplaneConfig, DecoderConfig) of the configuration."""
    hcfg = cfg.human
    tri = TriplaneConfig(
        resolution=tuple(hcfg.kplanes.resolution),
        out_dim=hcfg.kplanes.output_coordinate_dim,
        multires=tuple(hcfg.kplanes.multires),
        nested=bool(cfg.tpu.get("triplane_nested", False)))
    dec = DecoderConfig(
        n_features=tri.feat_dim,
        isotropic=hcfg.attribute_control.isotropic,
        fixed_opacity=hcfg.attribute_control.fixed_opacity)
    return tri, dec


def weight_layout(cfg) -> dict:
    """The shapes of the seeded weights: the triplane's planes per scale
    and each decoder layer's (fan_in, fan_out)."""
    tri, dec = field_configs(cfg)
    return {"planes": plane_shapes(tri),
            "geometry_dec": geometry_layer_shapes(dec),
            "appearance_dec": appearance_layer_shapes(dec)}


class Avatar(NamedTuple):
    cfg: Any
    tpl: Any
    template: Any
    acfg: AvatarConfig
    cache: Any
    params: Any
    buffers: Any


def avatar(cfg, smpl: dict, weights: dict, device) -> Avatar:
    """Template, config, buffers and parameters of the avatar: the
    template's canonical anchors, the given seeded weights (triplane and
    decoders) and the kit's poses."""
    hcfg = cfg.human
    if cfg.tpu.get("auto_fit_synthetic", True):
        raise NotImplementedError("the reference runs with "
                                  "tpu.auto_fit_synthetic=False")
    tpl = load_template(
        hcfg.body_template, num_betas=len(smpl["betas"]),
        n_subdivision=hcfg.n_subdivision,
        synthetic_res=float(cfg.tpu.get("synthetic_res", 1.0)))
    smpl = dict(smpl)
    if tpl.name == "synthetic":
        smpl["betas"] = np.zeros(tpl.num_betas, np.float32)
    template = DeviceTemplate.from_host(tpl, device)
    n = tpl.num_verts
    max_n = int(hcfg.density_control.max_n_gaussians)
    cap_mult = float(cfg.tpu.get("capacity_mult", 2.0))
    capacity = _round_up(min(max_n, int(n * cap_mult)), 256)
    tri, dec = field_configs(cfg)
    synthetic = tpl.name == "synthetic"
    ac = hcfg.attribute_control
    acfg = AvatarConfig(
        capacity=capacity, face_capacity=_round_up(capacity * 3, 256),
        edge_capacity=_round_up(capacity * 4, 256),
        num_frames=smpl["body_pose"].shape[0], num_betas=len(smpl["betas"]),
        sh_degree=hcfg.sh_degree, isotropic=ac.isotropic,
        fixed_opacity=ac.fixed_opacity, init_opacity=ac.init_opacity,
        init_scale_multiplier=ac.init_scale_multiplier,
        thickness_factor=ac.thickness_factor,
        disable_posedirs=hcfg.disable_posedirs,
        canonical_pose=hcfg.canon_pose_type,
        body_template=hcfg.body_template, triplane=tri, decoder=dec,
        offset_clamp=float(cfg.tpu.get("offset_clamp",
                                       0.05 if synthetic else 0.0)),
        scale_clamp=float(cfg.tpu.get("scale_clamp",
                                      0.05 if synthetic else 0.0)))
    betas = torch.as_tensor(smpl["betas"], device=device)
    cache = canonical_pose_cache(template, betas, hcfg.canon_pose_type)
    # init_avatar's random triplane and decoders are replaced by the
    # benchmark's weights
    state = init_avatar(torch.Generator().manual_seed(0), acfg, tpl, cache,
                        smpl, device=device)
    params = state.params._replace(
        triplane={"grids": [[g.clone() for g in s]
                            for s in weights["triplane"]["grids"]]},
        geometry_dec={k: {n_: v.clone() for n_, v in layer.items()}
                      for k, layer in weights["geometry_dec"].items()},
        appearance_dec={k: {n_: v.clone() for n_, v in layer.items()}
                        for k, layer in weights["appearance_dec"].items()})
    return Avatar(cfg=cfg, tpl=tpl, template=template, acfg=acfg,
                  cache=cache, params=params, buffers=state.buffers)


class Training(NamedTuple):
    tx: Any
    step_cfg: StepConfig
    photometric: PhotometricWeights
    region_lap: Any
    lap_pos_w: torch.Tensor
    lap_color_w: torch.Tensor
    train_scan: Any


def training_weights(cfg, camera) -> PhotometricWeights:
    """The photometric loss weights of the configuration (the LPIPS term
    off or at weight 0)."""
    loss_cfg = cfg.human.loss
    lpips_w = loss_cfg.lpips_w
    if not cfg.tpu.get("lpips_weights") and loss_cfg.lpips_w > 0:
        lpips_w = loss_cfg.lpips_w * float(cfg.tpu.get("random_lpips_factor",
                                                       0.05))
    if lpips_w > 0:
        raise NotImplementedError("the reference runs with the LPIPS term "
                                  "off (tpu.random_lpips_factor=0.0)")
    return PhotometricWeights(
        l1=loss_cfg.l1_w, ssim=loss_cfg.ssim_w, lpips=lpips_w,
        num_patches=loss_cfg.num_patches,
        patch_size=min(loss_cfg.patch_size,
                       min(camera.height, camera.width) // 2 * 2),
        grad_pyramid=float(loss_cfg.get("grad_pyramid_w", 0.0)),
        grad_pyramid_levels=int(loss_cfg.get("grad_pyramid_levels", 3)))


def training(av: Avatar, camera, device) -> Training:
    """The optimizer, loss weights, region laplacian and K-step chunk of
    the configuration (the Trainer's _init_training for one card, the
    LPIPS term off or at weight 0, the standard laplacian by gather)."""
    cfg, hcfg = av.cfg, av.cfg.human
    loss_cfg = hcfg.loss
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
    inner = int(cfg.tpu.get("inner_steps", 1) or 1)
    knn_backend = str(cfg.tpu.get("knn_backend", "auto"))
    if knn_backend == "auto":
        knn_backend = "chunk" if inner > 1 else "dense"
    step_cfg = StepConfig(
        weights=weights, opt_geo_from=hcfg.opt_geo_from,
        opt_app_from=hcfg.opt_app_from,
        opacity_norm_from=max(dc.prune_until_iter, dc.densify_until_iter),
        knn_backend=knn_backend, lap_shared=True)
    step = make_train_step(av.acfg, step_cfg, av.template, camera, tx,
                           raster_kw(cfg))
    stat_fn = None
    if knn_backend == "chunk":
        acfg = av.acfg

        def stat_fn(params, buffers):
            with torch.no_grad():
                xyz = get_canon_xyz(params, buffers, acfg)
            return edge_stat(xyz, buffers.alive, k=step_cfg.knn_k)

    if str(loss_cfg.laplacian.type) != "standard" or str(
            cfg.tpu.get("laplacian_backend", "auto")) not in ("auto",
                                                              "gather"):
        raise NotImplementedError("the reference builds the standard "
                                  "laplacian by gather")
    b = av.buffers
    edges = b.edges.cpu().numpy()[b.edge_valid.cpu().numpy() > 0.5]
    labels = np.where(b.alive.cpu().numpy() > 0.5,
                      b.vertex_label.cpu().numpy(), -1)
    lap_pos_w = torch.as_tensor(parse_region_weights(
        loss_cfg.laplacian.position_regions_w, DEFAULT_POSITION_REGIONS_W),
        device=device)
    lap_color_w = torch.as_tensor(parse_region_weights(
        loss_cfg.laplacian.color_regions_w, DEFAULT_COLOR_REGIONS_W),
        device=device)
    region_lap = build_region_laplacian(edges, labels,
                                        lap_pos_w.cpu().numpy(),
                                        num_regions=15, pad_to=8,
                                        device=device)
    return Training(tx=tx, step_cfg=step_cfg, photometric=photometric,
                    region_lap=region_lap, lap_pos_w=lap_pos_w,
                    lap_color_w=lap_color_w,
                    train_scan=make_train_scan(step, stat_fn))
