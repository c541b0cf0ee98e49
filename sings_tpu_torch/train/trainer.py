"""Trainer (port of sings_tpu/train/trainer.py): animation and training.

Trainer(cfg, mode="anim") builds what the JAX constructor builds for an
animation run: the kit (or an in-memory one), the animation dataset,
the body template with its synthetic calibration (the two-stage fit of
preprocess/refine.py, or its cache), the avatar
config and state, and the latest checkpoint. animate_chunk renders the
motion 16 frames at a time: decode once, pose a chunk with batched LBS,
rasterize each frame, quantise to uint8 on the device.

Trainer(cfg, mode="train") also builds the optimizer and its state, the
loss weights and StepConfig from the YAML keys (the LPIPS term with
random features at lpips_w * random_lpips_factor unless pretrained
weights are given, the dense, chunk or windowed KNN statistic), the
region laplacian (standard by gather or banded, or cotangent), the
LPIPS network, self.train_step / self.train_scan,
and resumes from the latest checkpoint (params, buffers, Adam state,
step) or pre-fits the decoders. train() is the JAX package's loop:
K-step chunks between host events (_is_event), checkpoints, validation
(with test-time pose refinement and the gauge-aligned metric),
visualisation, SH annealing and hybrid density control (host numpy
topology surgery, Adam moments zeroed at the changed slots, opacity
reset, laplacian rebuild), then a final checkpoint and validation.

With tpu.mesh (dp, gs) and dp * gs > 1, a training run is one process
per rank of a torch.distributed process group of dp * gs ranks
(cli/train.py starts it from torchrun's environment): train() takes dp
frames a step from the one shuffled order, one per dp rank, through
dist/train_sharded.py's step, with the strips balanced from the masks'
row sums when tpu.mesh.balance_strips is set. Rank 0 alone writes logs,
checkpoints, validation, visualisations and the synthetic calibration;
the other ranks wait at a barrier. A host event (resume, density
control, laplacian rebuild) ends with every rank holding rank 0's
params, buffers and optimizer state bit for bit (a broadcast).

Deviations from the JAX signatures:
  * Trainer(..., kit=TrainingKit) takes a kit held in memory, so a run
    needs no image files (and no image library) on disk;
  * Trainer(..., image_writer=callable) takes the sink of every image
    the trainer saves (validation pairs, canonical turntables, the
    default animation frames): image_writer(path, uint8 (H, W, 3)); the
    default writes the file with PIL, imported only then, which lets a
    machine without PIL or cv2 train and render;
  * animate_chunk(..., writer=callable) takes the frame sink;
  * train_step / train_scan take a torch.Generator (self.step_generator)
    where JAX takes PRNG keys, and optionally the draws themselves; the
    frame order is shuffled by a random.Random seeded from cfg.seed
    (the JAX loop uses the global `random`, seeded the same way).
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import random
import time

import numpy as np
import torch

from ..config.defaults import (
    DEFAULT_COLOR_REGIONS_W, DEFAULT_POSITION_REGIONS_W, parse_region_weights,
)
from ..data.anim import load_anim_dataset
from ..data.kit import TrainingKit, load_kit
from ..device import resolve_device
from ..dist.collectives import (
    barrier, broadcast_object, broadcast_tree, world_rank, world_size,
)
from ..data.cameras import get_rotating_cameras, get_smpl_static_params
from ..export.ply import save_ellipsoid_mesh, save_ply, save_splat
from ..fields.decoders import DecoderConfig, appearance_opacity_logit
from ..fields.triplane import TriplaneConfig, triplane_features
from ..kinematics.body_model import load_template
from ..kinematics.template import DeviceTemplate, canonical_pose_cache
from ..losses.lpips import get_lpips, lpips_distance
from ..losses.photometric import PhotometricWeights
from ..losses.regularizers import (
    L2NormConfig, build_cot_region_laplacian, build_region_laplacian,
    build_region_laplacian_banded, edge_stat, shard_region_laplacian,
)
from ..model.avatar import (
    AvatarConfig, avatar_forward, avatar_forward_chunk, fit_initial_attrs,
    get_canon_xyz, get_gs_attrs, init_avatar, initial_attr_targets,
)
from ..model.density import densify_and_subdivide, prune_and_simplify
from ..ops.profiling import span
from ..ops.rasterizer.api import rasterize
from ..ops.rotations import (
    axis_angle_to_matrix, matrix_to_axis_angle, rotation_6d_to_axis_angle,
    rotation_6d_to_matrix,
)
from ..ops.ssim import psnr, ssim
from .checkpoint import (
    CheckpointShapeMismatch, latest_checkpoint, load_checkpoint,
    save_checkpoint,
)
from .logging_util import install_run_log
from .optim import (
    LRConfig, TrainFlags, adam_directions, adam_init, make_optimizer,
    zero_moments_for_slots,
)
from .step import (
    LossWeights, StepConfig, make_train_scan, make_train_step, sh_degree_mask,
)


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def default_raster_kw(cfg, device: torch.device) -> dict:
    r = cfg.tpu.raster
    kw = dict(tile=r.tile, chunk=r.chunk, max_span=r.max_span,
              max_pairs=r.max_pairs, main_width=r.main_width,
              tail_capacity=r.tail_capacity, pair_cap=r.get("pair_cap"),
              scan_roll=bool(r.get("scan_roll", False)),
              layout=r.get("layout", "tiled"))
    if device.type != "cuda":
        # the JAX package's CPU path composites in 8-pair chunks; use the
        # same so CPU renders compare like with like
        kw.update(chunk=8)
    return kw


def _world_group():
    """The whole process group, None without one (or with one rank)."""
    import torch.distributed as dist

    return dist.group.WORLD if world_size() > 1 else None


def quantize(render: torch.Tensor) -> torch.Tensor:
    """(3, H, W) float render -> (H, W, 3) uint8 on the render's device;
    torch.round rounds half to even, like jnp.round."""
    img = torch.clamp(render, 0.0, 1.0)
    return torch.round(img.permute(1, 2, 0) * 255.0).to(torch.uint8)


def load_anim_cfg(path: str) -> dict:
    """Animation config: JSON by suffix, otherwise YAML (PyYAML then)."""
    with open(path) as fh:
        if path.endswith(".json"):
            return json.load(fh)
        import yaml

        return yaml.safe_load(fh)


def save_image_file(path: str, image: np.ndarray) -> None:
    """Default image sink: (H, W, 3) uint8 to a file, PIL imported here."""
    from PIL import Image

    Image.fromarray(image).save(path)


def _jpeg_writer(out_dir: str, pool: cf.ThreadPoolExecutor, save):
    def write(frames: np.ndarray, start: int):
        return [pool.submit(save, os.path.join(out_dir, f"{start + j:05d}.jpg"),
                            frames[j]) for j in range(frames.shape[0])]
    return write


def _to_uint8(img: torch.Tensor) -> np.ndarray:
    """(3, H, W) render -> (H, W, 3) uint8 as the JAX package saves it:
    clip, scale by 255, truncate."""
    return (img.detach().permute(1, 2, 0).clamp(0, 1).cpu().numpy()
            * 255).astype(np.uint8)


def _masked_psnr(img, gt, m) -> float:
    mse = float((((img - gt) * m) ** 2).sum() / torch.clamp_min(m.sum() * 3,
                                                              1.0))
    return float(20 * np.log10(1.0 / max(np.sqrt(mse), 1e-6)))


class Trainer:
    def __init__(self, cfg, mode: str = "anim", device=None,
                 kit: TrainingKit | None = None, image_writer=None):
        if mode not in ("anim", "train"):
            raise NotImplementedError(
                f"mode={mode!r}: the port has 'anim' and 'train'")
        self.cfg = cfg
        self.mode = mode
        self.device = resolve_device(device)
        random.seed(cfg.seed)
        np.random.seed(cfg.seed)
        self.generator = torch.Generator().manual_seed(int(cfg.seed))
        self.save_image = image_writer or save_image_file

        self.logdir = cfg.logdir or os.path.join(
            cfg.output_path, cfg.exp_name, cfg.dataset.name)
        self.logdir_ckpt = cfg.logdir_ckpt or os.path.join(self.logdir,
                                                           "ckpt")
        for sub in ("", "ckpt", "val", "train", "anim", "meshes", "canon"):
            os.makedirs(os.path.join(self.logdir, sub), exist_ok=True)
        # rank 0 alone writes: logs, checkpoints, images, caches
        self.io_rank = world_rank() == 0
        if self.io_rank:
            install_run_log(self.logdir, mode)
        self.bg_color = (torch.ones(3, device=self.device)
                         if cfg.bg_color == "white"
                         else torch.zeros(3, device=self.device))

        # ---------------- data
        if kit is None:
            kit_dir = os.path.join(cfg.dataset.root_dir,
                                   cfg.dataset.batch or "", cfg.dataset.name,
                                   cfg.dataset.seq or "")
            kit = load_kit(os.path.normpath(kit_dir),
                           downscale=int(cfg.dataset.get("downscale", 1) or 1),
                           max_frames=cfg.dataset.get("max_frames"))
        self.kit = kit
        self.camera = kit.camera.to(self.device)

        self.anim_dataset = None
        if cfg.anim_cfg_path and os.path.exists(cfg.anim_cfg_path):
            ac = load_anim_cfg(cfg.anim_cfg_path)
            self.anim_dataset = load_anim_dataset(
                ac["motion_src"], ac.get("motion_type", "custom"),
                ac.get("motion_start", 0), ac.get("motion_end", -1),
                ac.get("motion_skip", 1),
                tuple(ac.get("render_size", (512, 512))),
                rebase=ac.get("motion_rebase"),
                fx=float(ac.get("fx", 5000.0)),
                fy=float(ac.get("fy", 5000.0)), device=self.device)

        # ---------------- body template
        hcfg = cfg.human
        model_dir = os.path.join(cfg.tpu.smpl_model_dir, hcfg.body_template)
        self.tpl = load_template(
            model_dir, hcfg.body_template,
            num_betas=len(self.kit.smpl["betas"]),
            n_subdivision=hcfg.n_subdivision,
            parsing_dir=cfg.tpu.get("parsing_dir"),
            synthetic_res=float(cfg.tpu.get("synthetic_res", 1.0)))
        if self.tpl.name == "synthetic":
            # kit betas parametrise the licensed SMPL: zero them at the
            # synthetic template's dimension (the calibration cache
            # replaces them)
            smpl = dict(self.kit.smpl)
            smpl["betas"] = np.zeros(self.tpl.num_betas, np.float32)
            self.kit = self.kit._replace(smpl=smpl)
        if (self.tpl.name == "synthetic"
                and cfg.tpu.get("auto_fit_synthetic", True)):
            # rank 0 fits and writes the cache, the others then load it
            if not self.io_rank:
                barrier(_world_group())
            self._fit_synthetic_body()
            if self.io_rank:
                barrier(_world_group())
        self.template = DeviceTemplate.from_host(self.tpl, self.device)

        pad_f = int(cfg.dataset.get("pad_frames_to", 0) or 0)
        if pad_f > self.kit.smpl["body_pose"].shape[0]:
            smpl = dict(self.kit.smpl)
            extra = pad_f - smpl["body_pose"].shape[0]
            for k in ("body_pose", "global_orient", "transl"):
                smpl[k] = np.concatenate(
                    [smpl[k], np.repeat(smpl[k][-1:], extra, axis=0)])
            self.kit = self.kit._replace(smpl=smpl)

        # ---------------- avatar config + state
        n = self.tpl.num_verts
        max_n = int(hcfg.density_control.max_n_gaussians)
        cap_mult = float(cfg.tpu.get("capacity_mult", 2.0))
        capacity = _round_up(min(max_n, int(n * cap_mult)), 256)
        tri = TriplaneConfig(
            resolution=tuple(hcfg.kplanes.resolution),
            out_dim=hcfg.kplanes.output_coordinate_dim,
            multires=tuple(hcfg.kplanes.multires),
            nested=bool(cfg.tpu.get("triplane_nested", False)))
        dec = DecoderConfig(
            n_features=tri.feat_dim,
            isotropic=hcfg.attribute_control.isotropic,
            fixed_opacity=hcfg.attribute_control.fixed_opacity)
        synthetic = self.tpl.name == "synthetic"
        self.avatar_cfg = AvatarConfig(
            capacity=capacity,
            face_capacity=_round_up(capacity * 3, 256),
            edge_capacity=_round_up(capacity * 4, 256),
            num_frames=self.kit.smpl["body_pose"].shape[0],
            num_betas=len(self.kit.smpl["betas"]),
            sh_degree=hcfg.sh_degree,
            isotropic=hcfg.attribute_control.isotropic,
            fixed_opacity=hcfg.attribute_control.fixed_opacity,
            init_opacity=hcfg.attribute_control.init_opacity,
            init_scale_multiplier=hcfg.attribute_control.init_scale_multiplier,
            thickness_factor=hcfg.attribute_control.thickness_factor,
            disable_posedirs=hcfg.disable_posedirs,
            canonical_pose=hcfg.canon_pose_type,
            body_template=hcfg.body_template,
            triplane=tri,
            decoder=dec,
            offset_clamp=float(cfg.tpu.get("offset_clamp",
                                           0.05 if synthetic else 0.0)),
            scale_clamp=float(cfg.tpu.get("scale_clamp",
                                          0.05 if synthetic else 0.0)),
        )
        betas = torch.as_tensor(self.kit.smpl["betas"], device=self.device)
        self.cache = canonical_pose_cache(self.template, betas,
                                          hcfg.canon_pose_type)
        state = init_avatar(self.generator, self.avatar_cfg, self.tpl,
                            self.cache, self.kit.smpl, device=self.device)
        self.params = state.params
        self.buffers = state.buffers
        self.active_sh_degree = 0
        self.step = 0
        self.raster_kw = default_raster_kw(cfg, self.device)

        if mode == "train":
            self._init_training(hcfg, capacity)

        # auto-resume; a checkpoint of another shape is ignored in a
        # training run and refused otherwise, as in the JAX package
        ckpt = hcfg.ckpt or latest_checkpoint(self.logdir_ckpt)
        loaded = False
        if ckpt and os.path.exists(str(ckpt)):
            loaded = self.load_ckpt(str(ckpt))
            if not loaded and (mode != "train" or cfg.eval):
                raise RuntimeError(
                    f"checkpoint {ckpt} is incompatible with the current "
                    "config and this is an eval/animate run")
        if not loaded and mode == "train" and not cfg.eval:
            self._init_attrs()
        if getattr(self, "mesh", None) is not None:
            self._sync_from_rank0(self.mesh.group)

    # ------------------------------------------------------------------
    def _init_training(self, hcfg, capacity: int) -> None:
        """What the JAX constructor builds for training: optimizer and
        state, loss weights, StepConfig, the step and the K-step chunk,
        the region laplacians."""
        cfg = self.cfg
        dev = self.device
        self.images = torch.as_tensor(np.asarray(self.kit.images, np.float32),
                                      device=dev)
        self.masks = torch.as_tensor(np.asarray(self.kit.masks, np.float32),
                                     device=dev)
        self.step_generator = torch.Generator(device=dev).manual_seed(
            int(cfg.seed))
        lr = LRConfig(**{k: getattr(hcfg.lr, k) for k in LRConfig._fields})
        flags = TrainFlags(optim_pose=hcfg.optim_pose,
                           optim_betas=hcfg.optim_betas,
                           optim_trans=hcfg.optim_trans)
        self.tx = make_optimizer(
            lr, flags,
            grad_clip_norm=float(cfg.tpu.get("grad_clip_norm", 0.0) or 0.0))
        self.opt_state = self.tx.init(self.params)

        loss_cfg = hcfg.loss
        # the LPIPS network (validation's metric, and the training loss
        # when lpips_w > 0): pretrained weights from tpu.lpips_weights
        # keep lpips_w; random features scale it by random_lpips_factor
        # (their gradient scale is uncalibrated: at the full weight it
        # overwhelms L1)
        self.lpips_params = get_lpips(cfg.tpu.get("lpips_weights"),
                                      seed=int(cfg.seed), device=dev)
        lpips_w = loss_cfg.lpips_w
        if not self.lpips_params.pretrained and loss_cfg.lpips_w > 0:
            factor = float(cfg.tpu.get("random_lpips_factor", 0.05))
            print(f"[lpips] no pretrained weights: scaling lpips_w "
                  f"{loss_cfg.lpips_w} -> {loss_cfg.lpips_w * factor}")
            lpips_w = loss_cfg.lpips_w * factor
        weights = LossWeights(
            photometric=PhotometricWeights(
                l1=loss_cfg.l1_w, ssim=loss_cfg.ssim_w, lpips=lpips_w,
                num_patches=loss_cfg.num_patches,
                patch_size=min(loss_cfg.patch_size,
                               min(self.camera.height, self.camera.width)
                               // 2 * 2),
                grad_pyramid=float(loss_cfg.get("grad_pyramid_w", 0.0)),
                grad_pyramid_levels=int(
                    loss_cfg.get("grad_pyramid_levels", 3))),
            silhouette=float(loss_cfg.get("silhouette_w", 0.0)),
            l2=L2NormConfig(**{k: float(v)
                               for k, v in loss_cfg.l2_norm.items()}),
            mesh_edge=float(loss_cfg.mesh_edge),
            gaussian_connect=float(loss_cfg.gaussian_connect),
            lap_position_strength=float(loss_cfg.laplacian.position_strength),
            lap_color_strength=float(loss_cfg.laplacian.color_strength),
            lap_impose_from=int(loss_cfg.laplacian.impose_from_iter),
        )
        dc = hcfg.density_control.hybrid
        self.inner_steps = int(cfg.tpu.get("inner_steps", 1) or 1)
        knn_backend = str(cfg.tpu.get("knn_backend", "auto"))
        if knn_backend == "auto":
            knn_backend = "chunk" if self.inner_steps > 1 else "dense"
        if knn_backend not in ("dense", "chunk", "window"):
            raise ValueError(f"tpu.knn_backend={knn_backend!r}")
        self.step_cfg = step_cfg = StepConfig(
            weights=weights, opt_geo_from=hcfg.opt_geo_from,
            opt_app_from=hcfg.opt_app_from,
            opacity_norm_from=max(dc.prune_until_iter, dc.densify_until_iter),
            knn_backend=knn_backend, lap_shared=True)
        self.train_step = make_train_step(
            self.avatar_cfg, step_cfg, self.template, self.camera, self.tx,
            self.lpips_params if loss_cfg.lpips_w > 0 else None,
            self.raster_kw)
        stat_fn = None
        if knn_backend == "chunk":
            acfg = self.avatar_cfg

            def stat_fn(params, buffers):
                with torch.no_grad():
                    xyz = get_canon_xyz(params, buffers, acfg)
                return edge_stat(xyz, buffers.alive, k=step_cfg.knn_k)
        self.train_scan = make_train_scan(self.train_step, stat_fn)
        self._init_mesh(capacity)

        self.lap_pos_w = torch.as_tensor(parse_region_weights(
            loss_cfg.laplacian.position_regions_w,
            DEFAULT_POSITION_REGIONS_W), device=dev)
        self.lap_color_w = torch.as_tensor(parse_region_weights(
            loss_cfg.laplacian.color_regions_w, DEFAULT_COLOR_REGIONS_W),
            device=dev)
        self._lap_pad = None
        self._lap_rows_pad = None
        self._lap_band_pad = None
        self._rebuild_laplacians()

        self.density_cfg = dict(dc)
        self.order_rng = random.Random(int(cfg.seed))
        # merge into an existing results json instead of overwriting it
        self.eval_metrics = {}
        run_mode = "eval" if cfg.get("eval") else "train"
        res_path = os.path.join(self.logdir, f"results_{run_mode}.json")
        if os.path.exists(res_path):
            with open(res_path) as fh:
                self.eval_metrics = json.load(fh)

    def _init_mesh(self, capacity: int) -> None:
        """tpu.mesh (dp, gs) with dp * gs > 1: the rank mesh over the
        process group and the sharded step (dist/)."""
        cfg = self.cfg
        mesh_cfg = dict(cfg.tpu.get("mesh", {}) or {})
        dp = int(mesh_cfg.get("dp", 1) or 1)
        gs = int(mesh_cfg.get("gs", 1) or 1)
        self.mesh = None
        self.mesh_dp = 1
        if dp * gs == 1:
            return
        if world_size() != dp * gs:
            raise ValueError(
                f"tpu.mesh requests dp={dp} x gs={gs} ranks, the process "
                f"group has {world_size()} (start one process per rank: "
                f"torchrun --nproc_per_node={dp * gs} -m "
                "sings_tpu_torch.cli.train ...)")
        if self.camera.height % gs:
            raise ValueError(
                f"image height {self.camera.height} must split into gs={gs}"
                " strips (use dataset.downscale or gs that divides it)")
        assert capacity % gs == 0  # capacity is 256-aligned
        lap_type = str(cfg.human.loss.laplacian.type)
        backend = str(cfg.tpu.get("laplacian_backend", "auto"))
        if lap_type == "cotangent" or backend == "banded":
            raise ValueError(
                f"tpu.mesh with laplacian.type={lap_type!r}, "
                f"tpu.laplacian_backend={backend!r}: the sharded step splits"
                " the standard laplacian's gather tables by rows")
        from ..dist.shard import (
            balanced_strip_bounds, dp_generator, make_mesh,
        )
        from ..dist.train_sharded import make_sharded_train_step

        self.mesh = make_mesh(dp * gs, dp=dp)
        self.mesh_dp = dp
        strip_bounds, strip_h_max = None, None
        if mesh_cfg.get("balance_strips") and gs > 1:
            # balanced boundaries from the training masks' row sums (the
            # subject's row density stands for the pair density)
            row_w = self.masks.sum(dim=(0, 2)).cpu().numpy()
            strip_bounds, strip_h_max = balanced_strip_bounds(
                row_w, gs, tile=self.raster_kw.get("tile", 16))
            self._log(f"[mesh] balanced strips: bounds "
                      f"{strip_bounds.tolist()} h_max={strip_h_max}")
        self.strip_bounds = strip_bounds
        lpips_on = float(cfg.human.loss.lpips_w) > 0
        self.train_step_sharded = make_sharded_train_step(
            self.mesh, self.avatar_cfg, self.step_cfg, self.template,
            self.camera, self.tx, self.lpips_params if lpips_on else None,
            self.raster_kw, strip_bounds=strip_bounds,
            strip_h_max=strip_h_max)
        # dp frames a step replace the single-card chunks
        self.inner_steps = 1
        self.step_generator = dp_generator(cfg.seed, self.mesh, self.device)
        self._log(f"[mesh] training on a (dp={dp}, gs={gs}) rank mesh")

    def _log(self, msg: str) -> None:
        if self.io_rank:
            print(msg, flush=True)

    def _sync_from_rank0(self, group) -> None:
        """End a host event: rank 0's params, buffers and optimizer state
        on every rank of the group, and the laplacian rebuilt where rank
        0's topology differs from this rank's."""
        b = self.buffers
        mine = (b.alive, b.vertex_label, b.edges, b.edge_valid)
        self.params, self.buffers, self.opt_state = broadcast_tree(
            (self.params, self.buffers, self.opt_state), group)
        b = self.buffers
        if not all(torch.equal(x, y) for x, y in zip(
                mine, (b.alive, b.vertex_label, b.edges, b.edge_valid))):
            self._rebuild_laplacians()

    def _init_attrs(self) -> None:
        """Pre-fit the decoders (cfg.train.init_steps Adam steps), then
        start the optimizer state afresh."""
        targets = initial_attr_targets(self.avatar_cfg, self.tpl, self.cache,
                                       device=self.device)
        self.params, losses = fit_initial_attrs(
            self.params, self.buffers, self.avatar_cfg, targets,
            steps=int(self.cfg.train.init_steps))
        if len(losses):
            print(f"[init_attrs] loss {float(losses[0]):.5f} -> "
                  f"{float(losses[-1]):.5f}", flush=True)
        self.opt_state = self.tx.init(self.params)

    def _rebuild_laplacians(self) -> None:
        """Region laplacian of the live mesh: laplacian.type standard
        (tpu.laplacian_backend gather, or banded; "auto" means gather in
        the port) or cotangent (weights at the canonical anchors, frozen
        until the next rebuild); every padded shape grows only."""
        b = self.buffers
        edges = b.edges.cpu().numpy()[b.edge_valid.cpu().numpy() > 0.5]
        # dead slots keep their last label in the buffer: excluded
        labels = np.where(b.alive.cpu().numpy() > 0.5,
                          b.vertex_label.cpu().numpy(), -1)
        lap_w = self.lap_pos_w.cpu().numpy()
        lap_type = str(self.cfg.human.loss.laplacian.type)
        if lap_type == "cotangent":
            faces = b.faces.cpu().numpy()[b.face_valid.cpu().numpy() > 0.5]
            self.region_lap = build_cot_region_laplacian(
                self.params.xyz.detach().cpu().numpy(), faces, labels, lap_w,
                num_regions=15, pad_rows_to=self._lap_rows_pad,
                pad_width_to=self._lap_pad or 8, device=self.device)
            self._lap_rows_pad = max(self._lap_rows_pad or 0,
                                     self.region_lap.neighbors.shape[0])
        elif lap_type == "standard":
            backend = str(self.cfg.tpu.get("laplacian_backend", "auto"))
            if backend == "banded":
                def bucketed(raw_w: int) -> int:
                    # grow-only, 64-bucketed half-width with 12% headroom
                    # from the raw RCM bandwidth
                    bw_pad = -(-max(int((raw_w - 1) // 2 * 1.12), 1)
                               // 64) * 64
                    return 2 * bw_pad + 1

                self.region_lap = build_region_laplacian_banded(
                    edges, labels, lap_w, num_regions=15,
                    width_fn=bucketed, pad_width=self._lap_band_pad,
                    device=self.device)
                self._lap_band_pad = self.region_lap.band.shape[1]
                print(f"[laplacian] banded backend, band width "
                      f"{self._lap_band_pad}", flush=True)
            elif backend in ("auto", "gather"):
                self.region_lap = build_region_laplacian(
                    edges, labels, lap_w, num_regions=15,
                    pad_to=self._lap_pad or 8, device=self.device)
            else:
                raise ValueError(f"tpu.laplacian_backend={backend!r}")
        else:
            # 'norm' raises in the JAX package (and its reference) too
            raise NotImplementedError(
                f"laplacian.type={lap_type!r} (supported: 'standard', "
                "'cotangent')")
        if hasattr(self.region_lap, "neighbors"):
            self._lap_pad = max(self._lap_pad or 8,
                                self.region_lap.neighbors.shape[1])
        if getattr(self, "mesh", None) is not None:
            # this rank's rows of the laplacian
            self.region_lap_mesh = shard_region_laplacian(
                self.region_lap, self.mesh.gs).shard(self.mesh.gs_idx)

    # ------------------------------------------------------------------
    def train(self):
        """The training loop: chunks of up to inner_steps steps between
        host events, then the final checkpoint and validation."""
        cfg = self.cfg
        num_steps = int(cfg.train.num_steps)
        order = list(range(len(self.kit.train_split)))
        self.order_rng.shuffle(order)
        cursor = 0
        t0 = time.time()
        log_every = 50
        steps_since_log = 0
        last_loss, last_terms = None, {}
        while self.step < num_steps:
            t_iter = self.step
            # how many consecutive steps can run in one chunk
            k = 1
            if self.inner_steps > 1 and not self._is_event(t_iter):
                while (k < self.inner_steps and t_iter + k < num_steps
                       and not self._is_event(t_iter + k)):
                    k += 1
            frames = []
            for _ in range(k if self.mesh is None else self.mesh_dp):
                if cursor >= len(order):
                    self.order_rng.shuffle(order)
                    cursor = 0
                frames.append(int(self.kit.train_split[order[cursor]]))
                cursor += 1

            laps = (self.region_lap, self.region_lap, self.lap_pos_w,
                    self.lap_color_w)
            if self.mesh is not None:
                # one update: the dp frames' gradients averaged, each
                # frame's work split over its gs ranks
                frame = frames[self.mesh.dp_idx]
                batch = {"rgb": self.images[frame], "mask": self.masks[frame],
                         "idx": frame,
                         "smpl_scale": torch.ones(1, device=self.device)}
                (self.params, self.buffers, self.opt_state,
                 metrics) = self.train_step_sharded(
                    self.params, self.buffers, self.opt_state, self.cache,
                    batch, self.step_generator, t_iter,
                    self.active_sh_degree, self.region_lap_mesh,
                    self.region_lap_mesh, self.lap_pos_w, self.lap_color_w)
                last_loss = metrics["loss"]
                last_terms = {n: v for n, v in metrics.items()
                              if n not in ("loss", "skipped")}
                if float(metrics["skipped"]) > 0:
                    self._log(f"[{t_iter}] WARNING: non-finite gradients, "
                              "update skipped")
                render = None
            elif k == 1:
                frame = frames[0]
                batch = {"rgb": self.images[frame], "mask": self.masks[frame],
                         "idx": frame,
                         "smpl_scale": torch.ones(1, device=self.device)}
                (self.params, self.buffers, self.opt_state, metrics,
                 render) = self.train_step(
                    self.params, self.buffers, self.opt_state, self.cache,
                    batch, self.step_generator, t_iter,
                    self.active_sh_degree, *laps)
                last_loss = metrics["loss"]
                last_terms = {n: v for n, v in metrics.items()
                              if n not in ("loss", "skipped")}
                if float(metrics["skipped"]) > 0:
                    print(f"[{t_iter}] WARNING: non-finite gradients, "
                          "update skipped")
            else:
                batches = {"rgb": self.images[frames],
                           "mask": self.masks[frames], "idx": frames,
                           "smpl_scale": torch.ones((k, 1),
                                                    device=self.device)}
                (self.params, self.buffers, self.opt_state, losses, skipped,
                 term_metrics) = self.train_scan(
                    self.params, self.buffers, self.opt_state, self.cache,
                    batches, self.step_generator, t_iter,
                    self.active_sh_degree, *laps)
                last_loss = losses[-1]
                last_terms = {n: v[-1] for n, v in term_metrics.items()
                              if n not in ("loss", "skipped")}
                n_skip = float(skipped.sum())
                if n_skip > 0:
                    print(f"[{t_iter}] WARNING: {int(n_skip)}/{k} steps had "
                          "non-finite gradients, updates skipped")
                render = None

            steps_since_log += k
            if steps_since_log >= log_every:
                n_alive = int(self.buffers.alive.sum())
                dt = time.time() - t0
                terms = "".join(
                    f" {n.replace('photo_', '')}={float(v):.3f}"
                    for n, v in sorted(last_terms.items()))
                self._log(f"[{t_iter:6d}] loss={float(last_loss):.4f} "
                          f"n_gs={n_alive / 1000:.1f}K "
                          f"({steps_since_log / max(dt, 1e-9):.2f} it/s)"
                          f"{terms}")
                t0 = time.time()
                steps_since_log = 0

            last_t = t_iter + k - 1
            self._periodic_check(last_t, render)
            self._adjust_density(last_t)
            if self.mesh is not None and self._is_event(last_t):
                self._sync_from_rank0(self.mesh.group)
            self.step += k

        result = None
        if self.io_rank:
            self.save_ckpt("final")
            result = self.validate("final")
        return broadcast_object(result, _world_group())

    def _is_event(self, t: int) -> bool:
        """True when step t triggers host-side work after it runs
        (periodic checks, SH bump, density control): chunks break there."""
        cfg = self.cfg
        if t > 0 and (
            t % cfg.train.save_ckpt_interval == 0
            or t % cfg.train.val_interval == 0
            or (self.anim_dataset is not None
                and t % cfg.train.anim_interval == 0)
            or t % cfg.train.viz_interval == 0
            or t % 1000 == 0
        ):
            return True
        dc = self.density_cfg
        if (dc["prune_from_iter"] <= t < dc["prune_until_iter"]
                and (t - dc["prune_from_iter"]) % dc["prune_interval"] == 0):
            return True
        if (dc["densify_from_iter"] <= t < dc["densify_until_iter"]
                and (t - dc["densify_from_iter"] - dc["densify_interval"])
                % dc["densify_interval"] == 0):
            return True
        return False

    def _periodic_check(self, t_iter: int, render) -> None:
        """Checkpoint, validation, animation and visualisation when due
        (rank 0's; the other ranks wait at a barrier), then the SH
        schedule (every rank)."""
        cfg = self.cfg
        due = t_iter > 0 and [
            t_iter % cfg.train.save_ckpt_interval == 0,
            t_iter % cfg.train.val_interval == 0,
            self.anim_dataset is not None
            and t_iter % cfg.train.anim_interval == 0,
            t_iter % cfg.train.viz_interval == 0]
        if due and self.io_rank:
            if due[0]:
                self.save_ckpt(f"{t_iter:06d}")
            if due[1]:
                self.validate(f"{t_iter:06d}")
            if due[2]:
                self.animate_chunk(iter_s=f"{t_iter:06d}", max_frames=32,
                                   save_video=False)
            if due[3]:
                self.visualize(f"{t_iter:06d}")
        if due and any(due):
            barrier(_world_group())
        if t_iter % 1000 == 0 and t_iter > 0:
            if self.active_sh_degree < self.cfg.human.sh_degree:
                self.active_sh_degree += 1

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _fwd_numpy(self) -> dict:
        """Fresh forward for density decisions, pulled to the host."""
        out = avatar_forward(self.params, self.buffers, self.avatar_cfg,
                             self.template, self.cache, dataset_idx=0,
                             smpl_scale=torch.ones(1, device=self.device))
        return {k: v.cpu().numpy() for k, v in out.items()
                if k in ("xyz_canon", "scales_canon", "scales", "shs",
                         "opacity")}

    def _buffers_numpy(self) -> dict:
        return {f: getattr(self.buffers, f).cpu().numpy()
                for f in self.buffers._fields}

    def _apply_density_result(self, res) -> None:
        if not res.changed:
            return
        b = self.buffers

        def t(x, like):
            return torch.as_tensor(np.asarray(x), dtype=like.dtype,
                                   device=self.device).reshape(like.shape)

        self.buffers = b._replace(
            alive=t(res.alive, b.alive),
            scaling_multiplier=t(res.scaling_multiplier,
                                 b.scaling_multiplier),
            lbs_weights=t(res.lbs_weights, b.lbs_weights),
            vertex_label=t(res.vertex_label, b.vertex_label),
            anchor_normals=t(res.anchor_normals, b.anchor_normals),
            faces=t(res.faces, b.faces),
            face_valid=t(res.face_valid, b.face_valid),
            edges=t(res.edges, b.edges),
            edge_valid=t(res.edge_valid, b.edge_valid),
            num_level0=t(res.num_alive, b.num_level0),
            max_radii2d=torch.zeros_like(b.max_radii2d),
            xyz_grad_accum=torch.zeros_like(b.xyz_grad_accum),
            grad_denom=torch.zeros_like(b.grad_denom),
        )
        if res.new_xyz is not None:
            self.params = self.params._replace(
                xyz=t(res.new_xyz, self.params.xyz))
        self.opt_state = zero_moments_for_slots(
            self.opt_state, torch.as_tensor(res.changed_slots,
                                            device=self.device))
        self._reset_opacity()
        self._rebuild_laplacians()

    @torch.no_grad()
    def _reset_opacity(self) -> None:
        """Raise the opacity floor to 0.5 (sings_hybrid.py:1260-1278)."""
        if self.avatar_cfg.fixed_opacity:
            return
        feats = triplane_features(self.params.triplane, self.params.xyz,
                                  self.avatar_cfg.triplane)
        logit = appearance_opacity_logit(self.params.appearance_dec, feats,
                                         self.avatar_cfg.decoder)
        offset = torch.where(logit > 0, torch.zeros_like(logit), -logit)
        self.buffers = self.buffers._replace(opacity_offset=offset)

    def _adjust_density(self, t_iter: int) -> None:
        dc = self.density_cfg
        prune_flag = False
        if (dc["prune_from_iter"] <= t_iter < dc["prune_until_iter"]
                and (t_iter - dc["prune_from_iter"])
                % dc["prune_interval"] == 0):
            fwd = self._fwd_numpy()
            res = prune_and_simplify(
                self._buffers_numpy(), self.params.xyz.cpu().numpy(), fwd,
                opacity_threshold=dc["prune_opacity_threshold"],
                scale_threshold=dc["prune_scale_threshold"],
                prune_max_n_gs_once=dc.get("prune_max_n_gs_once", 5000),
                min_n_gs=int(self.cfg.human.density_control.min_n_gaussians),
                collapse_rate=dc.get("prune_collapse_rate", 0.5),
                face_capacity=self.avatar_cfg.face_capacity,
                edge_capacity=self.avatar_cfg.edge_capacity)
            if res.changed:
                prune_flag = True
                self._log(f"[density] prune -> {res.num_alive} gaussians")
                self._apply_density_result(res)

        if (dc["densify_from_iter"] <= t_iter < dc["densify_until_iter"]
                and (t_iter - dc["densify_from_iter"]
                     - dc["densify_interval"])
                % dc["densify_interval"] == 0):
            if prune_flag:
                # reference quirk: skip + drift the interval
                # (gs_trainer.py:311-313)
                dc["densify_interval"] += 1
                return
            fwd = self._fwd_numpy()
            res = densify_and_subdivide(
                self._buffers_numpy(), self.params.xyz.cpu().numpy(), fwd,
                grad_threshold=dc["densify_grad_threshold"],
                scale_threshold=dc["densify_scale_threshold"],
                max_screen_size=dc.get("densify_render_size_threshold", 20),
                max_n_gs=int(self.cfg.human.density_control.max_n_gaussians),
                face_capacity=self.avatar_cfg.face_capacity,
                edge_capacity=self.avatar_cfg.edge_capacity)
            if res.changed:
                self._log(f"[density] densify -> {res.num_alive} gaussians")
                new_mask = res.changed_slots > 0.5
                self._apply_density_result(res)
                self._rescale_new_scales(new_mask, fwd)

    def _rescale_new_scales(self, new_mask: np.ndarray, old_fwd: dict):
        """Match decoded scales of new slots to interpolated targets
        (sings_hybrid.py:1140-1147): target = clipped mean parent scale."""
        fwd = self._fwd_numpy()
        target = np.clip(old_fwd["scales_canon"].mean(-1), None, 0.008)
        fresh = fwd["scales_canon"].mean(-1)
        mult = self.buffers.scaling_multiplier.cpu().numpy().copy()
        ratio = np.clip(target.mean() / np.maximum(fresh, 1e-9), 0.05, 20.0)
        mult[new_mask, 0] *= ratio[new_mask]
        self.buffers = self.buffers._replace(
            scaling_multiplier=torch.as_tensor(mult, device=self.device))

    # ------------------------------------------------------------------
    def _pose_tensors(self, data: dict) -> dict:
        """Explicit SMPL arguments of a render as device tensors; the
        learned per-frame pose of data['dataset_idx'] when global_orient
        is None."""
        p = self.params
        if data.get("global_orient") is None and "dataset_idx" in data:
            i = int(data["dataset_idx"])
            data = dict(
                data,
                global_orient=rotation_6d_to_axis_angle(
                    p.global_orient[i].reshape(1, 6)).reshape(3),
                body_pose=rotation_6d_to_axis_angle(
                    p.body_pose[i].reshape(-1, 6)).reshape(-1),
                betas=p.betas, transl=p.transl[i])

        def t(x):
            if not isinstance(x, torch.Tensor):
                x = np.asarray(x, np.float32)
            return torch.as_tensor(x, device=self.device)

        betas = data.get("betas")
        out = {"global_orient": t(data["global_orient"]),
               "body_pose": t(data["body_pose"]),
               "betas": t(p.betas if betas is None else betas),
               "transl": t(data["transl"]),
               "smpl_scale": t(data.get("smpl_scale", np.ones(1)))}
        if data.get("ext_tfs") is not None:
            out["ext_tfs"] = tuple(t(x) for x in data["ext_tfs"])
        return out

    def _render_pose(self, pose: dict, camera, bg):
        """avatar_forward (eval mode) + rasterize of one pose: the raw
        render (3, H, W) and the forward outputs; differentiable in the
        pose tensors."""
        out = avatar_forward(
            self.params, self.buffers, self.avatar_cfg, self.template,
            self.cache, global_orient=pose["global_orient"],
            body_pose=pose["body_pose"], betas=pose["betas"],
            transl=pose["transl"], smpl_scale=pose["smpl_scale"],
            ext_tfs=pose.get("ext_tfs"), eval_mode=True)
        shs = out["shs"] * sh_degree_mask(self.active_sh_degree,
                                          self.device)[None, :, None]
        pkg = rasterize(out["xyz"], out["scales"], out["rotq"],
                        out["opacity"][:, 0], shs, camera, sh_degree=3,
                        bg=bg, alive=self.buffers.alive > 0.5,
                        backend="pallas", **self.raster_kw)
        # the raw render: val psnr/ssim read it unclamped
        return pkg["render"], out

    @torch.no_grad()
    def _render_eval(self, data: dict, camera=None, bg=None):
        camera = camera or self.camera
        bg = self.bg_color * 0 if bg is None else bg
        return self._render_pose(self._pose_tensors(data), camera, bg)

    def _val_pose_refine(self, data: dict, frame: int, steps: int) -> dict:
        """Test-time pose refinement of a val frame: Adam (lr 2e-3, as
        optax.adam) on (global_orient, body_pose, transl) of the frozen
        avatar against the masked MSE; a step with non-finite gradients
        applies zero gradients, as in the JAX package."""
        gt = self.images[frame]
        mask = self.masks[frame][None]
        full = self._pose_tensors(data)
        names = ("body_pose", "global_orient", "transl")
        pose = {k: full[k].clone() for k in names}
        state = adam_init(pose)
        zero_bg = torch.zeros(3, device=self.device)
        for _ in range(steps):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in pose.items()}
            img, _ = self._render_pose(dict(full, **leaves), self.camera,
                                       zero_bg)
            loss = (((img - gt) * mask) ** 2).sum() / torch.clamp_min(
                mask.sum() * 3, 1.0)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
            finite = torch.stack([torch.isfinite(g).all()
                                  for g in grads]).all()
            grads = {k: torch.where(finite, g, torch.zeros_like(g))
                     for k, g in zip(names, grads)}
            direction, state = adam_directions(grads, state, eps=1e-8)
            pose = {k: pose[k] - 2e-3 * direction[k] for k in names}
        return {k: v.detach().cpu().numpy() for k, v in pose.items()}

    def _val_gauge_alignment(self):
        """Global canonical-frame drift, estimated from TRAIN frames only:
        dR = polar(sum_i R_learned_i R_fit_i^T), dt = mean_i(t_learned_i
        - dR t_fit_i). Returns (dR (3, 3), dt (3,)) numpy, or None when
        the poses are not learned."""
        if self.params.global_orient is None:
            return None
        tr = np.asarray(self.kit.train_split)
        idx = torch.as_tensor(tr, device=self.params.global_orient.device)
        r_l = rotation_6d_to_matrix(
            self.params.global_orient[idx].reshape(-1, 6)).cpu().numpy()
        r_f = axis_angle_to_matrix(torch.as_tensor(np.asarray(
            self.kit.smpl["global_orient"], np.float32)[tr].reshape(-1, 3))
        ).numpy()
        m = np.einsum("fij,fkj->ik", r_l, r_f)  # sum R_l R_f^T
        u, _s, vt = np.linalg.svd(m)
        d = np.sign(np.linalg.det(u @ vt))
        dr = u @ np.diag([1.0, 1.0, d]) @ vt
        t_l = self.params.transl[idx].cpu().numpy()
        t_f = self.kit.smpl["transl"][tr]
        dt = (t_l - t_f @ dr.T).mean(axis=0)
        return dr.astype(np.float32), dt.astype(np.float32)

    def validate(self, iter_s="final") -> dict:
        """The reference protocol's psnr/ssim/lpips (black-bg render vs
        raw GT) plus psnr_masked, psnr_composite, the gauge-aligned and
        pose-refined masked PSNRs, the train-frame masked PSNR and the
        attribute diagnostics, written to results_{train,eval}.json. The
        diagnostics print their failure instead of raising, as in the JAX
        package."""
        metrics = {"psnr": [], "ssim": [], "lpips": [], "psnr_masked": [],
                   "psnr_composite": []}
        refine_steps = int(self.cfg.tpu.get("val_pose_refine_steps", 0))
        if refine_steps > 0:
            metrics["psnr_masked_refined"] = []
        gauge = None
        if bool(self.cfg.tpu.get("val_gauge_align", True)):
            try:
                gauge = self._val_gauge_alignment()
            except Exception as e:  # diagnostics must never kill a run
                print(f"[val] gauge alignment failed: {e}", flush=True)
        if gauge is not None:
            metrics["psnr_masked_aligned"] = []
        zero_bg = torch.zeros(3, device=self.device)
        for i, frame in enumerate(self.kit.val_split):
            data = {"global_orient": self.kit.smpl["global_orient"][frame],
                    "body_pose": self.kit.smpl["body_pose"][frame],
                    "betas": self.kit.smpl["betas"],
                    "transl": self.kit.smpl["transl"][frame]}
            img, _ = self._render_eval(data, bg=zero_bg)
            gt = self.images[frame]
            m = self.masks[frame][None]
            metrics["psnr"].append(float(psnr(img, gt)))
            metrics["ssim"].append(float(ssim(img, gt)))
            with torch.no_grad():
                metrics["lpips"].append(float(lpips_distance(
                    self.lpips_params, img[None].clamp(max=1.0),
                    gt[None])[0]))
            metrics["psnr_masked"].append(_masked_psnr(img, gt, m))
            metrics["psnr_composite"].append(float(psnr(img, gt * m)))
            if gauge is not None:
                try:
                    dr, dt = gauge
                    r_val = axis_angle_to_matrix(torch.as_tensor(
                        np.asarray(data["global_orient"], np.float32)
                    ).reshape(1, 3))[0]
                    go_a = matrix_to_axis_angle(
                        (torch.as_tensor(dr) @ r_val)[None])[0].numpy()
                    data_a = dict(
                        data, global_orient=go_a,
                        transl=dr @ data["transl"] + dt,
                        betas=self.params.betas.cpu().numpy())
                    img_a, _ = self._render_eval(data_a, bg=zero_bg)
                    metrics["psnr_masked_aligned"].append(
                        _masked_psnr(img_a, gt, m))
                except Exception as e:
                    print(f"[val] gauge-aligned render failed: {e}",
                          flush=True)
                    gauge = None
                    metrics.pop("psnr_masked_aligned", None)
            if refine_steps > 0:
                try:
                    pose = self._val_pose_refine(data, frame, refine_steps)
                    img_r, _ = self._render_eval(dict(data, **pose),
                                                 bg=zero_bg)
                    metrics["psnr_masked_refined"].append(
                        _masked_psnr(img_r, gt, m))
                except Exception as e:
                    print(f"[val] pose refine failed: {e}", flush=True)
                    refine_steps = 0
                    metrics.pop("psnr_masked_refined", None)
            if i < 4:
                self._save_image_pair(gt, img, os.path.join(
                    self.logdir, "val", f"full_{iter_s}_{i:03d}.png"))
        result = {k: float(np.mean(v)) for k, v in metrics.items()}
        # train-frame masked PSNR with the learned per-frame poses
        try:
            tr = []
            for frame in self.kit.train_split[:: max(
                    1, len(self.kit.train_split) // 8)][:8]:
                img, _ = self._render_eval(
                    {"global_orient": None, "body_pose": None, "betas": None,
                     "transl": None, "dataset_idx": int(frame)}, bg=zero_bg)
                tr.append(_masked_psnr(img, self.images[frame],
                                       self.masks[frame][None]))
            result["psnr_masked_train"] = float(np.mean(tr))
        except Exception as e:  # diagnostics must never kill a run
            print(f"[val] train-frame diagnostics failed: {e}", flush=True)
        # random-feature LPIPS is not comparable to the pretrained metric
        result["lpips_pretrained"] = bool(self.lpips_params.pretrained)
        try:
            with torch.no_grad():
                attrs = get_gs_attrs(self.params, self.buffers,
                                     self.avatar_cfg)
            alive = self.buffers.alive.cpu().numpy() > 0.5
            sc = attrs["scales"].cpu().numpy()[alive]
            op = attrs["opacity"].cpu().numpy()[alive].reshape(-1)
            print(f"[val {iter_s}] scales mean/p99/max "
                  f"{sc.mean():.4f}/{np.percentile(sc, 99):.4f}/"
                  f"{sc.max():.4f} opacity mean/p99 {op.mean():.4f}/"
                  f"{np.percentile(op, 99):.4f}", flush=True)
            result["scales_p99"] = float(np.percentile(sc, 99))
            result["opacity_mean"] = float(op.mean())
        except Exception as e:  # diagnostics must never kill a run
            print(f"[val] attr diagnostics failed: {e}", flush=True)
        self.eval_metrics[iter_s] = result
        print(f"[val {iter_s}] " + " ".join(
            f"{k}={v:.4f}" for k, v in result.items()), flush=True)
        run_mode = "eval" if self.cfg.get("eval") else "train"
        with open(os.path.join(self.logdir,
                               f"results_{run_mode}.json"), "w") as fh:
            json.dump(self.eval_metrics, fh, indent=2)
        return result

    def _save_image_pair(self, gt, pred, path: str) -> None:
        a = (gt.permute(1, 2, 0).cpu().numpy() * 255).astype(np.uint8)
        self.save_image(path, np.concatenate([a, _to_uint8(pred)], axis=1))

    # ------------------------------------------------------------------
    def render_canonical(self, iter_s="final", nframes=10, img_size=256,
                         pose_type=None) -> None:
        """Turntable render in a static pose (gs_trainer.py:757-851)."""
        pose_type = pose_type or self.cfg.human.canon_pose_type
        cams = get_rotating_cameras(img_size=img_size, nframes=nframes,
                                    device=self.device)
        static = get_smpl_static_params(self.params.betas.cpu().numpy(),
                                        pose_type=pose_type)
        out_dir = os.path.join(self.logdir, "canon")
        for i, cam in enumerate(cams):
            img, _ = self._render_eval(static, camera=cam, bg=self.bg_color)
            self.save_image(os.path.join(out_dir, f"{pose_type}_{i:05d}.png"),
                            _to_uint8(img))

    @torch.no_grad()
    def visualize(self, iter_s) -> None:
        out = avatar_forward(self.params, self.buffers, self.avatar_cfg,
                             self.template, self.cache, dataset_idx=0,
                             smpl_scale=torch.ones(1, device=self.device))
        out = {k: v.cpu().numpy() for k, v in out.items()
               if isinstance(v, torch.Tensor)}
        alive = self.buffers.alive.cpu().numpy()
        mesh_dir = os.path.join(self.logdir, "meshes")
        save_ply(out, os.path.join(mesh_dir, f"human_pcd_{iter_s}_splat.ply"),
                 alive=alive)
        save_ellipsoid_mesh(out, os.path.join(
            mesh_dir, f"human_voxel_{iter_s}_deformed_rgb.ply"), alive=alive)

    def save_splat_file(self, pose_type="little_a_pose") -> str:
        data = get_smpl_static_params(self.params.betas.cpu().numpy(),
                                      pose_type=pose_type)
        _, out = self._render_eval(data, bg=self.bg_color)
        path = os.path.join(self.logdir, "showcase.splat")
        save_splat({k: v.cpu().numpy() for k, v in out.items()
                    if isinstance(v, torch.Tensor)}, path,
                   alive=self.buffers.alive.cpu().numpy())
        return path

    # ------------------------------------------------------------------
    def _fit_synthetic_body(self):
        """Geometrically calibrate the synthetic template, or load the
        calibration cached in the logdir (synthetic_fit.npz).

        Two stages, as in the JAX package (reference
        ooptimize_smplh.py:263-404): (A) a keypoint-only skeleton fit of
        the shared bone proportions and per-frame pose/transl against
        the kit's sapiens coco-133 keypoints; (B) a silhouette+keypoint
        refinement of all betas and poses against the kit's masks. It
        runs before self.raster_kw exists, so refine_smpl takes its own
        raster settings, as the JAX trainer's call does."""
        nb = self.tpl.num_betas
        cache_path = os.path.join(self.logdir, "synthetic_fit.npz")
        if os.path.exists(cache_path):
            data = dict(np.load(cache_path))
            if data["betas"].shape[-1] == nb:
                self.kit = self.kit._replace(smpl={
                    k: data[k] for k in ("betas", "global_orient",
                                         "body_pose", "transl")})
                print("[fit_synthetic] loaded cached calibration", flush=True)
                return
            print("[fit_synthetic] cached calibration has stale betas "
                  f"({data['betas'].shape[-1]} != {nb}); refitting",
                  flush=True)
        if self.cfg.eval:
            # eval without a calibration cache: keep the kit poses and
            # the zeroed betas (already sized to the template)
            print("[fit_synthetic] eval mode, no cache: zeroed betas",
                  flush=True)
            return
        from ..preprocess.refine import (
            RefineConfig, SkeletonFitConfig, coco133_body_targets,
            face_anchor_targets, fit_skeleton, refine_smpl,
        )

        cam = self.camera
        d = max(1, min(cam.height, cam.width) // 128)
        init = {"betas": np.zeros(nb, np.float32),
                "global_orient": self.kit.smpl["global_orient"],
                "body_pose": self.kit.smpl["body_pose"],
                "transl": self.kit.smpl["transl"]}
        K = np.array([[cam.width / (2 * cam.tan_fovx), 0, cam.width / 2],
                      [0, cam.height / (2 * cam.tan_fovy), cam.height / 2],
                      [0, 0, 1]], np.float32)
        dt = DeviceTemplate.from_host(self.tpl, self.device)

        kp_t = kp_w = face_t = face_w = face_o = None
        if self.kit.keypoints is not None:
            kp_t, kp_w = coco133_body_targets(self.kit.keypoints,
                                              self.kit.keypoint_scores)
            face_t, face_w = face_anchor_targets(self.kit.keypoints,
                                                 self.kit.keypoint_scores)
            beta_mask = np.zeros(nb, np.float32)
            beta_mask[0] = 1.0
            if self.tpl.n_bone_betas:
                beta_mask[-self.tpl.n_bone_betas:] = 1.0
            res_a = fit_skeleton(
                dt, K, init, kp_t, kp_w,
                SkeletonFitConfig(steps=int(self.cfg.tpu.get(
                    "skeleton_fit_steps", 500))),
                beta_mask=beta_mask, face_targets=face_t,
                face_weights=face_w)
            print(f"[fit_synthetic] keypoint px err "
                  f"{res_a['px_err'][0]:.2f} -> {res_a['px_err'][-1]:.2f}",
                  flush=True)
            init = {k: res_a[k] for k in init}
            face_o = res_a.get("face_offsets")
        else:
            print("[fit_synthetic] no keypoints_coco133 in kit; "
                  "silhouette-only fit", flush=True)

        cfg = RefineConfig(
            steps=int(self.cfg.tpu.get("synthetic_fit_steps", 300)),
            lr=0.01, render_downscale=d,
            w_keypoints=0.5 if kp_t is not None else 0.0,
            w_face=0.5 if face_o is not None else 0.0,
            w_prior=0.05, optimize_betas=True)
        res = refine_smpl(dt, cam, K, init, self.kit.masks,
                          keypoints2d=kp_t, keypoint_valid=kp_w, cfg=cfg,
                          face_targets=face_t, face_weights=face_w,
                          face_offsets=face_o)
        print(f"[fit_synthetic] silhouette loss "
              f"{res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}",
              flush=True)
        smpl = {k: res[k] for k in ("betas", "global_orient", "body_pose",
                                    "transl")}
        self.kit = self.kit._replace(smpl=smpl)
        np.savez(cache_path, **smpl)

    def save_ckpt(self, iter_s="final") -> str:
        path = os.path.join(self.logdir_ckpt, f"human_{iter_s}.npz")
        save_checkpoint(path, params=self.params, buffers=self.buffers,
                        opt_state=getattr(self, "opt_state", None),
                        step=self.step,
                        active_sh_degree=self.active_sh_degree)
        print(f"[ckpt] saved {path}", flush=True)
        return path

    def load_ckpt(self, path: str) -> bool:
        """Load params, buffers, step, SH degree and, in train mode, the
        Adam state; False (and the state untouched) when the checkpoint
        does not fit this config."""
        training = self.mode == "train"
        try:
            res = load_checkpoint(path, self.avatar_cfg,
                                  num_joints=self.tpl.lbs_weights.shape[1],
                                  device=self.device, with_opt=training)
        except CheckpointShapeMismatch as e:
            print(f"[ckpt] IGNORING {path}: {e} (likely written with a "
                  "different capacity/config) - training from scratch",
                  flush=True)
            return False
        self.params = res["params"]
        self.buffers = res["buffers"]
        self.step = res["step"]
        self.active_sh_degree = res["active_sh_degree"]
        if training:
            self.opt_state = res["opt_state"]
            self._rebuild_laplacians()
        print(f"[ckpt] loaded {path} (step {self.step})", flush=True)
        return True

    # ------------------------------------------------------------------
    @torch.no_grad()
    def pose_chunk(self, gs_attrs: dict, chunk: dict) -> dict:
        """avatar_forward_chunk on one padded chunk of the dataset."""
        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x),
                                   device=self.device)

        return avatar_forward_chunk(
            self.params, self.buffers, self.avatar_cfg, self.template,
            self.cache, gs_attrs,
            global_orient=t(chunk["global_orient"]),
            body_pose=t(chunk["body_pose"]),
            betas=self.params.betas,
            transl=t(chunk["transl"]),
            smpl_scale=t(chunk["smpl_scale"]),
            ext_tfs=tuple(t(x) for x in chunk["ext_tfs"]))

    def frame_gaussians(self, posed: dict, b: int) -> tuple:
        """Positional rasterize() inputs of frame b: means, scales, quats,
        opacities, SH features masked to the active degree."""
        deg_mask = sh_degree_mask(self.active_sh_degree, self.device)
        return (posed["xyz"][b], posed["scales"][b], posed["rotq"][b],
                posed["opacity"][b][:, 0],
                posed["shs"][b] * deg_mask[None, :, None])

    @torch.no_grad()
    def render_chunk(self, gs_attrs: dict, chunk: dict) -> torch.Tensor:
        """(B, H, W, 3) uint8 frames of one padded chunk, on the device."""
        with span("anim.pose"):
            posed = self.pose_chunk(gs_attrs, chunk)
            alive = self.buffers.alive > 0.5
        frames = []
        for b in range(posed["xyz"].shape[0]):
            with span("anim.frame"):
                pkg = rasterize(
                    *self.frame_gaussians(posed, b),
                    self.anim_dataset.camera, sh_degree=3, bg=self.bg_color,
                    alive=alive, backend="pallas", **self.raster_kw)
                frames.append(quantize(pkg["render"]))
        return torch.stack(frames)

    def animate_chunk(self, chunk_size=16, iter_s="final", save_video=True,
                      max_frames=None, writer=None):
        """Render the animation dataset. writer(frames (b, H, W, 3) uint8
        numpy, start_index) receives each chunk in order; the default
        writes <logdir>/anim/%05d.jpg. Returns frames per second."""
        if self.anim_dataset is None:
            print("No animation dataset")
            return 0.0
        ds = self.anim_dataset
        num_frames = ds.num_frames if max_frames is None else min(
            ds.num_frames, max_frames)
        out_dir = os.path.join(self.logdir, "anim")
        os.makedirs(out_dir, exist_ok=True)

        with torch.no_grad():
            gs_attrs = get_gs_attrs(self.params, self.buffers,
                                    self.avatar_cfg)
        t_start = time.time()
        frames_done = 0
        pending: list[tuple] = []
        encodes = []
        with cf.ThreadPoolExecutor(max_workers=4) as pool:
            sink = writer or _jpeg_writer(out_dir, pool, self.save_image)

            def drain(limit):
                nonlocal frames_done
                while len(pending) > limit:
                    dev_imgs, s0, b0 = pending.pop(0)
                    with span("anim.readback"):
                        host = dev_imgs[:b0].cpu().numpy()
                    res = sink(host, s0)
                    encodes.extend(res or [])
                    frames_done += b0

            for start in range(0, num_frames, chunk_size):
                chunk = ds.get_chunk(start, start + chunk_size)
                b = min(chunk["body_pose"].shape[0], num_frames - start)
                if b < chunk_size:  # pad to the chunk size, drop extras

                    def fit(x):
                        x = x[:b]
                        return np.concatenate(
                            [x, np.repeat(x[-1:], chunk_size - b, 0)])

                    chunk = {k: (tuple(fit(x) for x in v)
                                 if isinstance(v, tuple) else fit(v))
                             for k, v in chunk.items()}
                # the device renders chunk k+1 while chunk k is read back
                pending.append((self.render_chunk(gs_attrs, chunk), start, b))
                drain(1)
            drain(0)
            for f in encodes:
                f.result()
        dt = time.time() - t_start
        fps = frames_done / max(dt, 1e-9)
        print(f"[anim] {frames_done} frames in {dt:.2f}s ({fps:.2f} fps)",
              flush=True)
        if save_video:
            from ..export.video import create_video

            video = os.path.join(self.logdir,
                                 f"anim_{ds.motion_name}_{iter_s}.mp4")
            create_video(out_dir, video, fps=20, ext="jpg")
        return fps
