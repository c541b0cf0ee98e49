"""Trainer (port of sings_tpu/train/trainer.py): animation mode and the
train-mode constructor.

Trainer(cfg, mode="anim") builds what the JAX constructor builds for an
animation run: the kit (or an in-memory one), the animation dataset,
the body template with its cached synthetic calibration, the avatar
config and state, and the latest checkpoint. animate_chunk renders the
motion 16 frames at a time: decode once, pose a chunk with batched LBS,
rasterize each frame, quantise to uint8 on the device.

Trainer(cfg, mode="train") also builds the optimizer and its state, the
loss weights and StepConfig from the YAML keys, the region laplacian,
the decoder pre-fit (init_attrs) and self.train_step /
self.train_scan, the step and K-step chunk that bench.py's recipe
benchmark drives. Trainer.train() (the loop with logging, validation,
checkpoints, SH annealing and density control) is a later slice and
raises, as does resuming a training run from a checkpoint.

Deviations from the JAX signatures:
  * Trainer(..., kit=TrainingKit) takes a kit held in memory, so a run
    needs no image files (and no image library) on disk;
  * animate_chunk(..., writer=callable) takes the frame sink; the
    default writes JPEGs with PIL, imported only then, which lets a
    machine without PIL or cv2 render;
  * train_step / train_scan take a torch.Generator (self.step_generator)
    where JAX takes PRNG keys, and optionally the draws themselves.
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
from ..fields.decoders import DecoderConfig
from ..fields.triplane import TriplaneConfig
from ..kinematics.body_model import load_template
from ..kinematics.template import DeviceTemplate, canonical_pose_cache
from ..losses.photometric import PhotometricWeights
from ..losses.regularizers import (
    L2NormConfig, build_region_laplacian, edge_stat,
)
from ..model.avatar import (
    AvatarConfig, avatar_forward_chunk, fit_initial_attrs, get_canon_xyz,
    get_gs_attrs, init_avatar, initial_attr_targets,
)
from ..ops.rasterizer.api import rasterize
from .checkpoint import latest_checkpoint, load_checkpoint
from .optim import LRConfig, TrainFlags, make_optimizer
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


def _jpeg_writer(out_dir: str, pool: cf.ThreadPoolExecutor):
    def write(frames: np.ndarray, start: int):
        from PIL import Image

        def encode(j):
            Image.fromarray(frames[j]).save(
                os.path.join(out_dir, f"{start + j:05d}.jpg"))

        return [pool.submit(encode, j) for j in range(frames.shape[0])]
    return write


class Trainer:
    def __init__(self, cfg, mode: str = "anim", device=None,
                 kit: TrainingKit | None = None):
        if mode not in ("anim", "train"):
            raise NotImplementedError(
                f"mode={mode!r}: the port has 'anim' and 'train'")
        self.cfg = cfg
        self.device = resolve_device(device)
        random.seed(cfg.seed)
        np.random.seed(cfg.seed)
        self.generator = torch.Generator().manual_seed(int(cfg.seed))

        self.logdir = cfg.logdir or os.path.join(
            cfg.output_path, cfg.exp_name, cfg.dataset.name)
        self.logdir_ckpt = cfg.logdir_ckpt or os.path.join(self.logdir,
                                                           "ckpt")
        for sub in ("", "ckpt", "anim"):
            os.makedirs(os.path.join(self.logdir, sub), exist_ok=True)
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
            self._fit_synthetic_body()
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

        ckpt = hcfg.ckpt or latest_checkpoint(self.logdir_ckpt)
        if ckpt and os.path.exists(str(ckpt)):
            if mode == "train" and not cfg.eval:
                raise NotImplementedError(
                    f"found checkpoint {ckpt}: resuming a training run is "
                    "a later slice of the port (ROADMAP queue A 2); use a "
                    "fresh output_path")
            self.load_ckpt(str(ckpt))
        elif mode == "train" and not cfg.eval:
            self._init_attrs()

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
        # LPIPS: pretrained weights keep lpips_w, the random-feature
        # fallback scales it by random_lpips_factor; either way a
        # positive weight needs the LPIPS network, not ported yet
        lpips_path = cfg.tpu.get("lpips_weights")
        pretrained = bool(lpips_path) and os.path.exists(str(lpips_path))
        lpips_w = float(loss_cfg.lpips_w)
        if not pretrained and lpips_w > 0:
            lpips_w *= float(cfg.tpu.get("random_lpips_factor", 0.05))
        if lpips_w > 0:
            raise NotImplementedError(
                f"LPIPS weight {lpips_w} > 0: losses/lpips.py is not "
                "ported; it waits for pretrained VGG-LPIPS weights in the "
                f"repository (tpu.lpips_weights={lpips_path!r}). Set "
                "human.loss.lpips_w=0 or tpu.random_lpips_factor=0")
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
        if knn_backend not in ("dense", "chunk"):
            raise NotImplementedError(
                f"tpu.knn_backend={knn_backend!r}: the port has the dense "
                "KNN ('dense', 'chunk'); the windowed statistic waits")
        self.step_cfg = step_cfg = StepConfig(
            weights=weights, opt_geo_from=hcfg.opt_geo_from,
            opt_app_from=hcfg.opt_app_from,
            opacity_norm_from=max(dc.prune_until_iter, dc.densify_until_iter),
            knn_backend=knn_backend, lap_shared=True)
        self.train_step = make_train_step(
            self.avatar_cfg, step_cfg, self.template, self.camera, self.tx,
            None, self.raster_kw)
        stat_fn = None
        if knn_backend == "chunk":
            acfg = self.avatar_cfg

            def stat_fn(params, buffers):
                with torch.no_grad():
                    xyz = get_canon_xyz(params, buffers, acfg)
                return edge_stat(xyz, buffers.alive, k=step_cfg.knn_k)
        self.train_scan = make_train_scan(self.train_step, stat_fn)

        self.lap_pos_w = torch.as_tensor(parse_region_weights(
            loss_cfg.laplacian.position_regions_w,
            DEFAULT_POSITION_REGIONS_W), device=dev)
        self.lap_color_w = torch.as_tensor(parse_region_weights(
            loss_cfg.laplacian.color_regions_w, DEFAULT_COLOR_REGIONS_W),
            device=dev)
        self._lap_pad = None
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
        """Region laplacian of the live mesh (standard type, gather
        backend; "auto" means gather in the port)."""
        b = self.buffers
        lap_type = str(self.cfg.human.loss.laplacian.type)
        backend = str(self.cfg.tpu.get("laplacian_backend", "auto"))
        if lap_type != "standard" or backend not in ("auto", "gather"):
            raise NotImplementedError(
                f"laplacian type={lap_type!r} backend={backend!r}: the port "
                "has the standard laplacian with the gather backend")
        edges = b.edges.cpu().numpy()[b.edge_valid.cpu().numpy() > 0.5]
        labels = np.where(b.alive.cpu().numpy() > 0.5,
                          b.vertex_label.cpu().numpy(), -1)
        self.region_lap = build_region_laplacian(
            edges, labels, self.lap_pos_w.cpu().numpy(), num_regions=15,
            pad_to=self._lap_pad or 8, device=self.device)
        self._lap_pad = max(self._lap_pad or 8,
                            self.region_lap.neighbors.shape[1])

    def train(self):
        raise NotImplementedError(
            "Trainer.train() (logging, validation, checkpoints, SH "
            "annealing, density control) is a later slice of the port "
            "(ROADMAP queue A 2); drive self.train_scan directly")

    # ------------------------------------------------------------------
    def _fit_synthetic_body(self):
        """Load the cached synthetic-template calibration
        (synthetic_fit.npz in the logdir) written by a training run."""
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
            print("[fit_synthetic] eval mode, no cache: zeroed betas",
                  flush=True)
            return
        raise NotImplementedError(
            "fitting the synthetic template (keypoint + silhouette "
            "refinement) is not ported yet (ROADMAP queue A 2); set "
            "tpu.auto_fit_synthetic=False, run with eval=True "
            "or provide synthetic_fit.npz")

    def load_ckpt(self, path: str) -> None:
        res = load_checkpoint(path, self.avatar_cfg,
                              num_joints=self.tpl.lbs_weights.shape[1],
                              device=self.device)
        self.params = res["params"]
        self.buffers = res["buffers"]
        self.step = res["step"]
        self.active_sh_degree = res["active_sh_degree"]
        print(f"[ckpt] loaded {path} (step {self.step})", flush=True)

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
        posed = self.pose_chunk(gs_attrs, chunk)
        alive = self.buffers.alive > 0.5
        frames = []
        for b in range(posed["xyz"].shape[0]):
            pkg = rasterize(
                *self.frame_gaussians(posed, b), self.anim_dataset.camera,
                sh_degree=3, bg=self.bg_color, alive=alive,
                backend="pallas", **self.raster_kw)
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
            sink = writer or _jpeg_writer(out_dir, pool)

            def drain(limit):
                nonlocal frames_done
                while len(pending) > limit:
                    dev_imgs, s0, b0 = pending.pop(0)
                    res = sink(dev_imgs[:b0].cpu().numpy(), s0)
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
