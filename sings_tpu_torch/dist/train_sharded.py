"""The sharded training step over a (dp, gs) rank mesh (port of
sings_tpu/dist/train_sharded.py).

The full objective of train/step.py split over ranks, one process each
(shard.py for the axes):

  * frames over dp: every dp rank trains on its own frame;
  * per dp rank, the gs ranks split the heavy stages:
      - the gaussian decode and LBS on capacity / gs slots each
        (triplane sample, decoder MLPs, skinning); the posed gaussians
        meet in one all_gather;
      - rasterisation of a horizontal image strip through a
        principal-point-shifted camera (binning and the composite
        kernels stay local to the rank);
      - masked L1 and silhouette on the local strip, SSIM through the
        exact halo exchange (halo.py), LPIPS and gradient-pyramid
        patches drawn the same on every rank and evaluated round-robin
        on the gathered render;
  * the per-gaussian regularisers: the KNN edge term and the region
    laplacian split by rows (gaussians_edge_loss_rows,
    ShardedRegionLaplacian), l2 and mesh-edge replicated and divided by
    gs (l2's square root needs the global sum);
  * the density statistics reduced over the mesh with the single-card
    conventions (the probe gradient rescaled from the strip's NDC to the
    full image's);
  * the loss summed over gs and averaged over dp, the gradients
    likewise (one all_reduce over the mesh, after torch.autograd.grad),
    the non-finite guard, and the port's Adam on every rank.

Each rank's loss is a local contribution whose rank-sum is the global
objective; inside the differentiated function only all_gather_rows and
the halo ppermutes touch param-dependent values (collectives.py). The
parameters stay bit for bit the same on every rank: every rank applies
the same update to the same reduced gradients.

At mesh (1, 1) the step computes train/step.py's objective (the KNN
statistic and the laplacian by their row-split forms, the same sums in
another order). Deviations from the JAX signatures: the step takes this
rank's frame (no dp axis), a torch.Generator per dp rank (shard.
dp_generator) or the draws themselves, where JAX folds the dp index
into one key, and an optional camera per call (the case step's).
"""
from __future__ import annotations

import numpy as np
import torch

from ..losses.lpips import lpips_distance
from ..losses.photometric import (
    crop_patches, draw_step_randoms, grad_pyramid_distance,
)
from ..losses.regularizers import gaussians_edge_loss_rows
from ..model.avatar import AvatarConfig, avatar_forward
from ..ops.clip import abs as jabs
from ..ops.clip import clip
from ..ops.graphics import Camera
from ..ops.rasterizer.api import rasterize
from ..train.step import (
    StepConfig, gate_outputs, grad_leaves, guarded_update, leaf_grads,
    regularizer_terms, sh_degree_mask,
)
from ..tree import tree_leaves, tree_map
from .collectives import all_gather_rows, pmax, psum
from .halo import strip_ssim_local, strip_ssim_local_bounded
from .shard import Mesh, camera_strip

_GATHER_KEYS = ("xyz", "scales", "rotq", "shs", "opacity",
                "xyz_canon", "xyz_offsets", "xyz_anchor_canon")


def _slice_gaussian_state(params, buffers, start: int, shard: int):
    """The per-gaussian state of slots [start, start + shard)."""
    def sl(x):
        return x[start: start + shard]

    p_loc = params._replace(xyz=sl(params.xyz))
    b_loc = buffers._replace(
        alive=sl(buffers.alive),
        scaling_multiplier=sl(buffers.scaling_multiplier),
        opacity_offset=sl(buffers.opacity_offset),
        lbs_weights=sl(buffers.lbs_weights),
        vertex_label=sl(buffers.vertex_label),
        anchor_normals=sl(buffers.anchor_normals),
        max_radii2d=sl(buffers.max_radii2d),
        xyz_grad_accum=sl(buffers.xyz_grad_accum),
        grad_denom=sl(buffers.grad_denom),
    )
    return p_loc, b_loc


def _gather_gaussians(out_loc: dict, group) -> dict:
    """The _GATHER_KEYS arrays of every gs rank's shard, in rank order,
    through one all_gather of their rows packed side by side."""
    n = out_loc["xyz"].shape[0]
    flat = [out_loc[k].reshape(n, -1) for k in _GATHER_KEYS]
    full = all_gather_rows(torch.cat(flat, dim=1), group)
    out, c0 = {}, 0
    for k, f in zip(_GATHER_KEYS, flat):
        out[k] = full[:, c0: c0 + f.shape[1]].reshape(
            (-1,) + out_loc[k].shape[1:])
        c0 += f.shape[1]
    return out


def make_frame_loss(avatar_cfg: AvatarConfig, step_cfg: StepConfig,
                    template, height: int, width: int, n_gs: int,
                    lpips_params, raster_kw: dict, strip_bounds=None,
                    strip_h_max: int | None = None):
    """The per-(frame, gs rank) loss of the sharded steps.

    Returns frame_loss(params, probe, buffers, cache, camera, frame,
    draws, step, active_sh_degree, region_lap_pos, region_lap_color,
    lap_pos_w, lap_color_w, strip_idx, group) -> (local loss, aux),
    whose sum over the gs group is the single-card objective. params
    and probe are the differentiated leaves; camera is the full image's
    (height x width); region_lap_* are this rank's ShardedRegionLaplacian
    rows (shard(strip_idx)); group is the gs process group.

    strip_bounds / strip_h_max: balanced strips. bounds is an
    (n_gs + 1,) tile-aligned array of pixel rows (0 ... height); every
    rank renders a strip_h_max-row window from its bound and owns
    bounds[i+1] - bounds[i] rows of it (rasterize(valid_rows=) bins no
    pairs past them). None: equal strips."""
    w = step_cfg.weights
    balanced = strip_bounds is not None
    if balanced:
        bounds = np.asarray(strip_bounds, np.int64)
        assert bounds.shape == (n_gs + 1,)
        strip_h = int(strip_h_max)
    else:
        assert height % n_gs == 0, "height must split over gs"
        strip_h = height // n_gs
    assert avatar_cfg.capacity % n_gs == 0, "capacity must split over gs"
    gauss_shard = avatar_cfg.capacity // n_gs
    pw = w.photometric
    npatch = pw.num_patches
    patches_per_rank = -(-npatch // n_gs)
    lpips = None
    if lpips_params is not None and pw.lpips > 0:
        def lpips(a, b):
            return lpips_distance(lpips_params, a, b)

    def frame_loss(params, probe, buffers, cache, camera: Camera, frame,
                   draws, step: int, active_sh_degree: int, region_lap_pos,
                   region_lap_color, lap_pos_w, lap_color_w, strip_idx: int,
                   group):
        dev = buffers.alive.device
        bg = draws["bg"]
        deg_mask = sh_degree_mask(active_sh_degree, dev)

        # ---- decode this rank's capacity/gs shard only
        p_loc, b_loc = _slice_gaussian_state(
            params, buffers, strip_idx * gauss_shard, gauss_shard)
        out_loc = gate_outputs(avatar_forward(
            p_loc, b_loc, avatar_cfg, template, cache,
            smpl_scale=frame.get("smpl_scale"), dataset_idx=frame["idx"]),
            step_cfg, step)
        out_loc["shs"] = out_loc["shs"] * deg_mask[None, :, None]
        out = _gather_gaussians(out_loc, group)

        # ---- rasterise this rank's strip of the image (all gaussians)
        alive_b = buffers.alive > 0.5
        if balanced:
            y0 = int(bounds[strip_idx])
            h_own = int(bounds[strip_idx + 1]) - y0
            valid_rows = h_own
        else:
            y0 = strip_idx * strip_h
            h_own = strip_h
            valid_rows = None
        pkg = rasterize(out["xyz"], out["scales"], out["rotq"],
                        out["opacity"][:, 0], out["shs"],
                        camera_strip(camera, y0, strip_h), sh_degree=3,
                        bg=bg, alive=alive_b, screen_probe=probe,
                        backend="pallas", valid_rows=valid_rows,
                        **raster_kw)
        # the raw render, as train/step.py reads it
        render = pkg["render"]
        # owned rows: a balanced window's rows past h_own belong to the
        # next rank (they rendered bg)
        rm = ((torch.arange(strip_h, device=dev) < h_own).to(render.dtype)
              if balanced else None)

        # ---- photometric: this strip's contributions
        mask = frame["mask"]
        m3 = mask[None]
        gt_full = frame["rgb"] * m3 + bg[:, None, None] * (1.0 - m3)
        if balanced:
            # the window may run past the image's bottom: pad, then slice
            gt = torch.nn.functional.pad(gt_full, (0, 0, 0, strip_h))[
                :, y0: y0 + strip_h]
            ms = torch.nn.functional.pad(mask, (0, 0, 0, strip_h))[
                y0: y0 + strip_h] * rm[:, None]
        else:
            gt = gt_full[:, y0: y0 + strip_h]
            ms = mask[y0: y0 + strip_h]
        mask_area = torch.clamp_min(mask.sum(), 1.0)

        photo_d = {}
        photo = 0.0
        if pw.l1 > 0:
            diff = jabs(render - gt)
            if balanced:
                diff = diff * rm[None, :, None]
            photo_d["l1"] = pw.l1 * diff.sum() / mask_area
            photo = photo + photo_d["l1"]
        if pw.ssim > 0:
            frac = mask.sum() / (height * width)
            # the gs sum of (1/n - local) * frac is (1 - ssim) * frac
            local_ssim = (
                strip_ssim_local_bounded(render, gt, group, h_own,
                                         float(height * width))
                if balanced else strip_ssim_local(render, gt, group))
            photo_d["ssim"] = pw.ssim * (1.0 / n_gs - local_ssim) * frac
            photo = photo + photo_d["ssim"]
        if w.silhouette != 0:
            # this strip's part of mean (1 - T - mask)^2 over the image
            sq = (1.0 - pkg["transmittance"] - ms) ** 2
            if balanced:
                sq = sq * rm[:, None]
            photo_d["sil"] = w.silhouette * (torch.sum(sq)
                                             / (height * width))
            photo = photo + photo_d["sil"]
        if lpips is not None or pw.grad_pyramid > 0:
            # the patches need the full image: gather the strips (exact
            # transpose), crop the same patches on every rank, evaluate
            # them round-robin
            render_full = all_gather_rows(render, group, dim=1)
            if balanced:
                # each image row from the window of the rank that owns it
                rows = np.arange(height)
                owner = np.clip(np.searchsorted(bounds, rows, side="right")
                                - 1, 0, n_gs - 1)
                src = owner * strip_h + (rows - bounds[owner])
                render_full = render_full[:, torch.as_tensor(src,
                                                             device=dev)]
            noise = draws["noise"]
            pred_bg = render_full * m3 + noise * (1.0 - m3)
            gt_bg = gt_full * m3 + noise * (1.0 - m3)
            mine = [strip_idx + j * n_gs for j in range(patches_per_rank)]
            mine = [i for i in mine if i < npatch]
            if mine:
                sel = torch.as_tensor(mine, device=dev)
                ys, xs = draws["ys"][sel], draws["xs"][sel]
                pred_p = crop_patches(pred_bg, ys, xs, pw.patch_size)
                gt_p = crop_patches(gt_bg, ys, xs, pw.patch_size)
            if lpips is not None:
                d = (lpips(clip(pred_p, hi=1.0), gt_p).sum() if mine
                     else render.new_zeros(()))
                photo_d["lpips_patch"] = pw.lpips * d / npatch
                photo = photo + photo_d["lpips_patch"]
            if pw.grad_pyramid > 0:
                gp = (torch.stack([
                    grad_pyramid_distance(clip(pred_p[i: i + 1], hi=1.0),
                                          gt_p[i: i + 1],
                                          pw.grad_pyramid_levels)
                    for i in range(len(mine))]).sum() if mine
                    else render.new_zeros(()))
                photo_d["grad_pyr"] = pw.grad_pyramid * gp / npatch
                photo = photo + photo_d["grad_pyr"]

        # ---- per-gaussian regularisers over the gathered arrays: the KNN
        # edge term and the laplacians as this rank's rows, l2 and
        # mesh-edge replicated / n_gs
        def connect_rows(xyz_canon, scales, alive):
            return gaussians_edge_loss_rows(
                xyz_canon, scales, alive, row_start=strip_idx * gauss_shard,
                rows=gauss_shard, k=step_cfg.knn_k)

        r = regularizer_terms(step_cfg, out, buffers, step, region_lap_pos,
                              region_lap_color, lap_pos_w, lap_color_w,
                              connect_rows, n_rep=n_gs)
        reg, edge, connect = r["reg_l2"], r["mesh_edge"], r["connect"]
        lap_pos_loss, lap_color_loss = r["lap_pos"], r["lap_color"]
        hand_lap = r["hand_lap"]

        total = (photo + reg + edge + connect + lap_pos_loss
                 + lap_color_loss + hand_lap)
        aux = {
            "loss": total, "photo": photo, "reg_l2": reg, "mesh_edge": edge,
            "connect": connect, "lap_pos": lap_pos_loss,
            "lap_color": lap_color_loss, "radii": pkg["radii"],
            "visible": pkg["visibility_filter"],
            **{f"photo_{k}": v for k, v in photo_d.items()},
        }
        return total, aux

    return frame_loss


def make_sharded_train_step(mesh: Mesh, avatar_cfg: AvatarConfig,
                            step_cfg: StepConfig, template,
                            camera: Camera | None, tx, lpips_params,
                            raster_kw: dict, strip_bounds=None,
                            strip_h_max: int | None = None,
                            height: int | None = None,
                            width: int | None = None):
    """Build step(params, buffers, opt_state, cache, frame, generator,
    step, active_sh_degree, region_lap_pos, region_lap_color, lap_pos_w,
    lap_color_w, draws=None, camera=None) -> (params, buffers,
    opt_state, metrics), equal on every rank of the mesh.

    frame: this rank's frame ('rgb' (3, H, W), 'mask' (H, W), 'idx',
    optional 'smpl_scale'); generator: this rank's dp generator
    (shard.dp_generator), or draws: the output of draw_step_randoms for
    the frame. region_lap_*: a ShardedRegionLaplacian of all gs ranks
    or this rank's shard. camera: this call's full-image camera, or
    None for the one the step was built with (when it was built with
    none, height and width give the image size). step.grads_fn takes
    the same arguments but opt_state and returns the reduced (loss,
    grads).

    strip_bounds / strip_h_max: balanced strips (make_frame_loss), fixed
    for the step's life: rebuild the step to rebalance."""
    n_gs = mesh.gs
    built = camera
    height = camera.height if camera is not None else int(height)
    width = camera.width if camera is not None else int(width)
    frame_loss = make_frame_loss(avatar_cfg, step_cfg, template, height,
                                 width, n_gs, lpips_params, raster_kw,
                                 strip_bounds=strip_bounds,
                                 strip_h_max=strip_h_max)
    strip_h_used = (int(strip_h_max) if strip_bounds is not None
                    else height // n_gs)
    pw = step_cfg.weights.photometric

    def own_rows(lap):
        if lap is None or lap.row_start.shape[0] == 1:
            return lap
        return lap.shard(mesh.gs_idx)

    def _core(params, buffers, cache, frame, generator, step,
              active_sh_degree, region_lap_pos, region_lap_color, lap_pos_w,
              lap_color_w, draws, camera):
        cam = built if camera is None else camera
        if draws is None:
            draws = draw_step_randoms(generator, frame["mask"], pw)
        p = grad_leaves(params)
        probe = torch.zeros((avatar_cfg.capacity, 2),
                            device=buffers.alive.device, requires_grad=True)
        loss_local, aux = frame_loss(
            p, probe, buffers, cache, cam, frame, draws, int(step),
            int(active_sh_degree), own_rows(region_lap_pos),
            own_rows(region_lap_color), lap_pos_w, lap_color_w,
            mesh.gs_idx, mesh.gs_group)
        grad_tree, probe_grad = leaf_grads(loss_local, p, probe)
        grads = tree_leaves(grad_tree)
        # the loss terms and gradients: summed over gs and averaged over
        # dp (JAX's pmean(psum(., gs), dp)), in one all_reduce over the
        # mesh outside the gradient
        names = [k for k in aux if k not in ("radii", "visible")]
        scalars = torch.stack([torch.as_tensor(aux[k], dtype=torch.float32,
                                               device=probe.device).detach()
                               for k in names])
        flat = torch.cat([scalars] + [g.reshape(-1) for g in grads])
        flat = psum(flat, mesh.group) / mesh.dp
        metrics = dict(zip(names, flat[: len(names)]))
        off = len(names)
        red = []
        for g in grads:
            red.append(flat[off: off + g.numel()].reshape(g.shape))
            off += g.numel()
        it = iter(red)
        grad_tree = tree_map(lambda _: next(it), p)
        return metrics, grad_tree, aux, probe_grad

    def step_fn(params, buffers, opt_state, cache, frame, generator, step,
                active_sh_degree, region_lap_pos, region_lap_color,
                lap_pos_w, lap_color_w, draws=None, camera=None):
        metrics, grads, aux, probe_grad = _core(
            params, buffers, cache, frame, generator, step,
            active_sh_degree, region_lap_pos, region_lap_color, lap_pos_w,
            lap_color_w, draws, camera)

        params, opt_state, finite = guarded_update(
            tx, grads, opt_state, params, metrics["loss"])

        # density statistics: the probe gradient back to the full image's
        # NDC convention (rasterize scaled it by the strip window's
        # height), summed over strips and frames
        scale = torch.tensor([1.0, height / float(strip_h_used)],
                             device=probe_grad.device)
        probe_g = psum(probe_grad, mesh.gs_group) * scale
        seen = pmax(torch.stack([aux["visible"].to(torch.float32),
                                 aux["radii"].to(torch.float32)]),
                    mesh.gs_group)
        acc = (seen[0] > 0.5) & finite
        radii = seen[1]
        max_r = torch.where(acc, torch.maximum(buffers.max_radii2d, radii),
                            buffers.max_radii2d)
        adds = torch.stack([
            torch.where(acc, torch.linalg.norm(probe_g, dim=-1),
                        torch.zeros_like(buffers.xyz_grad_accum)),
            acc.to(torch.float32)])
        adds = psum(adds, mesh.dp_group)
        buffers = buffers._replace(
            max_radii2d=pmax(max_r, mesh.dp_group),
            xyz_grad_accum=buffers.xyz_grad_accum + adds[0],
            grad_denom=buffers.grad_denom + adds[1])
        metrics["skipped"] = (~finite).to(torch.float32)
        return params, buffers, opt_state, metrics

    def grads_fn(params, buffers, cache, frame, generator, step,
                 active_sh_degree, region_lap_pos, region_lap_color,
                 lap_pos_w, lap_color_w, draws=None, camera=None):
        metrics, grads, _, _ = _core(
            params, buffers, cache, frame, generator, step,
            active_sh_degree, region_lap_pos, region_lap_color, lap_pos_w,
            lap_color_w, draws, camera)
        return metrics["loss"], grads

    step_fn.grads_fn = grads_fn
    return step_fn
