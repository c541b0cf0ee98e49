"""The reference's side of a training cell: the targets it renders from
the starting avatar, and the first checked steps of the chunk as the
plain copy takes them."""
from __future__ import annotations

import torch

from .plain.model.avatar import avatar_forward
from .plain.ops.rasterizer.api import rasterize
from .plain.train.step import sh_degree_mask
from .plain.tree import tree_leaves, tree_map
from .build import raster_kw


@torch.no_grad()
def render_targets(av, camera, noise: torch.Tensor, sh_degree: int = 0):
    """Each kit frame's mask, the starting avatar's own silhouette
    ((1 - T) > 0.5), and its image, that render plus 0.05 of the seeded
    noise, clamped to [0, 1] (chip_smoke's seed_train_targets)."""
    dev = av.buffers.alive.device
    mask_deg = sh_degree_mask(sh_degree, dev)
    kw = raster_kw(av.cfg)
    images, masks = [], []
    for f in range(noise.shape[0]):
        out = avatar_forward(av.params, av.buffers, av.acfg, av.template,
                             av.cache, dataset_idx=f)
        pkg = rasterize(out["xyz"], out["scales"], out["rotq"],
                        out["opacity"][:, 0],
                        out["shs"] * mask_deg[None, :, None], camera,
                        sh_degree=3, bg=torch.zeros(3, device=dev),
                        alive=av.buffers.alive > 0.5, **kw)
        masks.append(((1.0 - pkg["transmittance"]) > 0.5).float())
        images.append(torch.clamp(pkg["render"] + 0.05 * noise[f], 0, 1))
    return torch.stack(images), torch.stack(masks)


def checked_steps(av, tr, images, masks, chunks: list, step0: int) -> dict:
    """The reference's first steps from the starting state, chunk by
    chunk as the program took them: chunks is a list of (frames, draws)
    per train_scan call. Returns the losses of every step, the first
    moments after the first call (mu1), the parameters before and after
    the last call (p0, p1) and both moments after it (mu, nu)."""
    dev = av.buffers.alive.device
    params, buffers = av.params, av.buffers
    opt = tr.tx.init(params)
    p0 = params
    losses, mu1 = [], None
    step = step0
    for frames, draws in chunks:
        k = len(frames)
        batches = {"rgb": images[frames], "mask": masks[frames],
                   "idx": list(frames),
                   "smpl_scale": torch.ones((k, 1), device=dev)}
        params, buffers, opt, ls, _sk, _m = tr.train_scan(
            params, buffers, opt, av.cache, batches, None, step, 0,
            tr.region_lap, tr.region_lap, tr.lap_pos_w, tr.lap_color_w,
            draws=draws)
        losses += [float(x) for x in ls.cpu()]
        if mu1 is None:
            mu1 = tree_map(lambda m: m.clone(), opt.mu)
        step += k
    return {"losses": losses, "mu1": tree_leaves(mu1),
            "p0": tree_leaves(p0), "p1": tree_leaves(params),
            "mu": tree_leaves(opt.mu), "nu": tree_leaves(opt.nu)}
