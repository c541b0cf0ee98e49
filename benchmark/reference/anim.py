"""The reference's side of an animation cell: the frames of chosen
chunks of the motion, decoded, posed, rendered and quantised by the
plain copy."""
from __future__ import annotations

import numpy as np
import torch

from .plain.model.avatar import avatar_forward_chunk, get_gs_attrs
from .plain.ops.rasterizer.api import rasterize
from .plain.train.step import sh_degree_mask
from .build import raster_kw


def quantize(render: torch.Tensor) -> torch.Tensor:
    """(3, H, W) float render -> (H, W, 3) uint8: clamp to [0, 1], scale
    by 255, round half to even."""
    img = torch.clamp(render, 0.0, 1.0)
    return torch.round(img.permute(1, 2, 0) * 255.0).to(torch.uint8)


def padded_chunk(ds, start: int, size: int, num_frames: int) -> tuple:
    """The motion's chunk at start, padded to size by repeating its last
    frame; and the number of frames it really holds."""
    chunk = ds.get_chunk(start, start + size)
    b = min(chunk["body_pose"].shape[0], num_frames - start)
    if b < size:
        def fit(x):
            x = x[:b]
            return np.concatenate([x, np.repeat(x[-1:], size - b, 0)])

        chunk = {k: (tuple(fit(x) for x in v) if isinstance(v, tuple)
                     else fit(v)) for k, v in chunk.items()}
    return chunk, b


@torch.no_grad()
def chunk_frames(av, ds, start: int, size: int, bg: torch.Tensor,
                 sh_degree: int = 0) -> np.ndarray:
    """(b, H, W, 3) uint8 frames of the chunk at start."""
    dev = av.buffers.alive.device
    chunk, b = padded_chunk(ds, start, size, ds.num_frames)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    gs = get_gs_attrs(av.params, av.buffers, av.acfg)
    posed = avatar_forward_chunk(
        av.params, av.buffers, av.acfg, av.template, av.cache, gs,
        global_orient=t(chunk["global_orient"]),
        body_pose=t(chunk["body_pose"]), betas=av.params.betas,
        transl=t(chunk["transl"]), smpl_scale=t(chunk["smpl_scale"]),
        ext_tfs=tuple(t(x) for x in chunk["ext_tfs"]))
    mask_deg = sh_degree_mask(sh_degree, dev)
    alive = av.buffers.alive > 0.5
    kw = raster_kw(av.cfg)
    frames = []
    for j in range(b):
        pkg = rasterize(posed["xyz"][j], posed["scales"][j],
                        posed["rotq"][j], posed["opacity"][j][:, 0],
                        posed["shs"][j] * mask_deg[None, :, None],
                        ds.camera, sh_degree=3, bg=bg, alive=alive, **kw)
        frames.append(quantize(pkg["render"]).cpu().numpy())
    return np.stack(frames)
