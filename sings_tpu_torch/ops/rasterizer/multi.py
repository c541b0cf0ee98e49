"""Several avatars in one render (port of
sings_tpu/ops/rasterizer/multi.py): their gaussians, each avatar
translated, concatenated into one rasterize call, so that one
composite_fwd launch composites every avatar in one global depth
order.
"""
from __future__ import annotations

import torch

from ..graphics import Camera
from .api import rasterize


def rasterize_multi(avatar_outs: list, camera: Camera, *,
                    translations: list | None = None,
                    bg: torch.Tensor | None = None, sh_degree: int = 3,
                    alives: list | None = None, **raster_kw) -> dict:
    """Render several avatar forward outputs (dicts with xyz, scales,
    rotq, opacity, shs, optionally alive) into one image; translations:
    optional per-avatar (3,) world offsets. Returns rasterize's dict."""
    xyz, scales, rotq, opac, shs, alive = [], [], [], [], [], []
    for i, out in enumerate(avatar_outs):
        p = out["xyz"]
        if translations is not None:
            p = p + torch.as_tensor(translations[i], dtype=p.dtype,
                                    device=p.device).reshape(1, 3)
        xyz.append(p)
        scales.append(out["scales"])
        rotq.append(out["rotq"])
        opac.append(out["opacity"].reshape(-1))
        shs.append(out["shs"])
        if alives is not None:
            alive.append(alives[i])
        elif "alive" in out:
            alive.append(out["alive"] > 0.5)
        else:
            alive.append(torch.ones(p.shape[0], dtype=torch.bool,
                                    device=p.device))
    return rasterize(torch.cat(xyz), torch.cat(scales), torch.cat(rotq),
                     torch.cat(opac), torch.cat(shs), camera,
                     sh_degree=sh_degree, bg=bg, alive=torch.cat(alive),
                     **raster_kw)
