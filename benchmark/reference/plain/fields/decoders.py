"""Geometry / appearance decoder MLPs (port of sings_tpu/fields/decoders.py).

Parameters are the JAX pytree: {"net0": {"w", "b"}, ...} with weights
stored (fan_in, fan_out) and applied as ``x @ w + b`` (an nn.Linear
would hold w.T). GELU is the exact-erf form, torch's default.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class DecoderConfig(NamedTuple):
    n_features: int = 96
    isotropic: bool = True
    fixed_opacity: bool = False
    geo_hidden: int = 128
    app_hidden: int = 64
    sh_coeffs: int = 16


def _linear_init(gen: torch.Generator, fan_in: int, fan_out: int,
                 device) -> dict:
    """torch.nn.Linear default init: kaiming-uniform weights, uniform
    bias in +-1/sqrt(fan_in)."""
    bound_w = float(np.sqrt(1.0 / fan_in) * np.sqrt(3.0))
    bound_b = float(np.sqrt(1.0 / fan_in))
    w = (torch.rand((fan_in, fan_out), generator=gen) * 2 - 1) * bound_w
    b = (torch.rand((fan_out,), generator=gen) * 2 - 1) * bound_b
    return {"w": w.to(device), "b": b.to(device)}


def _linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # approximate="none": exact erf


class Softplus(torch.autograd.Function):
    """jax.nn.softplus = logaddexp(x, 0): log1p(exp(-|x|)) + max(x, 0)
    forward, and logaddexp's derivative exp(x - out) (0.5 at 0, the
    logistic elsewhere); autograd of the forward would pass torch.abs'
    0 and clamp_min's full cotangent at x = 0 (derivative 1)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return Softplus.apply(x)


def geometry_layer_shapes(cfg: DecoderConfig) -> dict:
    out = {
        "net0": (cfg.n_features, cfg.geo_hidden),
        "net1": (cfg.geo_hidden, cfg.geo_hidden),
        "xyz": (cfg.geo_hidden, 3),
        "scales0": (cfg.geo_hidden, cfg.geo_hidden),
        "scales1": (cfg.geo_hidden, 1 if cfg.isotropic else 3),
    }
    if not cfg.isotropic:
        out["rot"] = (cfg.geo_hidden, 6)
    return out


def appearance_layer_shapes(cfg: DecoderConfig) -> dict:
    out = {
        "net0": (cfg.n_features, cfg.app_hidden),
        "net1": (cfg.app_hidden, cfg.app_hidden),
        "shs": (cfg.app_hidden, cfg.sh_coeffs * 3),
    }
    if not cfg.fixed_opacity:
        out["opacity"] = (cfg.app_hidden, 1)
    return out


def init_geometry_decoder(gen: torch.Generator, cfg: DecoderConfig,
                          device="cpu") -> dict:
    return {k: _linear_init(gen, *s, device)
            for k, s in geometry_layer_shapes(cfg).items()}


def init_appearance_decoder(gen: torch.Generator, cfg: DecoderConfig,
                            device="cpu") -> dict:
    return {k: _linear_init(gen, *s, device)
            for k, s in appearance_layer_shapes(cfg).items()}


def geometry_decoder(p: dict, feats: torch.Tensor,
                     cfg: DecoderConfig) -> dict:
    x = _gelu(_linear(p["net0"], feats))
    x = _gelu(_linear(p["net1"], x))
    xyz_offsets = _linear(p["xyz"], x)
    rotations = _linear(p["rot"], x) if not cfg.isotropic else None
    s = _gelu(_linear(p["scales0"], x))
    scales_aux = _linear(p["scales1"], s)
    scales = softplus(scales_aux)  # jax.nn.softplus, no linear cutoff
    if scales.shape[-1] == 1:
        scales_aux = scales_aux.expand(-1, 3)
        scales = scales.expand(-1, 3)
    return {
        "xyz_offsets": xyz_offsets,
        "rotations": rotations,
        "scales": scales,
        "scales_aux": scales_aux,
    }


def appearance_decoder(p: dict, feats: torch.Tensor, cfg: DecoderConfig,
                       opacity_offset: torch.Tensor | float = 0.0) -> dict:
    x = _gelu(_linear(p["net0"], feats))
    x = _gelu(_linear(p["net1"], x))
    shs = _linear(p["shs"], x).reshape(-1, cfg.sh_coeffs, 3)
    if cfg.fixed_opacity:
        opacity = torch.ones((feats.shape[0], 1), dtype=feats.dtype,
                             device=feats.device)
    else:
        logit = _linear(p["opacity"], x)
        opacity = torch.sigmoid(logit + opacity_offset)
    return {"shs": shs, "opacity": opacity}
