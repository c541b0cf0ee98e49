"""Clamping and |x| with JAX's gradients.

JAX differentiates jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi)
(and jnp.maximum / jnp.minimum against a constant) with half the
cotangent to each side where the two are equal, so a value exactly on
a bound gets half of it (a quarter where x == lo == hi); torch.clamp
passes all of it there. `clip` is x.clamp(lo, hi) with JAX's gradient,
for the sites where a tie moves a gradient (ops/sampling.py's border
clip, losses/photometric.py's patch clamp, ops/rasterizer/common.py's
tangent clamp, ops/rotations.py's norm floor and quaternion w).

JAX differentiates jnp.abs as +1 where x >= 0, -0.0 and 0 included;
torch.abs has derivative 0 at 0. `abs` is torch.abs with JAX's
gradient, for the L1 terms of losses/photometric.py, which are exactly
0 where a prediction and its target are equal and flat.
"""
from __future__ import annotations

import torch


def clip_factor(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """d clip(x, lo, hi) / dx as JAX differentiates it: 1 inside, 1/2
    at a bound x equals (1/4 when x == lo == hi), 0 outside; a bound of
    None is absent."""
    one, half, zero = (torch.ones_like(x), torch.full_like(x, 0.5),
                       torch.zeros_like(x))
    f = one
    y = x
    if lo is not None:
        f = torch.where(x > lo, one, torch.where(x == lo, half, zero))
        y = torch.clamp_min(x, lo)
    if hi is not None:
        f = f * torch.where(y < hi, one, torch.where(y == hi, half, zero))
    return f


class Clip(torch.autograd.Function):
    """x.clamp(lo, hi) with jnp.clip's gradient."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return x.clamp(lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * clip_factor(x, *ctx.bounds), None, None


def clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """jnp.clip(x, lo, hi): x.clamp(lo, hi) forward, JAX's tie gradient."""
    return Clip.apply(x, lo, hi)


class Abs(torch.autograd.Function):
    """torch.abs with jnp.abs' gradient: sign +1 where x >= 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs(x: torch.Tensor) -> torch.Tensor:  # noqa: A001
    """jnp.abs(x): torch.abs forward, derivative +1 at 0 and -0.0."""
    return Abs.apply(x)
