"""Learning-rate schedules (port of sings_tpu/ops/schedules.py).

Pure functions of the step, evaluated in float32 like the JAX package.
The step may be a Python number or a tensor (the optimizer's count on
the device), so the schedule runs without a host synchronisation.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def expon_lr(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1_000_000):
    """Log-linear interpolation from lr_init to lr_final with optional
    sine-eased delay (Plenoxels-style)."""
    def helper(step):
        step = _f32(step)
        if lr_init == 0.0 and lr_final == 0.0:
            return torch.zeros_like(step)
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
        else:
            delay_rate = 1.0
        t = torch.clamp(step / max_steps, 0, 1)
        log_lerp = torch.exp(math.log(lr_init) * (1 - t)
                             + math.log(lr_final) * t)
        return torch.where(step < 0, torch.zeros_like(step),
                           delay_rate * log_lerp)
    return helper


def cosine_lr(lr_init, lr_final, lr_delay_steps, t_max):
    """Cosine annealing after a constant delay window."""
    def helper(step):
        step = _f32(step)
        after = step - lr_delay_steps
        span = t_max - lr_delay_steps
        cosine = torch.cos(math.pi * after / span)
        lr = lr_final + 0.5 * (lr_init - lr_final) * (1 + cosine)
        return torch.where(step < lr_delay_steps,
                           torch.full_like(step, lr_init), lr)
    return helper


def constant_lr(lr):
    def helper(step):
        return torch.full_like(_f32(step), lr)
    return helper
