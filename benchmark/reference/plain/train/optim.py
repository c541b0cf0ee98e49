"""Optimizer: Adam with per-field learning rates (port of
sings_tpu/train/optim.py).

The JAX package chains optax's scale_by_adam(b1 0.9, b2 0.999,
eps 1e-15) with a per-field learning-rate map: xyz follows expon_lr,
every other field keeps its constant rate (the reference's
update_learning_rate returns after the xyz group), and frozen fields
(TrainFlags) get a zero update while their moments still move. An
optional global-norm clip goes first.

Here the same arithmetic runs as tensor ops on the parameter tree, not
torch.optim.Adam, so the caller can keep or drop a whole update with a
torch.where on the device (the step's non-finite guard) without a host
synchronisation. AdamState.count is the optimizer's own update count:
the learning-rate schedules read it before the increment, the bias
corrections after, as optax does.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..model.avatar import AvatarParams
from ..ops.schedules import constant_lr, expon_lr
from ..tree import tree_leaves, tree_map

B1, B2, EPS = 0.9, 0.999, 1e-15


class LRConfig(NamedTuple):
    position_init: float = 0.00016
    position_final: float = 1.6e-06
    position_delay_mult: float = 0.01
    position_max_steps: int = 16000
    smpl_spatial: float = 2.0
    vembed: float = 0.0005
    geometry: float = 0.0005
    appearance: float = 0.0005
    smpl_pose: float = 0.0001
    smpl_betas: float = 0.0001
    smpl_trans: float = 0.0001
    mlp_max_steps: int = 16000


class TrainFlags(NamedTuple):
    """Per-group trainability (reference optim_pose/optim_trans/...)."""

    optim_pose: bool = True
    optim_betas: bool = False
    optim_trans: bool = True


class AdamState(NamedTuple):
    count: torch.Tensor  # () int32, updates applied so far
    mu: Any              # first moments, same tree as the parameters
    nu: Any              # second moments


def lr_schedules(cfg: LRConfig) -> dict:
    """Field-name -> schedule(step) map."""
    xyz = expon_lr(
        lr_init=cfg.position_init * cfg.smpl_spatial,
        lr_final=cfg.position_final * cfg.smpl_spatial,
        lr_delay_mult=cfg.position_delay_mult,
        max_steps=cfg.position_max_steps,
    )
    return {
        "xyz": xyz,
        "triplane": constant_lr(cfg.vembed),
        "geometry_dec": constant_lr(cfg.geometry),
        "appearance_dec": constant_lr(cfg.appearance),
        "global_orient": constant_lr(cfg.smpl_pose),
        "body_pose": constant_lr(cfg.smpl_pose),
        "betas": constant_lr(cfg.smpl_betas),
        "transl": constant_lr(cfg.smpl_trans),
    }


def _frozen(field: str, flags: TrainFlags) -> bool:
    return ((field in ("global_orient", "body_pose") and not flags.optim_pose)
            or (field == "betas" and not flags.optim_betas)
            or (field == "transl" and not flags.optim_trans))


def adam_init(params: Any) -> AdamState:
    device = tree_leaves(params)[0].device
    zeros = tree_map(torch.zeros_like, params)
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=device),
                     mu=zeros, nu=tree_map(torch.zeros_like, params))


def adam_directions(grads: Any, state: AdamState, b1: float = B1,
                    b2: float = B2, eps: float = EPS):
    """optax.scale_by_adam: (bias-corrected m / (sqrt(v) + eps) per leaf,
    the new state)."""
    mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
    nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state.nu)
    count = state.count + 1
    c = count.to(torch.float32)
    bc1 = 1 - torch.pow(torch.full_like(c, b1), c)  # in f32, as optax
    bc2 = 1 - torch.pow(torch.full_like(c, b2), c)
    direction = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + eps),
                         mu, nu)
    return direction, AdamState(count=count, mu=mu, nu=nu)


def clip_by_global_norm(grads: Any, max_norm: float) -> Any:
    """optax.clip_by_global_norm: scale every leaf by max_norm / norm
    when the global norm exceeds max_norm."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in tree_leaves(grads)))
    keep = norm < max_norm
    return tree_map(lambda g: torch.where(keep, g, (g / norm) * max_norm),
                    grads)


class Optimizer(NamedTuple):
    """Adam + per-field schedules + trainability masks on AvatarParams.

    update(grads, state, params) -> (new params, new state), both
    computed unconditionally; the caller selects."""

    lr: LRConfig = LRConfig()
    flags: TrainFlags = TrainFlags()
    grad_clip_norm: float = 0.0

    def init(self, params: AvatarParams) -> AdamState:
        return adam_init(params)

    def update(self, grads: AvatarParams, state: AdamState,
               params: AvatarParams):
        if self.grad_clip_norm and self.grad_clip_norm > 0:
            grads = clip_by_global_norm(grads, self.grad_clip_norm)
        direction, new_state = adam_directions(grads, state)
        schedules = lr_schedules(self.lr)
        new = {}
        for field in AvatarParams._fields:
            lr = schedules[field](state.count)
            mult = 0.0 if _frozen(field, self.flags) else 1.0
            new[field] = tree_map(lambda p, d: p + (-lr * mult) * d,
                                  getattr(params, field),
                                  getattr(direction, field))
        return AvatarParams(**new), new_state


def make_optimizer(cfg: LRConfig, flags: TrainFlags,
                   grad_clip_norm: float = 0.0) -> Optimizer:
    return Optimizer(lr=cfg, flags=flags, grad_clip_norm=grad_clip_norm)
