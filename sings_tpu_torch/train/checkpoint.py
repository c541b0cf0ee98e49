"""Checkpoints in the JAX package's npz format (port of
sings_tpu/train/checkpoint.py).

The JAX trainer writes params__i / buffers__i / opt__i leaves in
jax.tree_util flatten order: NamedTuple fields in declaration order,
dict keys sorted, lists by index, None contributing no leaf. The port's
AvatarParams / AvatarBuffers mirror those trees, so a JAX checkpoint
loads leaf for leaf; every shape is checked against the AvatarConfig.
The optimizer section (opt__*) holds optax's chain state, whose leaves
are the Adam count, mu, nu (each a tree like the params) and the
learning-rate schedule's count; the port's AdamState writes and reads
that layout, so a training run resumes across the two packages.
params/buffers/adam_state/region_laplacian_from_numpy turn the JAX
package's in-memory state into the port's, so tests can start both
packages from one state.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from ..fields.decoders import appearance_layer_shapes, geometry_layer_shapes
from ..fields.triplane import plane_shapes
from ..model.avatar import AvatarBuffers, AvatarConfig, AvatarParams


class CheckpointShapeMismatch(ValueError):
    """Checkpoint arrays don't match the current model configuration."""


def tree_flatten(tree: Any) -> list:
    """Leaves in jax.tree_util order."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields for x in tree_flatten(getattr(tree, f))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_flatten(v)]
    return [tree]


def _linear_tree(shapes: dict) -> dict:
    return {k: {"b": ((s[1],), "f"), "w": (s, "f")} for k, s in shapes.items()}


def param_spec(cfg: AvatarConfig) -> AvatarParams:
    """AvatarParams of (shape, kind) leaves for `cfg`."""
    f = max(cfg.num_frames, 1)
    c = cfg.capacity
    return AvatarParams(
        xyz=((c, 3), "f"),
        triplane={"grids": [[(s, "f") for s in planes]
                            for planes in plane_shapes(cfg.triplane)]},
        geometry_dec=_linear_tree(geometry_layer_shapes(cfg.decoder)),
        appearance_dec=_linear_tree(appearance_layer_shapes(cfg.decoder)),
        global_orient=((f, 6), "f"),
        body_pose=((f, 23 * 6), "f"),
        transl=((f, 3), "f"),
        betas=((cfg.num_betas,), "f"),
    )


def buffer_spec(cfg: AvatarConfig, num_joints: int) -> AvatarBuffers:
    c, fc, ec = cfg.capacity, cfg.face_capacity, cfg.edge_capacity
    return AvatarBuffers(
        alive=((c,), "f"), scaling_multiplier=((c, 1), "f"),
        opacity_offset=((c, 1), "f"), lbs_weights=((c, num_joints), "f"),
        vertex_label=((c,), "i"), anchor_normals=((c, 3), "f"),
        faces=((fc, 3), "i"), face_valid=((fc,), "f"),
        edges=((ec, 2), "i"), edge_valid=((ec,), "f"),
        num_level0=((), "i"), max_radii2d=((c,), "f"),
        xyz_grad_accum=((c,), "f"), grad_denom=((c,), "f"),
    )


def _is_spec_leaf(x):
    return (isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], str)
            and isinstance(x[0], tuple))


def _spec_leaves(spec) -> list:
    """Like tree_flatten, but (shape, kind) pairs are leaves."""
    if _is_spec_leaf(spec):
        return [spec]
    if isinstance(spec, tuple) and hasattr(spec, "_fields"):
        return [x for f in spec._fields for x in _spec_leaves(getattr(spec, f))]
    if isinstance(spec, dict):
        return [x for k in sorted(spec) for x in _spec_leaves(spec[k])]
    return [x for v in spec for x in _spec_leaves(v)]


def _rebuild(spec, leaves):
    it = iter(leaves)

    def build(s):
        if _is_spec_leaf(s):
            return next(it)
        if isinstance(s, tuple) and hasattr(s, "_fields"):
            return type(s)(**{f: build(getattr(s, f)) for f in s._fields})
        if isinstance(s, dict):
            return {k: build(s[k]) for k in sorted(s)}
        return [build(v) for v in s]

    return build(spec)


def _load_section(data, prefix: str, spec, device):
    specs = _spec_leaves(spec)
    n_have = sum(1 for k in data.files if k.startswith(prefix + "__")
                 and k[len(prefix) + 2:].isdigit())
    if n_have != len(specs):
        raise CheckpointShapeMismatch(
            f"{prefix}: checkpoint has {n_have} leaves, config expects "
            f"{len(specs)}")
    leaves = []
    for i, (shape, kind) in enumerate(specs):
        arr = data[f"{prefix}__{i}"]
        if arr.shape != shape:
            raise CheckpointShapeMismatch(
                f"{prefix} leaf {i}: checkpoint {arr.shape} vs config "
                f"{shape}")
        dt = np.float32 if kind == "f" else np.int32
        leaves.append(torch.as_tensor(np.array(arr, dtype=dt), device=device))
    return _rebuild(spec, leaves)


def opt_spec(cfg: AvatarConfig) -> list:
    """The opt section's leaves: optax's (ScaleByAdamState(count, mu,
    nu), ScaleByScheduleState(count)), a clip's EmptyState holding none."""
    p = param_spec(cfg)
    return [((), "i"), p, p, ((), "i")]


def load_checkpoint(path: str, cfg: AvatarConfig, *, num_joints: int,
                    device="cpu", with_opt: bool = False) -> dict:
    """Read a checkpoint written by either package's save_checkpoint.
    with_opt: also read the Adam state ("opt_state", an AdamState);
    a checkpoint without one raises CheckpointShapeMismatch."""
    data = np.load(path, allow_pickle=False)
    params = _load_section(data, "params", param_spec(cfg), device)
    buffers = _load_section(data, "buffers", buffer_spec(cfg, num_joints),
                            device)
    opt_state = None
    if with_opt:
        from .optim import AdamState

        count, mu, nu, _ = _load_section(data, "opt", opt_spec(cfg), device)
        opt_state = AdamState(count=count, mu=mu, nu=nu)
    extra = {k[len("extra__"):]: data[k] for k in data.files
             if k.startswith("extra__")}
    return {
        "params": params,
        "buffers": buffers,
        "opt_state": opt_state,
        "step": int(data["step"]),
        "active_sh_degree": int(data["active_sh_degree"]),
        "extra": extra,
    }


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path: str, *, params, buffers, step: int,
                    active_sh_degree: int, opt_state=None,
                    extra: dict | None = None):
    """Write the same keys as the JAX package; no opt section unless an
    optimizer state is given. An AdamState is written in optax's layout
    (its count twice: Adam's and the schedule's, equal in both
    packages); any other pytree of arrays as it is."""
    from .optim import AdamState

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    out: dict = {"step": np.asarray(step),
                 "active_sh_degree": np.asarray(active_sh_degree)}
    sections = [("params", params), ("buffers", buffers)]
    if isinstance(opt_state, AdamState):
        opt_state = [opt_state, opt_state.count]
    if opt_state is not None:
        sections.append(("opt", opt_state))
    for prefix, tree in sections:
        for i, leaf in enumerate(tree_flatten(tree)):
            out[f"{prefix}__{i}"] = _np(leaf)
    for k, v in (extra or {}).items():
        out[f"extra__{k}"] = np.asarray(v)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **out)
    os.replace(tmp, path)


def latest_checkpoint(ckpt_dir: str, pattern: str = "human_") -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    files = sorted(f for f in os.listdir(ckpt_dir)
                   if f.startswith(pattern) and f.endswith(".npz"))
    return os.path.join(ckpt_dir, files[-1]) if files else None


def _tree_from_numpy(tree, cls=None, device="cpu"):
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        target = cls or type(tree)
        return target(**{f: _tree_from_numpy(getattr(tree, f), None, device)
                         for f in tree._fields})
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, None, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_from_numpy(v, None, device) for v in tree)
    return torch.as_tensor(np.array(tree), device=device)


def params_from_numpy(tree, device="cpu") -> AvatarParams:
    """A JAX AvatarParams whose leaves were np.asarray-ed -> the port's."""
    return _tree_from_numpy(tree, AvatarParams, device)


def buffers_from_numpy(tree, device="cpu") -> AvatarBuffers:
    """A JAX AvatarBuffers (max_radii2d, xyz_grad_accum and grad_denom
    included) -> the port's."""
    return _tree_from_numpy(tree, AvatarBuffers, device)


def adam_state_from_numpy(opt_state, device="cpu"):
    """The optax state of sings_tpu's make_optimizer (a tuple holding a
    ScaleByAdamState(count, mu, nu); leaves numpy or JAX arrays) -> the
    port's AdamState, so both packages can start from one state."""
    from .optim import AdamState

    adam = next(s for s in opt_state if hasattr(s, "mu"))
    return AdamState(
        count=torch.as_tensor(np.array(adam.count), dtype=torch.int32,
                              device=device),
        mu=params_from_numpy(adam.mu, device),
        nu=params_from_numpy(adam.nu, device))


def region_laplacian_from_numpy(rl, device="cpu"):
    """A JAX RegionLaplacian (the gather tables) -> the port's."""
    from ..losses.regularizers import RegionLaplacian

    return RegionLaplacian(*[torch.as_tensor(np.array(x), device=device)
                             for x in rl])
