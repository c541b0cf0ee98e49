"""Parameter trees: NamedTuples, dicts, lists and tuples of tensors.

The port keeps the JAX package's pytrees (AvatarParams of nested
dicts and lists) as plain Python containers; these two helpers walk
them in jax.tree_util order (NamedTuple fields in declaration order,
dict keys sorted, lists by index, None holding no leaf).
"""
from __future__ import annotations

from typing import Any, Callable


def tree_leaves(tree: Any) -> list:
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields for x in tree_leaves(getattr(tree, f))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn applied leaf by leaf over trees of the same structure, in
    tree_leaves order (a dict comes back with its keys sorted)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(**{f: tree_map(fn, getattr(tree, f),
                                         *[getattr(r, f) for r in rest])
                             for f in tree._fields})
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest])
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *[r[i] for r in rest])
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
