"""Collectives over a torch.distributed process group, with the JAX
package's autograd rules (what shard_map's all_gather, ppermute and psum
are to sings_tpu/dist).

Gradient-safety rule (sings_tpu/dist/train_sharded.py): a rank's loss is
a LOCAL contribution whose rank-sum is the objective. Inside the
differentiated function only two collectives touch param-dependent
values, and both have an exact transpose:
  * all_gather_rows: its backward sums the cotangent over the group and
    keeps the rank's slice (JAX's psum_scatter);
  * ppermute: its backward is the inverse permutation.
Every other reduction (psum, pmean, pmax) acts on detached values, after
torch.autograd.grad, as JAX keeps them outside jax.grad. Two torch
collectives break the rule and are not used: dist.all_reduce has no
autograd (inside the loss it drops the other ranks' gradients), and
torch.distributed.nn.functional.all_gather's backward needs a
reduce_scatter, which gloo lacks.

A group argument of None means a group of one rank: every collective is
then the identity (ppermute gives zeros, as JAX's does to a rank that
receives nothing). The group's backend picks the transport: NCCL moves
CUDA tensors (one rank per device), gloo moves CPU tensors; gloo with
CUDA tensors (several ranks sharing one card, where NCCL refuses) copies
each tensor to the host and back inside the collective.
"""
from __future__ import annotations

import hashlib
import os

import torch
import torch.distributed as dist

from ..tree import tree_leaves, tree_map


def world_size() -> int:
    """The process group's size, 1 when none is initialised."""
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    """This process's rank, 0 when no process group is initialised."""
    return dist.get_rank() if dist.is_initialized() else 0


def start_from_env(backend: str | None, device: str):
    """Start the process group from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) when WORLD_SIZE >
    1 and none is running. Returns (this rank's device: cuda:LOCAL_RANK
    modulo the card count for a CUDA device, whether this call started
    the group). backend: "nccl" or "gloo", None for NCCL on CUDA and
    gloo on the CPU."""
    n = int(os.environ.get("WORLD_SIZE", "1"))
    if n == 1 or dist.is_initialized():
        return device, False
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        rank=int(os.environ["RANK"]), world_size=n)
    return dev, True


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _stage(group, x: torch.Tensor):
    """x detached and contiguous, on the host when the group is gloo's
    and x a CUDA tensor (gloo moves host memory); and whether it was
    copied there."""
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    return (x.detach().cpu() if staged else x.detach()).contiguous(), staged


def _all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    src, staged = _stage(group, x)
    parts = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    return out.to(x.device) if staged else out


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    src, staged = _stage(group, x)
    buf = src.clone() if not staged else src
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device) if staged else buf


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return _all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        total = _all_reduce(g, ctx.group, dist.ReduceOp.SUM)
        return (total.narrow(ctx.dim, group_rank(ctx.group) * ctx.size,
                             ctx.size), None, None)


def all_gather_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's x concatenated along dim in rank order (JAX's tiled
    all_gather); the backward sums the cotangent over the group and
    keeps this rank's slice."""
    if group_size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim)


def _global(group, r: int) -> int:
    return dist.get_global_rank(group, r)


def _ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    if group is None:
        return (x.detach().clone() if (0, 0) in perm
                else torch.zeros_like(x))
    me = group_rank(group)
    out = torch.zeros_like(x)
    src, staged = _stage(group, x)
    recv = torch.zeros_like(src)
    ops, got = [], False
    for s, d in perm:
        if s == me:
            ops.append(dist.P2POp(dist.isend, src, _global(group, d), group))
        if d == me:
            ops.append(dist.P2POp(dist.irecv, recv, _global(group, s),
                                  group))
            got = True
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if got:
        out = recv.to(x.device) if staged else recv
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _ppermute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _ppermute(g.contiguous(), ctx.group, inverse), None, None


def ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """JAX's ppermute: rank d receives rank s's x for each (s, d) of
    perm (ranks within the group); a rank that receives nothing gets
    zeros. The backward is the inverse permutation."""
    return _PPermute.apply(x, group, tuple(tuple(p) for p in perm))


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group of a value outside the differentiated
    function (detached)."""
    if group_size(group) == 1:
        return x.detach()
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    return psum(x, group) / group_size(group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x.detach()
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def broadcast_tree(tree, group, src: int = 0):
    """Every tensor leaf of tree replaced by the group's rank src's, bit
    for bit (src within the group)."""
    if group_size(group) == 1:
        return tree
    root = _global(group, src)

    def bcast(x):
        if not isinstance(x, torch.Tensor):
            return x
        buf, staged = _stage(group, x)
        buf = buf.clone()
        dist.broadcast(buf, root, group=group)
        return buf.to(x.device) if staged else buf

    return tree_map(bcast, tree)


def broadcast_object(obj, group, src: int = 0):
    """A picklable host object from the group's rank src."""
    if group_size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, _global(group, src), group=group)
    return box[0]


def barrier(group) -> None:
    if group_size(group) > 1:
        dist.barrier(group=group)


def trees_equal(tree, group) -> bool:
    """True when every rank of the group holds the same bits in every
    tensor leaf of tree (a check, for tests and the smoke run)."""
    if group_size(group) == 1:
        return True
    h = hashlib.sha256()
    for x in tree_leaves(tree):
        h.update(x.detach().cpu().numpy().tobytes())
    blob = h.hexdigest()
    blobs = [None] * group_size(group)
    dist.all_gather_object(blobs, blob, group=group)
    return all(b == blobs[0] for b in blobs)
