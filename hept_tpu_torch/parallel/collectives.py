"""Collectives with their gradients stated (the port's counterpart of what
`shard_map` transposes for the JAX package).

JAX's TP step differentiates through `shard_map` with `check_vma=False` and
gets the single-device gradients because it averages the loss over every
model axis (`hept_tpu/parallel/tp.py:162-179`). Eager PyTorch has no such
transpose: each collective here is a `torch.autograd.Function` whose
backward is written for the one case the port runs, a loss that every rank
of the group computes identically from replicated values:

- `all_gather(x, dim, group)`: forward gathers the ranks' slices along
  `dim`; backward takes this rank's slice of the cotangent (the cotangent
  is replicated, so no sum).
- `all_reduce_fwd(x, group)`: forward sums over the group; backward is the
  identity (each rank's addend gets the whole cotangent).
- `copy_to_group(x, group)`: identity forward, the sum over the group
  backward: a replicated input feeding rank-local work (Megatron's f,
  whose pair g is `all_gather` / `all_reduce_fwd`).
- `broadcast(x, group)`: group rank 0's value on every rank, no gradient.
- `all_to_all(x, group)`: x holds one cell per rank along dim 0 (P, ...);
  forward sends cell j to rank j and returns the cells received, cell i
  from rank i. The exchange is its own transpose (rank i's cell j becomes
  rank j's cell i, and back), so backward is the same exchange of the
  cotangent. Unlike the others it carries no replication assumption: each
  cell's cotangent goes back to the rank that sent it.

`torch.distributed.nn.functional.all_reduce` is not used: its backward sums
the cotangents too, so with every rank back-propagating the same replicated
loss a ones input comes back with gradient `world` (2.0 at two ranks).

Two ranks sharing one card must use gloo (NCCL refuses two ranks on one
device). Gloo in torch 2.11 + CUDA 12.8 takes CUDA tensors for every
collective called here (all_reduce, all_gather, broadcast and
all_to_all_single; probed on the H100 machine), so nothing is staged
through host memory by this module.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce over `group` (no autograd)."""
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


def gather_tensor(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's `x` concatenated along `dim` in group-rank order (no
    autograd)."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def exchange(x: torch.Tensor, group) -> torch.Tensor:
    """All-to-all of the (P, ...) cells along dim 0 over `group` (no
    autograd): cell j goes to group rank j; the result's cell i came from
    group rank i."""
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[0] != n:
        raise ValueError(f"all_to_all: {x.shape[0]} cells for a group of {n}")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _broadcast(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    out = x.detach().clone().contiguous()
    dist.broadcast(out, src=dist.get_global_rank(group, 0), group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.width = dim, group, x.shape[dim]
        return gather_tensor(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        r = group_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.width, ctx.width).contiguous(), None, None


class _AllReduceFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return exchange(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Exchange the (P, ...) cells along dim 0: cell j to group rank j;
    backward: the same exchange of the cotangent."""
    return x if group_size(group) == 1 else _AllToAll.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate the group's slices along `dim`, in group-rank order;
    backward: this rank's slice of the (replicated) cotangent."""
    return x if group_size(group) == 1 else _AllGather.apply(x, dim, group)


def all_reduce_fwd(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; backward: the identity."""
    return x if group_size(group) == 1 else _AllReduceFwd.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """The identity; backward: the sum of the cotangents over the group."""
    return x if group_size(group) == 1 else _CopyToGroup.apply(x, group)


def broadcast(x: torch.Tensor, group) -> torch.Tensor:
    """Group rank 0's `x` on every rank of the group (no gradient)."""
    return _broadcast(x, group)
