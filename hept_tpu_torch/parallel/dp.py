"""Data-parallel train step (port of `hept_tpu/parallel/dp.py`).

Each rank of the "data" axis runs its own slice of the event batch
(`shard_batch`), back-propagates the mean loss over its events divided by
the data ranks, and the gradients are summed over the data axis by ONE
all-reduce of a flat buffer holding every gradient. The division comes
before the backward, as JAX's pmean of the loss puts it: every cotangent
then has the single-process step's scale, which the e4m3 transport of the
fp8 unsort (whose subnormal range flushes small values) does not ignore.
Elsewhere, over a power-of-two count of ranks, dividing first or last
gives the same bits wherever values stay in the normal range. Then every
rank clips (optax's formula, `train/optim.py:clip_by_global_norm_`) and
steps its own optimizer on the same averaged gradients, so the replicas
stay equal without a broadcast.

Why not `DistributedDataParallel`: its bucketed all-reduce overlaps the
backward, which buys nothing for a model of tens of thousands of
parameters (one ~100 KB all-reduce a step), while its hooks need every
parameter to get a gradient and its reducer orders the buckets at run
time. One flat all-reduce after the backward is the same sum on NCCL and
gloo, in a fixed order, and a one-rank group returns the gradients
unchanged (the step equals the single-process step bit for bit).

With equal event slices the average of the per-rank mean losses is the
mean over the global batch, as in JAX's `make_dp_train_step`; `loss` and
`grad_norm` (the averaged gradient's) are reported for the global batch.
"""

from __future__ import annotations

import torch

from ..train.optim import clip_by_global_norm_, global_norm
from .collectives import all_reduce_, group_size


def flat_all_reduce_(tensors: list, group) -> None:
    """Sum `tensors` in place over `group` with one all-reduce of their
    concatenation."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, group)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def shard_batch(batch: dict, rank: int, size: int) -> dict:
    """This data rank's equal slice of a packed batch (every array's leading
    event axis); the batch size must divide by the data axis."""
    b = next(iter(batch.values())).shape[0]
    if b % size:
        raise ValueError(f"batch of {b} events does not divide over {size} data ranks")
    per = b // size
    return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}


def train_step(model, optimizer, loss_fn, apply_fn, batch: dict, data_group,
               generator: torch.Generator | None = None, clip_norm: float = 0.0,
               sharded_norm=None) -> dict:
    """One DP step on this rank's events (`batch`, already sliced):
    loss, gradients averaged over `data_group`, clip, optimizer step.
    `apply_fn(model, batch, generator)` is the forward (`train/trainer.py:
    model_apply`). `sharded_norm`, when given, maps the gradient list to its
    global norm (TP: the head-sharded gradients' squares summed over the
    model ranks). Returns detached {"loss", "grad_norm"}: the global
    batch's mean loss and the averaged gradients' norm before clipping."""
    optimizer.zero_grad(set_to_none=True)
    n = group_size(data_group)
    loss = loss_fn(apply_fn(model, batch, generator), batch)
    if n > 1:
        loss = loss / n
    loss.backward()
    params = [p for p in model.parameters() if p.grad is not None]
    grads = [p.grad for p in params]
    loss_avg = loss.detach().reshape(1).clone()
    flat_all_reduce_(grads + [loss_avg], data_group)
    grad_norm = global_norm(grads) if sharded_norm is None else sharded_norm(model, grads)
    if clip_norm:
        clip_by_global_norm_(grads, grad_norm, clip_norm)
    optimizer.step()
    return {"loss": loss_avg[0], "grad_norm": grad_norm.detach()}
