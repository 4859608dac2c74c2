"""Distributed payload routing for the bucket-axis SP: the sharded sort and
unsort (port of `hept_tpu/parallel/dsort.py`).

`bp.py`'s replicated transport carries the whole (rows, n) payload through
the bucket sort on every rank. Here only the comparator sort is
replicated: every rank sorts the (c, n) keys with the index as the
tie-break (`sort_perm`) and so derives the same global permutation; the
payload, split over the P ranks of a group along its point axis (ne = n / P
columns a rank), moves to its sorted position through ONE all-to-all of
capped cells (`route_local`). Each (source rank -> destination rank) cell
holds at most `cap` points; `permute_overflows` tells, from the permutation
alone and alike on every rank, whether a cell would overflow (the routed
result is then wrong, and callers poison it).

The permutation is integer math on detached keys; the payload path is a
gather, a scatter into the cells, the exchange and a gather, all linear,
so autograd transposes it exactly: the exchange's backward is the reverse
exchange (`collectives.all_to_all`).
"""

from __future__ import annotations

import torch

from .collectives import all_to_all, group_rank, group_size

# sort key of rows forced to the end
_BIG_KEY = 3.0e38


def sort_perm(keys: torch.Tensor, invalid: torch.Tensor | None = None) -> torch.Tensor:
    """The global sort permutation of keys (..., n), comparator only:
    output position j takes input element src[..., j]. A stable sort, so
    ties keep their input order (the index breaks them). Invalid elements
    (optional (n,) bool) key to +BIG. Returns int64 src."""
    with torch.no_grad():
        if invalid is not None:
            keys = torch.where(invalid, torch.full_like(keys, _BIG_KEY), keys)
        return torch.argsort(keys, dim=-1, stable=True)


def invert_perm(src: torch.Tensor) -> torch.Tensor:
    """inv with inv[..., src[..., j]] = j: routes sorted data back to input
    order through the same `route_local`."""
    ar = torch.arange(src.shape[-1], dtype=src.dtype, device=src.device)
    return torch.empty_like(src).scatter_(-1, src, ar.expand_as(src).contiguous())


def cell_fill(perm: torch.Tensor, n_shards: int) -> torch.Tensor:
    """The points of each (source, destination) cell of the routed
    permutation (c, n) over `n_shards` ranks: (c, P * P) int64, cell
    source * P + destination."""
    with torch.no_grad():
        c, n = perm.shape
        ne = n // n_shards
        dst = torch.arange(n, device=perm.device) // ne
        cell = (perm // ne) * n_shards + dst[None, :]
        counts = torch.zeros((c, n_shards * n_shards), dtype=torch.int64, device=perm.device)
        return counts.scatter_add_(1, cell, torch.ones_like(cell))


def permute_overflows(perm: torch.Tensor, n_shards: int, cap: int) -> torch.Tensor:
    """Does any (source, destination) cell of the routed permutation (c, n)
    exceed `cap` points? A 0-d bool tensor (no host read); True means
    `route_local` would be wrong."""
    return cell_fill(perm, n_shards).amax() > cap


def _route_plan(perm: torch.Tensor, n_shards: int, me: int):
    """The integer plan of a routing, alike on every rank: each output
    position's source rank, index within its source slab, and rank within
    its (source -> destination) cell (earlier positions of the same
    destination slab with the same source)."""
    c, n = perm.shape
    ne = n // n_shards
    src_rank = perm // ne
    src_loc = perm % ne
    sblk = src_rank.reshape(c, n_shards, 1, ne)
    # (c, P dst, P src, ne): the running count per source along the last,
    # contiguous axis (the scan along an outer axis of extent ne that this
    # replaced took 29.5 ms of a world-1 bucket step on an H100)
    onehot = (sblk == torch.arange(n_shards, device=perm.device)[:, None]).to(torch.int32)
    run = torch.cumsum(onehot, dim=-1, dtype=torch.int32) - onehot  # exclusive
    order = torch.gather(run, 2, sblk)[:, :, 0].reshape(c, n).to(perm.dtype)
    return src_rank, src_loc, order


def route_local(perm: torch.Tensor, payload_local: torch.Tensor, group, cap: int) -> torch.Tensor:
    """This rank's slab of payload[..., perm], the payload split over
    `group` along its last axis.

    Args:
      perm: (c, n) int64 permutation, the same on every rank.
      payload_local: (c, rows, ne) this rank's columns [r * ne, (r + 1) * ne)
        of the (c, rows, n) payload, ne = n / P.
      group: the process group of the P ranks (None: one rank).
      cap: points a (source -> destination) cell can hold; a point beyond it
        is dropped (`permute_overflows` tells).
    Returns: (c, rows, ne) this rank's columns of payload[:, :, perm].

    Every rank sends one (P, c, cap, rows) buffer through `all_to_all`:
    cell j holds, in destination order, the points of its slab that rank j's
    output slab takes. The scatter into the cells writes each point to its
    slot and everything else (positions this rank does not source, and
    overflows) to a spare slot cap, sliced off before the exchange.
    """
    n_shards, me = group_size(group), group_rank(group)
    c, n = perm.shape
    rows, ne = payload_local.shape[1], payload_local.shape[2]
    if ne * n_shards != n:
        raise ValueError(f"payload slab of {ne} columns for n={n} over {n_shards} ranks")
    with torch.no_grad():
        src_rank, src_loc, order = _route_plan(perm, n_shards, me)
        dst_rank = (torch.arange(n, device=perm.device) // ne).expand(c, n)
        mine = src_rank == me
        slot = torch.where(mine & (order < cap), order, cap)
        take = torch.where(mine, src_loc, 0)
        rounds = torch.arange(c, device=perm.device)[:, None].expand(c, n)
    # sender: the value each output position takes from this rank's slab
    cols = payload_local.transpose(1, 2)  # (c, ne, rows)
    picked = torch.gather(cols, 1, take[:, :, None].expand(c, n, rows))
    picked = torch.where(mine[:, :, None], picked, torch.zeros_like(picked))
    send = payload_local.new_zeros((n_shards, c, cap + 1, rows))
    send = send.index_put((dst_rank, rounds, slot), picked)[:, :, :cap]
    recv = all_to_all(send, group)  # (P, c, cap, rows): cell i from rank i
    # receiver: this rank's output slab
    sl = slice(me * ne, (me + 1) * ne)
    with torch.no_grad():
        src_mine = src_rank[:, sl]
        slot_mine = order[:, sl].clamp(max=cap - 1)
    out = recv[src_mine, rounds[:, :ne], slot_mine]  # (c, ne, rows)
    return out.transpose(1, 2)


def shard_permute(perm: torch.Tensor, payload_local: torch.Tensor, group, *,
                  cap: int) -> torch.Tensor:
    """Apply a replicated permutation (c, n) to a payload split over `group`
    along its last axis (the counterpart of JAX's `make_shard_permute`):
    this rank's (c, rows, n / P) slab of payload[:, :, perm]. One
    all-to-all of (P, c, cap, rows) cells. Wrong where
    `permute_overflows(perm, P, cap)`: check it, or size cap generously
    (2 n / P^2 holds for about uniform hash keys)."""
    if perm.shape[-1] % group_size(group):
        raise ValueError(f"n={perm.shape[-1]} does not divide over {group_size(group)} ranks")
    return route_local(perm, payload_local, group, cap)
