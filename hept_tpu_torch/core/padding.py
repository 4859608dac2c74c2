"""Replication padding (port of `hept_tpu/core/padding.py`'s replicate
mode): slots past the last real row of the trailing bucket copy real rows by
sorted AND-code rank; slots beyond ceil(n/B)*B are inert whole buckets."""

from __future__ import annotations

import torch


def ceil_to_multiple(n, m: int):
    return ((n + m - 1) // m) * m


def replication_pad_plan(n_valid: torch.Tensor, n_total: int, block_size: int,
                         sorted_code_idx: torch.Tensor):
    """Gather indices of the replicate padding mode.

    Args:
      n_valid: scalar int tensor, real rows in slots [0, n_valid).
      n_total: buffer size, a multiple of block_size.
      sorted_code_idx: (n_total,) argsort of the hash-0/head-0 AND code with
        invalid rows keyed to sort last.
    Returns:
      gather: (n_total,) source row per slot; valid: (n_total,) bool real
      rows; inert: (n_total,) bool whole-bucket inert pad slots.
    """
    pos = torch.arange(n_total, device=sorted_code_idx.device)
    padded_n = ceil_to_multiple(n_valid, block_size)
    fill_rank = torch.clamp(n_valid - block_size + (pos - n_valid), 0, n_total - 1)
    fill_idx = sorted_code_idx[fill_rank]
    valid = pos < n_valid
    inert = pos >= padded_n
    gather = torch.where(valid, pos, torch.where(inert, torch.zeros_like(pos), fill_idx))
    return gather, valid, inert
