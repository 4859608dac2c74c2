"""Intra-event model parallelism: head-sharded HEPT attention (port of
`hept_tpu/parallel/sp.py`).

The bucket grid (n_hashes, heads, n_buckets) is embarrassingly parallel
after the sort. Split over heads, each rank hashes, sorts, attends and
unsorts its own head slice with no communication (the hash span and the
E2LSH directions are per (hash, head)); the one collective is the
all-gather of the output heads.
"""

from __future__ import annotations

import torch

from ..ops.bucket_attn import hept_attention_core
from .collectives import all_gather, copy_to_group, group_rank, group_size


def head_sharded_attention(q_hat: torch.Tensor, k_hat: torch.Tensor, v: torch.Tensor,
                           alpha: torch.Tensor, codes: torch.Tensor,
                           invalid: torch.Tensor | None, group, *, block_size: int,
                           impl: str = "xla", perms=None) -> torch.Tensor:
    """`ops/bucket_attn.py:hept_attention_core` with its heads split over
    `group`: every rank passes the whole inputs, runs the core (kernel K10
    on CUDA tensors) on its equal head slice and gets the whole
    (h, n, dv) output back.

    Args as `hept_attention_core`: q_hat, k_hat (h, n, d), v (h, n, dv),
    alpha (h, d, c), codes (c, h, n), invalid (n,). The inputs are
    replicated, so their gradients are summed over the group (each rank's
    slice contributes its heads' part): every rank gets the unsharded
    core's input gradients. `perms`: optional (q_src, k_src) of all the
    heads, each (c, h, n), as the core takes them (to hold two runs on the
    same permutations); this rank applies its heads' slice.
    """
    h = q_hat.shape[0]
    n_sh = group_size(group)
    if h % n_sh:
        raise ValueError(f"{h} heads do not divide over {n_sh} ranks")
    w = h // n_sh
    sl = slice(group_rank(group) * w, (group_rank(group) + 1) * w)
    q_hat, k_hat, v = (copy_to_group(t, group)[sl] for t in (q_hat, k_hat, v))
    if perms is not None:
        perms = tuple(p[:, sl] for p in perms)
    out = hept_attention_core(q_hat, k_hat, v, alpha[sl], codes[:, sl], invalid,
                              block_size=block_size, impl=impl, perms=perms)
    return all_gather(out, 0, group)
