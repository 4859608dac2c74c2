"""E2LSH random-projection hashing (port of `hept_tpu/core/hashing.py`).

Hash values are projections `x @ alpha` onto frozen N(0, 1) directions, one
per (head, OR-hash). They only feed a sort, so they carry no gradient.
"""

from __future__ import annotations

import torch


def e2lsh_init(generator: torch.Generator, n_heads: int, dim: int, n_hashes: int,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """Frozen N(0, 1) projection directions, shape (n_heads, dim, n_hashes).

    A fresh draw: `jax.random` cannot be reproduced in torch, so weights
    carried across from the JAX package copy these constants
    (utils/convert.py).
    """
    return torch.randn((n_heads, dim, n_hashes), generator=generator, device=device)


def e2lsh_project(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Project per-head vectors onto the hash directions.

    Args:
      x: (n_heads, n, dim) per-head features (any strides).
      alpha: (n_heads, dim, n_hashes).
    Returns: (n_hashes, n_heads, n) float32 hash values, detached.
    """
    with torch.no_grad():
        return torch.einsum("hnd,hdc->chn", x.to(torch.float32), alpha)


def lsh_mapping(alpha: torch.Tensor, queries: torch.Tensor, keys: torch.Tensor):
    """Hash q and k, and the span that separates AND regions.

    Args:
      alpha: (n_heads, dim, n_hashes).
      queries, keys: (n_heads, n, dim).
    Returns: (q_hashed, k_hashed, hash_shift) of shapes (c, h, n), (c, h, n)
      and (c, h, 1), detached: hash_shift = max - min over q AND k and over
      the n points, per (round, head). A region code times a value at least
      the span keeps regions from interleaving after the sort.
    """
    q_hashed = e2lsh_project(queries, alpha)
    k_hashed = e2lsh_project(keys, alpha)
    hi = torch.maximum(q_hashed.amax(dim=-1, keepdim=True), k_hashed.amax(dim=-1, keepdim=True))
    lo = torch.minimum(q_hashed.amin(dim=-1, keepdim=True), k_hashed.amin(dim=-1, keepdim=True))
    return q_hashed, k_hashed, hi - lo
