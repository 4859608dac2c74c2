"""E2LSH directions (port of `hept_tpu/core/hashing.py:e2lsh_init`)."""

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
