"""Tiled brute-force k-nearest-neighbours (port of
`hept_tpu/ops/knn.py:knn_brute_force`).

The retrieval metrics need each point's nearest neighbours in the embedding
space. The query axis is tiled, so only (tile, N) distance blocks exist at
once (a full 60k x 60k f32 block would be 14.6 GB). The squared L2 distance
uses the same expansion as the JAX package, |q|^2 - 2 q.p^T + |p|^2, in
float32; the product q.p^T is one `torch.matmul`, as XLA computed it outside
any Pallas kernel. The package turns TF32 off at import (`hept_tpu_torch/
__init__.py`), so the product is full float32 on the card.

`torch.topk` does not promise an order among equal distances, where
`lax.top_k` keeps the lower index; with continuous embeddings ties do not
occur among real points.
"""

from __future__ import annotations

import torch


def knn_brute_force(queries: torch.Tensor, points: torch.Tensor, k: int,
                    valid: torch.Tensor | None = None,
                    tile: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest points (L2) for each query, tiled over queries.

    Args:
      queries: (M, d); points: (N, d); valid: optional (N,) bool -- invalid
        points get +inf distance (never neighbours while k valid points
        exist).
      tile: query rows per distance block.
    Returns:
      (dists, indices): (M, k) ascending squared-L2 distances and int64
      indices.
    """
    queries = queries.to(torch.float32)
    points = points.to(torch.float32)
    p_sq = torch.sum(points * points, dim=-1)
    pt = points.t()
    dists, idxs = [], []
    for start in range(0, queries.shape[0], tile):
        q = queries[start : start + tile]
        # (|q|^2 - 2 q.p) + |p|^2, rounded as the JAX expression rounds
        d2 = torch.matmul(q, pt).mul_(-2.0)
        d2.add_(torch.sum(q * q, dim=-1, keepdim=True)).add_(p_sq[None, :])
        if valid is not None:
            d2.masked_fill_(torch.logical_not(valid)[None, :], float("inf"))
        d, i = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
        del d2
        dists.append(d)
        idxs.append(i)
    return torch.cat(dists), torch.cat(idxs)
