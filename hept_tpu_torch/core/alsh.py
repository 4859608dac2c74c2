"""Asymmetric-LSH transforms and auxiliary hash families (port of
`hept_tpu/core/alsh.py`, the reference's `src/models/model_utils/
hash_utils.py:96-373`).

No model path calls them (smyrf's XBOX+ sits beside its consumer in
`models/attention/smyrf.py`); they are kept for the API's sake. The random
families take their draws as an argument (anchors, rotations, directions)
or draw them from a `torch.Generator`, as `models/attention/draws.py` does.
"""

from __future__ import annotations

import torch


def _normal(shape, generator, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def l2lsh_k(vec: torch.Tensor) -> torch.Tensor:
    """L2-ALSH key transform (hash_utils.py:187-199): normalise by the max
    norm and append |x|^2, |x|^4, |x|^8 columns."""
    norms = torch.linalg.norm(vec, dim=-1, keepdim=True)
    x = vec / norms.amax(dim=0, keepdim=True)
    n = torch.linalg.norm(x, dim=-1, keepdim=True)
    return torch.cat([x, n**2, n**4, n**8], dim=-1)


def l2lsh_q(vec: torch.Tensor) -> torch.Tensor:
    """L2-ALSH query transform (hash_utils.py:201-206): standardise and pad
    with three 0.5 columns."""
    mu = vec.mean(dim=-1, keepdim=True)
    sd = vec.std(dim=-1, keepdim=True, correction=0)
    x = (vec - mu) / sd.clamp(min=1e-12)
    ext = torch.full(x.shape[:-1] + (1,), 0.5, dtype=x.dtype, device=x.device)
    return torch.cat([x, ext, ext, ext], dim=-1)


def xbox(q: torch.Tensor, k: torch.Tensor):
    """XBOX transform (hash_utils.py:209-219): keys padded to the max key
    norm, queries zero-extended."""
    k_norm = torch.linalg.norm(k, dim=-1, keepdim=True)
    max_norm = k_norm.amax(dim=-2, keepdim=True)
    k_ext = torch.sqrt(torch.clamp(max_norm**2 - k_norm**2, min=0.0))
    zeros = torch.zeros(q.shape[:-1] + (1,), dtype=q.dtype, device=q.device)
    return torch.cat([q, zeros], dim=-1), torch.cat([k, k_ext], dim=-1)


def xbox_max(q: torch.Tensor, k: torch.Tensor):
    """XBOXMax (hash_utils.py:240-255): XBOX+ with the max instead of the
    sum of the two norm maxima."""
    q_sq = torch.sum(q * q, dim=-1, keepdim=True)
    k_sq = torch.sum(k * k, dim=-1, keepdim=True)
    m = torch.maximum(q_sq.amax(dim=-2, keepdim=True), k_sq.amax(dim=-2, keepdim=True))
    q_ext = torch.sqrt(torch.clamp(m - q_sq, min=0.0))
    k_ext = torch.sqrt(torch.clamp(m - k_sq, min=0.0))
    return (torch.cat([q, torch.zeros_like(q_ext), q_ext], dim=-1),
            torch.cat([k, k_ext, torch.zeros_like(k_ext)], dim=-1))


def voronoi_lsh(vecs: torch.Tensor, n_hashes: int, n_anchors: int = 16,
                generator: torch.Generator | None = None,
                anchors: torch.Tensor | None = None) -> torch.Tensor:
    """Voronoi LSH (hash_utils.py:290-311): the bucket is the nearest of a
    random anchor set, one set per round. vecs (..., n, d) -> (n_hashes,
    ..., n). `anchors` (n_hashes, n_anchors, d), else normal draws from
    `generator`."""
    d = vecs.shape[-1]
    if anchors is None:
        anchors = _normal((n_hashes, n_anchors, d), generator, vecs)
    lead = (1,) * (vecs.dim() - 2)
    d2 = (torch.sum(vecs**2, dim=-1)[None, ..., None]
          - 2.0 * torch.einsum("...nd,had->h...na", vecs, anchors)
          + torch.sum(anchors**2, dim=-1).reshape((n_hashes,) + lead + (1, n_anchors)))
    return torch.argmin(d2, dim=-1)


def cross_polytope_lsh(vecs: torch.Tensor, n_hashes: int,
                       generator: torch.Generator | None = None,
                       rotations: torch.Tensor | None = None) -> torch.Tensor:
    """Cross-polytope LSH (hash_utils.py:314-326): the bucket is the argmax
    of [Rx; -Rx] under a random rotation per round. `rotations` (n_hashes,
    d, d), else normal draws from `generator`."""
    d = vecs.shape[-1]
    if rotations is None:
        rotations = _normal((n_hashes, d, d), generator, vecs)
    proj = torch.einsum("...nd,hde->h...ne", vecs, rotations)
    return torch.argmax(torch.cat([proj, -proj], dim=-1), dim=-1)


def sort_key_val(keys: torch.Tensor, values: torch.Tensor, dim: int = -1):
    """Sort keys and carry values (hash_utils.py:158-164)."""
    order = torch.argsort(keys, dim=dim, stable=True)
    return torch.gather(keys, dim, order), torch.gather(values, dim, order)


def hadamard_transform(x: torch.Tensor) -> torch.Tensor:
    """Fast Walsh-Hadamard transform along the last axis (a power-of-two
    width), normalised by 1/sqrt(d) (hash_utils.py:96-116's sign-randomised
    variant is this transform of x times random signs)."""
    d = x.shape[-1]
    if d & (d - 1):
        raise ValueError(f"dimension {d} is not a power of two")
    h, y = 1, x
    while h < d:
        y = y.reshape(x.shape[:-1] + (d // (2 * h), 2, h))
        a, b = y[..., 0, :], y[..., 1, :]
        y = torch.stack([a + b, a - b], dim=-2).reshape(x.shape)
        h *= 2
    return y / d**0.5


def inversion_number(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairs (i, j), i < j, ordered differently by the rankings of x and y
    (hash_utils.py:119-144, a bucketing-quality diagnostic); O(n^2)."""
    rx = torch.argsort(torch.argsort(x))
    ry = torch.argsort(torch.argsort(y))
    less_x = rx[:, None] < rx[None, :]
    less_y = ry[:, None] < ry[None, :]
    return torch.sum(torch.triu(less_x ^ less_y, diagonal=1))


def h2lsh_k(vec: torch.Tensor) -> torch.Tensor:
    """H2-ALSH key transform (hash_utils.py:258-270): append sqrt(M^2 -
    |x|^2), M the global max norm, so every key has norm M."""
    norms = torch.linalg.norm(vec, dim=-1, keepdim=True)
    ext = torch.sqrt(torch.clamp(norms.max() ** 2 - norms**2, min=0.0))
    return torch.cat([vec, ext], dim=-1)


def h2lsh_q(vec: torch.Tensor) -> torch.Tensor:
    """H2-ALSH query transform (hash_utils.py:272-276): unit-normalise and
    zero-extend."""
    norms = torch.linalg.norm(vec, dim=-1, keepdim=True)
    x = vec / norms.clamp(min=1e-12)
    return torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)


def qlsh_project(q: torch.Tensor, k: torch.Tensor, n_hashes: int, r: float = 1.0,
                 generator: torch.Generator | None = None,
                 directions: torch.Tensor | None = None):
    """QLSH (hash_utils.py:353-373): query-centric E2LSH. Both sides project
    on shared directions (`directions` (d, n_hashes), else normal draws from
    `generator`); keys quantise relative to each query's projection.
    Returns (q_proj (nq, n_hashes), k_bucket (nq, nk, n_hashes)) with
    k_bucket = floor((k.a - q.a) / r)."""
    if directions is None:
        directions = _normal((q.shape[-1], n_hashes), generator, q)
    qp, kp = q @ directions, k @ directions
    return qp, torch.floor((kp[None, :, :] - qp[:, None, :]) / r).to(torch.int32)
