"""Random feature maps for kernel linear attention (port of
`hept_tpu/ops/rff.py`).

FAVOR+ softmax features, their non-causal linear attention, the Favor
feature map with a log offset (performer's RBF mode) and random Fourier
features (FLT), as pure functions of explicit projection matrices. The
random matrices are drawn from a `torch.Generator`: the JAX package's
`jax.random` draws cannot be reproduced in torch, so a model carried across
from JAX copies its frozen matrices (`utils/convert.py`), and the tests hold
`orthogonal_from_draws` against JAX on JAX's own Gaussian draws.

The products are `torch.einsum` / `torch.matmul`, as XLA computed them
outside any Pallas kernel; the package turns TF32 off at import, so they are
full float32 on the card.
"""

from __future__ import annotations

import math

import torch


def orthogonal_from_draws(blocks: torch.Tensor, gauss: torch.Tensor, nrows: int,
                          scaling: int = 0) -> torch.Tensor:
    """Block-orthogonal projections from Gaussian draws: QR of each
    (ncols, ncols) block with the Haar sign correction, rows stacked and cut
    to `nrows`, then scaled by chi-distributed norms (the row norms of
    `gauss` (nrows, ncols), scaling=0) or by sqrt(ncols) (scaling=1)."""
    nblocks, ncols, _ = blocks.shape
    q, r = torch.linalg.qr(blocks)
    diag_sign = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
    q = (q * diag_sign[:, None, :]).transpose(-1, -2)
    g_ortho = q.reshape(nblocks * ncols, ncols)[:nrows]
    if scaling == 0:
        return torch.linalg.norm(gauss, dim=1)[:, None] * g_ortho
    if scaling == 1:
        return math.sqrt(ncols) * g_ortho
    raise ValueError(f"invalid scaling {scaling}")


def gaussian_orthogonal_random_matrix(nrows: int, ncols: int, scaling: int = 0,
                                      generator: torch.Generator | None = None,
                                      device=None) -> torch.Tensor:
    """(nrows, ncols) block-orthogonal Gaussian projections
    (`orthogonal_from_draws` of fresh draws from `generator`)."""
    nblocks = int(math.ceil(nrows / ncols))
    gdev = generator.device if generator is not None else device
    blocks = torch.randn((nblocks, ncols, ncols), generator=generator, device=gdev)
    gauss = torch.randn((nrows, ncols), generator=generator, device=gdev)
    return orthogonal_from_draws(blocks, gauss, nrows, scaling).to(device)


def orthogonal_gaussian(dim: int, n_features: int, generator: torch.Generator | None = None,
                        device=None) -> torch.Tensor:
    """Feature-map omega (dim, n_features // 2): block-orthogonal Gaussian
    rows, transposed."""
    return gaussian_orthogonal_random_matrix(n_features // 2, dim, 0, generator, device).t()


def softmax_kernel(data: torch.Tensor, projection: torch.Tensor, is_query: bool,
                   softmax_temp: float | None = None, eps: float = 1e-4) -> torch.Tensor:
    """FAVOR+ positive softmax features. data (..., n, d), projection (m, d)
    -> (..., n, m). Queries stabilise with a per-row max, keys with one max
    over the rows and features."""
    d = data.shape[-1]
    if softmax_temp is None:
        softmax_temp = 1.0 / math.sqrt(d)
    normalizer = math.sqrt(softmax_temp)
    ratio = projection.shape[0] ** -0.5
    data_dash = torch.einsum("...id,jd->...ij", normalizer * data, projection)
    diag = torch.sum(data**2, dim=-1, keepdim=True) * 0.5 * normalizer**2
    if is_query:
        stab = torch.amax(data_dash, dim=-1, keepdim=True)
    else:
        stab = torch.amax(data_dash, dim=(-1, -2), keepdim=True)
    return ratio * (torch.exp(data_dash - diag - stab) + eps)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """Non-causal linear attention. q, k (..., n, m) feature maps; v
    (..., n, dv)."""
    k_sum = torch.sum(k, dim=-2)
    d_inv = 1.0 / (torch.einsum("...nd,...d->...n", q, k_sum) + eps)
    context = torch.einsum("...nd,...ne->...de", k, v)
    return torch.einsum("...de,...nd,...n->...ne", context, q, d_inv)


def favor_features(x: torch.Tensor, omega: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """Hyperbolic exp features with an additive log offset (performer's RBF
    mode). x (..., n, d), omega (d, m/2), offset (..., n, 1) -> (..., n, m)."""
    n_dims = 2 * omega.shape[-1]
    u = torch.einsum("...nd,dm->...nm", x, omega)
    off = offset - 0.5 * math.log(n_dims)
    return torch.cat([torch.exp(u + off), torch.exp(-u + off)], dim=-1)


def rff_features(x: torch.Tensor, omega: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    """Random Fourier features [cos(u), sin(u)] * sqrt(2/m), u = x sqrt(gamma)
    omega."""
    n_dims = 2 * omega.shape[-1]
    u = torch.einsum("...nd,dm->...nm", x * math.sqrt(gamma), omega)
    return torch.cat([torch.cos(u), torch.sin(u)], dim=-1) * math.sqrt(2.0 / n_dims)
