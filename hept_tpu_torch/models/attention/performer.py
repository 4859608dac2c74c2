"""Performer (FAVOR+) linear attention baseline (port of
`hept_tpu/models/attention/performer.py`).

Softmax-kernel random features and non-causal linear attention; the "rpe"
mode folds the RBF distance kernel into a Favor feature map of [q | sqrt(2w)
coords] with per-token log offsets. The frozen matrices are buffers
(`projection_matrix`, or `favor_omega` in rpe mode), drawn at init.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.rff import (
    favor_features,
    gaussian_orthogonal_random_matrix,
    linear_attention,
    orthogonal_gaussian,
    softmax_kernel,
)
from ..mlp import TorchLinear
from .hept import rpe_scales


def split_heads(t: torch.Tensor, h: int, d: int) -> torch.Tensor:
    """(n, h*d) -> (h, n, d)."""
    return t.reshape(t.shape[0], h, d).permute(1, 0, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(h, n, d) -> (n, h*d)."""
    h, n, d = t.shape
    return t.permute(1, 0, 2).reshape(n, h * d)


class PerformerAttention(nn.Module):
    def __init__(self, h_dim: int, num_heads: int, nb_features: int, num_w_per_dist: int,
                 coords_dim: int, pe_type: str = "learned", softmax_eps: float = 1e-6,
                 normalization_eps: float = 1e-6, generator=None, device=None):
        super().__init__()
        self.h_dim, self.num_heads = h_dim, num_heads
        self.num_w_per_dist, self.coords_dim = num_w_per_dist, coords_dim
        self.pe_type = pe_type
        self.softmax_eps, self.normalization_eps = softmax_eps, normalization_eps
        if pe_type == "rpe":
            self.register_buffer("favor_omega", orthogonal_gaussian(
                h_dim + coords_dim, nb_features, generator, device))
        else:
            self.register_buffer("projection_matrix", gaussian_orthogonal_random_matrix(
                nb_features, h_dim, 0, generator, device))
        self.out_linear = TorchLinear(num_heads * h_dim, h_dim, generator=generator,
                                      device=device)

    def forward(self, query, key, value, coords, valid, w_rpe):
        h, d = self.num_heads, self.h_dim
        q, k, v = (split_heads(t, h, d) for t in (query, key, value))
        if self.pe_type == "rpe":
            sqrt_w_r = rpe_scales(w_rpe, h, d, self.coords_dim, self.num_w_per_dist)[:, None, :] \
                * coords[None, :, :]  # (h, n, cd)
            q_sq = -0.5 * torch.sum(q * q, dim=-1, keepdim=True)
            k_sq = -0.5 * torch.sum(k * k, dim=-1, keepdim=True)
            w_r = -torch.sum(sqrt_w_r * sqrt_w_r, dim=-1, keepdim=True)
            q = favor_features(torch.cat([q, sqrt_w_r], dim=-1), self.favor_omega, q_sq + w_r)
            k = favor_features(torch.cat([k, sqrt_w_r], dim=-1), self.favor_omega, k_sq + w_r)
        else:
            q = softmax_kernel(q, self.projection_matrix, True, eps=self.softmax_eps)
            k = softmax_kernel(k, self.projection_matrix, False, eps=self.softmax_eps)
        k = torch.where(valid[None, :, None], k, torch.zeros_like(k))
        out = linear_attention(q, k, v, eps=self.normalization_eps)
        return self.out_linear(merge_heads(out))
