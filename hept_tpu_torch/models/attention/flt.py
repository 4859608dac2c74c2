"""FLT: Fourier-learned-transform attention baseline (port of
`hept_tpu/models/attention/flt.py`).

Learnable distance weights in (dR, dAngle) groups; each coordinate group is
lifted with random Fourier features, concatenated to q / k, and run through
Performer's softmax-kernel linear attention. `coords_dim` is the full
coords width. The frozen matrices (`rff_omega_dr`, `rff_omega_da`,
`projection_matrix`) are buffers drawn at init.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...ops.rff import (
    gaussian_orthogonal_random_matrix,
    linear_attention,
    orthogonal_gaussian,
    rff_features,
    softmax_kernel,
)
from ..mlp import TorchLinear
from .performer import merge_heads, split_heads


class FLTAttention(nn.Module):
    def __init__(self, h_dim: int, num_heads: int, nb_features: int, nb_features_inner: int,
                 num_w_per_dist: int, coords_dim: int, softmax_eps: float = 1e-6,
                 normalization_eps: float = 1e-6, generator=None, device=None):
        super().__init__()
        self.h_dim, self.num_heads = h_dim, num_heads
        self.nb_features_inner, self.num_w_per_dist = nb_features_inner, num_w_per_dist
        self.coords_dim = coords_dim
        self.softmax_eps, self.normalization_eps = softmax_eps, normalization_eps
        self.register_buffer("rff_omega_dr", orthogonal_gaussian(2, nb_features_inner,
                                                                 generator, device))
        self.register_buffer("rff_omega_da", orthogonal_gaussian(1, nb_features_inner,
                                                                 generator, device))
        ncols = h_dim + (coords_dim - 1) * nb_features_inner
        self.register_buffer("projection_matrix", gaussian_orthogonal_random_matrix(
            nb_features, ncols, 0, generator, device))
        self.out_linear = TorchLinear(num_heads * h_dim, h_dim, generator=generator,
                                      device=device)

    def forward(self, query, key, value, coords, valid, w_rpe):
        h, d, cd = self.num_heads, self.h_dim, self.coords_dim
        n = query.shape[0]
        q, k, v = (split_heads(t, h, d) for t in (query, key, value))
        temp = 1.0 / math.sqrt(d)
        # w_rpe as (h, d, cd - 1, 2 groups (alpha, qw), num_w_per_dist // 2)
        kk = self.num_w_per_dist // 2
        w = w_rpe.reshape(h, d, cd - 1, 2, kk).permute(3, 0, 1, 2, 4)
        summed = torch.exp(torch.clamp(w.sum(dim=2), max=50.0)).sum(dim=-1)  # (2, h, cd-1)
        alpha, qw = summed[0], summed[1]
        qw_e = torch.cat([qw[:, :1], qw], dim=-1)  # (h, cd)
        sqrt_w_r = torch.sqrt(qw_e)[:, None, :] * coords[None, :, :]  # (h, n, cd)

        phi_dr = rff_features(sqrt_w_r[..., :2][..., None, :], self.rff_omega_dr)
        phi_da = rff_features(sqrt_w_r[..., 2:][..., None], self.rff_omega_da)
        phi = torch.cat([phi_dr, phi_da], dim=-2)  # (h, n, cd-1, m)
        phi = phi * torch.sqrt(alpha)[:, None, :, None]
        phi = phi.reshape(h, n, (cd - 1) * self.nb_features_inner)

        q_cat = torch.cat([q * math.sqrt(temp), phi], dim=-1)
        k_cat = torch.cat([k * math.sqrt(temp), phi], dim=-1)
        qf = softmax_kernel(q_cat, self.projection_matrix, True, softmax_temp=1.0,
                            eps=self.softmax_eps)
        kf = softmax_kernel(k_cat, self.projection_matrix, False, softmax_temp=1.0,
                            eps=self.softmax_eps)
        kf = torch.where(valid[None, :, None], kf, torch.zeros_like(kf))
        out = linear_attention(qf, kf, v, eps=self.normalization_eps)
        return self.out_linear(merge_heads(out))
