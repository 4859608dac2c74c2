"""HEPT attention module on the static-plan path (port of the post-sort
branch of `hept_tpu/models/attention/hept.py`)."""

from __future__ import annotations

import torch
from torch import nn

from ...core.hashing import e2lsh_init
from ...ops.bucket_attn import hept_attention_core_xcols
from ..mlp import TorchLinear


def rpe_scales(w_rpe: torch.Tensor, num_heads: int, h_dim: int, coords_dim: int,
               num_w_per_dist: int) -> torch.Tensor:
    """Per-head RPE column scales sqrt(2 w) (h, coords_dim): per distance
    group, w = sum_k exp(min(sum_d W[h, d, r, k], 50)); eta and phi share
    the first group's width (they form dR)."""
    w = w_rpe.reshape(num_heads, h_dim, coords_dim - 1, num_w_per_dist)
    qw = torch.exp(torch.clamp(w.sum(dim=1), max=50.0)).sum(dim=-1)
    qw_expanded = torch.cat([qw[:, :1], qw], dim=-1)
    return torch.sqrt(2.0 * qw_expanded)


class HeptAttention(nn.Module):
    """LSH-bucketed block-local RBF attention over a static bucket plan.

    The caller passes the shared normed hidden state and the per-head q/k/v
    kernels; they are applied after the plan's gather. `e2lsh_alpha` is the
    per-layer hash constant the reference declares; a static plan does not
    read it, and it is kept so weights carry across unchanged.
    """

    def __init__(self, cfg, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        h, d = cfg.num_heads, cfg.h_dim
        self.out_linear = TorchLinear(h * d, d, generator=generator, device=device)
        self.register_buffer(
            "e2lsh_alpha",
            e2lsh_init(generator, 1, d + cfg.coords_dim, cfg.n_hashes, device=device),
        )

    def forward(self, x_normed, coords, invalid, plan, w_rpe, wq, wk, wv):
        cfg = self.cfg
        sqrt_w = rpe_scales(w_rpe, cfg.num_heads, cfg.h_dim, cfg.coords_dim,
                            cfg.num_w_per_dist)
        out = hept_attention_core_xcols(
            x_normed.t(), coords.t(), wq, wk, wv, sqrt_w, invalid, plan,
            block_size=cfg.block_size, sort_pack=cfg.sort_pack,
            unsort_pack=cfg.unsort_pack, kernel_bf16=cfg.kernel_bf16,
            kernel_center=cfg.kernel_center,
        )  # (n, h * d) rows
        return self.out_linear(out)
