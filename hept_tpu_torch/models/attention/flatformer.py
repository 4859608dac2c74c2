"""FlatFormer grouped window attention baseline (port of
`hept_tpu/models/attention/flatformer.py`).

Coordinates are binned onto a B x B grid; four serpentine window orderings
(x, shifted x, y, shifted y) each sort the points (stable; invalid rows
last) into equal groups, and a post-norm transformer layer (attention +
FFN) runs within the groups of each ordering before the inverse map puts
the rows back. Invalid keys are masked inside their groups.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...core.buckets import invert_permutation
from ...ops.bucket_attn import stable_ratio
from ..mlp import TorchLinear, layer_norm
from .hept import rpe_scales
from .smyrf import BIG


def discretize_coords(coords: torch.Tensor, b: int) -> torch.Tensor:
    """Bin each column into [0, b) over the rows' range (float bins)."""
    mn = torch.amin(coords, dim=-2, keepdim=True)
    mx = torch.amax(coords, dim=-2, keepdim=True)
    bucket = (mx - mn) / b
    out = torch.floor((coords - mn) / torch.clamp(bucket, min=1e-12))
    return torch.clamp(out, 0, b - 1)


def serpentine_keys(dis_xy: torch.Tensor, b: int, num_slices: int, shifted: bool):
    """Serpentine window-major sort keys (vx, vy) of binned (n, 2) [y, x]
    columns, as floats."""
    n2 = m2 = b // num_slices  # window shape
    n1 = m1 = int(math.ceil(b / n2) + 1)
    y, x = dis_xy[:, 0], dis_xy[:, 1]
    if shifted:
        x = x + n2 // 2
        y = y + m2 // 2
    x1, y1 = torch.div(x, n2, rounding_mode="floor"), torch.div(y, m2, rounding_mode="floor")
    x2, y2 = torch.remainder(x, n2), torch.remainder(y, m2)

    def sgn(t):
        return torch.where(torch.remainder(t, 2) == 0, 1.0, -1.0)

    vx = (n1 * y1 + sgn(y1) * x1) * n2 * m2 + sgn(y1) * (m2 * x2 + sgn(x2) * y2)
    vy = (m1 * x1 + sgn(x1) * y1) * m2 * n2 + sgn(x1) * (n2 * y2 + sgn(y2) * x2)
    return vx, vy


class GroupAttention(nn.Module):
    """Attention within groups of `group_size` consecutive rows: softmax
    over the group, or in "rpe" mode the normalised RBF kernel of
    [q | sqrt(2w) pe] and [k | sqrt(2w) pe]."""

    def __init__(self, h_dim: int, num_heads: int, group_size: int, num_w_per_dist: int,
                 pe_type: str, generator=None, device=None):
        super().__init__()
        self.h_dim, self.num_heads, self.group_size = h_dim, num_heads, group_size
        self.num_w_per_dist, self.pe_type = num_w_per_dist, pe_type
        kw = dict(generator=generator, device=device)
        hd = h_dim * num_heads
        self.w_q = TorchLinear(h_dim, hd, bias=False, **kw)
        self.w_k = TorchLinear(h_dim, hd, bias=False, **kw)
        self.w_v = TorchLinear(h_dim, hd, bias=False, **kw)
        self.out_linear = TorchLinear(hd, h_dim, **kw)

    def forward(self, x, pe, key_valid, w_rpe):
        n = x.shape[0]
        h, d, gs = self.num_heads, self.h_dim, self.group_size
        ng = n // gs
        qk_in = x if self.pe_type == "rpe" else x + pe

        def grp(t):  # (n, ...) -> (ng, h, gs, ...)
            return t.reshape(ng, gs, h, -1).permute(0, 2, 1, 3)

        q, k, v = grp(self.w_q(qk_in)), grp(self.w_k(qk_in)), grp(self.w_v(x))
        kv = key_valid.reshape(ng, 1, 1, gs)
        if self.pe_type == "rpe":
            cd = pe.shape[-1]
            sw = grp(rpe_scales(w_rpe, h, d, cd, self.num_w_per_dist)[None] * pe[:, None, :])
            q_hat = torch.cat([q, sw], dim=-1)
            k_hat = torch.cat([k, sw], dim=-1)
            logits = torch.einsum("ghie,ghje->ghij", q_hat, k_hat)
            q_sq = -0.5 * torch.sum(q_hat**2, dim=-1, keepdim=True)
            k_sq = -0.5 * torch.sum(k_hat**2, dim=-1, keepdim=True)
            p = torch.exp(torch.clamp(logits + q_sq + k_sq.transpose(-1, -2), max=0.0))
            p = torch.where(kv > 0.5, p, torch.zeros_like(p))
            p = stable_ratio(p, torch.sum(p, dim=-1, keepdim=True) + 1e-20)
        else:
            logits = torch.einsum("ghie,ghje->ghij", q * (1.0 / math.sqrt(d)), k)
            logits = torch.where(kv > 0.5, logits, torch.full_like(logits, -1e9))
            p = torch.softmax(logits, dim=-1)
        out = torch.einsum("ghij,ghjd->ghid", p, v)
        return self.out_linear(out.permute(0, 2, 1, 3).reshape(n, h * d))


class BasicLayer(nn.Module):
    """Post-norm group attention and FFN (hidden 2 h_dim)."""

    def __init__(self, h_dim: int, num_heads: int, group_size: int, num_w_per_dist: int,
                 pe_type: str, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.attn = GroupAttention(h_dim, num_heads, group_size, num_w_per_dist, pe_type, **kw)
        self.norm1 = layer_norm(h_dim, device)
        self.fc1 = TorchLinear(h_dim, 2 * h_dim, **kw)
        self.fc2 = TorchLinear(2 * h_dim, h_dim, **kw)
        self.norm2 = layer_norm(h_dim, device)

    def forward(self, x, pe, key_valid, w_rpe):
        x = self.norm1(x + self.attn(x, pe, key_valid, w_rpe))
        return self.norm2(x + self.fc2(torch.relu(self.fc1(x))))


class FlatformerAttention(nn.Module):
    """Four BasicLayers, one per serpentine ordering; returns the last
    output and all four."""

    def __init__(self, h_dim: int, num_heads: int, group_size: int, num_w_per_dist: int,
                 b_grid: int = 1000, num_slices_per_axis: int = 30, pe_type: str = "learned",
                 generator=None, device=None):
        super().__init__()
        self.group_size, self.b_grid = group_size, b_grid
        self.num_slices_per_axis = num_slices_per_axis
        self.layers = nn.ModuleList(
            BasicLayer(h_dim, num_heads, group_size, num_w_per_dist, pe_type, generator, device)
            for _ in range(4))

    def orders(self, coords: torch.Tensor, valid: torch.Tensor) -> list:
        """The four orderings' (idx, inverse) maps: stable argsorts of the
        serpentine keys, invalid rows keyed to +BIG."""
        dis = discretize_coords(coords[:, :2], self.b_grid)
        keys = [*serpentine_keys(dis, self.b_grid, self.num_slices_per_axis, False),
                *serpentine_keys(dis, self.b_grid, self.num_slices_per_axis, True)]
        out = []
        for kk in (keys[0], keys[2], keys[1], keys[3]):  # vx, vx shifted, vy, vy shifted
            kk = torch.where(valid, kk.to(torch.float32), torch.full_like(kk, BIG))
            idx = torch.argsort(kk, stable=True)
            out.append((idx, invert_permutation(idx)))
        return out

    def forward(self, x, coords, pe, valid, w_rpe):
        n = x.shape[0]
        if n % self.group_size:
            raise ValueError(f"flatformer needs n % group_size == 0, got n={n}, "
                             f"group_size={self.group_size}")
        all_x = []
        with torch.no_grad():
            orders = self.orders(coords, valid)
        for layer, (idx, inv) in zip(self.layers, orders):
            x = layer(x[idx], pe[idx], valid[idx].to(x.dtype), w_rpe)[inv]
            all_x.append(x)
        return x, all_x
