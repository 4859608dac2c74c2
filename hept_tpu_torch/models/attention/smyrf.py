"""SMYRF attention baseline (port of `hept_tpu/models/attention/smyrf.py`).

The XBOX+ asymmetric transform equalises q / k norms; an E2LSH projection
with a uniform shift beta clusters points; separate stable argsorts of the
q and k hashes give balanced clusters; exact softmax runs within each
(q-cluster, k-cluster) pair, rows whose keys are all masked give 0, and the
hash rounds combine with logsumexp weights. "rpe" mode hashes the
RBF-lifted [q | sqrt(2w) coords] and appends [1, -|q|^2/2] / [-|k|^2/2, 1]
so that the logit is the RBF exponent, clamped at 0. The E2LSH draws come
from the step's generator, a fixed draw without one, or the caller
(`rotations=(alpha, beta)`; `draws.py`). A caller may record the (q, k)
sort orders (`record_perms=`, a list) and impose them on another run
(`perms=`).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...core.buckets import gather_rows, invert_permutation
from ..mlp import TorchLinear
from . import draws
from .hept import rpe_scales
from .performer import merge_heads, split_heads

MASKED_VALUE = -3.0e38
BIG = 3.0e38  # the hash of an invalid row: it sorts last


def xboxplus(q: torch.Tensor, k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """XBOX+ transform: q -> [q, 0, sqrt(M - |q|^2)], k -> [k, sqrt(M - |k|^2),
    0], M the sum of the largest squared norms over the rows."""
    q_sq = torch.sum(q * q, dim=-1, keepdim=True)
    k_sq = torch.sum(k * k, dim=-1, keepdim=True)
    m = torch.amax(q_sq, dim=-2, keepdim=True) + torch.amax(k_sq, dim=-2, keepdim=True)
    q_ext = torch.sqrt(torch.clamp(m - q_sq, min=0.0))
    k_ext = torch.sqrt(torch.clamp(m - k_sq, min=0.0))
    return (torch.cat([q, torch.zeros_like(q_ext), q_ext], dim=-1),
            torch.cat([k, k_ext, torch.zeros_like(k_ext)], dim=-1))


def e2lsh_specs(dim_t: int, n_hashes: int) -> tuple:
    """alpha (dim_t, c) normal, beta (1, c) uniform."""
    return (("normal", (dim_t, n_hashes)), ("uniform", (1, n_hashes)))


def e2lsh_sort(q_t, k_t, valid, alpha, beta, r: float):
    """Stable argsorts (c, h, n) of the E2LSH hashes of q_t and k_t (h, n, e);
    invalid rows hash to +BIG."""
    with torch.no_grad():
        shift = (beta * r).t()[:, :, None]  # (c, 1, 1)
        out = []
        for t in (q_t, k_t):
            hashed = torch.einsum("hnd,dc->chn", t, alpha) + shift
            hashed = torch.where(valid[None, None, :], hashed, torch.full_like(hashed, BIG))
            out.append(torch.argsort(hashed, dim=-1, stable=True))
        return out


def zero_invalid(t: torch.Tensor, valid: torch.Tensor, h: int, d: int) -> torch.Tensor:
    """(n, h*d) with invalid rows zeroed -> (h, n, d)."""
    return split_heads(torch.where(valid[:, None], t, torch.zeros_like(t)), h, d)


class SmyrfAttention(nn.Module):
    def __init__(self, h_dim: int, num_heads: int, bucket_size: int, n_hashes: int,
                 num_w_per_dist: int, coords_dim: int, pe_type: str = "learned", r: float = 1.0,
                 generator=None, device=None):
        super().__init__()
        self.h_dim, self.num_heads = h_dim, num_heads
        self.bucket_size, self.n_hashes = bucket_size, n_hashes
        self.num_w_per_dist, self.coords_dim = num_w_per_dist, coords_dim
        self.pe_type, self.r = pe_type, r
        self.out_linear = TorchLinear(num_heads * h_dim, h_dim, generator=generator,
                                      device=device)
        self._fixed: dict = {}

    def hash_dim(self) -> int:
        """Width of the hashed vectors (alpha's rows)."""
        if "rpe" in self.pe_type:
            return self.h_dim + self.coords_dim
        return self.h_dim + 2

    def forward(self, query, key, value, coords, valid, w_rpe, rotations=None, generator=None,
                perms=None, record_perms=None):
        n = query.shape[0]
        h, d, c, bs = self.num_heads, self.h_dim, self.n_hashes, self.bucket_size
        if n % bs:
            raise ValueError(f"smyrf needs n % bucket_size == 0, got n={n}, bs={bs}")
        nb = n // bs
        # invalid rows zeroed first: XBOX+ takes its norms over all rows
        q, k, v = (zero_invalid(t, valid, h, d) for t in (query, key, value))
        rpe = "rpe" in self.pe_type
        if rpe:
            sqrt_w_r = rpe_scales(w_rpe, h, d, self.coords_dim, self.num_w_per_dist)[:, None, :] \
                * coords[None, :, :]
            q = torch.cat([q, sqrt_w_r], dim=-1)
            k = torch.cat([k, sqrt_w_r], dim=-1)
            temp = 1.0
            q_t, k_t = q, k
        else:
            temp = 1.0 / math.sqrt(d)
            q_t, k_t = xboxplus(q, k)
        if rotations is None:
            rotations = draws.draw(e2lsh_specs(self.hash_dim(), c), generator, q.device,
                                   self._fixed)
        q_pos, k_pos = e2lsh_sort(q_t, k_t, valid, *rotations, self.r) if perms is None else perms
        if record_perms is not None:
            record_perms.append((q_pos, k_pos))

        if self.pe_type == "rpe":
            q_sq = -0.5 * torch.sum(q * q, dim=-1, keepdim=True)
            k_sq = -0.5 * torch.sum(k * k, dim=-1, keepdim=True)
            ones = torch.ones_like(q_sq)
            q = torch.cat([q, ones, q_sq], dim=-1)
            k = torch.cat([k, k_sq, ones], dim=-1)

        dq = q.shape[-1]
        sq = gather_rows(q, q_pos).reshape(c, h, nb, bs, dq)
        sk = gather_rows(k, k_pos).reshape(c, h, nb, bs, dq)
        sv = gather_rows(v, k_pos).reshape(c, h, nb, bs, d)
        kvalid = valid[None, :, None].to(q.dtype).expand(h, n, 1)
        s_kvalid = gather_rows(kvalid, k_pos).reshape(c, h, nb, bs)

        inner = torch.einsum("chbie,chbje->chbij", sq, sk)
        if rpe:
            inner = torch.clamp(inner, max=0.0)
        inner = inner * temp
        inner = torch.where(s_kvalid[:, :, :, None, :] > 0.5, inner,
                            torch.full_like(inner, MASKED_VALUE))
        lse = torch.logsumexp(inner, dim=-1, keepdim=True)
        dots = torch.exp(inner - lse)
        full_row_mask = torch.all(inner <= MASKED_VALUE, dim=-1, keepdim=True)
        dots = torch.where(full_row_mask, torch.zeros_like(dots), dots)
        so = torch.einsum("chbij,chbjd->chbid", dots, sv)

        q_inv = invert_permutation(q_pos)
        o = gather_rows(so.reshape(c, h, n, d), q_inv)
        logits = gather_rows(lse.reshape(c, h, n, 1), q_inv)
        probs = torch.exp(logits - torch.logsumexp(logits, dim=0, keepdim=True))
        return self.out_linear(merge_heads(torch.sum(o * probs, dim=0)))
