"""Scatterbrain (SB) attention baseline: SMYRF's sparse part plus a
Performer low-rank part (port of `hept_tpu/models/attention/sb.py`).

Points cluster as in SMYRF (XBOX+ and E2LSH); within a cluster the exact
softmax weights lose the low-rank estimate of the same pairs, so that they
are not counted twice; a global FAVOR+ linear-attention term adds the
long-range mass; the rounds combine with logsumexp weights, and the sparse
and low-rank parts are normalised together. With more than one round each
(q, k) pair is down-weighted by the number of rounds it meets in. The frozen
projection `sb_projection` is a buffer drawn at init; the E2LSH draws come
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
from ...ops.rff import gaussian_orthogonal_random_matrix
from ..mlp import TorchLinear
from . import draws
from .performer import merge_heads
from .smyrf import MASKED_VALUE, e2lsh_sort, e2lsh_specs, xboxplus, zero_invalid


def sb_softmax_kernel(data: torch.Tensor, projection: torch.Tensor, is_query: bool,
                      softmax_temp: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cosh-variant FAVOR features and their log scale: (features, log_scale)
    with features * exp(log_scale) the feature map."""
    m = 2 * projection.shape[0]
    normalizer = math.sqrt(softmax_temp)
    data_dash = torch.einsum("...id,jd->...ij", data, normalizer * projection)
    diag = torch.sum(data**2, dim=-1, keepdim=True) / 2 * softmax_temp
    data_dash = torch.cat([data_dash, -data_dash], dim=-1)
    if is_query:
        amax = torch.amax(data_dash, dim=-1, keepdim=True)
        return torch.exp(data_dash - amax), -diag + amax - math.log(m) / 2
    dmd = data_dash - diag - math.log(m) / 2
    log_scale = torch.amax(dmd, dim=(-1, -2), keepdim=True)
    return torch.exp(dmd - log_scale), log_scale


class SBAttention(nn.Module):
    def __init__(self, h_dim: int, num_heads: int, bucket_size: int, n_hashes: int,
                 nb_features: int, r: float = 1.0, generator=None, device=None):
        super().__init__()
        self.h_dim, self.num_heads = h_dim, num_heads
        self.bucket_size, self.n_hashes, self.r = bucket_size, n_hashes, r
        self.register_buffer("sb_projection", gaussian_orthogonal_random_matrix(
            nb_features // 2, h_dim, 0, generator, device))
        self.out_linear = TorchLinear(num_heads * h_dim, h_dim, generator=generator,
                                      device=device)
        self._fixed: dict = {}

    def hash_dim(self) -> int:
        return self.h_dim + 2

    def forward(self, query, key, value, valid, rotations=None, generator=None,
                perms=None, record_perms=None):
        n = query.shape[0]
        h, d, c, bs = self.num_heads, self.h_dim, self.n_hashes, self.bucket_size
        if n % bs:
            raise ValueError(f"sb needs n % bucket_size == 0, got n={n}, bs={bs}")
        nb = n // bs
        temp = 1.0 / math.sqrt(d)
        q, k, v = (zero_invalid(t, valid, h, d) for t in (query, key, value))

        # LSH clusters (XBOX+, E2LSH with a shift)
        if rotations is None:
            rotations = draws.draw(e2lsh_specs(self.hash_dim(), c), generator, q.device,
                                   self._fixed)
        q_pos, k_pos = e2lsh_sort(*xboxplus(q, k), valid, *rotations, self.r) \
            if perms is None else perms
        if record_perms is not None:
            record_perms.append((q_pos, k_pos))

        # the global low-rank part
        q_prime, q_log = sb_softmax_kernel(q, self.sb_projection, True, temp)
        k_prime, k_log = sb_softmax_kernel(k, self.sb_projection, False, temp)
        prime_log_scale = q_log + k_log  # (h, n, 1)
        k_prime = torch.where(valid[None, :, None], k_prime, torch.zeros_like(k_prime))
        qk1 = torch.einsum("hnm,hm->hn", q_prime, k_prime.sum(dim=-2))
        context = torch.einsum("hnm,hne->hme", k_prime, v)
        qkv = torch.einsum("hme,hnm->hne", context, q_prime)

        # the sparse in-bucket part
        sq = gather_rows(q, q_pos).reshape(c, h, nb, bs, d)
        sk = gather_rows(k, k_pos).reshape(c, h, nb, bs, d)
        sv = gather_rows(v, k_pos).reshape(c, h, nb, bs, d)
        sqp = gather_rows(q_prime, q_pos).reshape(c, h, nb, bs, -1)
        skp = gather_rows(k_prime, k_pos).reshape(c, h, nb, bs, -1)
        s_log = gather_rows(prime_log_scale, q_pos).reshape(c, h, nb, bs, 1)
        kvalid = valid[None, :, None].to(q.dtype).expand(h, n, 1)
        s_kvalid = gather_rows(kvalid, k_pos).reshape(c, h, nb, 1, bs)

        inner = torch.einsum("chbie,chbje->chbij", sq, sk) * temp
        dots_prime = torch.einsum("chbim,chbjm->chbij", sqp, skp)
        inner = torch.where(s_kvalid > 0.5, inner, torch.full_like(inner, MASKED_VALUE))
        dots_prime = torch.where(s_kvalid > 0.5, dots_prime, torch.zeros_like(dots_prime))

        q_rev = invert_permutation(q_pos)
        if c > 1:
            # a pair that meets in several rounds counts once
            with torch.no_grad():
                k_rev = invert_permutation(k_pos)
                s_qb = gather_rows((q_rev // bs).permute(1, 2, 0), q_pos)
                s_kb = gather_rows((k_rev // bs).permute(1, 2, 0), k_pos)
                s_qb = s_qb.reshape(c, h, nb, bs, c)
                s_kb = s_kb.reshape(c, h, nb, bs, c)
                dup = torch.zeros(inner.shape, dtype=inner.dtype, device=inner.device)
                for r in range(c):
                    dup += (s_qb[..., :, None, r] == s_kb[..., None, :, r]).to(inner.dtype)
                dup = torch.clamp(dup, min=1.0)
            inner = inner - torch.log(dup)
            dots_prime = dots_prime / dup

        lse = torch.maximum(torch.amax(inner, dim=-1, keepdim=True), s_log)
        dots = torch.exp(inner - lse) - dots_prime * torch.exp(s_log - lse)
        dots_sum = torch.sum(dots, dim=-1, keepdim=True)
        so = torch.einsum("chbij,chbjd->chbid", dots, sv)
        o = gather_rows(so.reshape(c, h, n, d), q_rev)
        logits = gather_rows(lse.reshape(c, h, n, 1), q_rev)
        dsum = gather_rows(dots_sum.reshape(c, h, n, 1), q_rev)

        norm_log_scale = torch.logsumexp(logits, dim=0)  # (h, n, 1)
        probs = torch.exp(logits - norm_log_scale[None])
        out_lsh = torch.sum(o * probs, dim=0)
        prime_scale = torch.exp(prime_log_scale - norm_log_scale)
        out = out_lsh + qkv * prime_scale
        normalization = torch.sum(dsum * probs, dim=0) + qk1[..., None] * prime_scale
        out = out / torch.clamp(normalization, min=1e-6)
        return self.out_linear(merge_heads(out))
