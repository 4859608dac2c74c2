"""Reformer LSH attention baseline (port of
`hept_tpu/models/attention/reformer.py`).

q = k sharing; argmax-of-random-rotations bucketing with one rotation set
shared across heads; a stable sort by bucket id; look-one-back key windows;
the self mask at -5e4 and the pad mask at -3e38; logsumexp OR-combine over
the hash rounds. `attend_across_buckets=False` masks keys of another bucket
id, `allow_duplicate_attention=False` down-weights each (q, k) pair by the
number of rounds it meets in. The rotations come from the step's generator,
a fixed draw without one, or the caller (`rotations=`; `draws.py`). A
caller may also record the sort order (`record_perms=`, a list) and impose
it on another run (`perms=`), so that two runs whose hashes differ by
rounding bucket the points alike.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...core.buckets import gather_rows, invert_permutation
from ..mlp import TorchLinear
from . import draws
from .performer import merge_heads, split_heads

TOKEN_SELF_ATTN_VALUE = -5e4
MASKED_VALUE = -3.0e38


def look_one_back(x: torch.Tensor) -> torch.Tensor:
    """(c, h, nb, bs, ...) -> (c, h, nb, 2 bs, ...): each bucket's keys and
    the previous bucket's."""
    return torch.cat([x, torch.roll(x, 1, dims=2)], dim=3)


class ReformerAttention(nn.Module):
    def __init__(self, h_dim: int, num_heads: int, bucket_size: int, n_hashes: int,
                 allow_duplicate_attention: bool = True, attend_across_buckets: bool = True,
                 generator=None, device=None):
        super().__init__()
        self.h_dim, self.num_heads = h_dim, num_heads
        self.bucket_size, self.n_hashes = bucket_size, n_hashes
        self.allow_duplicate_attention = allow_duplicate_attention
        self.attend_across_buckets = attend_across_buckets
        self.out_linear = TorchLinear(num_heads * h_dim, h_dim, generator=generator,
                                      device=device)
        self._fixed: dict = {}

    def rotation_specs(self, n: int) -> tuple:
        return (("normal", (self.h_dim, self.n_hashes, n // self.bucket_size // 2)),)

    def forward(self, qk, key, value, valid, rotations=None, generator=None, perms=None,
                record_perms=None):
        del key  # q = k
        n = qk.shape[0]
        h, d, c, bs = self.num_heads, self.h_dim, self.n_hashes, self.bucket_size
        if n % (2 * bs):
            raise ValueError(f"reformer needs n % (2 * bucket_size) == 0, got n={n}, bs={bs}")
        nb = n // bs
        temp = 1.0 / math.sqrt(d)
        keep = valid[:, None]
        qk = split_heads(torch.where(keep, qk, torch.zeros_like(qk)), h, d)
        v = split_heads(torch.where(keep, value, torch.zeros_like(value)), h, d)

        if rotations is None:
            (rotations,) = draws.draw(self.rotation_specs(n), generator, qk.device, self._fixed)
        rotated = torch.einsum("hnd,dci->chni", qk, rotations)
        rotated = torch.cat([rotated, -rotated], dim=-1)
        with torch.no_grad():
            buckets = torch.argmax(rotated, dim=-1)  # (c, h, n)
            # invalid rows to the last bucket, so that they sort last
            buckets = torch.where(valid[None, None, :], buckets, torch.full_like(buckets, nb - 1))
            perm = torch.argsort(buckets, dim=-1, stable=True) if perms is None else perms
            perm_inv = invert_permutation(perm)
        if record_perms is not None:
            record_perms.append(perm)

        qk_norm = qk / torch.clamp(torch.linalg.norm(qk, dim=-1, keepdim=True), min=1e-12)
        sq = gather_rows(qk, perm).reshape(c, h, nb, bs, d)
        sperm = perm.reshape(c, h, nb, bs)
        sk = look_one_back(gather_rows(qk_norm, perm).reshape(c, h, nb, bs, d))
        sv = look_one_back(gather_rows(v, perm).reshape(c, h, nb, bs, d))
        skidx = look_one_back(sperm[..., None])  # (c, h, nb, 2bs, 1) keys' original rows
        kvalid = valid[None, :, None].to(qk.dtype).expand(h, n, 1)
        svalid = look_one_back(gather_rows(kvalid, perm).reshape(c, h, nb, bs, 1))

        inner = torch.einsum("chbie,chbje->chbij", sq, sk) * temp
        inner = torch.where(svalid[..., 0][:, :, :, None, :] > 0.5, inner,
                            torch.full_like(inner, MASKED_VALUE))
        self_mask = sperm[..., :, None] == skidx[..., None, :, 0]
        inner = torch.where(self_mask, torch.full_like(inner, TOKEN_SELF_ATTN_VALUE), inner)

        if not self.attend_across_buckets:
            # a sorted block can straddle two bucket ids: mask the keys of
            # the other one
            sbuckets = gather_rows(buckets.permute(1, 2, 0), perm)  # (c, h, n, c)
            own = torch.take_along_dim(
                sbuckets, torch.arange(c, device=qk.device)[:, None, None, None], dim=-1
            ).reshape(c, h, nb, bs)
            bkv = look_one_back(own[..., None])[..., 0]
            inner = torch.where(own[..., :, None] != bkv[..., None, :],
                                torch.full_like(inner, MASKED_VALUE), inner)

        if not self.allow_duplicate_attention:
            # count the rounds in which each (q, k) pair meets: q's rank
            # bucket equals k's, or k's + 1 (k seen through look-one-back)
            locs1 = (perm_inv // bs).permute(1, 2, 0)  # (h, n, c)
            locs2 = (locs1 + 1) % nb
            if not self.attend_across_buckets:
                bb = buckets.permute(1, 2, 0)
                locs1 = bb * nb + locs1
                locs2 = bb * nb + locs2
            slocs = gather_rows(torch.cat([locs1, locs2], dim=-1), perm)
            slocs = slocs.reshape(c, h, nb, bs, 2 * c)
            bkv_locs = look_one_back(slocs)
            dup = torch.zeros_like(inner)
            for r in range(2 * c):
                dup += (slocs[..., r % c][..., :, None] == bkv_locs[..., r][..., None, :]).to(
                    inner.dtype)
            inner = inner - torch.log(dup + 1e-9)

        lse = torch.logsumexp(inner, dim=-1, keepdim=True)
        dots = torch.exp(inner - lse)
        so = torch.einsum("chbij,chbjd->chbid", dots, sv)
        o = gather_rows(so.reshape(c, h, n, d), perm_inv)
        logits = gather_rows(lse.reshape(c, h, n, 1), perm_inv)
        probs = torch.exp(logits - torch.logsumexp(logits, dim=0, keepdim=True))
        return self.out_linear(merge_heads(torch.sum(o * probs, dim=0)))
