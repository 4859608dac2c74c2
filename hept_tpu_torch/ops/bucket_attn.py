"""HEPT bucket attention on the `hept_acc` path (port of the main-path parts
of `hept_tpu/ops/bucket_attn.py`).

Per bucket of `block_size` sorted points the core computes the unnormalised
RBF kernel exp(min(q.k - |q|^2/2 - |k|^2/2, 0)), its row sums (denominator)
and the value sums (numerator), then OR-combines the rounds as
sum num / sum denom. The port covers the static-plan path: keys are hashed
once per step (`static_hash`), one sort builds every round's permutation
(`static_bucket_plan`), and each layer gathers its x columns by the plan,
projects them after the gather, runs the bucket kernel
(`bucket_attn_cuda`, K1/K2) and unsorts [num|denom] with a row gather.
"""

from __future__ import annotations

import torch

from ..core.buckets import permute_gather, permute_gather_rows
from .bucket_attn_cuda import DENOM_EPS, bucket_rbf_attention_cols

__all__ = [
    "DENOM_EPS", "stable_ratio", "bucket_rbf_attention_cols", "static_hash",
    "static_bucket_plan", "hept_attention_core_xcols",
]

# sort key of rows forced into trailing buckets
_BIG_KEY = 3.0e38


class _StableRatio(torch.autograd.Function):
    @staticmethod
    def forward(ctx, num, den):
        o = num / den
        ctx.save_for_backward(o, den)
        return o

    @staticmethod
    def backward(ctx, g):
        o, den = ctx.saved_tensors
        inv = 1.0 / den
        d_num = g * inv
        # reduce over the broadcast axes (den has size 1 where num does not)
        go = g * o
        axes = tuple(i for i, (a, b) in enumerate(zip(go.shape, den.shape)) if b == 1 and a != 1)
        d_den = -torch.sum(go, dim=axes, keepdim=True) * inv if axes else -go * inv
        return d_num, d_den


def stable_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den with a denominator-square-free backward.

    Plain autograd of num/den computes -g*num/den**2; with DENOM_EPS = 1e-20
    a row whose probabilities all underflow has den**2 underflow to 0 and
    the gradient becomes NaN. With o = num/den: d num = g/den and
    d den = -sum(g*o)/den. `den` broadcasts to num with size 1 on exactly
    the axes it reduces over.
    """
    return _StableRatio.apply(num, den)


def static_hash(x0_cols: torch.Tensor, coords_cols: torch.Tensor, alpha: torch.Tensor,
                scale: float) -> torch.Tensor:
    """Layer-invariant bucket hashes: one hash per step in [x0|coords] space
    (the "x0" variant): x0 standardised per point, over its d_model
    features, plus the coords scaled by `scale`.

    Args:
      x0_cols: (d_model, n) encoder-output columns.
      coords_cols: (cd, n).
      alpha: (1, d_model + cd, c) E2LSH directions.
    Returns: (c, n) hash values, detached.
    """
    with torch.no_grad():
        d_model = x0_cols.shape[0]
        a1, a2 = alpha[0, :d_model, :], alpha[0, d_model:, :]
        mu = x0_cols.mean(dim=0, keepdim=True)
        sd = torch.sqrt(((x0_cols - mu) ** 2).mean(dim=0, keepdim=True) + 1e-6)
        return (torch.einsum("rc,rn->cn", scale * a2, coords_cols)
                + torch.einsum("ec,en->cn", a1, (x0_cols - mu) / sd))


def static_bucket_plan(hashed: torch.Tensor, codes0: torch.Tensor,
                       invalid: torch.Tensor | None, coords_cols: torch.Tensor,
                       sort_pack: bool = False, coords_f32: bool = False):
    """The once-per-step bucket plan of the static-keys mode (one event).

    key = hash + code * span(hash) per round; invalid rows key to +BIG so
    they fill trailing buckets. One sort gives every round's permutation;
    each layer then reorders its x columns with `permute_gather` and reuses
    the sorted coords.

    Args:
      hashed: (c, n) hash values (`static_hash`).
      codes0: (n,) or (c, n) AND codes.
      invalid: optional (n,) bool.
      coords_cols: (cd, n).
      sort_pack: round the sorted coords through bf16 (returned as bf16)
        unless `coords_f32`.
      coords_f32: carry the sorted coords exactly (kernel_center).
    Returns: (src, inv, scoords): (c, 1, n) int64 permutations (sorted slot
      s holds row src[s]; row j sits at slot inv[j]) and (c, 1, cd, n)
      sorted coords.

    Ties occur only between rows with identical payloads (replication pads
    copy a real row exactly; inert pads share +BIG), so the sorted coords do
    not depend on how ties break. The JAX package sorts unstably; this sort
    is stable.
    """
    with torch.no_grad():
        hash_shift = hashed.amax(dim=1, keepdim=True) - hashed.amin(dim=1, keepdim=True)
        codes_s = codes0.to(torch.float32)
        if codes_s.dim() == 1:
            codes_s = codes_s[None]
        key = hashed + codes_s * hash_shift
        if invalid is not None:
            key = torch.where(invalid[None, :], torch.full_like(key, _BIG_KEY), key)
        src = torch.argsort(key, dim=-1, stable=True)  # (c, n)
        inv = torch.argsort(src, dim=-1)
        pack = sort_pack and not coords_f32
        coords = coords_cols.to(torch.bfloat16) if pack else coords_cols.to(torch.float32)
        scoords = coords[:, src].permute(1, 0, 2)  # (c, cd, n)
        return src[:, None], inv[:, None], scoords[:, None].contiguous()


def hept_attention_core_xcols(
    x_cols: torch.Tensor,
    coords_cols: torch.Tensor,
    wq: torch.Tensor,
    wk: torch.Tensor,
    wv: torch.Tensor,
    sqrt_w: torch.Tensor,
    invalid: torch.Tensor | None,
    plan,
    *,
    block_size: int,
    sort_pack: bool = False,
    unsort_pack: bool = False,
    kernel_bf16: bool = False,
    kernel_center: bool = False,
) -> torch.Tensor:
    """Post-sort-projection HEPT attention on a static plan, all heads
    sharing one bucket grid per round (the `hept_acc` path: share_heads,
    unsort_rows, one event).

    Args:
      x_cols: (d_model, n) normed hidden state as columns.
      coords_cols: (cd, n).
      wq, wk, wv: (h, d_model, d) per-head projection kernels (x @ w).
      sqrt_w: (h, cd) RPE column scales.
      invalid: optional (n,) bool rows (zeroed).
      plan: (src, inv, scoords) from `static_bucket_plan`, c rounds.
      sort_pack: gather x through bf16 and project in bf16.
      unsort_pack: move the [num|denom] rows through bf16 in the unsort.
      kernel_bf16: feed the bucket kernels bf16 operands.
      kernel_center: subtract a per-bucket mean from the RPE columns of q
        and k before any bf16 cast (exact in f32: the RBF logits are
        -|q - k|^2/2, shift-invariant).
    Returns: (n, h * d) attention output rows.
    """
    h, d_model, d = wq.shape
    n = x_cols.shape[-1]
    dv = wv.shape[-1]
    src, inv, scoords = plan
    c = src.shape[0]
    if invalid is not None:
        keep = torch.logical_not(invalid)[None, :]
        x_cols = torch.where(keep, x_cols, torch.zeros_like(x_cols))
    ptype = torch.bfloat16 if kernel_bf16 else torch.float32

    sxs = permute_gather(x_cols[None], src, inv, pack=sort_pack,
                         out_bf16=sort_pack)  # (c, 1, d_model, n)
    # the rpe columns are the same for q and k (both sqrt_w * coords of the
    # same sorted copy): compute and centre once
    rpe = sqrt_w[None, None, :, :, None] * scoords[:, :, None].to(torch.float32)
    if kernel_center:
        b = rpe.reshape(*rpe.shape[:-1], n // block_size, block_size)
        b = b - b.mean(dim=-1, keepdim=True).detach()
        rpe = b.reshape(rpe.shape)
    rpe = rpe.to(ptype)  # (c, 1, h, cd, n)

    def project(w):
        # products of the transported values summed in f32, one rounding to
        # the kernel dtype (the MXU's bf16-operand, f32-accumulate dot)
        proj = torch.einsum("hed,cben->cbhdn", w.to(sxs.dtype).to(torch.float32),
                            sxs.to(torch.float32))
        return proj.to(ptype)

    sq = torch.cat([project(wq), rpe], dim=3).reshape(c * h, d + rpe.shape[3], n)
    sk = torch.cat([project(wk), rpe], dim=3).reshape(c * h, d + rpe.shape[3], n)
    sv = project(wv).reshape(c * h, dv, n)

    denom, so = bucket_rbf_attention_cols(sq.contiguous(), sk.contiguous(),
                                          sv.contiguous(), block_size)

    # row-major unsort: one transpose makes every head's [num|denom] a
    # contiguous (h*(dv+1))-feature row, then natural position j takes round
    # r's sorted slot inv[r, j] (backward gathers by src)
    od = torch.cat([so, denom], dim=1).reshape(c, h, dv + 1, n)
    rows = od.permute(0, 3, 1, 2).reshape(c, n, h * (dv + 1))
    rows = permute_gather_rows(rows, inv.reshape(c, n), src.reshape(c, n), pack=unsort_pack)
    combined = rows.sum(dim=0).reshape(n, h, dv + 1)
    out = stable_ratio(combined[..., :dv], combined[..., dv:])
    return out.reshape(n, h * dv)
