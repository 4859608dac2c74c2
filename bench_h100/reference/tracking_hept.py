"""Plain reference of the `tracking_hept` configuration's attention (the
published HEPT): per layer, per head and per OR round, dynamic E2LSH keys.

Each head's q_hat = [q | sqrt(2 w) * coords] and k_hat = [k | sqrt(2 w) *
coords] (projected before the sort, inert pads zeroed) are hashed on the
layer's frozen directions; key = hash + AND code x the (round, head)'s span
over q and k, inert pads last. q is sorted by its keys, k and v by theirs;
bucket b of the sorted q attends to bucket b of the sorted k; the [num |
den] rows go back by the q order and the rounds are summed before num /
den. Everything float32, as the configuration states.
"""

from __future__ import annotations

import torch

from .common import (BIG_KEY, PRECISIONS, TrackingReference, bucket_attend, head_split,
                     rpe_scales)

REQUIRED = {"static_keys": False, "qkv_post_sort": False, "share_heads": False}


def plan(W, cfg, h, coords, codes, inert):
    m = cfg["model_kwargs"]
    for k, v in REQUIRED.items():
        if bool(m.get(k, False)) != v:
            raise NotImplementedError(f"reference: {k} must be {v!r}")
    return None


def attend(W, cfg, layer, xn, coords, codes, inert, plan_, prec):
    m = cfg["model_kwargs"]
    h, d, bs = m["num_heads"], m["h_dim"], m["block_size"]
    b = f"blocks.{layer}"
    sqrt_w = rpe_scales(W[f"{b}.w_rpe"], h, d, coords.shape[1], m["num_w_per_dist"])
    q, k, v = (head_split(xn @ W[f"{b}.{w}.weight"].t(), h) for w in ("w_q", "w_k", "w_v"))
    rpe = sqrt_w[:, None, :] * coords[None]
    qh, kh = torch.cat([q, rpe], -1), torch.cat([k, rpe], -1)  # (h, n, d + cd)
    alpha = W[f"{b}.attn.e2lsh_alpha"]  # (h, d + cd, c)
    with torch.no_grad():
        qhash = torch.einsum("hnd,hdc->chn", qh, alpha)
        khash = torch.einsum("hnd,hdc->chn", kh, alpha)
        hi = torch.maximum(qhash.amax(-1, keepdim=True), khash.amax(-1, keepdim=True))
        lo = torch.minimum(qhash.amin(-1, keepdim=True), khash.amin(-1, keepdim=True))
        shift = codes.to(torch.float32) * (hi - lo)
        qsrc = torch.argsort(torch.where(inert, BIG_KEY, qhash + shift), dim=-1, stable=True)
        ksrc = torch.argsort(torch.where(inert, BIG_KEY, khash + shift), dim=-1, stable=True)
    heads = torch.arange(h, device=xn.device)[:, None]
    num = den = 0.0
    for c in range(qsrc.shape[0]):
        qs, ks = qsrc[c], ksrc[c]  # (h, n)
        nu, de = bucket_attend(qh[heads, qs], kh[heads, ks], v[heads, ks], bs, prec)
        inv = torch.argsort(qs, dim=-1)
        num = num + nu[heads, inv]
        den = den + de[heads, inv]
    n = xn.shape[0]
    return (num / den).permute(1, 0, 2).reshape(n, h * d)


# what the harness calls, found by the configuration's name
REFERENCE = TrackingReference(plan, attend)
param_spec = REFERENCE.param_spec
train_reference = REFERENCE.train_reference
eval_reference = REFERENCE.eval_reference
__all__ = ["PRECISIONS", "REFERENCE", "param_spec", "train_reference", "eval_reference"]
