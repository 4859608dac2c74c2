"""Plain reference of the `tracking_hept_acc` configuration's attention:
buckets from a static plan.

Once per step the encoder output, standardised per point, and the scaled
coordinates are hashed on `static_rounds` frozen E2LSH directions; each
round's key is hash + AND code (hash 0's codes, head 0, rows cycled over the
rounds) x the round's hash span, inert pads last; one stable argsort per
round. Layer l attends over rounds (l * n_hashes + j) % static_rounds, all
heads on one sorted order: q / k / v projected per head, with the RPE rows
sqrt(2 w) * coords centred per bucket (exact: the RBF logits depend on q - k
only), the bucket RBF attention, the unsort, and the OR-combine sum num /
sum den over the rounds.

The configuration states bfloat16 for the transport of x, the projection
weights and outputs, the RPE rows, p before the value product and the
[num | den] unsort; the reference computes them in float32 and rounds them
only through `prec`.
"""

from __future__ import annotations

import math

import torch

from .common import (BIG_KEY, PRECISIONS, TrackingReference, bucket_attend, head_split,
                     rpe_scales)

REQUIRED = {"static_keys": "x0", "qkv_post_sort": True, "share_heads": True}


def plan(W, cfg, h, coords, codes, inert):
    m = cfg["model_kwargs"]
    for k, v in REQUIRED.items():
        if m.get(k) != v:
            raise NotImplementedError(f"reference: {k} must be {v!r}")
    with torch.no_grad():
        d = m["h_dim"]
        rounds, nh = m["static_rounds"], m["n_hashes"]
        mu = h.mean(dim=1, keepdim=True)
        xs = (h - mu) / torch.sqrt(((h - mu) ** 2).mean(dim=1, keepdim=True) + 1e-6)
        alpha = W["static_alpha"][0]  # (d + cd, rounds)
        scale = math.sqrt(2.0 * m["num_w_per_dist"])
        hashed = (xs @ alpha[:d] + (scale * coords) @ alpha[d:]).t()  # (rounds, n)
        codes0 = codes[[t % nh for t in range(rounds)], 0].to(torch.float32)
        span = hashed.amax(dim=1, keepdim=True) - hashed.amin(dim=1, keepdim=True)
        key = torch.where(inert[None], BIG_KEY, hashed + codes0 * span)
        return torch.argsort(key, dim=-1, stable=True)


def attend(W, cfg, layer, xn, coords, codes, inert, src, prec):
    m = cfg["model_kwargs"]
    h, d, bs, nh = m["num_heads"], m["h_dim"], m["block_size"], m["n_hashes"]
    b = f"blocks.{layer}"
    sqrt_w = rpe_scales(W[f"{b}.w_rpe"], h, d, coords.shape[1], m["num_w_per_dist"])
    x = prec.round(xn)
    q, k, v = (head_split(prec.round(x @ prec.round(W[f"{b}.{w}.weight"]).t()), h)
               for w in ("w_q", "w_k", "w_v"))  # (h, n, d)
    rpe = sqrt_w[:, None, :] * coords[None]  # (h, n, cd)
    n = xn.shape[0]
    num = den = 0.0
    for j in range(nh):
        s = src[(layer * nh + j) % src.shape[0]]
        r = rpe[:, s].reshape(h, n // bs, bs, -1)
        r = prec.round((r - r.mean(dim=2, keepdim=True).detach()).reshape(h, n, -1))
        nu, de = bucket_attend(torch.cat([q[:, s], r], -1), torch.cat([k[:, s], r], -1),
                               v[:, s], bs, prec)
        inv = torch.argsort(s)
        num = num + prec.round(nu)[:, inv]
        den = den + prec.round_den(de)[:, inv]
    return (num / den).permute(1, 0, 2).reshape(n, h * d)


# what the harness calls, found by the configuration's name
REFERENCE = TrackingReference(plan, attend)
param_spec = REFERENCE.param_spec
train_reference = REFERENCE.train_reference
eval_reference = REFERENCE.eval_reference
__all__ = ["PRECISIONS", "REFERENCE", "param_spec", "train_reference", "eval_reference"]
