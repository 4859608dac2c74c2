"""Operations and bytes of the HEPT training and eval steps, from shapes,
and the published peaks of one H100.

The bucket attention's counts are a frozen copy of `chip_smoke.py`'s bound
arithmetic (K1 / K2 at bs 512, K6 / K7 at bs 100): each input byte read once
and each output byte written once; the forward's logits (d) and value
products (dv), the backward's logits again, dq, dk (3 d) and dv, dp (2 dv).
The model's operations count each linear layer forward and backward (twice
the forward), the bucket attention forward and backward without the
backward's recomputed logits, the hashes and the pair loss.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: HBM3 bandwidth and peak rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
# the port's 5-layer output MLP (hidden 256)
HEAD_HIDDEN, HEAD_LAYERS = 256, 5


def bound_s(nbytes: float, flops: float, precision: str) -> float:
    """Least time: the larger of bytes / HBM bandwidth and operations / the
    peak of `precision`."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOP_PER_S[precision])


def attn_fwd(r: int, n: int, bs: int, d: int, dv: int, el: int) -> tuple[float, float]:
    """(bytes, operations) of one bucket-attention forward: r rows of n
    sorted points in buckets of bs; q, k (d) and v (dv) of el bytes in,
    [so | denom] f32 out."""
    return el * r * n * (2 * d + dv) + 4 * r * n * (dv + 1), 2.0 * r * n * bs * (d + dv)


def attn_bwd(r: int, n: int, bs: int, d: int, dv: int, el: int) -> tuple[float, float]:
    """(bytes, operations) of one bucket-attention backward: q, k, v and the
    f32 cotangents in, dq, dk, dv out; the logits recomputed."""
    return 2 * el * r * n * (2 * d + dv) + 4 * r * n * (dv + 1), \
        2.0 * r * n * bs * (3 * d + 2 * dv)


def attention_shape(cfg: dict, n: int) -> dict:
    """The bucket attention's call shape and precision in one layer."""
    m = cfg["model_kwargs"]
    bf16 = bool(m.get("kernel_bf16"))
    return {"r": m["n_hashes"] * m["num_heads"], "n": n, "bs": m["block_size"],
            "d": m["h_dim"] + cfg["coords_dim"], "dv": m["h_dim"], "el": 2 if bf16 else 4,
            "precision": "bf16" if bf16 else "f32", "calls": m["n_layers"]}


def attention_bound_s(cfg: dict, n: int, backward: bool) -> float:
    """Least time of a step's bucket-attention forwards, plus backwards when
    `backward`."""
    a = attention_shape(cfg, n)
    args = (a["r"], n, a["bs"], a["d"], a["dv"], a["el"])
    t = bound_s(*attn_fwd(*args), a["precision"])
    if backward:
        t += bound_s(*attn_bwd(*args), a["precision"])
    return a["calls"] * t


def linear_flops(cfg: dict, n: int) -> float:
    """Forward operations of every linear layer and hash of one event."""
    m = cfg["model_kwargs"]
    d, h, L, c = m["h_dim"], m["num_heads"], m["n_layers"], m["n_hashes"]
    cd, fin = cfg["coords_dim"], cfg["in_dim"]
    # q / k / v projected once, or once per sorted round after the sort
    proj_rounds = c if m.get("qkv_post_sort") else 1
    per_layer = (3 * proj_rounds * 2 * n * d * h * d  # q, k, v
                 + 2 * n * h * d * d  # out_linear
                 + 2 * 2 * n * d * d)  # feed-forward
    if not m.get("static_keys"):
        per_layer += 2 * c * h * 2 * n * (d + cd)  # E2LSH hashes of q and k
    dims = [d // 2] + [HEAD_HIDDEN] * (HEAD_LAYERS - 1) + [d // 2]
    head = 2 * n * d * (L + 1) * (d // 2) + sum(2 * n * a * b for a, b in zip(dims, dims[1:]))
    enc = 2 * n * (fin * d + d * d)
    static = 2 * n * (d + cd) * m.get("static_rounds", 0) if m.get("static_keys") else 0
    return enc + L * per_layer + head + static


def loss_flops(pairs: int, emb_dim: int) -> float:
    """Forward operations of the windowed InfoNCE over `pairs` pairs."""
    return pairs * (3 * emb_dim + 12)


def model_flops_s(cfg: dict, n: int, pairs: int, backward: bool) -> float:
    """Least time of a step's model arithmetic: each class of operations
    at the peak of the precision the configuration states for it (bucket
    attention: bf16 or f32; everything else f32, TF32 off). Backward counts
    twice the forward (the attention's without its recomputed logits)."""
    a = attention_shape(cfg, n)
    fwd = 2.0 * a["r"] * n * a["bs"] * (a["d"] + a["dv"])
    attn = a["calls"] * fwd * (3 if backward else 1)
    rest = linear_flops(cfg, n) + loss_flops(pairs, cfg["model_kwargs"]["h_dim"] // 2)
    rest *= 3 if backward else 1
    return attn / PEAK_FLOP_PER_S[a["precision"]] + rest / PEAK_FLOP_PER_S["f32"]
