"""The FLOP and byte counts against hand counts at small shapes."""

import math

import pytest

from bench_h100 import flops

CFG = {"in_dim": 3, "coords_dim": 2,
       "model_kwargs": {"h_dim": 4, "num_heads": 2, "n_layers": 1, "n_hashes": 2,
                        "block_size": 2, "kernel_bf16": True}}


def test_attention_counts_by_hand():
    # r = 2 rows of n = 4 points in buckets of 2, d = 6 (4 + 2), dv = 4, bf16
    by, fl = flops.attn_fwd(2, 4, 2, 6, 4, 2)
    # q, k: 2 * 4 * 6 values, v: 2 * 4 * 4, each 2 bytes; out 2 * 4 * 5 f32
    assert by == 2 * (2 * 48 + 32) + 4 * 40
    # every query meets 2 keys: 2 * (6 + 4) multiply-adds each, 8 queries
    assert fl == 8 * 2 * 2 * 10
    by, fl = flops.attn_bwd(2, 4, 2, 6, 4, 2)
    assert by == 2 * (2 * (2 * 48 + 32)) + 4 * 40
    assert fl == 8 * 2 * 2 * (18 + 8)


def test_bound_takes_the_larger_side():
    assert flops.bound_s(3.35e12, 0.0, "bf16") == pytest.approx(1.0)
    assert flops.bound_s(0.0, 989e12, "bf16") == pytest.approx(1.0)
    assert flops.bound_s(3.35e12, 2 * 67e12, "f32") == pytest.approx(2.0)


def test_attention_bound_sums_the_layers():
    a = flops.attention_shape(CFG, 4)
    assert (a["r"], a["d"], a["dv"], a["el"], a["precision"]) == (4, 6, 4, 2, "bf16")
    one = flops.bound_s(*flops.attn_fwd(4, 4, 2, 6, 4, 2), "bf16")
    both = one + flops.bound_s(*flops.attn_bwd(4, 4, 2, 6, 4, 2), "bf16")
    assert flops.attention_bound_s(CFG, 4, backward=False) == pytest.approx(one)
    assert flops.attention_bound_s(CFG, 4, backward=True) == pytest.approx(both)


def test_linear_flops_by_hand():
    n, d, h = 4, 4, 2
    enc = 2 * n * (3 * d + d * d)
    layer = 3 * 2 * n * d * h * d + 2 * n * h * d * d + 2 * 2 * n * d * d
    hashes = 2 * 2 * h * 2 * n * (d + 2)  # dynamic keys: q and k, 2 rounds
    dims = [2, 256, 256, 256, 256, 2]
    head = 2 * n * d * 2 * 2 + sum(2 * n * a * b for a, b in zip(dims, dims[1:]))
    assert flops.linear_flops(CFG, n) == enc + layer + hashes + head


def test_model_least_time_by_hand():
    n, pairs = 4, 10
    attn = 3 * 2.0 * 4 * n * 2 * 10 / 989e12
    rest = 3 * (flops.linear_flops(CFG, n) + pairs * (3 * 2 + 12)) / 67e12
    assert flops.model_flops_s(CFG, n, pairs, backward=True) == pytest.approx(attn + rest)
    assert math.isclose(flops.model_flops_s(CFG, n, pairs, backward=False),
                        (attn + rest) / 3)
