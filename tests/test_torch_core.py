"""hept_tpu_torch.core against hept_tpu.core on tests/test_core.py-style
inputs. Integer and permutation results are exact; float results exact or
1e-6 (the same f32 operations in the same order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hept_tpu.core import bit_shift as jbit_shift  # noqa: E402
from hept_tpu.core import invert_permutation as jinvert  # noqa: E402
from hept_tpu.core import quantile_partition as jquantile  # noqa: E402
from hept_tpu.core import region_codes as jregion_codes  # noqa: E402
from hept_tpu.core import replication_pad_plan as jpad_plan  # noqa: E402
from hept_tpu.core.buckets import permute_gather as jpermute_gather  # noqa: E402
from hept_tpu.core.buckets import permute_gather_rows as jpermute_gather_rows  # noqa: E402
from hept_tpu_torch.core.buckets import (  # noqa: E402
    bit_shift,
    invert_permutation,
    permute_gather,
    permute_gather_rows,
)
from hept_tpu_torch.core.hashing import e2lsh_init  # noqa: E402
from hept_tpu_torch.core.padding import replication_pad_plan  # noqa: E402
from hept_tpu_torch.core.regions import get_regions, quantile_partition, region_codes  # noqa: E402


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def test_bit_shift_matches_jax():
    rng = np.random.default_rng(0)
    for hi_max in (1, 5, 37, 1000):
        base = rng.integers(0, hi_max, (4, 200)).astype(np.int32)
        hi = rng.integers(0, 7, (4, 200)).astype(np.int32)
        np.testing.assert_array_equal(bit_shift(_t(base), _t(hi)).numpy(),
                                      np.asarray(jbit_shift(base, hi)))


def test_invert_permutation_matches_jax():
    rng = np.random.default_rng(1)
    perms = np.stack([rng.permutation(64) for _ in range(6)]).reshape(2, 3, 64)
    np.testing.assert_array_equal(invert_permutation(_t(perms)).numpy(),
                                  np.asarray(jinvert(jnp.asarray(perms))))


@pytest.mark.parametrize("n_points", [None, 23])
def test_quantile_partition_matches_jax(n_points):
    rng = np.random.default_rng(2)
    sorted_idx = rng.permutation(30)
    nr = np.asarray([[3.0], [5.0], [7.5], [2.33333]], np.float32)
    got = quantile_partition(_t(sorted_idx), _t(nr), n_points)
    want = jquantile(jnp.asarray(sorted_idx), jnp.asarray(nr), n_points)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_region_codes_with_pads_match_jax():
    rng = np.random.default_rng(3)
    n = 60
    coords = rng.normal(size=(n, 6)).astype(np.float32)
    coords[::7, 0] = coords[1, 0]  # equal etas: ties broken by index (stable)
    valid = np.arange(n) < 51
    regions = np.asarray(
        [[[3.0, 4.33333], [5.0, 2.66667]], [[6.0, 2.0], [2.33333, 7.0]]], np.float32)
    got = region_codes(_t(coords), _t(regions), _t(valid), n_points=_t(valid.sum()))
    want = jregion_codes(jnp.asarray(coords), jnp.asarray(regions), jnp.asarray(valid),
                         n_points=jnp.asarray(valid.sum()))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_get_regions_law():
    """Fresh draws (jax.random is not reproducible in torch): shape, product
    ~ num_regions, rounded to thirds -- the same law as the JAX draw."""
    r = get_regions(torch.Generator().manual_seed(0), num_regions=150, n_hashes=3, num_heads=8)
    assert r.shape == (3, 2, 8) and r.dtype == torch.float32
    np.testing.assert_allclose(torch.prod(r, dim=1).numpy(), 150.0, rtol=0.15)
    np.testing.assert_allclose(r.numpy() * 3, np.round(r.numpy() * 3), atol=1e-5)
    a = e2lsh_init(torch.Generator().manual_seed(0), 1, 30, 8)
    assert a.shape == (1, 30, 8)


@pytest.mark.parametrize("n_valid", [40, 48, 33])
def test_replication_pad_plan_matches_jax(n_valid):
    rng = np.random.default_rng(4)
    n_total, bs = 64, 16
    sorted_idx = rng.permutation(n_total)
    got = replication_pad_plan(_t(n_valid), n_total, bs, _t(sorted_idx))
    want = jpad_plan(jnp.asarray(n_valid), n_total, bs, jnp.asarray(sorted_idx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("pack,out_bf16", [(False, False), (True, False), (True, True)])
def test_permute_gather_matches_jax(pack, out_bf16):
    """Forward and backward, including the bf16 transport rounding."""
    rng = np.random.default_rng(5)
    c, d, ne = 3, 6, 40
    payload = rng.normal(size=(1, d, ne)).astype(np.float32)
    src = np.stack([rng.permutation(ne) for _ in range(c)])[:, None].astype(np.int32)
    inv = np.argsort(src, axis=-1).astype(np.int32)
    ct = rng.normal(size=(c, 1, d, ne)).astype(np.float32)

    def jf(p):
        out = jpermute_gather(p, jnp.asarray(src), jnp.asarray(inv), pack=pack,
                              out_bf16=out_bf16)
        return jnp.sum(out.astype(jnp.float32) * ct), out

    (_, jout), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(payload))
    p = _t(payload).requires_grad_(True)
    out = permute_gather(p, _t(src, torch.int64), _t(inv, torch.int64), pack=pack,
                         out_bf16=out_bf16)
    assert (out.dtype == torch.bfloat16) == (jout.dtype == jnp.bfloat16)
    torch.sum(out.float() * _t(ct)).backward()
    np.testing.assert_array_equal(out.float().detach().numpy(), np.asarray(jout, np.float32))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("s", [1, 2])
def test_permute_gather_rows_matches_jax(pack, s):
    """Row gather (the [num|denom] unsort) with broadcast sources."""
    rng = np.random.default_rng(6)
    r, ne, w = 2, 30, 7
    rows = rng.normal(size=(s, ne, w)).astype(np.float32)
    idx = np.stack([rng.permutation(ne) for _ in range(r)]).astype(np.int32)
    inv = np.argsort(idx, axis=-1).astype(np.int32)
    ct = rng.normal(size=(r, ne, w)).astype(np.float32)

    def jf(x):
        out = jpermute_gather_rows(x, jnp.asarray(idx), jnp.asarray(inv), pack=pack)
        return jnp.sum(out * ct), out

    (_, jout), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(rows))
    x = _t(rows).requires_grad_(True)
    out = permute_gather_rows(x, _t(idx, torch.int64), _t(inv, torch.int64), pack=pack)
    torch.sum(out * _t(ct)).backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)
