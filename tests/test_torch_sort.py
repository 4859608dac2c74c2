"""Plain K12 (hept_tpu_torch.ops.sort.bitonic_sort_rows) against the JAX
package's bitonic sort kernel (`ops/sort_pallas.py`) in Pallas interpret
mode, bit for bit, at the shapes of tests/test_pallas_kernel.py. JAX's
sorter runs inside one `jax.jit`, waited for: eager dispatch from the test
thread while an interpret-mode kernel's callbacks dispatch on XLA's can
deadlock. Its network schedule (arrays it caches on first use) is built
eagerly first, so that the jit does not trace it into the cache."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from hept_tpu.ops.sort_pallas import _get_sorter  # noqa: E402
from hept_tpu.ops.sort_pallas import bitonic_sort_rows as jax_bitonic_sort_rows  # noqa: E402
from hept_tpu_torch.ops.sort import bitonic_sort_rows, sort_route  # noqa: E402


def _inputs(rows, n, ops, seed=0):
    """Keys with a +BIG tail (as invalid rows) and interior ties, among them
    -0.0 and +0.0 (equal keys); ops - 1 uint32 payloads and the row-position
    iota."""
    rng = np.random.default_rng(seed)
    keys = rng.standard_normal((rows, n)).astype(np.float32)
    keys[:, -30:] = 3.0e38
    keys[:, :40] = np.round(keys[:, :40], 1)
    keys[:, 40:44] = [-0.0, 0.0, -0.0, 0.0]
    pays = [rng.integers(0, 2**32, (rows, n), dtype=np.int64).astype(np.uint32)
            for _ in range(ops - 1)]
    pays.append(np.broadcast_to(np.arange(n, dtype=np.uint32), (rows, n)).copy())
    return keys, pays


@pytest.mark.parametrize("n", [384, 512])  # 384 pads to 512 in the TPU kernel
def test_plain_k12_matches_bitonic_sort_rows(n):
    """Every sorted payload bit-equal to JAX's K12 (interpret mode), uint32
    payloads carried as int32 bit patterns."""
    rows, ops = 2, 4
    keys, pays = _inputs(rows, n, ops)
    with pltpu.force_tpu_interpret_mode():
        _get_sorter(rows, 512, ops)
        want = jax.block_until_ready(jax.jit(lambda k, *p: jax_bitonic_sort_rows(k, list(p)))(
            jnp.asarray(keys), *[jnp.asarray(p) for p in pays]))
    got = bitonic_sort_rows(torch.from_numpy(keys),
                            [torch.from_numpy(p.view(np.int32)) for p in pays])
    assert len(got) == ops
    for j, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w), err_msg=f"op {j}")


def test_plain_k12_breaks_key_ties_by_the_last_payload():
    """Equal keys order by the tie-break payload (not by position): a
    reversed tie-break reverses each run of equal keys."""
    keys = torch.tensor([[1.0, 0.0, 1.0, 0.0, 1.0]])
    tie = torch.tensor([[4, 3, 2, 1, 0]], dtype=torch.int32)
    (pos, sorted_tie) = bitonic_sort_rows(keys, [torch.arange(5, dtype=torch.int32)[None], tie])
    assert pos.tolist() == [[3, 1, 4, 2, 0]]
    assert sorted_tie.tolist() == [[1, 3, 0, 2, 4]]


@pytest.mark.parametrize("rows,n,ops,route", [
    (24, 60000, 16, "cluster"), (1, 1, 1, "cluster"), (0, 0, 1, "cluster"),
    (2, 65536, 32, "cluster"), (2, 65537, 1, "bitonic"), (65535, 2**30 - 1, 32, "bitonic"),
])
def test_sort_route_by_shape(rows, n, ops, route):
    """The cluster route takes rows of up to 65536 keys (8 CTAs of 8192),
    the bitonic route the longer ones."""
    assert sort_route(rows, n, ops) == route


@pytest.mark.parametrize("rows,n,ops", [(1, 10, 0), (1, 10, 33), (65536, 10, 1), (1, 2**30, 1),
                                        (-1, 10, 1)])
def test_sort_route_refuses_what_no_route_takes(rows, n, ops):
    with pytest.raises(ValueError):
        sort_route(rows, n, ops)


def _order_key(keys, tie):
    """The cluster route's 64-bit key, built as `csrc/sort.cu:order_key`
    builds it: the f32 bits with -0.0 folded onto +0.0, negatives inverted
    and positives' sign bit set, above the tie-break with its sign bit
    flipped."""
    u = keys.astype(np.float32).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    u = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000)).astype(np.uint32)
    lo = tie.astype(np.int32).view(np.uint32) ^ np.uint32(0x80000000)
    return (u.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


@pytest.mark.parametrize("kind", ["normal", "specials", "equal", "reversed_tie"])
def test_order_key_sorts_as_plain_k12(kind):
    """A stable sort on the 64-bit key (leftover ties by position, as the
    kernel breaks them) gives plain K12's order: signed zeros tie, +-inf,
    denormals and the extreme finite values order by value, and ties in the
    key go by the int32 tie-break, negative ones included."""
    rng = np.random.default_rng(3)
    rows, n = 3, 257
    if kind == "normal":
        keys, tie = _inputs(rows, n, 2, seed=4)[0], None
    elif kind == "specials":
        pool = np.array([np.inf, -np.inf, 1e-45, -1e-45, 1e-40, -1e-40, 0.0, -0.0,
                         3.4028235e38, -3.4028235e38, 1.0, -1.0], np.float32)
        keys, tie = pool[rng.integers(0, len(pool), (rows, n))], None
    elif kind == "equal":
        keys = np.full((rows, n), -0.0, np.float32)
        keys[:, ::2] = 0.0
        tie = rng.integers(-3, 3, (rows, n)).astype(np.int32)
    else:
        keys = np.round(rng.standard_normal((rows, n)), 0).astype(np.float32)
        tie = np.broadcast_to(np.arange(n, 0, -1, dtype=np.int32) - 100, (rows, n)).copy()
    if tie is None:
        tie = np.broadcast_to(np.arange(n, dtype=np.int32), (rows, n)).copy()
    pos = np.broadcast_to(np.arange(n, dtype=np.int32), (rows, n)).copy()
    want = bitonic_sort_rows(torch.from_numpy(keys), [torch.from_numpy(pos),
                                                      torch.from_numpy(tie)])[0]
    got = np.argsort(_order_key(keys, tie), axis=-1, kind="stable")
    np.testing.assert_array_equal(got, want.numpy())
