"""Plain K12 (hept_tpu_torch.ops.sort.bitonic_sort_rows) against the JAX
package's bitonic sort kernel (`ops/sort_pallas.py`) in Pallas interpret
mode, bit for bit, at the shapes of tests/test_pallas_kernel.py. JAX's
sorter is called eagerly, as that test calls it: it caches its network
schedule as arrays made on first use, which a `jax.jit` would leak."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from hept_tpu.ops.sort_pallas import bitonic_sort_rows as jax_bitonic_sort_rows  # noqa: E402
from hept_tpu_torch.ops.sort import bitonic_sort_rows  # noqa: E402


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
        want = jax_bitonic_sort_rows(jnp.asarray(keys), [jnp.asarray(p) for p in pays])
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
