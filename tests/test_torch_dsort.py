"""The port's distributed sort (`parallel/dsort.py`) against the JAX
package's (`hept_tpu/parallel/dsort.py`): `sort_perm`, `invert_perm` and
`permute_overflows` bit for bit, and `route_local` on 2 and 4 gloo ranks
(processes of `torch_parallel_workers.py`, one spawn per world size) equal
to payload[..., perm] bit for bit, forward and gradient, and its round
trip through the inverse permutation, as `tests/test_dsort.py` holds JAX's
on the conftest's virtual devices."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hept_tpu_torch.parallel.dsort import invert_perm, permute_overflows, sort_perm  # noqa: E402
from torch_ranks import spawn  # noqa: E402

C, ROWS, NE = 3, 5, 16


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def test_sort_perm_matches_jax():
    """Random keys with repeated values and invalid entries: the stable key
    sort with the index as tie-break, JAX's `sort_perm`, the same
    permutation; `invert_perm` its inverse, as JAX's."""
    import jax.numpy as jnp

    from hept_tpu.parallel import dsort as jd

    rng = np.random.default_rng(0)
    keys = rng.integers(0, 40, size=(C, 128)).astype(np.float32)  # many ties
    invalid = rng.random(128) < 0.1
    for inv in (None, invalid):
        want = np.asarray(jd.sort_perm(jnp.asarray(keys),
                                       None if inv is None else jnp.asarray(inv)))
        got = sort_perm(_t(keys), None if inv is None else _t(inv))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(invert_perm(got).numpy(),
                                      np.asarray(jd.invert_perm(jnp.asarray(want))))


@pytest.mark.parametrize("n_shards,cap", [(2, 16), (4, 8), (4, 3), (8, 2)])
def test_permute_overflows_matches_jax(n_shards, cap):
    """The cell-overflow flag of random permutations at caps on either side
    of the largest cell, JAX's."""
    import jax.numpy as jnp

    from hept_tpu.parallel import dsort as jd

    rng = np.random.default_rng(n_shards * 10 + cap)
    perm = np.stack([rng.permutation(64) for _ in range(C)]).astype(np.int32)
    want = bool(jd.permute_overflows(jnp.asarray(perm), n_shards, cap))
    assert bool(permute_overflows(_t(perm, torch.int64), n_shards, cap)) == want


def _cases(world: int, seed: int) -> list:
    """A random permutation at cap ne (never overflows), the stable sort of
    keys (as the bucket SP routes it) at JAX's 2 ne / P cap, and the
    identity."""
    rng = np.random.default_rng(seed)
    n = world * NE
    keys = rng.normal(size=(C, n)).astype(np.float32)
    perms = [np.stack([rng.permutation(n) for _ in range(C)]),
             np.argsort(keys, axis=-1, kind="stable"),
             np.broadcast_to(np.arange(n), (C, n))]
    caps = [NE, max(1, -(-2 * n // (world * world))), NE]
    out = []
    for perm, cap in zip(perms, caps):
        assert not bool(permute_overflows(_t(perm, torch.int64), world, cap))
        out.append({"perm": _t(perm, torch.int64),
                    "payload": _t(rng.normal(size=(C, ROWS, n)).astype(np.float32)),
                    "cot": _t(rng.normal(size=(C, ROWS, n)).astype(np.float32)), "cap": cap})
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def routed(request, tmp_path_factory):
    world = request.param
    cases = _cases(world, seed=world)
    outs = spawn("dsort", world, tmp_path_factory.mktemp(f"dsort{world}"), {"cases": cases})
    return world, cases, outs


@pytest.mark.parametrize("case", [0, 1, 2], ids=["random", "key_sort", "identity"])
def test_route_local_forward(routed, case):
    """Each rank's slab of route_local equals payload[..., perm] bit for
    bit."""
    world, cases, outs = routed
    cs = cases[case]
    want = torch.gather(cs["payload"], 2, cs["perm"][:, None].expand_as(cs["payload"]))
    got = torch.cat([o[case]["out"] for o in outs], dim=-1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", [0, 1, 2], ids=["random", "key_sort", "identity"])
def test_route_local_gradient(routed, case):
    """The payload's gradient of sum(out * cot) is the cotangent sent back
    by the inverse permutation, bit for bit (JAX's
    `test_shard_permute_gradients` holds its shard_map the same way)."""
    world, cases, outs = routed
    cs = cases[case]
    inv = invert_perm(cs["perm"])
    want = torch.gather(cs["cot"], 2, inv[:, None].expand_as(cs["cot"]))
    got = torch.cat([o[case]["grad"] for o in outs], dim=-1)
    assert torch.equal(got, want)


def test_route_local_round_trip(routed):
    """Routing the sorted slabs back through the inverse permutation gives
    each rank its own input slab, bit for bit (`tests/test_dsort.py`'s
    unsort round trip)."""
    world, cases, outs = routed
    for k, cs in enumerate(cases):
        got = torch.cat([o[k]["back"] for o in outs], dim=-1)
        assert torch.equal(got, cs["payload"]), k
