"""The port's row gather (K5's plain version, and `permute_gather_rows`
through it) against the JAX package's Pallas row-gather kernels K5
(`row_gather_dma`) and K11 (`row_gather_vreg`) in interpret mode, bit for
bit: the gather moves bits, so no tolerance applies."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hept_tpu.core.buckets as jb  # noqa: E402
from hept_tpu.ops.gather_pallas import row_gather_dma, row_gather_vreg  # noqa: E402
from hept_tpu_torch.core.buckets import permute_gather_rows  # noqa: E402
from hept_tpu_torch.ops.row_gather import LAUNCHES, row_gather, row_gather_plain  # noqa: E402


def _case(S, R, n, w, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 2**32, size=(S, n, w), dtype=np.uint32)
    idx = np.stack([rng.permutation(n) for _ in range(R)]).astype(np.int32)
    return src, idx


def _port(src, idx):
    """The port's gather on the u32 rows (as int32, the same bits)."""
    out = row_gather(torch.from_numpy(src.view(np.int32)), torch.from_numpy(idx).long())
    return out.numpy().view(np.uint32)


# the cases of tests/test_gather_pallas.py, and 100- and 120-byte f32 rows
# (the parity unsort's W = 25; the row-major core's d = 30 from 8 sources)
@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("S,R,n,w", [(3, 3, 256, 100), (1, 4, 192, 128), (3, 3, 256, 25),
                                     (2, 6, 192, 30)])
def test_plain_k5_equals_vreg(S, R, n, w, tile):
    src, idx = _case(S, R, n, w)
    want = np.asarray(row_gather_vreg(jnp.asarray(src), jnp.asarray(idx), tile=tile,
                                      interpret=True))
    np.testing.assert_array_equal(_port(src, idx), want[..., :w])
    assert (want[..., w:] == 0).all()


def test_plain_k5_equals_vreg_ragged_tail():
    src, idx = _case(2, 2, 200, 100, seed=3)
    want = np.asarray(row_gather_vreg(jnp.asarray(src), jnp.asarray(idx), tile=64,
                                      interpret=True))
    np.testing.assert_array_equal(_port(src, idx), want[..., :100])


@pytest.mark.parametrize("S,R,n,w", [(3, 3, 256, 100), (1, 2, 96, 128), (3, 3, 256, 25),
                                     (2, 6, 192, 30)])
def test_plain_k5_equals_dma(S, R, n, w):
    src, idx = _case(S, R, n, w, seed=7)
    want = np.asarray(row_gather_dma(jnp.asarray(src), jnp.asarray(idx), t_tile=64,
                                     interpret=True))
    np.testing.assert_array_equal(_port(src, idx), want[..., :w])


def test_plain_k5_keeps_2_byte_rows_and_wide_rows():
    """bf16 rows (the unsort_pack transport) and a row wider than the TPU's
    128 words: the plain version moves the bits of any 2- or 4-byte row."""
    rng = np.random.default_rng(2)
    src = torch.from_numpy(rng.integers(-2**15, 2**15, size=(2, 50, 300), dtype=np.int16))
    idx = torch.from_numpy(np.stack([rng.permutation(50) for _ in range(4)]))
    out = row_gather_plain(src.view(torch.bfloat16), idx).view(torch.int16).numpy()
    for r in range(4):
        np.testing.assert_array_equal(out[r], src.numpy()[r % 2][idx.numpy()[r]])


def test_cpu_tensors_run_the_plain_version():
    before = LAUNCHES["row_gather"]
    src, idx = _case(1, 2, 16, 4)
    _port(src, idx)
    assert LAUNCHES["row_gather"] == before


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("S,R", [(2, 2), (2, 4), (1, 2)])
def test_permute_gather_rows_equals_jax_pallas_route(monkeypatch, pack, S, R):
    """Values and gradients of `permute_gather_rows` against JAX's with
    HEPT_ROW_GATHER=pallas (K5 in interpret mode), at atol=0. Broadcast
    sources sum R/S = 2 cotangent copies: one f32 addition, the same in both."""
    rng = np.random.default_rng(11)
    n, w = 200, 9
    rows = rng.normal(size=(S, n, w)).astype(np.float32)
    perms = np.stack([rng.permutation(n) for _ in range(R)]).astype(np.int32)
    inv = np.argsort(perms, axis=-1).astype(np.int32)
    ct = rng.normal(size=(R, n, w)).astype(np.float32)

    monkeypatch.setattr(jb, "_ROW_GATHER_BACKEND", "pallas")
    jb._permute_gather_rows_cache.clear()
    try:
        def jf(x):
            out = jb.permute_gather_rows(x, jnp.asarray(perms), jnp.asarray(inv), pack=pack)
            return jnp.sum(out * ct), out

        (_, jout), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(rows))
        jout, jg = np.asarray(jout), np.asarray(jg)
    finally:
        jb._permute_gather_rows_cache.clear()

    x = torch.from_numpy(rows).requires_grad_(True)
    out = permute_gather_rows(x, torch.from_numpy(perms).long(), torch.from_numpy(inv).long(),
                              pack=pack)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=0, atol=0)
    np.testing.assert_allclose(x.grad.numpy(), jg, rtol=0, atol=0)
