"""The port's row-major reference pipeline against the JAX package's: plain
K10 (`bucket_rbf_attention_rows`) against `bucket_rbf_attention_pallas` in
Pallas interpret mode, `sort_carry_rows` against JAX's `sort_carry`, and
`hept_attention_core` against JAX's (running K10 in interpret mode) and
against the dense golden.

Both sides get the same numpy-made inputs. JAX sorts unstably and the port
stably, so inputs with exact key ties run the port on JAX's own
permutations, recorded from its sorts with `jax.debug.callback`. JAX runs
each interpret-mode computation inside one `jax.jit`: eager dispatch from
the test thread can deadlock with the interpreter's callback thread.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import hept_tpu.ops.bucket_attn as jba  # noqa: E402
from hept_tpu.core.buckets import sort_carry as jax_sort_carry  # noqa: E402
from hept_tpu.ops.bucket_attn_pallas import bucket_rbf_attention_pallas  # noqa: E402
from hept_tpu_torch.core.buckets import sort_carry_rows  # noqa: E402
from hept_tpu_torch.ops.bucket_attn import (  # noqa: E402
    bucket_rbf_attention_rows,
    dense_rbf_attention,
    hept_attention_core,
)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(got, want, tol, name=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("lead,bs", [
    ((6,), 8),
    ((5,), 12),  # JAX pads the bucket to 16 rows and masks the padded keys
    ((2, 3, 4), 12),  # (c, h, nb) leading dims
])
def test_plain_k10_matches_pallas(lead, bs):
    """denom, so and the VJP of `bucket_rbf_attention_pallas` (interpret
    mode) and the port's K10 on the CPU: output 1e-5 x scale, gradients
    1e-4 x scale, f32."""
    rng = np.random.default_rng(0)
    d, dv = 7, 5
    sq, sk = (rng.normal(size=(*lead, bs, d)).astype(np.float32) * 0.6 for _ in range(2))
    sv = rng.normal(size=(*lead, bs, dv)).astype(np.float32)
    g_den = rng.normal(size=(*lead, bs, 1)).astype(np.float32)
    g_so = rng.normal(size=(*lead, bs, dv)).astype(np.float32)
    def fwd_vjp(q, k, v, gd, gs):
        out, vjp = jax.vjp(bucket_rbf_attention_pallas, q, k, v)
        return out, vjp((gd, gs))

    with pltpu.force_tpu_interpret_mode():
        (jden, jso), jgrads = jax.jit(fwd_vjp)(*(jnp.asarray(a)
                                                 for a in (sq, sk, sv, g_den, g_so)))
    ins = [_t(a).requires_grad_(True) for a in (sq, sk, sv)]
    den, so = bucket_rbf_attention_rows(*ins)
    _close(den, jden, 1e-5, "denom")
    _close(so, jso, 1e-5, "so")
    torch.autograd.backward((den, so), (_t(g_den), _t(g_so)))
    for t, g, nm in zip(ins, jgrads, ("dq", "dk", "dv")):
        _close(t.grad, g, 1e-4, nm)


def test_k10_is_float32_only():
    x = torch.zeros((2, 8, 7), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        bucket_rbf_attention_rows(x, x, torch.zeros((2, 8, 5), dtype=torch.bfloat16))


@pytest.mark.parametrize("bs,d,dv,want", [
    (100, 30, 24, ("tiled", "tiled")),  # the parity core: 14400 buckets of 100
    (96, 30, 24, ("tiled", "tiled")),
    (12, 30, 24, ("tiled", "tiled")),
    (8, 7, 5, ("tiled", "tiled")),  # JAX's unpadded bs 8 case
    (4, 7, 5, ("tiled", "tiled")),
    (100, 7, 5, ("tiled", "tiled")),
    (50, 30, 24, ("first_cut", "tiled")),  # bs % 4 != 0: the forward's 4-key steps
    (99, 30, 24, ("first_cut", "tiled")),
    (1, 7, 5, ("first_cut", "tiled")),
    (104, 30, 24, ("first_cut", "first_cut")),  # above the tiled kernels' 100 points
    (300, 30, 24, ("first_cut", "first_cut")),
    (512, 7, 5, ("first_cut", "first_cut")),
])
def test_k10_route_table(bs, d, dv, want):
    """K10's routes are fixed before launch by bucket size and widths: K6
    f32's tiled forward at bs % 4 == 0 up to 100, K7 v1's tiled backward up
    to 100 (its CTA's shared memory fits every compiled width there, 224,800
    bytes at bs 100, d 30, dv 24), the first-cut kernels otherwise."""
    from hept_tpu_torch.ops import bucket_attn_cuda as ba

    assert (ba.rows_fwd_route(bs), ba.rows_bwd_route(bs, d, dv)) == want
    if bs == 100 and d == 30:
        assert ba._tiled_bwd_smem(bs, d, dv) == 224_800 <= ba._SMEM_BYTES


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("layout", ["(h, n, d)", "(c, h, n, d)"])
def test_sort_carry_rows_matches_sort_carry(layout, pack):
    """Sorted rows and the source index exactly (tie-free keys, bf16
    transport rounding when packed); the VJP (the cotangent gathered by the
    inverse permutation, summed over the rounds for a broadcast payload)
    exactly."""
    rng = np.random.default_rng(2)
    c, h, n, d = 3, 2, 40, 5
    keys = rng.normal(size=(c, h, n)).astype(np.float32)
    shape = (h, n, d) if layout == "(h, n, d)" else (c, h, n, d)
    payload = rng.normal(size=shape).astype(np.float32)
    ct = rng.normal(size=(c, h, n, d)).astype(np.float32)
    (jout, jsrc), jvjp = jax.vjp(lambda p: jax_sort_carry(jnp.asarray(keys), p, pack),
                                 jnp.asarray(payload))
    (jgrad,) = jvjp((jnp.asarray(ct), np.zeros(jsrc.shape, jax.dtypes.float0)))
    tp = _t(payload).requires_grad_(True)
    out, src = sort_carry_rows(_t(keys), tp, pack=pack)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    out.backward(_t(ct))
    np.testing.assert_array_equal(tp.grad.numpy(), np.asarray(jgrad))


def _core_inputs(ties: bool, bs: int, seed=3):
    """q_hat / k_hat / v rows (h, n, d) and codes. With ties: the last
    bucket's first 6 rows copy earlier rows exactly (as replication pads do)
    and its last 10 rows are invalid and zero."""
    rng = np.random.default_rng(seed)
    h, dh, dv, c, n = 2, 11, 8, 2, 6 * bs
    q, k = (rng.normal(size=(h, n, dh)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(h, n, dv)).astype(np.float32)
    codes = rng.integers(0, 3, size=(c, h, n)).astype(np.int32)
    invalid = np.zeros(n, bool)
    if ties:
        src = rng.choice(n - bs, 6, replace=False)
        for a in (q, k, v):
            a[:, n - bs:n - bs + 6] = a[:, src]
        codes[..., n - bs:n - bs + 6] = codes[..., src]
        invalid[n - 10:] = True
        for a in (q, k, v):
            a[:, invalid] = 0.0
    alpha = rng.normal(size=(h, dh, c)).astype(np.float32)
    return q, k, v, alpha, codes, invalid


@contextlib.contextmanager
def _jax_k10(monkeypatch):
    """Run JAX's `hept_attention_core` through its TPU kernel K10
    (interpret mode; on the CPU it would take the einsum path) and record
    the source index of every sort_carry, in call order (q, then k)."""
    rec = []
    sort = jba.sort_carry

    def recording_sort(keys, payload, pack=False):
        out, src = sort(keys, payload, pack)
        jax.debug.callback(lambda a: rec.append(np.asarray(a)), src, ordered=True)
        return out, src

    monkeypatch.setattr(jba, "sort_carry", recording_sort)
    monkeypatch.setattr(jba, "bucket_rbf_attention_xla",
                        lambda sq, sk, sv: bucket_rbf_attention_pallas(sq, sk, sv))
    jba.hept_attention_core.clear_cache()
    try:
        with pltpu.force_tpu_interpret_mode():
            yield rec
    finally:
        jba.hept_attention_core.clear_cache()


@pytest.mark.parametrize("ties,sort_pack,bs", [
    (False, False, 16),
    (True, False, 12),  # JAX's K10 pads the 12-row buckets to 16
    (False, True, 16),
])
def test_core_matches_jax(monkeypatch, ties, sort_pack, bs):
    """`hept_attention_core` against JAX's, which runs K10 in interpret
    mode: output to 1e-5 x scale and the gradients of q_hat, k_hat and v to
    1e-4 x scale, f32 (bf16-rounded transport with sort_pack, on both
    sides). Tie-free, the port's own keys give JAX's permutations exactly;
    with exact ties and invalid rows the port runs on JAX's recorded
    permutations."""
    q, k, v, alpha, codes, invalid = _core_inputs(ties, bs)
    w = np.random.default_rng(4).normal(size=v.shape).astype(np.float32)
    with _jax_k10(monkeypatch) as rec:
        def loss(q_, k_, v_):
            out = jba.hept_attention_core(q_, k_, v_, jnp.asarray(alpha), jnp.asarray(codes),
                                          jnp.asarray(invalid), block_size=bs, impl="pallas",
                                          sort_pack=sort_pack)
            return jnp.sum(out * w), out

        (_, jout), jgrads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert len(rec) == 2
    perms = tuple(_t(p, torch.int64) for p in rec)
    ins = [_t(a).requires_grad_(True) for a in (q, k, v)]
    seen = []
    out = hept_attention_core(*ins, _t(alpha), _t(codes), _t(invalid), block_size=bs,
                              impl="pallas", sort_pack=sort_pack,
                              perms=perms if ties else None, record_perms=seen)
    if not ties:
        for got, want in zip(seen[0], perms):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert tuple(out.shape) == jout.shape
    _close(out, jout, 1e-5, "output")
    torch.sum(out * _t(w)).backward()
    for t, g, nm in zip(ins, jgrads, ("q_hat", "k_hat", "v")):
        _close(t.grad, g, 1e-4, nm)


def test_core_with_one_bucket_is_dense_attention():
    """With block_size = n every round's bucket holds all points, so the
    OR-combine is exact dense RBF attention (tests/test_bucket_attn.py's
    property): the port's core and its dense golden against JAX's dense
    golden, 1e-5."""
    rng = np.random.default_rng(5)
    h, n, d, dv, c = 2, 32, 6, 5, 3
    q, k = (rng.normal(size=(h, n, d)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(h, n, dv)).astype(np.float32)
    alpha = rng.normal(size=(h, d, c)).astype(np.float32)
    want = np.asarray(jba.dense_rbf_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    dense = dense_rbf_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(dense.numpy(), want, rtol=1e-5, atol=1e-5)
    out = hept_attention_core(_t(q), _t(k), _t(v), _t(alpha), torch.zeros((c, h, n)),
                              block_size=n, impl="xla")
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
