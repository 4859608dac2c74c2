"""Plain K1/K2 (hept_tpu_torch.ops.bucket_attn_cuda) against the JAX
package's own flat-slab kernels, run in Pallas interpret mode as
tests/test_pallas_kernel.py runs them, plus the bf16-gradient contract and
the square-free ratio."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from hept_tpu.ops.bucket_attn import bucket_rbf_attention_cols_xla  # noqa: E402
from hept_tpu.ops.bucket_attn import stable_ratio as jstable_ratio  # noqa: E402
from hept_tpu.ops.bucket_attn_pallas import (  # noqa: E402
    _slab128_g,
    bucket_rbf_attention_cols_pallas,
)
from hept_tpu_torch.ops.bucket_attn import (  # noqa: E402
    DENOM_EPS,
    bucket_rbf_attention_cols,
    stable_ratio,
)
from hept_tpu_torch.ops.bucket_attn_cuda import (  # noqa: E402
    bucket_attn_bwd_plain,
    bucket_attn_fwd_plain,
)


def _loss_t(sq, sk, sv, bs):
    den, so = bucket_rbf_attention_cols(sq, sk, sv, bs)
    return torch.sum(so / den) + torch.sum(torch.log(den))


def _check_against_slab2(arrs, bs, dt):
    """Value and gradients of sum(so/den) + sum(log den) through the TPU's
    slab2 kernels (interpret mode) and through plain K1/K2: f32 to 1e-4,
    bf16 to 2e-2 x scale (the tolerances of test_slab2_matches_hybrid). The
    JAX side, its casts included, runs inside one `jax.jit`: eager dispatch
    from the test thread can deadlock with interpret mode's callbacks."""
    jdt = jnp.dtype(dt)

    def jloss(sq, sk, sv):
        den, so = bucket_rbf_attention_cols_pallas(sq, sk, sv, block_size=bs, hybrid="slab2")
        return jnp.sum(so / den) + jnp.sum(jnp.log(den))

    @jax.jit
    def jvg(*ins):
        return jax.value_and_grad(jloss, argnums=(0, 1, 2))(*(a.astype(jdt) for a in ins))

    with pltpu.force_tpu_interpret_mode():
        jl, jg = jax.block_until_ready(jvg(*arrs))
    tdt = getattr(torch, dt)
    ins = [torch.tensor(a).to(tdt).requires_grad_(True) for a in arrs]
    tl = _loss_t(*ins, bs)
    tl.backward()
    tol = 1e-4 if dt == "float32" else 2e-2
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=tol)
    for a, t, nm in zip(jg, ins, ("dq", "dk", "dv")):
        assert t.grad.dtype == tdt, nm
        a = np.asarray(a, np.float32)
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(t.grad.float().numpy(), a, rtol=tol, atol=tol * scale,
                                   err_msg=nm)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_k1_k2_match_tpu_slab2_kernels(dt):
    """Plain K1/K2 against the TPU's slab2 kernels at small widths."""
    r, d, dv, nb, bs = 2, 5, 4, 32, 8
    assert _slab128_g(nb, bs) >= 2
    n = nb * bs
    rng = np.random.default_rng(9)
    arrs = [rng.normal(size=s).astype(np.float32) for s in ((r, d, n), (r, d, n), (r, dv, n))]
    _check_against_slab2(arrs, bs, dt)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_k1_k2_match_tpu_slab2_kernels_at_main_path_widths(dt):
    """The same at the hept_acc step's column widths (d = 30: 24 projection
    rows and 6 RPE rows, dv = 24), bucket size 128, 4 buckets (one slab of
    g = 4): the card's K1/K2 are held against this plain version, so it is
    pinned to JAX where the card runs it. Inputs O(0.3) keep the logits
    -|q - k|^2 / 2 of order -3, not all pt ~ 0."""
    r, d, dv, nb, bs = 2, 30, 24, 4, 128
    assert _slab128_g(nb, bs) == 4
    n = nb * bs
    rng = np.random.default_rng(12)
    arrs = [(rng.normal(size=s) * sc).astype(np.float32)
            for s, sc in (((r, d, n), 0.3), ((r, d, n), 0.3), ((r, dv, n), 1.0))]
    _check_against_slab2(arrs, bs, dt)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_k1_matches_cols_xla(dt):
    """Plain K1 is the einsum math of bucket_rbf_attention_cols_xla."""
    r, d, dv, nb, bs = 3, 7, 5, 4, 16
    n = nb * bs
    rng = np.random.default_rng(1)
    arrs = [rng.normal(size=s).astype(np.float32) for s in ((r, d, n), (r, d, n), (r, dv, n))]
    jden, jso = bucket_rbf_attention_cols_xla(*(jnp.asarray(a).astype(dt) for a in arrs), bs)
    den, so = bucket_attn_fwd_plain(*(torch.tensor(a).to(getattr(torch, dt)) for a in arrs), bs)
    np.testing.assert_allclose(den.numpy(), np.asarray(jden), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(so.numpy(), np.asarray(jso), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jso)).max())


def test_plain_k2_is_gradient_of_bf16_forward_at_scale():
    """Port of test_pallas_kernel.py::test_bwd_is_gradient_of_bf16_forward_at_scale:
    RPE-like rows with a large per-bucket common mode (~40) where the signal
    is O(1). Plain K2 on bf16 operands must be the gradient of the bf16
    forward: held against the f32-accumulated JAX gradient at the bf16
    point, 2e-2 x scale."""
    r, d_x, cd, dv, nb, bs = 2, 4, 3, 5, 4, 8
    n = nb * bs
    rng = np.random.default_rng(11)
    common = rng.normal(size=(r, cd, nb, 1)) * 40.0
    loc_q = rng.normal(size=(r, cd, nb, bs))
    loc_k = rng.normal(size=(r, cd, nb, bs))
    sq = np.concatenate([rng.normal(size=(r, d_x, nb, bs)), common + loc_q], axis=1)
    sk = np.concatenate([rng.normal(size=(r, d_x, nb, bs)), common + loc_k], axis=1)
    sv = rng.normal(size=(r, dv, n))
    # round to bf16 once; both sides see the same bf16 values
    ins_t = [torch.tensor(a.reshape(-1, a.shape[1], n) if a.ndim == 4 else a,
                          dtype=torch.float32).to(torch.bfloat16) for a in (sq, sk, sv)]

    def loss_x(q, k, v):
        den, so = bucket_rbf_attention_cols_xla(q, k, v, bs)
        return jnp.sum(so / den)

    g_ref = jax.grad(loss_x, argnums=(0, 1, 2))(
        *(jnp.asarray(t.float().numpy()) for t in ins_t))
    ins = [t.clone().requires_grad_(True) for t in ins_t]
    den, so = bucket_rbf_attention_cols(*ins, bs)
    torch.sum(so / den).backward()
    for a, t, nm in zip(g_ref, ins, ("dq", "dk", "dv")):
        a = np.asarray(a, np.float32)
        scale = np.abs(a).max()
        np.testing.assert_allclose(t.grad.float().numpy(), a, rtol=2e-2, atol=2e-2 * scale,
                                   err_msg=nm)


def test_plain_k2_f32_is_autograd_of_plain_k1():
    """In f32 the explicit K2 formula equals autograd of the K1 math (1e-5)."""
    r, d, dv, nb, bs = 2, 6, 3, 3, 8
    n = nb * bs
    rng = np.random.default_rng(4)
    ins = [torch.tensor(rng.normal(size=s), dtype=torch.float32, requires_grad=True)
           for s in ((r, d, n), (r, d, n), (r, dv, n))]
    gden = torch.tensor(rng.normal(size=(r, 1, n)), dtype=torch.float32)
    gso = torch.tensor(rng.normal(size=(r, dv, n)), dtype=torch.float32)
    den, so = bucket_attn_fwd_plain(*ins, bs)
    ref = torch.autograd.grad((den * gden).sum() + (so * gso).sum(), ins)
    got = bucket_attn_bwd_plain(*(t.detach() for t in ins), gden, gso, bs)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_stable_ratio_square_free_backward():
    """Denominators at DENOM_EPS give finite gradients (plain num/den would
    give NaN); values and gradients match JAX's stable_ratio (1e-6)."""
    rng = np.random.default_rng(2)
    num = rng.normal(size=(5, 3, 4)).astype(np.float32)
    den = np.abs(rng.normal(size=(5, 3, 1))).astype(np.float32) + 0.1
    den[0, 0, 0] = DENOM_EPS
    num[0, 0] = 0.0
    g = rng.normal(size=(5, 3, 4)).astype(np.float32)
    jv, jvjp = jax.vjp(jstable_ratio, jnp.asarray(num), jnp.asarray(den))
    jdn, jdd = jvjp(jnp.asarray(g))
    tn = torch.tensor(num, requires_grad=True)
    td = torch.tensor(den, requires_grad=True)
    out = stable_ratio(tn, td)
    out.backward(torch.tensor(g))
    assert torch.isfinite(tn.grad).all() and torch.isfinite(td.grad).all()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jv), rtol=1e-6)
    np.testing.assert_allclose(tn.grad.numpy(), np.asarray(jdn), rtol=1e-6)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jdd), rtol=1e-6)
