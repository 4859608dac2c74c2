"""Plain K6/K7 (hept_tpu_torch.ops.bucket_attn_cuda) against the JAX
package's per-bucket column kernels (`_fwd_cols_impl`, `_bwd_cols_impl`),
run in Pallas interpret mode as tests/test_pallas_kernel.py runs them; the
attn_impl dispatch against `bucket_rbf_attention_cols_pallas` mode by mode;
and K7 v2's bf16-gradient contract."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from hept_tpu.ops.bucket_attn import bucket_rbf_attention_cols_xla  # noqa: E402
from hept_tpu.ops.bucket_attn_pallas import (  # noqa: E402
    _bwd_cols_impl,
    _fwd_cols_impl,
    _pick_group,
    _pick_group_loop,
    bucket_rbf_attention_cols_pallas,
)
from hept_tpu_torch.ops import bucket_attn_cuda as ba  # noqa: E402
from hept_tpu_torch.ops.bucket_attn import bucket_rbf_attention_cols  # noqa: E402


def _arrays(r, d, dv, nb, bs, seed, common=0.0):
    """q/k columns with an O(1) local part (plus an optional per-bucket
    common mode, shared by q and k, on the last 3 rows, as uncentred RPE
    columns have), values and cotangents, from a numpy seed."""
    rng = np.random.default_rng(seed)
    n = nb * bs
    shared = rng.normal(size=(r, 3, nb, 1)) * common

    def qk():
        x = rng.normal(size=(r, d, nb, bs)) * 0.5
        x[:, -3:] += shared
        return x.reshape(r, d, n).astype(np.float32)

    return (qk(), qk(), rng.normal(size=(r, dv, n)).astype(np.float32),
            rng.normal(size=(r, 1, n)).astype(np.float32),
            rng.normal(size=(r, dv, n)).astype(np.float32))


def _jit(fn, dt, **static):
    """fn(q, k, v, **static) on the inputs cast to dt, casts included, as
    one `jax.jit`: eager dispatch from the test thread can deadlock with
    interpret mode's callbacks."""
    return jax.jit(lambda *ins: fn(*(a.astype(jnp.dtype(dt)) for a in ins), **static))


def _torch(a, dt):
    return torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, dt))


def _close(got, want, tol, name):
    want = np.asarray(want, np.float32)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol * scale,
                               err_msg=name)


@pytest.mark.parametrize("case,dt,nb,loop", [
    ("f32", "float32", 12, False),  # nb 12: JAX pads to 16 buckets, g = 8
    ("bf16 hi/lo", "bfloat16", 12, False),
    ("bf16 loop (exact bias)", "bfloat16", 16, True),
])
def test_plain_k6_matches_fwd_cols_impl(case, dt, nb, loop):
    """denom and so of `_fwd_cols_impl` (interpret mode) and plain K6: f32
    to 1e-5 x scale; bf16 to 5e-3 x scale (pt is rounded to bf16 before
    the value product; the two sum the logits in other orders)."""
    r, d, dv, bs = 2, 7, 5, 8
    if loop:  # the loop kernel runs where its group beats the unrolled one
        assert _pick_group_loop(nb, bs * (2 * d + dv) * 2 + bs * 4 * (1 + dv)) > _pick_group(nb)
    sq, sk, sv, _, _ = _arrays(r, d, dv, nb, bs, seed=3, common=3.0)
    with pltpu.force_tpu_interpret_mode():
        jden, jso = _jit(_fwd_cols_impl, dt, bs=bs, loop=loop)(sq, sk, sv)
    den, so = ba.cols_fwd_plain(_torch(sq, dt), _torch(sk, dt), _torch(sv, dt), bs,
                                hilo=dt == "bfloat16" and not loop)
    tol = 1e-5 if dt == "float32" else 5e-3
    _close(den, jden, max(tol, 1e-5), f"{case} denom")
    _close(so, jso, tol, f"{case} so")


def test_k6_hilo_differs_from_exact_bias():
    """The hi/lo bias rows are not the exact f32 bias: with a large common
    mode (|x|^2/2 ~ 1e3) the two contracts give different logits, and
    plain K6 follows the TPU kernel's (interpret mode) in each."""
    r, d, dv, nb, bs = 2, 7, 5, 12, 8
    sq, sk, sv, _, _ = _arrays(r, d, dv, nb, bs, seed=4, common=30.0)
    ins = [_torch(a, "bfloat16") for a in (sq, sk, sv)]
    hilo = ba.cols_fwd_plain(*ins, bs, hilo=True)[0]
    exact = ba.cols_fwd_plain(*ins, bs, hilo=False)[0]
    assert float((hilo - exact).abs().max()) > 1e-3 * float(exact.abs().max())
    with pltpu.force_tpu_interpret_mode():
        jden, _ = _jit(_fwd_cols_impl, "bfloat16", bs=bs)(sq, sk, sv)
    _close(hilo, jden, 1e-5, "hilo denom")


@pytest.mark.parametrize("case,dt,v2,loop", [
    ("v1 f32", "float32", False, False),
    ("v1 on bf16 residuals (upcast)", "bfloat16", False, False),
    ("v2", "bfloat16", True, False),
    ("v2 loop", "bfloat16", True, True),
])
def test_plain_k7_matches_bwd_cols_impl(case, dt, v2, loop):
    """dq, dk, dv of `_bwd_cols_impl` (interpret mode) and plain K7: f32 to
    1e-5 x scale; bf16 outputs to 1e-2 x scale (one bf16 ulp)."""
    r, d, dv, nb, bs = 2, 7, 5, 16, 8
    sq, sk, sv, gden, gso = _arrays(r, d, dv, nb, bs, seed=5, common=3.0)

    def bwd(q, k, v, gd, gs):  # one jax.jit, as _jit
        qkv = tuple(a.astype(jnp.dtype(dt)) for a in (q, k, v))
        return _bwd_cols_impl(qkv, (gd, gs), bs, v2=v2, loop=loop)

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(bwd)(sq, sk, sv, gden, gso)
    got = ba.cols_bwd_plain(_torch(sq, dt), _torch(sk, dt), _torch(sv, dt),
                            torch.tensor(gden), torch.tensor(gso), bs, v2)
    tol = 1e-5 if dt == "float32" else 1e-2
    for g, w, nm in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == getattr(torch, dt), nm
        _close(g, w, tol, f"{case} {nm}")


def test_plain_k7_v2_is_gradient_of_bf16_forward_at_scale():
    """Port of test_pallas_kernel.py::test_bwd_is_gradient_of_bf16_forward_at_scale
    for K7 v2 (the hybrid2 route at block_size 100's shape class): RPE-like
    rows with a per-bucket common mode ~40 where the signal is O(1); the
    gradient must be the f32-accumulated JAX gradient of the bf16 forward
    at the same bf16 values, 2e-2 x scale."""
    r, d, dv, nb, bs = 2, 7, 5, 4, 10
    sq, sk, sv, _, _ = _arrays(r, d, dv, nb, bs, seed=11, common=40.0)
    ins_t = [_torch(a, "bfloat16") for a in (sq, sk, sv)]
    assert ba.cols_routes("hybrid2", nb * bs, bs, torch.bfloat16) == ("K6", "K7 v2")

    def loss_x(q, k, v):
        den, so = bucket_rbf_attention_cols_xla(q, k, v, bs)
        return jnp.sum(so / den)

    g_ref = jax.grad(loss_x, argnums=(0, 1, 2))(
        *(jnp.asarray(t.float().numpy()) for t in ins_t))
    ins = [t.clone().requires_grad_(True) for t in ins_t]
    den, so = bucket_rbf_attention_cols(*ins, bs, "hybrid2")
    torch.sum(so / den).backward()
    for a, t, nm in zip(g_ref, ins, ("dq", "dk", "dv")):
        _close(t.grad, a, 2e-2, nm)


_TABLE = [  # (mode, n, bs, dtype) -> routes; slab2 at bs 512 with nb 118 has g = 2
    ("slab2", 60416, 512, "bfloat16", ("K1", "K2")),
    ("slab2", 60416, 512, "float32", ("K1", "K2")),
    ("slab2", 60000, 100, "bfloat16", ("K6", "K7 v2")),
    ("slab2", 60000, 100, "float32", ("K6", "K7 v1")),
    ("hybrid2", 60000, 100, "bfloat16", ("K6", "K7 v2")),
    ("hybrid2l", 60000, 100, "bfloat16", ("K6", "K7 v2")),
    ("hybrid2", 60000, 100, "float32", ("K6", "K7 v1")),
    ("hybrid", 60000, 100, "bfloat16", ("K6", "K7 v1")),
    ("pallas", 60000, 100, "float32", ("K6", "K7 v1")),
    ("pallas", 60000, 100, "bfloat16", ("K6 hilo", "K7 v1")),
    ("loop2", 60000, 100, "bfloat16", ("K6", "K7 v2")),
    ("loop2", 60000, 100, "float32", ("K6", "K7 v1")),
    # K8/K9's contracts (JAX: slab g = 8 at bs 100, g = 2 at bs 512) on K6 / K7 v1
    ("slab", 60000, 100, "bfloat16", ("K6 hilo", "K7 v1")),
    ("slab", 60000, 100, "float32", ("K6", "K7 v1")),
    ("slab", 60416, 512, "bfloat16", ("K6 hilo", "K7 v1")),
    ("hybrid_slab", 60000, 100, "bfloat16", ("K6", "K7 v1")),
    ("hybrid_slab", 60416, 512, "float32", ("K6", "K7 v1")),
]


@pytest.mark.parametrize("mode,n,bs,dt,want", _TABLE)
def test_cols_routes_follow_make_cols_pallas(mode, n, bs, dt, want):
    assert ba.cols_routes(mode, n, bs, getattr(torch, dt)) == want


@pytest.mark.parametrize("dt,bs,v2,want", [
    ("bfloat16", 100, True, "tc"),  # hept_fast / hept_turbo: padded to 112
    ("bfloat16", 36, True, "tc"),
    ("bfloat16", 64, True, "tc"),
    ("bfloat16", 300, True, "tc"),
    ("bfloat16", 1696, True, "tc"),  # the widest padded bucket that fits
    ("bfloat16", 1712, True, "scalar"),  # its tiles overflow shared memory
    ("bfloat16", 50, True, "scalar"),  # no multiple of 4: 8-byte staging
    ("bfloat16", 10, True, "scalar"),
    ("bfloat16", 100, False, "scalar"),  # v1 (K9's contract): f32 math
    ("float32", 100, True, "scalar"),  # the parity profile: no TF32, no bf16
    ("float32", 100, False, "scalar"),
])
def test_cols_bwd_route_table(dt, bs, v2, want):
    """K7's route is fixed before launch by dtype, bucket size and variant:
    the tensor cores only for v2 on bf16 at bs % 4 == 0 that fits."""
    assert ba.cols_bwd_route(getattr(torch, dt), bs, v2) == want


@pytest.mark.parametrize("dt,bs,want", [
    ("bfloat16", 100, "tc"),  # hept_fast / hept_turbo / slab on bf16: padded to 112
    ("bfloat16", 36, "tc"),
    ("bfloat16", 64, "tc"),
    ("bfloat16", 300, "tc"),
    ("bfloat16", 1760, "tc"),  # the widest padded bucket that fits
    ("bfloat16", 1764, "scalar"),  # its tiles (1776 points) overflow shared memory
    ("bfloat16", 50, "scalar"),  # no multiple of 4: 8-byte staging
    ("bfloat16", 10, "scalar"),
    ("float32", 100, "scalar"),  # the parity profile: no TF32, no bf16
])
def test_cols_fwd_route_table(dt, bs, want):
    """K6's route is fixed before launch by dtype and bucket size: the tensor
    cores only for bf16 at bs % 4 == 0 that fits, in either bias mode."""
    assert ba.cols_fwd_route(getattr(torch, dt), bs) == want


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::tc_bwd_kernel<30, 24>(__nv_bfloat16 const*, int, int)", "K2"),
    ("void (anonymous namespace)::tc_cols_bwd_kernel<30, 24>(__nv_bfloat16 const*, int)", "K7"),
    ("void (anonymous namespace)::cols_bwd_tiled_kernel<30, 24>(float const*, int, int)", "K7"),
    ("void (anonymous namespace)::cols_bwd_kernel<30, 24, false, false>(float const*)", "K7"),
    ("void (anonymous namespace)::bwd_kernel<30, 24, false>(float const*, int, int)", "K2"),
    ("void (anonymous namespace)::tc_fwd_kernel<30, 24, 2>(__nv_bfloat16 const*)", "K1"),
    ("void (anonymous namespace)::tc_cols_fwd_kernel<30, 24, true, 1>(__nv_bfloat16 const*)",
     "K6"),
    ("void (anonymous namespace)::cols_fwd_tiled_kernel<30, 24, 5>(float const*, int)", "K6"),
    ("void (anonymous namespace)::cols_fwd_kernel<30, 24, true, false, false>(int)", "K6"),
    ("void at::native::elementwise_kernel<128, 4>(int, float)", None),
    # K10: the column kernels instantiated on the row layout (ROWS, the last
    # template argument, true)
    ("void (anonymous namespace)::cols_fwd_tiled_kernel<30, 24, true>(float const*, int, bool)",
     "K10"),
    ("void (anonymous namespace)::cols_fwd_tiled_kernel<30, 24, false>(float const*, int, bool)",
     "K6"),
    ("void (anonymous namespace)::cols_bwd_tiled_kernel<30, 24, true>(float const*, int, bool)",
     "K10"),
    ("void (anonymous namespace)::cols_bwd_tiled_kernel<7, 5, false>(float const*, int, bool)",
     "K7"),
    ("void (anonymous namespace)::cols_fwd_kernel<30, 24, false, false, true>(float const*)",
     "K10"),
    ("void (anonymous namespace)::cols_bwd_kernel<7, 5, false, true>(float const*, int)", "K10"),
    ("void (anonymous namespace)::gather_kernel<4>(float const*, int const*, float*, int)", "K3"),
    ("void (anonymous namespace)::gather1_kernel(float const*, int const*, float*, int)", "K3"),
    ("void (anonymous namespace)::row_gather_kernel<16>(void const*, long const*)", "K5"),
])
def test_profiler_maps_kernel_names(name, want):
    """utils/profiling.py books each kernel's device time to its TPU kernel
    by the profiler's name: K6's and K7's tensor-core and tiled kernels count
    as K6 and K7, tc_fwd_kernel as K1 and tc_bwd_kernel as K2 only, the
    column kernels on the row layout as K10, both gather kernels as K3."""
    from hept_tpu_torch.utils.profiling import port_kernel

    assert port_kernel(name) == want


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["pallas", "hybrid", "hybrid2", "hybrid2l", "loop2", "slab2",
                                  "slab", "hybrid_slab"])
def test_modes_match_jax_cols_pallas(mode, dt):
    """Value and gradients of sum(so/den) + sum(log den) through
    `bucket_rbf_attention_cols_pallas(hybrid=mode)` (interpret mode) and the
    port's dispatch (plain K6/K7 on the CPU): f32 to 1e-4, bf16 to 2e-2 x
    scale. nb = 6 of bs 10: no flat slab, so slab2 takes the column kernels;
    slab / hybrid_slab run JAX's slab kernels K8/K9 on slabs of 64 buckets
    (n = 60 padded to 640), the port K6 (hi/lo on bf16 for slab) and K7 v1."""
    r, d, dv, nb, bs = 2, 7, 5, 6, 10
    sq, sk, sv, _, _ = _arrays(r, d, dv, nb, bs, seed=7, common=2.0)

    def jloss(q, k, v):
        den, so = bucket_rbf_attention_cols_pallas(q, k, v, block_size=bs, hybrid=mode)
        return jnp.sum(so / den) + jnp.sum(jnp.log(den))

    with pltpu.force_tpu_interpret_mode():
        jl, jg = _jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)), dt)(sq, sk, sv)
    ins = [_torch(a, dt).requires_grad_(True) for a in (sq, sk, sv)]
    den, so = bucket_rbf_attention_cols(*ins, bs, mode)
    loss = torch.sum(so / den) + torch.sum(torch.log(den))
    loss.backward()
    tol = 1e-4 if dt == "float32" else 2e-2
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=tol)
    for a, t, nm in zip(jg, ins, ("dq", "dk", "dv")):
        assert t.grad.dtype == getattr(torch, dt), nm
        _close(t.grad, a, tol, nm)
