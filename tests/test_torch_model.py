"""The port's HEPT transformer against the JAX package's, same weights.

Both models get the same packed event and the same parameters and frozen
constants (`from_jax_variables`). JAX sorts its static plan unstably, and
replication pads are exact copies of real rows, so equal keys occur: the
layer-level comparisons inject JAX's plan (src/inv/scoords) into the port,
and the port's own plan is compared tie-aware (the same key at every sorted
slot, the same sorted coords).
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from hept_tpu.models import HeptTransformer as JaxHept  # noqa: E402
from hept_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from hept_tpu.models.transformer import _prepare_event  # noqa: E402
from hept_tpu.ops.bucket_attn import static_bucket_plan as jax_static_plan  # noqa: E402
from hept_tpu.ops.bucket_attn import static_hash as jax_static_hash  # noqa: E402
from hept_tpu_torch.data.batching import pack_events  # noqa: E402
from hept_tpu_torch.data.synthetic import synthetic_tracking_event  # noqa: E402
from hept_tpu_torch.models.transformer import (  # noqa: E402
    HeptTransformer,
    TransformerConfig,
    prepare_event,
)
from hept_tpu_torch.ops.bucket_attn import static_bucket_plan, static_hash  # noqa: E402
from hept_tpu_torch.utils.convert import from_jax_variables  # noqa: E402

SMALL = dict(h_dim=8, num_heads=2, n_layers=2, block_size=16, n_hashes=2,
             static_rounds=4, num_regions=16, num_w_per_dist=10,
             padding_mode="replicate", qkv_post_sort=True, shared_sort=True,
             share_heads=True, static_keys="x0", unsort_rows=True)
F32_MODES = dict(sort_pack=False, unsort_pack=False, kernel_bf16=False, kernel_center=False)
ACC_MODES = dict(sort_pack=True, unsort_pack=True, kernel_bf16=True, kernel_center=True)


def _event():
    rng = np.random.default_rng(5)
    ev = synthetic_tracking_event(rng, n_points=378, pairs_per_point=8)
    batch = pack_events([ev], block_size=16)  # 24 buckets: 6 replication pads
    return batch["x"][0], batch["coords"][0], batch["valid"][0]


def _jax_model(modes, scan_layers=True, attn_impl="slab2"):
    cfg = JaxConfig(in_dim=10, coords_dim=6, attn_impl=attn_impl, scan_layers=scan_layers,
                    sort_ops=8, **SMALL, **modes)
    return JaxHept(cfg), cfg


def _jax_plan(variables, cfg, x, coords, valid):
    """The static plan exactly as JaxHept computes it inside __call__."""
    p, c = variables["params"], variables["constants"]
    xp, cp, codes, invalid, _, _ = _prepare_event(x, coords, valid, c["regions"], cfg)
    h = jax.nn.relu(xp @ p["feat_enc_0"]["kernel"] + p["feat_enc_0"]["bias"])
    h = h @ p["feat_enc_1"]["kernel"] + p["feat_enc_1"]["bias"]
    scale = float(np.sqrt(2.0 * cfg.num_w_per_dist))
    hashed = jax_static_hash(h.T, cp.T, c["static_alpha"], scale, "x0")
    rows = jnp.asarray([t % cfg.n_hashes for t in range(cfg.static_rounds)])
    codes0 = codes[:, 0][rows]
    plan = jax_static_plan(hashed, codes0, invalid, cp.T, sort_events=1,
                           sort_pack=cfg.sort_pack, sort_ops=cfg.sort_ops,
                           coords_f32=cfg.kernel_center)
    return plan, dict(hashed=hashed, codes0=codes0, invalid=invalid, coords=cp, h=h)


def _port(variables, modes, attn_impl="slab2"):
    cfg = TransformerConfig(in_dim=10, coords_dim=6, attn_impl=attn_impl, **SMALL, **modes)
    model = HeptTransformer(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(from_jax_variables(variables))
    return model


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _tpu_kernels(monkeypatch, mode="slab2"):
    """Route the JAX model's bucket attention through the TPU's own Pallas
    kernels of attn_impl `mode` (slab2: K1/K2; hybrid2: einsum forward and
    K7 v2; interpret mode), as on the TPU; on the CPU the model otherwise
    takes the einsum path, whose autodiff rounds the bf16 gradient pieces
    separately (the broken contract K2 and K7 v2 fix)."""
    import hept_tpu.ops.bucket_attn as jba
    from hept_tpu.ops.bucket_attn_pallas import bucket_rbf_attention_cols_pallas

    einsum = jba.bucket_rbf_attention_cols_xla
    inside = []

    def kernels(sq, sk, sv, block_size, precision=None):
        if inside:  # the hybrid modes' einsum forward calls back in here
            return einsum(sq, sk, sv, block_size, precision=precision)
        inside.append(True)
        try:
            return bucket_rbf_attention_cols_pallas(sq, sk, sv, block_size=block_size,
                                                    hybrid=mode)
        finally:
            inside.pop()

    jba.hept_attention_core_xcols.clear_cache()
    monkeypatch.setattr(jba, "bucket_rbf_attention_cols_xla", kernels)
    return pltpu.force_tpu_interpret_mode()


def _compare(modes, fwd_tol, grad_tol, ctx=None, attn_impl="slab2"):
    x, coords, valid = _event()
    jmodel, jcfg = _jax_model(modes, attn_impl=attn_impl)
    w_out = np.random.default_rng(2).normal(size=(x.shape[0], 4)).astype(np.float32)
    w_out *= valid[:, None]
    with ctx or contextlib.nullcontext():
        # each JAX computation that may run interpret-mode kernels is one
        # jitted call on traced inputs, waited for before the next dispatch:
        # eager dispatch from this thread while an interpret-mode kernel's
        # callbacks dispatch on XLA's can deadlock
        variables = jax.block_until_ready(
            jax.jit(jmodel.init)(jax.random.PRNGKey(1), x, coords, valid))
        plan, _ = _jax_plan(variables, jcfg, x, coords, valid)

        def jloss(params, x, coords, valid):
            out = jmodel.apply({"params": params, "constants": variables["constants"]},
                               x, coords, valid)
            return jnp.sum(out * w_out), out

        (_, jout), jgrads = jax.block_until_ready(jax.jit(
            jax.value_and_grad(jloss, has_aux=True))(variables["params"], x, coords, valid))

    model = _port(variables, modes, attn_impl)
    tplan = tuple(_t(a, torch.int64) for a in plan[:2]) + (_t(plan[2]).float(),)
    out = model(_t(x), _t(coords), _t(valid), plan=tplan)
    loss = torch.sum(out * _t(w_out))
    loss.backward()

    jout = np.asarray(jout, np.float32)
    scale = np.abs(jout).max()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=fwd_tol, atol=fwd_tol * scale)
    ref = from_jax_variables({"params": jgrads, "constants": variables["constants"]})
    for name, p in model.named_parameters():
        g = p.grad.numpy()
        r = ref[name].numpy()
        gscale = max(np.abs(r).max(), 1e-12)
        np.testing.assert_allclose(g, r, rtol=grad_tol, atol=grad_tol * gscale, err_msg=name)


def test_model_f32_modes_match_jax():
    """Every bf16 mode off: forward to 1e-4, parameter gradients to
    1e-3 x each gradient's scale (f32 summation order only)."""
    _compare(F32_MODES, 1e-4, 1e-3)


def test_model_hept_acc_modes_match_jax(monkeypatch):
    """The hept_acc flags (bf16 transport and kernels, per-bucket centering),
    JAX running its TPU kernels: 2e-2 x scale, the bf16 rounding level."""
    import hept_tpu.ops.bucket_attn as jba

    try:
        _compare(ACC_MODES, 2e-2, 2e-2, ctx=_tpu_kernels(monkeypatch))
    finally:
        jba.hept_attention_core_xcols.clear_cache()


def test_model_hept_max_modes_match_jax(monkeypatch):
    """The hept_max flags (hept_acc's at OR width 3 over 3 rounds a layer,
    all distinct: 6 static rounds for 2 layers), JAX running its slab2
    kernels K1/K2 in interpret mode: 2e-2 x scale, as hept_acc."""
    import hept_tpu.ops.bucket_attn as jba

    monkeypatch.setitem(SMALL, "n_hashes", 3)
    monkeypatch.setitem(SMALL, "static_rounds", 6)
    try:
        _compare(ACC_MODES, 2e-2, 2e-2, ctx=_tpu_kernels(monkeypatch))
    finally:
        jba.hept_attention_core_xcols.clear_cache()


@pytest.mark.parametrize("n_hashes,static_rounds", [(2, 4), (1, 2)])
def test_model_hept_fast_modes_match_jax(monkeypatch, n_hashes, static_rounds):
    """The hept_fast / hept_turbo flags (attn_impl hybrid2: K6's exact-bias
    bf16 forward and K7 v2), JAX running its einsum forward and K7 v2 in
    interpret mode: 2e-2 x scale, as hept_acc."""
    import hept_tpu.ops.bucket_attn as jba

    monkeypatch.setitem(SMALL, "n_hashes", n_hashes)
    monkeypatch.setitem(SMALL, "static_rounds", static_rounds)
    try:
        _compare(ACC_MODES, 2e-2, 2e-2, ctx=_tpu_kernels(monkeypatch, "hybrid2"),
                 attn_impl="hybrid2")
    finally:
        jba.hept_attention_core_xcols.clear_cache()


def test_prepare_event_and_plan_match_jax():
    """prepare_event exactly; static_hash to 1e-5; the plan tie-aware and
    exact given JAX's hash values."""
    x, coords, valid = _event()
    jmodel, jcfg = _jax_model(ACC_MODES)
    variables = jmodel.init(jax.random.PRNGKey(3), x, coords, valid)
    plan, aux = _jax_plan(variables, jcfg, x, coords, valid)
    regions = _t(variables["constants"]["regions"])
    xp, cp, codes, inert = prepare_event(_t(x), _t(coords), _t(valid), regions, 16)
    jx, jc, jcodes, jinv, _, _ = _prepare_event(x, coords, valid,
                                                variables["constants"]["regions"], jcfg)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(cp.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(inert.numpy(), np.asarray(jinv))

    hashed = static_hash(_t(aux["h"]).t(), cp.t(),
                         _t(variables["constants"]["static_alpha"]),
                         float(np.sqrt(20.0)))
    np.testing.assert_allclose(hashed.numpy(), np.asarray(aux["hashed"]), rtol=1e-5, atol=1e-5)

    src, inv, scoords = static_bucket_plan(_t(aux["hashed"]), _t(aux["codes0"]), inert,
                                           cp.t(), sort_pack=True, coords_f32=True)
    jsrc, jinvp, jsc = (np.asarray(a) for a in plan)
    # the key at every sorted slot: unique whatever order ties take
    hs = np.asarray(aux["hashed"])
    key = hs + np.asarray(aux["codes0"], np.float32) * (hs.max(1, keepdims=True)
                                                      - hs.min(1, keepdims=True))
    key = np.where(np.asarray(inert)[None], np.float32(3.0e38), key)
    s = src.numpy()[:, 0]
    np.testing.assert_array_equal(np.take_along_axis(key, s, 1),
                                  np.take_along_axis(key, jsrc[:, 0], 1))
    assert (np.diff(np.take_along_axis(key, s, 1), axis=1) >= 0).all()
    np.testing.assert_array_equal(np.take_along_axis(s, inv.numpy()[:, 0], 1),
                                  np.broadcast_to(np.arange(s.shape[1]), s.shape))
    np.testing.assert_array_equal(scoords.numpy(), jsc)
    assert jinvp.shape == inv.shape


def test_port_plan_drives_the_same_model():
    """Without an injected plan the port builds its own; on this event the
    tie-aware-equal plan gives the JAX model's output (f32 modes)."""
    x, coords, valid = _event()
    jmodel, _ = _jax_model(F32_MODES, scan_layers=False)
    variables = jmodel.init(jax.random.PRNGKey(4), x, coords, valid)
    jout = np.asarray(jmodel.apply(variables, x, coords, valid))
    model = _port(variables, F32_MODES)
    with torch.no_grad():
        out = model(_t(x), _t(coords), _t(valid)).numpy()
    real = valid
    np.testing.assert_allclose(out[real], jout[real], rtol=1e-4,
                               atol=1e-4 * np.abs(jout).max())

