"""The port's reference-parity `hept` path (per-layer, per-head dynamic keys
and the sort-carry transport) against the JAX package's.

Both sides get the same inputs, made with numpy, and the same parameters and
frozen constants (`from_jax_variables`). JAX sorts unstably and the port
stably, and replication pads copy their source row's key exactly, so where a
tie straddles a bucket boundary the two put a real point in different
buckets. Comparisons on such inputs therefore run the port on JAX's own
permutations (recorded from its sort with `jax.debug.callback`); the keys
and the permutations they imply are compared on tie-free inputs (no pads).
JAX's bucket attention runs its TPU kernels K6/K7 in Pallas interpret mode
where the test says so (on the CPU it would otherwise take the einsum path),
inside one `jax.jit`: eager dispatch from the test thread can deadlock with
the interpreter's callback thread, which dispatches work of its own.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import hept_tpu.ops.bucket_attn as jba  # noqa: E402
from hept_tpu.core.buckets import grouped_sort_carry as jax_grouped_sort_carry  # noqa: E402
from hept_tpu.core.buckets import unsort_carry as jax_unsort_carry  # noqa: E402
from hept_tpu.core.hashing import lsh_mapping as jax_lsh_mapping  # noqa: E402
from hept_tpu.models import HeptTransformer as JaxHept  # noqa: E402
from hept_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from hept_tpu.ops.bucket_attn_pallas import bucket_rbf_attention_cols_pallas  # noqa: E402
from hept_tpu.parallel.dp import make_single_device_train_step  # noqa: E402
from hept_tpu.train.config import ExperimentConfig as JaxExperimentConfig  # noqa: E402
from hept_tpu.train.optim import make_lr_schedule  # noqa: E402
from hept_tpu.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from hept_tpu.train.state import TrainState  # noqa: E402
from hept_tpu.train.trainer import make_loss_fn as jax_make_loss_fn  # noqa: E402
from hept_tpu.train.trainer import make_model_apply  # noqa: E402
from hept_tpu_torch.core.buckets import sort_carry, unsort_carry  # noqa: E402
from hept_tpu_torch.core.hashing import lsh_mapping  # noqa: E402
from hept_tpu_torch.data.batching import pack_events  # noqa: E402
from hept_tpu_torch.data.synthetic import synthetic_tracking_event  # noqa: E402
from hept_tpu_torch.models.transformer import HeptTransformer, TransformerConfig  # noqa: E402
from hept_tpu_torch.ops.bucket_attn import hept_attention_core_cols  # noqa: E402
from hept_tpu_torch.train import trainer  # noqa: E402
from hept_tpu_torch.train.config import ExperimentConfig  # noqa: E402
from hept_tpu_torch.utils.convert import from_jax_variables  # noqa: E402

BS = 16
SMALL = dict(h_dim=8, num_heads=2, n_layers=2, block_size=BS, n_hashes=2, num_regions=16,
             num_w_per_dist=10, padding_mode="replicate")


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(got, want, tol, name=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=name)


def _event(n_points):
    """One synthetic event packed to a multiple of BS: 378 points leave 6
    replication pads; 384 points leave none (tie-free keys)."""
    ev = synthetic_tracking_event(np.random.default_rng(5), n_points=n_points,
                                  pairs_per_point=8)
    batch = pack_events([ev], block_size=BS, window_pairs=128)
    return batch


@contextlib.contextmanager
def _jax_cols_kernels(monkeypatch, mode="pallas"):
    """Run JAX's dynamic-key core through its TPU column kernels (K6/K7,
    interpret mode) and record the (q_src, k_src) of every sort, in call
    order (one per layer and forward)."""
    rec = []
    sort = jba.grouped_sort_carry

    def recording_sort(keys, payloads, **kw):
        outs, srcs = sort(keys, payloads, **kw)
        if len(keys) == 2:  # the q / k sort; the unsort has one group
            jax.debug.callback(lambda a, b: rec.append((np.asarray(a), np.asarray(b))),
                               *srcs, ordered=True)
        return outs, srcs

    def kernels(sq, sk, sv, block_size, precision=None):
        return bucket_rbf_attention_cols_pallas(sq, sk, sv, block_size=block_size, hybrid=mode)

    monkeypatch.setattr(jba, "grouped_sort_carry", recording_sort)
    monkeypatch.setattr(jba, "bucket_rbf_attention_cols_xla", kernels)
    jba.hept_attention_core_cols.clear_cache()
    try:
        with pltpu.force_tpu_interpret_mode():
            yield rec
    finally:
        jba.hept_attention_core_cols.clear_cache()


def test_lsh_mapping_matches_jax():
    """Hashes and the span over q AND k per (round, head): 1e-5 x scale;
    no gradient flows through them."""
    rng = np.random.default_rng(0)
    h, n, d, c = 3, 50, 14, 2
    q, k = (rng.normal(size=(h, n, d)).astype(np.float32) for _ in range(2))
    alpha = rng.normal(size=(h, d, c)).astype(np.float32)
    tq = _t(q).requires_grad_(True)
    got = lsh_mapping(_t(alpha), tq, _t(k))
    want = jax_lsh_mapping(jnp.asarray(alpha), jnp.asarray(q), jnp.asarray(k))
    for g, w, nm in zip(got, want, ("q_hashed", "k_hashed", "hash_shift")):
        assert not g.requires_grad
        assert tuple(g.shape) == w.shape, nm
        _close(g, w, 1e-5, nm)


@pytest.mark.parametrize("layout", ["(h, d, n)", "(d, n)", "(c, h, d, n)"])
def test_sort_carry_matches_grouped_sort_carry(layout):
    """Sorted columns and src exactly (tie-free keys); the VJP (the
    cotangent gathered by the inverse permutation, summed over the broadcast
    axes) to 1e-6."""
    rng = np.random.default_rng(1)
    c, h, d, n = 2, 3, 4, 40
    keys = rng.normal(size=(c, h, n)).astype(np.float32)
    shape = {"(h, d, n)": (h, d, n), "(d, n)": (d, n), "(c, h, d, n)": (c, h, d, n)}[layout]
    payload = rng.normal(size=shape).astype(np.float32)
    ct = rng.normal(size=(c, h, d, n)).astype(np.float32)

    def jf(p):
        (out,), (src,) = jax_grouped_sort_carry([jnp.asarray(keys)], [p])
        return out, src

    jout, jsrc = jf(jnp.asarray(payload))
    _, jvjp = jax.vjp(lambda p: jf(p)[0], jnp.asarray(payload))
    (jgrad,) = jvjp(jnp.asarray(ct))
    tp = _t(payload).requires_grad_(True)
    out, src = sort_carry(_t(keys), tp)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    out.backward(_t(ct))
    _close(tp.grad, jgrad, 1e-6, "vjp")


@pytest.mark.parametrize("pack", [False, True])
def test_unsort_carry_matches_jax(pack):
    """Rows back in the original order (bf16 transport when packed), values
    and VJP exactly as JAX's unsort_carry."""
    rng = np.random.default_rng(2)
    c, h, n, w = 2, 3, 40, 5
    src = np.stack([np.stack([rng.permutation(n) for _ in range(h)]) for _ in range(c)])
    rows = rng.normal(size=(c, h, n, w)).astype(np.float32)
    ct = rng.normal(size=(c, h, n, w)).astype(np.float32)
    jout, jvjp = jax.vjp(lambda r: jax_unsort_carry(jnp.asarray(src, jnp.int32), r, pack),
                         jnp.asarray(rows))
    (jgrad,) = jvjp(jnp.asarray(ct))
    tr = _t(rows).requires_grad_(True)
    out = unsort_carry(_t(src, torch.int64), tr, pack=pack)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    out.backward(_t(ct))
    np.testing.assert_array_equal(tr.grad.numpy(), np.asarray(jgrad))


def _core_inputs(ties: bool, seed=3):
    """q_hat / k_hat / v columns (h, d, n) and codes. With ties: the last
    bucket's first 6 columns copy earlier columns exactly (as replication
    pads do) and its last 10 columns are invalid."""
    rng = np.random.default_rng(seed)
    h, dh, dv, c, n = 2, 11, 8, 2, 6 * BS
    q, k = (rng.normal(size=(h, dh, n)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(h, dv, n)).astype(np.float32)
    codes = rng.integers(0, 3, size=(c, h, n)).astype(np.int32)
    invalid = np.zeros(n, bool)
    if ties:
        src = rng.choice(n - BS, 6, replace=False)
        for a in (q, k, v):
            a[..., n - BS:n - BS + 6] = a[..., src]
        codes[..., n - BS:n - BS + 6] = codes[..., src]
        invalid[n - 10:] = True
        for a in (q, k, v):
            a[..., invalid] = 0.0
    alpha = rng.normal(size=(h, dh, c)).astype(np.float32)
    return q, k, v, alpha, codes, invalid


def _jax_core(monkeypatch, q, k, v, alpha, codes, invalid, w):
    with _jax_cols_kernels(monkeypatch) as rec:
        def loss(q_, k_, v_):
            out = jba.hept_attention_core_cols(q_, k_, v_, jnp.asarray(alpha),
                                               jnp.asarray(codes), jnp.asarray(invalid),
                                               block_size=BS, impl="pallas")
            return jnp.sum(out * w), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return out, grads, rec


@pytest.mark.parametrize("ties", [False, True])
def test_core_cols_matches_jax(monkeypatch, ties):
    """`hept_attention_core_cols` against JAX's, which runs K6 / K7 v1 in
    interpret mode: output to 1e-5 x scale and the gradients of q_hat, k_hat
    and v (the k side's cotangent goes back by k's own inverse permutation)
    to 1e-4 x scale, f32. Tie-free, the port's own keys give JAX's
    permutations exactly; with exact ties and invalid rows the port runs on
    JAX's recorded permutations."""
    q, k, v, alpha, codes, invalid = _core_inputs(ties)
    h, dv, n = v.shape
    w = np.random.default_rng(4).normal(size=(h, dv, n)).astype(np.float32)
    jout, jgrads, rec = _jax_core(monkeypatch, q, k, v, alpha, codes, invalid, w)
    assert len(rec) == 1
    perms = tuple(_t(p, torch.int64) for p in rec[0])
    ins = [_t(a).requires_grad_(True) for a in (q, k, v)]
    seen = []
    out = hept_attention_core_cols(*ins, _t(alpha), _t(codes), _t(invalid), block_size=BS,
                                   impl="pallas", perms=None if not ties else perms,
                                   record_perms=seen)
    if not ties:
        for got, want in zip(seen[0], perms):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
    jrows = np.asarray(jout).reshape(h * dv, n).T
    _close(out, jrows, 1e-5, "output")
    torch.sum(out * _t(w.reshape(h * dv, n).T)).backward()
    for t, g, nm in zip(ins, jgrads, ("q_hat", "k_hat", "v")):
        _close(t.grad, g, 1e-4, nm)


def _jax_parity(scan_layers=False, attn_impl="pallas"):
    cfg = JaxConfig(in_dim=10, coords_dim=6, attn_impl=attn_impl, scan_layers=scan_layers,
                    **SMALL)
    return JaxHept(cfg)


def _port(variables, attn_impl="pallas"):
    cfg = TransformerConfig(in_dim=10, coords_dim=6, attn_impl=attn_impl, **SMALL)
    model = HeptTransformer(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(from_jax_variables(variables))
    return model


def _check_parity_model(monkeypatch, attn_impl):
    batch = _event(378)
    x, coords, valid = batch["x"][0], batch["coords"][0], batch["valid"][0]
    assert not valid.all()
    jmodel = _jax_parity(attn_impl=attn_impl)
    variables = jmodel.init(jax.random.PRNGKey(1), x, coords, valid)
    w_out = np.random.default_rng(2).normal(size=(x.shape[0], 4)).astype(np.float32)
    with _jax_cols_kernels(monkeypatch, attn_impl) as rec:
        def jloss(params, x_, coords_, valid_):
            out = jmodel.apply({"params": params, "constants": variables["constants"]},
                               x_, coords_, valid_)
            return jnp.sum(out * w_out), out

        (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            variables["params"], x, coords, valid)
    assert len(rec) == SMALL["n_layers"]
    model = _port(variables, attn_impl)
    perms = [tuple(_t(p, torch.int64) for p in layer) for layer in rec]
    out = model(_t(x), _t(coords), _t(valid), perms=perms)
    _close(out, jout, 1e-4, "output")
    torch.sum(out * _t(w_out)).backward()
    ref = from_jax_variables({"params": jgrads, "constants": variables["constants"]})
    names = [nm for nm, _ in model.named_parameters()]
    assert {"blocks.0.w_q.weight", "blocks.1.w_k.weight", "blocks.1.w_v.weight",
            "blocks.0.w_rpe"} <= set(names)
    for name, p in model.named_parameters():
        _close(p.grad, ref[name], 1e-3, name)


def test_parity_model_matches_jax_kernels(monkeypatch):
    """The whole parity model (2 layers, replication pads) with JAX's weights
    and constants, JAX running K6 / K7 v1 in interpret mode, the port on
    JAX's recorded per-layer permutations: outputs to 1e-4 x scale and every
    parameter gradient to 1e-3 x its scale, f32."""
    _check_parity_model(monkeypatch, "pallas")


def test_parity_model_slab_matches_jax_kernels(monkeypatch):
    """The same with `attn_impl: slab`: JAX runs its block-diagonal slab
    kernels K8/K9 (slabs of 64 buckets of 16, in interpret mode), the port
    K6 / K7 v1, whose contracts they are."""
    _check_parity_model(monkeypatch, "slab")


@pytest.mark.parametrize("scan_layers", [False, True])
def test_weight_bridge_carries_parity_model(scan_layers):
    """from_jax_variables on a JAX-initialised parity model, loop (block_i)
    and scan layouts: no static_alpha, per-head e2lsh_alpha (h, d + cd,
    n_hashes), and the port's output equals JAX's (einsum path, tie-free
    event, the port's own keys) to 1e-4 x scale."""
    batch = _event(384)
    x, coords, valid = batch["x"][0], batch["coords"][0], batch["valid"][0]
    assert valid.all()
    jmodel = _jax_parity(scan_layers)
    variables = jmodel.init(jax.random.PRNGKey(7), x, coords, valid)
    assert ("blocks" in variables["params"]) == scan_layers
    sd = from_jax_variables(variables)
    assert "static_alpha" not in sd
    assert tuple(sd["blocks.1.attn.e2lsh_alpha"].shape) == (2, 8 + 6, 2)
    jout = np.asarray(jmodel.apply(variables, x, coords, valid))
    model = _port(variables)
    with torch.no_grad():
        out = model(_t(x), _t(coords), _t(valid))
    _close(out, jout, 1e-4)


def test_parity_train_step_matches_jax():
    """One train_step of the parity configuration (dropout off) against
    make_single_device_train_step on a tie-free event: loss 1e-5, gradient
    norm 1e-3, Adam's first moment 1e-3 x scale + 1e-7 (f32, JAX on its
    einsum path, the same math as K6 / K7 v1)."""
    batch = _event(384)
    model_kwargs = {k: v for k, v in SMALL.items() if k != "padding_mode"}
    model_kwargs["dropout"] = 0.0
    jcfg = JaxExperimentConfig(model_kwargs=dict(model_kwargs), attn_impl="pallas",
                               loss_kwargs=dict(tau=0.05, dist_metric="l2_rbf"))
    jmodel = JaxHept(jcfg.model_config(10, 6))
    variables = jmodel.init(jax.random.PRNGKey(0), batch["x"][0], batch["coords"][0],
                            batch["valid"][0])
    tx = jax_make_optimizer("adam", schedule=make_lr_schedule("step", 1e-2))
    state = TrainState.create(variables, tx, jax.random.PRNGKey(1))
    step = make_single_device_train_step(make_model_apply(jmodel), jax_make_loss_fn(jcfg), tx)
    new_state, jm = step(state, jax.tree_util.tree_map(jnp.asarray, batch))

    cfg = ExperimentConfig(model_kwargs=dict(model_kwargs), device="cpu", attn_impl="pallas",
                           loss_kwargs=dict(tau=0.05, dist_metric="l2_rbf"))
    model = trainer.build_model(cfg, 10, 6, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(from_jax_variables(variables))
    opt = trainer.make_optimizer(model.parameters(), lr=1e-2)
    m = trainer.train_step(model, opt, trainer.make_loss_fn(cfg),
                           trainer.batch_to_device(batch, "cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    mu = from_jax_variables({"params": new_state.opt_state.inner_state[0].mu,
                             "constants": variables["constants"]})
    for name, p in model.named_parameters():
        want = mu[name].numpy()
        np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(), want, rtol=1e-3,
                                   atol=1e-3 * np.abs(want).max() + 1e-7, err_msg=name)


@pytest.mark.parametrize("bad", [
    dict(shared_sort=True),  # shared_sort without the post-sort projections
    dict(gather_sort=True),  # JAX's pre-sort core takes no gather_sort
    dict(transport_groups=4),  # JAX ignores it without a plan
    dict(static_and_bins=4),  # likewise
    dict(sort_pack="fp8"),  # the e4m3 encoding is the unsort's
    dict(kernel_bf16=True),  # JAX's pre-sort core takes no kernel_bf16
])
def test_unported_modes_name_the_roadmap(bad):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TransformerConfig(in_dim=10, coords_dim=6, **dict(SMALL, **bad)).check_supported()


@pytest.mark.parametrize("mode", [
    dict(qkv_post_sort=True, shared_sort=True, head_shards=2),
    dict(use_ckpt=True, hash_shards=2),
], ids=["post_sort_head_tp", "use_ckpt_hash_tp"])
def test_formerly_refused_modes_are_accepted(mode):
    """Two modes this test file once held refused (post-sort keys under head
    TP, use_ckpt under hash TP) now pass `check_supported`; they are held
    against JAX's TP step in `test_torch_tp_post_sort.py`."""
    TransformerConfig(in_dim=10, coords_dim=6, **dict(SMALL, **mode)).check_supported()


def test_supported_paths():
    TransformerConfig(in_dim=10, coords_dim=6, **SMALL).check_supported()
    TransformerConfig(in_dim=10, coords_dim=6, qkv_post_sort=True, shared_sort=True,
                      share_heads=True, static_keys="x0", unsort_rows=True, sort_pack=True,
                      **SMALL).check_supported()
