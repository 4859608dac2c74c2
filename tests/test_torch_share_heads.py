"""The port's dynamic-key share_heads path (qkv_post_sort + shared_sort +
share_heads without a static plan, f32: the path the bucket-axis SP runs)
against the JAX package's, and the refusals around it (fault F1: a
`sort_pack` / `unsort_pack` that is neither a bool nor, for the unsort, JAX's
"fp8", is refused on every path).

JAX runs `hept_attention_core_xcols` on its f32 einsum (`attn_impl: "xla"`,
the kernel `parallel/bp.py`'s core runs), the port K6 / K7 v1's plain
versions. JAX sorts unstably and the port stably: where keys tie (invalid
rows, replication pads) the port runs on JAX's recorded sort orders (one
(c, n) permutation a layer, recorded with `jax.debug.callback`); on
tie-free inputs the port's own keys must give JAX's permutation. The JAX
side runs inside one waited `jax.jit`. Tolerances are
`test_torch_parity_model.py`'s: core output 1e-5 and input gradients 1e-4
of scale; model output 1e-4 and parameter gradients 1e-3 of scale; one
train step's loss 1e-5, gradient norm 1e-3, Adam's first moment 1e-3 of
scale + 1e-7.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hept_tpu.ops.bucket_attn as jba  # noqa: E402
from hept_tpu.models import HeptTransformer as JaxHept  # noqa: E402
from hept_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from hept_tpu.parallel.dp import make_single_device_train_step  # noqa: E402
from hept_tpu.train.config import ExperimentConfig as JaxExperimentConfig  # noqa: E402
from hept_tpu.train.optim import make_lr_schedule  # noqa: E402
from hept_tpu.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from hept_tpu.train.state import TrainState  # noqa: E402
from hept_tpu.train.trainer import make_loss_fn as jax_make_loss_fn  # noqa: E402
from hept_tpu.train.trainer import make_model_apply  # noqa: E402
from hept_tpu_torch.data.batching import pack_events  # noqa: E402
from hept_tpu_torch.data.synthetic import synthetic_tracking_event  # noqa: E402
from hept_tpu_torch.models.transformer import HeptTransformer, TransformerConfig  # noqa: E402
from hept_tpu_torch.ops.bucket_attn import hept_attention_core_xcols  # noqa: E402
from hept_tpu_torch.train import trainer  # noqa: E402
from hept_tpu_torch.train.config import ExperimentConfig  # noqa: E402
from hept_tpu_torch.utils.convert import from_jax_variables  # noqa: E402

BS = 16
SHARED = dict(qkv_post_sort=True, shared_sort=True, share_heads=True)
SMALL = dict(h_dim=8, num_heads=2, n_layers=2, block_size=BS, n_hashes=2, num_regions=16,
             num_w_per_dist=10, padding_mode="replicate", **SHARED)
STATIC = dict(SHARED, static_keys="x0", unsort_rows=True)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(got, want, tol, name=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=name)


@contextlib.contextmanager
def _record_jax_sorts(monkeypatch):
    """Record the (c, n) src of every share_heads key sort of JAX's xcols
    core, in call order (its unsorts sort integer keys and are skipped)."""
    rec = []
    sort = jba.grouped_sort_carry

    def recording_sort(keys, payloads, **kw):
        outs, srcs = sort(keys, payloads, **kw)
        if jnp.issubdtype(keys[0].dtype, jnp.floating):
            jax.debug.callback(lambda a: rec.append(np.asarray(a).reshape(a.shape[0], -1)),
                               srcs[0], ordered=True)
        return outs, srcs

    monkeypatch.setattr(jba, "grouped_sort_carry", recording_sort)
    jba.hept_attention_core_xcols.clear_cache()
    try:
        yield rec
    finally:
        jba.hept_attention_core_xcols.clear_cache()


def _core_inputs(seed, ties, h=2, dm=8, d=8, cd=3, c=2, n=8 * BS):
    """The core's operands (`tests/test_bucket_sharding.py:_inputs`' recipe).
    With ties: the last 20 rows are invalid (all key to +BIG)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(dm, n)).astype(np.float32)
    coords = rng.normal(size=(cd, n)).astype(np.float32)
    wq, wk, wv = (rng.normal(size=(h, dm, d)).astype(np.float32) * 0.2 for _ in range(3))
    sqrt_w = np.abs(rng.normal(size=(h, cd)).astype(np.float32)) + 0.5
    alpha = rng.normal(size=(1, dm + cd, c)).astype(np.float32)
    codes = np.broadcast_to(rng.integers(0, 4, size=(c, 1, n)), (c, h, n)).astype(np.int32)
    invalid = np.zeros(n, bool)
    if ties:
        invalid[-20:] = True
    cot = rng.normal(size=(n, h * d)).astype(np.float32)
    return [x, coords, wq, wk, wv, sqrt_w], alpha, codes, invalid, cot


@pytest.mark.parametrize("unsort_rows", [False, True], ids=["head_carry", "merged_rows"])
@pytest.mark.parametrize("ties", [False, True], ids=["tie_free", "invalid_rows"])
def test_core_matches_jax(monkeypatch, unsort_rows, ties):
    """The dynamic-key share_heads core (both unsorts: the head-broadcast
    carry and the merged-row gather) against JAX's xcols core: output to
    1e-5 and the gradients of x, coords, wq, wk, wv and sqrt_w to 1e-4 of
    scale. Tie-free, the port's own keys give JAX's permutation."""
    diff, alpha, codes, invalid, cot = _core_inputs(3 + ties, ties)
    h, d, n = diff[2].shape[0], diff[2].shape[2], diff[0].shape[1]
    # JAX returns (h, d, n) columns, or (n, h * d) rows under unsort_rows
    wj = cot if unsort_rows else cot.T.reshape(h, d, n)
    with _record_jax_sorts(monkeypatch) as rec:
        def loss(*a):
            out = jba.hept_attention_core_xcols(
                *a, jnp.asarray(alpha), jnp.asarray(codes), jnp.asarray(invalid), None,
                block_size=BS, impl="xla", shared_sort=True, share_heads=True,
                unsort_rows=unsort_rows)
            return jnp.sum(out * wj), out

        (_, jout), jgrads = jax.block_until_ready(jax.jit(jax.value_and_grad(
            loss, argnums=tuple(range(6)), has_aux=True))(*map(jnp.asarray, diff)))
    assert len(rec) == 1
    ins = [_t(a).requires_grad_(True) for a in diff]
    seen = []
    out = hept_attention_core_xcols(*ins, _t(alpha), _t(codes), _t(invalid), None,
                                    block_size=BS, impl="pallas", share_heads=True,
                                    unsort_rows=unsort_rows,
                                    src=_t(rec[0], torch.int64) if ties else None,
                                    record_perms=seen)
    if not ties:
        np.testing.assert_array_equal(seen[0].numpy(), rec[0])
    jrows = np.asarray(jout) if unsort_rows else np.asarray(jout).reshape(h * d, n).T
    _close(out, jrows, 1e-5, "output")
    torch.sum(out * _t(cot)).backward()
    for t, g, nm in zip(ins, jgrads, ("x", "coords", "wq", "wk", "wv", "sqrt_w")):
        _close(t.grad, g, 1e-4, nm)


def _event(n_points):
    """One synthetic event packed to a multiple of BS: 378 points leave 6
    replication pads; 384 points leave none (tie-free keys)."""
    ev = synthetic_tracking_event(np.random.default_rng(5), n_points=n_points,
                                  pairs_per_point=8)
    return pack_events([ev], block_size=BS, window_pairs=128)


@pytest.mark.parametrize("unsort_rows", [False, True], ids=["head_carry", "merged_rows"])
def test_model_matches_jax(monkeypatch, unsort_rows):
    """The whole share_heads model (2 layers, replication pads) with JAX's
    weights and constants (`from_jax_variables` carries each layer's one-head
    e2lsh_alpha (1, h_dim + cd, n_hashes)), the port on JAX's recorded sort
    orders: output to 1e-4 and every parameter gradient to 1e-3 of scale."""
    batch = _event(378)
    x, coords, valid = batch["x"][0], batch["coords"][0], batch["valid"][0]
    assert not valid.all()
    kw = dict(SMALL, unsort_rows=unsort_rows)
    jmodel = JaxHept(JaxConfig(in_dim=10, coords_dim=6, attn_impl="xla", **kw))
    variables = jax.block_until_ready(jax.jit(jmodel.init)(jax.random.PRNGKey(1), x, coords,
                                                           valid))
    w_out = np.random.default_rng(2).normal(size=(x.shape[0], 4)).astype(np.float32)
    with _record_jax_sorts(monkeypatch) as rec:
        def jloss(params, x_, coords_, valid_):
            out = jmodel.apply({"params": params, "constants": variables["constants"]},
                               x_, coords_, valid_)
            return jnp.sum(out * w_out), out

        (_, jout), jgrads = jax.block_until_ready(jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(variables["params"], x, coords, valid))
    assert len(rec) == SMALL["n_layers"]
    sd = from_jax_variables(variables)
    assert tuple(sd["blocks.1.attn.e2lsh_alpha"].shape) == (1, 8 + 6, 2)
    assert "static_alpha" not in sd
    model = HeptTransformer(TransformerConfig(in_dim=10, coords_dim=6, attn_impl="pallas", **kw),
                            torch.Generator().manual_seed(0))
    model.load_state_dict(sd)
    out = model(_t(x), _t(coords), _t(valid), perms=[_t(p, torch.int64) for p in rec])
    _close(out, jout, 1e-4, "output")
    torch.sum(out * _t(w_out)).backward()
    ref = from_jax_variables({"params": jgrads, "constants": variables["constants"]})
    for name, p in model.named_parameters():
        _close(p.grad, ref[name], 1e-3, name)


def test_train_step_matches_jax():
    """One train_step (dropout off, Adam lr 1e-2) against
    make_single_device_train_step on a tie-free event, the port on its own
    keys: loss 1e-5, gradient norm 1e-3, Adam's first moment 1e-3 of scale
    + 1e-7."""
    batch = _event(384)
    mk = {k: v for k, v in SMALL.items() if k != "padding_mode"}
    mk["dropout"] = 0.0
    loss_kw = dict(tau=0.05, dist_metric="l2_rbf")
    jcfg = JaxExperimentConfig(model_kwargs=dict(mk), attn_impl="xla", loss_kwargs=loss_kw)
    jmodel = JaxHept(jcfg.model_config(10, 6))
    variables = jax.block_until_ready(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), batch["x"][0], batch["coords"][0], batch["valid"][0]))
    tx = jax_make_optimizer("adam", schedule=make_lr_schedule("step", 1e-2))
    state = TrainState.create(variables, tx, jax.random.PRNGKey(1))
    step = jax.jit(make_single_device_train_step(make_model_apply(jmodel),
                                                 jax_make_loss_fn(jcfg), tx))
    new_state, jm = jax.block_until_ready(step(state, jax.tree_util.tree_map(jnp.asarray,
                                                                             batch)))
    cfg = ExperimentConfig(model_kwargs=dict(mk), device="cpu", attn_impl="pallas",
                           loss_kwargs=loss_kw)
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


BASE = dict(h_dim=8, num_heads=2, n_layers=2, block_size=BS, n_hashes=2, num_regions=16,
            num_w_per_dist=10)


@pytest.mark.parametrize("path", [{}, SHARED, STATIC], ids=["dynamic", "dynamic_shared",
                                                            "static_plan"])
@pytest.mark.parametrize("flag", ["unsort_pack", "sort_pack"])
def test_fp8_transport_is_refused(path, flag):
    """Fault F1 and the fp8 unsort: `unsort_pack: "fp8"` (JAX's e4m3 ratio
    transport) runs where JAX runs it (`test_torch_static_family.py`) and
    is refused, on every path, with the merged-row unsorts JAX asserts
    against (fold_unsort, and unsort_rows after the sort); a sort_pack
    "fp8" (JAX documents the encoding for the unsort only) is refused on
    every path, instead of running as the bf16 transport."""
    extra = dict(fold_unsort=True) if flag == "unsort_pack" else {}
    cfg = TransformerConfig(in_dim=10, coords_dim=6, **BASE, **path, **extra, **{flag: "fp8"})
    reason = "merged-row unsorts" if flag == "unsort_pack" else "Not queued"
    with pytest.raises(NotImplementedError, match=reason):
        cfg.check_supported()


@pytest.mark.parametrize("bad", [
    dict(SHARED, kernel_bf16=True, bucket_shards=2),
    dict(qkv_post_sort=True, kernel_center=True),  # no shared q/k copy
    dict(SHARED, sort_pack=True, bucket_shards=2),
    dict(SHARED, unsort_pack=True, bucket_shards=2),
    dict(share_heads=True),  # share_heads needs the post-sort projections
    dict(SHARED, gather_sort=True, bucket_shards=2),
    dict(SHARED, head_shards=2),
], ids=["kernel_bf16", "kernel_center", "sort_pack", "unsort_pack", "pre_sort_share_heads",
        "gather_sort", "head_shards"])
def test_dynamic_share_heads_refusals(bad):
    """What stays refused around the dynamic-key post-sort paths: the bf16
    modes and gather_sort under bucket shards (JAX's bucket core runs f32
    and takes no gather_sort), kernel_center without a shared q/k copy,
    share_heads under head sharding (JAX's shard_map cannot split its
    one-head e2lsh_alpha), share_heads without the post-sort projections.
    (The bf16 modes, gather_sort and the paths without share_heads
    themselves run: `test_torch_post_sort.py`, `test_torch_gather_sort.py`,
    `test_torch_dynamic_bf16.py`.)"""
    with pytest.raises(NotImplementedError):
        TransformerConfig(in_dim=10, coords_dim=6, **dict(BASE, **bad)).check_supported()


@pytest.mark.parametrize("mode", [
    dict(qkv_post_sort=True, shared_sort=True, head_shards=2),  # post-sort without share_heads
    dict(qkv_post_sort=True, hash_shards=2),
], ids=["no_share_heads", "post_sort_alone"])
def test_formerly_refused_sharded_post_sort_is_accepted(mode):
    """Head / hash sharding of the post-sort paths without share_heads,
    once refused here, passes `check_supported`; it is held against JAX's
    TP step in `test_torch_tp_post_sort.py`."""
    TransformerConfig(in_dim=10, coords_dim=6, **dict(BASE, **mode)).check_supported()


@pytest.mark.parametrize("bad", [
    dict(STATIC, bucket_shards=2),  # the static plan
    dict(bucket_shards=2),  # per-head dynamic keys
    dict(SHARED, bucket_shards=2, head_shards=2),
    dict(SHARED, bucket_shards=2, hash_shards=2),
    dict(SHARED, bucket_transport="ring"),
    dict(BASE, attn_type="performer", bucket_shards=2),
], ids=["static_plan", "per_head_keys", "head_tp", "hash_tp", "transport", "baseline"])
def test_bucket_shard_refusals(bad):
    """What JAX's bucket SP asserts (`hept_tpu/models/attention/hept.py:
    174-179`), and head / hash sharding beside it, are refused."""
    with pytest.raises(NotImplementedError):
        TransformerConfig(in_dim=10, coords_dim=6, **dict(BASE, **bad)).check_supported()


def test_supported_share_heads_paths():
    TransformerConfig(in_dim=10, coords_dim=6, **BASE, **SHARED).check_supported()
    TransformerConfig(in_dim=10, coords_dim=6, **BASE, **SHARED, unsort_rows=True,
                      bucket_shards=4, bucket_transport="distributed").check_supported()
