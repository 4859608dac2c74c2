"""Batches of events: the port's flat batching (`make_flat_batched_apply`,
stacked `sort_events`) and the `batch_mode: flat` train step against the
JAX package's on the same packed batch and carried weights, flat against
the event loop inside the port, `iter_batches(drop_last=)` and `prefetch`.

Events of 96 and 80 points with block_size 16 have no replication pads, so
no two rows share a sort key and JAX's unstable sorts cannot order a bucket
differently (the inert slots all key to +BIG and fill whole buckets whose
rows are masked). Tolerances as `test_torch_model.py`: f32 modes forward
1e-4 and gradients 1e-3 of scale; the hept_acc flags with JAX's slab2
kernels in interpret mode 2e-2 of scale; a train step's loss 1e-5.
"""

import contextlib
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hept_tpu_torch.data.batching import pack_events  # noqa: E402
from hept_tpu_torch.data.datasets import make_synthetic_tracking  # noqa: E402
from hept_tpu_torch.data.prefetch import prefetch  # noqa: E402
from hept_tpu_torch.data.synthetic import synthetic_tracking_event  # noqa: E402
from hept_tpu_torch.models.transformer import (  # noqa: E402
    HeptTransformer,
    TransformerConfig,
    make_batched_apply,
    make_flat_batched_apply,
)
from hept_tpu_torch.train import trainer  # noqa: E402
from hept_tpu_torch.train.config import ExperimentConfig  # noqa: E402
from hept_tpu_torch.utils.convert import from_jax_variables  # noqa: E402

from test_torch_model import ACC_MODES, F32_MODES, _tpu_kernels  # noqa: E402

STATIC = dict(h_dim=8, num_heads=2, n_layers=2, block_size=16, n_hashes=2, static_rounds=4,
              num_regions=16, num_w_per_dist=10, padding_mode="replicate", qkv_post_sort=True,
              shared_sort=True, share_heads=True, static_keys="x0", unsort_rows=True,
              dropout=0.0)
DYNAMIC = dict(h_dim=8, num_heads=2, n_layers=2, block_size=16, n_hashes=2, num_regions=9,
               num_w_per_dist=3, padding_mode="replicate", dropout=0.0)


def _batch(sizes=(96, 80), seed=5):
    rng = np.random.default_rng(seed)
    evs = [synthetic_tracking_event(rng, n_points=n, pairs_per_point=8) for n in sizes]
    return pack_events(evs, block_size=16, n_max=112, window_pairs=128)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _models(kw, jax_impl, port_impl):
    from hept_tpu.models import HeptTransformer as JaxHept
    from hept_tpu.models import TransformerConfig as JaxConfig

    jcfg = JaxConfig(in_dim=10, coords_dim=6, attn_impl=jax_impl, sort_ops=8, **kw)
    cfg = TransformerConfig(in_dim=10, coords_dim=6, attn_impl=port_impl, **kw)
    return JaxHept(jcfg), jcfg, cfg


def _compare_flat(kw, fwd_tol, grad_tol, jax_impl="xla", port_impl="pallas", ctx=None):
    from hept_tpu.models.transformer import make_flat_batched_apply as jax_flat

    batch = _batch()
    x, c, v = batch["x"], batch["coords"], batch["valid"]
    jmodel, _, cfg = _models(kw, jax_impl, port_impl)
    w_out = np.random.default_rng(2).normal(size=x.shape[:2] + (4,)).astype(np.float32)
    w_out *= v[..., None]
    japply = jax_flat(jmodel)
    with ctx or contextlib.nullcontext():
        # initialised on the flat batch: a stacked model needs n % (B * bs) == 0
        variables = jax.block_until_ready(jax.jit(jmodel.init)(
            jax.random.PRNGKey(1), x.reshape(-1, x.shape[-1]), c.reshape(-1, c.shape[-1]),
            v.reshape(-1)))

        def jloss(params, x, c, v):
            out = japply({"params": params, "constants": variables["constants"]}, x, c, v)
            return jnp.sum(out * w_out), out

        (_, jout), jgrads = jax.block_until_ready(
            jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables["params"], x, c, v))
    model = HeptTransformer(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(from_jax_variables(variables))
    out = make_flat_batched_apply(model)(_t(x), _t(c), _t(v))
    torch.sum(out * _t(w_out)).backward()
    jout = np.asarray(jout, np.float32)
    scale = np.abs(jout).max()
    np.testing.assert_allclose(out.detach().numpy()[v], jout[v], rtol=fwd_tol,
                               atol=fwd_tol * scale)
    ref = from_jax_variables({"params": jgrads, "constants": variables["constants"]})
    for name, p in model.named_parameters():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=grad_tol,
                                   atol=grad_tol * max(np.abs(r).max(), 1e-12), err_msg=name)
    return model, batch


@pytest.mark.parametrize("sort_events", [1, 2])
def test_flat_static_f32_matches_jax(sort_events):
    """The static plan, f32 modes: one flat forward of two events with the
    batch index in the AND codes, and stacked (`sort_events` 2: each event
    its own plan row), against JAX's `make_flat_batched_apply`."""
    _compare_flat(dict(STATIC, **F32_MODES, sort_events=sort_events), 1e-4, 1e-3,
                  jax_impl="slab2", port_impl="slab2")


def test_flat_static_hept_acc_matches_jax_kernels(monkeypatch):
    """The hept_acc flags flat, JAX running its slab2 kernels (K1/K2) in
    interpret mode: 2e-2 of scale."""
    import hept_tpu.ops.bucket_attn as jba

    try:
        _compare_flat(dict(STATIC, **ACC_MODES), 2e-2, 2e-2, jax_impl="slab2",
                      port_impl="slab2", ctx=_tpu_kernels(monkeypatch))
    finally:
        jba.hept_attention_core_xcols.clear_cache()


def test_flat_dynamic_matches_jax_and_the_loop():
    """The dynamic-key path (reference parity) flat against JAX, and the
    port's flat forward against its event loop (same buckets: 1e-5)."""
    model, batch = _compare_flat(DYNAMIC, 1e-4, 1e-3)
    x, c, v = (_t(batch[k]) for k in ("x", "coords", "valid"))
    with torch.no_grad():
        flat = make_flat_batched_apply(model)(x, c, v)
        loop = make_batched_apply(model)(x, c, v)
    np.testing.assert_allclose(flat.numpy()[batch["valid"]], loop.numpy()[batch["valid"]],
                               rtol=1e-5, atol=1e-5 * loop.abs().max().item())


def test_flat_equals_loop_with_replication_pads():
    """The static plan, three events of 90, 75 and 100 points (replication
    pads, so ties): stable sorts put tied rows in the same order flat and
    event by event, so the flat forward is the loop's to 1e-5 of scale.

    Not so on the dynamic-key path at three events: the batch index sits
    above each AND code, so key = hash + code * span is larger and float32
    rounds its hash part coarser than the loop's, and near-equal hashes
    can change order (max |flat - loop| 3.1e-3 on these events; 6e-7 with
    the keys in float64). JAX's flat batching computes the same float32
    keys; the port keeps them."""
    batch = _batch((90, 75, 100), seed=7)
    cfg = TransformerConfig(in_dim=10, coords_dim=6, attn_impl="slab2", **STATIC)
    model = HeptTransformer(cfg, torch.Generator().manual_seed(3))
    x, c, v = (_t(batch[k]) for k in ("x", "coords", "valid"))
    with torch.no_grad():
        flat = make_flat_batched_apply(model)(x, c, v).numpy()
        loop = make_batched_apply(model)(x, c, v).numpy()
    m = batch["valid"]
    np.testing.assert_allclose(flat[m], loop[m], rtol=1e-5, atol=1e-5 * np.abs(loop).max())


def test_flat_train_step_matches_jax():
    """One `batch_mode: flat` loss + Adam step (lr 1e-2) against JAX's
    `make_model_apply(batch_mode="flat")` single-device step: loss 1e-5,
    gradient norm 1e-3, Adam's first moment 1e-3 of scale."""
    from hept_tpu.models import HeptTransformer as JaxHept
    from hept_tpu.parallel.dp import make_single_device_train_step
    from hept_tpu.train.config import ExperimentConfig as JaxExperimentConfig
    from hept_tpu.train.optim import make_lr_schedule
    from hept_tpu.train.optim import make_optimizer as jax_make_optimizer
    from hept_tpu.train.state import TrainState
    from hept_tpu.train.trainer import make_loss_fn as jax_make_loss_fn
    from hept_tpu.train.trainer import make_model_apply

    batch = _batch()
    mk = {k: v for k, v in dict(STATIC, **F32_MODES).items() if k != "padding_mode"}
    kw = dict(model_kwargs=mk, attn_impl="slab2", batch_mode="flat",
              loss_kwargs=dict(tau=0.05, dist_metric="l2_rbf"))
    jcfg = JaxExperimentConfig(**kw)
    jmodel = JaxHept(jcfg.model_config(10, 6))
    variables = jax.block_until_ready(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), batch["x"][0], batch["coords"][0], batch["valid"][0]))
    tx = jax_make_optimizer("adam", schedule=make_lr_schedule("step", 1e-2))
    state = TrainState.create(variables, tx, jax.random.PRNGKey(1))
    step = jax.jit(make_single_device_train_step(
        make_model_apply(jmodel, batch_mode="flat"), jax_make_loss_fn(jcfg), tx))
    new_state, jm = jax.block_until_ready(step(state, jax.tree_util.tree_map(jnp.asarray,
                                                                              batch)))

    cfg = ExperimentConfig(device="cpu", **kw)
    model = trainer.build_model(cfg, 10, 6, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(from_jax_variables(variables))
    opt = trainer.make_optimizer(model.parameters(), lr=1e-2)
    m = trainer.train_step(model, opt, trainer.make_loss_fn(cfg),
                           trainer.batch_to_device(batch, "cpu"), batch_mode="flat")
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    mu = from_jax_variables({"params": new_state.opt_state.inner_state[0].mu,
                             "constants": variables["constants"]})
    for name, p in model.named_parameters():
        r = mu[name].numpy()
        np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(), r, rtol=1e-3,
                                   atol=1e-3 * np.abs(r).max() + 1e-7, err_msg=name)


def test_flat_refusals():
    """Flat batching needs HEPT; stacked events need the static plan."""
    cfg = TransformerConfig(in_dim=10, coords_dim=6, attn_type="performer", h_dim=8,
                            num_heads=2, n_layers=1)
    with pytest.raises(ValueError, match="HEPT"):
        make_flat_batched_apply(HeptTransformer(cfg, torch.Generator().manual_seed(0)))
    with pytest.raises(NotImplementedError, match="sort_events"):
        TransformerConfig(in_dim=10, coords_dim=6, attn_impl="pallas", sort_events=2,
                          **DYNAMIC).check_supported()
    model = HeptTransformer(TransformerConfig(in_dim=10, coords_dim=6, attn_impl="slab2",
                                              sort_events=2, **STATIC),
                            torch.Generator().manual_seed(0))
    b = _batch((96, 80, 64))
    with pytest.raises(ValueError, match="sort_events=2, got B=3"):
        make_flat_batched_apply(model)(_t(b["x"]), _t(b["coords"]), _t(b["valid"]))
    with pytest.raises(ValueError, match="batch_mode"):
        ExperimentConfig(batch_mode="stacked")


@pytest.mark.parametrize("drop_last,expect", [(None, [2, 2, 1]), (True, [2, 2]),
                                              (False, [2, 2, 1])])
def test_iter_batches_drop_last(drop_last, expect):
    """Eval keeps a trailing partial batch unless `drop_last`; training
    (a shuffle generator) drops it by default, as in JAX."""
    ds = make_synthetic_tracking(n_events=7, n_points=40, seed=0)  # 5 train events
    sizes = [b["x"].shape[0] for b in ds.iter_batches("train", 2, 16, drop_last=drop_last)]
    assert sizes == expect
    shuffled = list(ds.iter_batches("train", 2, 16, shuffle_rng=np.random.default_rng(0)))
    assert [b["x"].shape[0] for b in shuffled] == [2, 2]


def test_prefetch_order_depth_and_errors():
    """Items come in order through `transfer`; the worker runs at most
    `depth` items ahead of a consumer that has taken none (plus the one it
    holds); an error in the worker reaches the consumer after the items
    before it; closing early stops the worker."""
    produced = []

    def source(n, fail_at=None):
        for i in range(n):
            if i == fail_at:
                raise KeyError("boom")
            produced.append(i)
            yield i

    assert list(prefetch(source(10), transfer=lambda i: 2 * i, depth=3)) == \
        [2 * i for i in range(10)]

    produced.clear()
    it = prefetch(source(50), depth=2)
    assert next(it) == 0
    time.sleep(0.3)
    assert len(produced) <= 1 + 2 + 1  # the item taken, the queue, one in hand
    it.close()  # stops and joins the worker
    assert not any(t.name == "prefetch" and t.is_alive() for t in threading.enumerate())

    got = []
    with pytest.raises(KeyError, match="boom"):
        for i in prefetch(source(10, fail_at=4), depth=2):
            got.append(i)
    assert got == [0, 1, 2, 3]
    assert not any(t.name == "prefetch" and t.is_alive() for t in threading.enumerate())
