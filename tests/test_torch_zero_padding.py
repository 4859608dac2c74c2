"""Zero padding (the reference's src variant, JAX's default
`padding_mode`) in the port against the JAX package: `geo_code` and the
zero branch of `prepare_event` bit for bit, then the parity, the dynamic
share_heads and the static-plan models with carried weights (output to
1e-4, every parameter gradient to 1e-3 of its scale, f32: the tolerances of
`test_torch_parity_model.py`), one train step, and the flat-batching
refusal. Pads are invalid rows keyed to +BIG, so the model comparisons run
the port on JAX's recorded sort orders or its static plan
(`torch_dynamic_keys.py`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hept_tpu.core.regions import geo_code as jax_geo_code  # noqa: E402
from hept_tpu.core.regions import region_codes as jax_region_codes  # noqa: E402
from hept_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from hept_tpu.models.transformer import _prepare_event  # noqa: E402
from hept_tpu_torch.core.regions import geo_code, get_regions, region_codes  # noqa: E402
from hept_tpu_torch.models.transformer import (  # noqa: E402
    HeptTransformer,
    TransformerConfig,
    make_flat_batched_apply,
    prepare_event,
)
from torch_dynamic_keys import (  # noqa: E402
    BASE,
    SHARE_HEADS,
    STATIC,
    compare_model,
    event,
    t,
)

ZERO = dict(padding_mode="zero")


def test_geo_code_matches_jax():
    """Region ranks over the padded length (pads last) and the mixed-radix
    float code, bit for bit."""
    rng = np.random.default_rng(0)
    n = 200
    coords = rng.normal(size=(n, 6)).astype(np.float32)
    valid = np.arange(n) < 171
    regions = get_regions(torch.Generator().manual_seed(3), 16, 2, 3)
    eta, phi = region_codes(t(coords), regions, valid_mask=t(valid))
    jeta, jphi = jax_region_codes(jnp.asarray(coords), jnp.asarray(regions.numpy()),
                                  valid_mask=jnp.asarray(valid))
    np.testing.assert_array_equal(eta.numpy(), np.asarray(jeta))
    np.testing.assert_array_equal(phi.numpy(), np.asarray(jphi))
    got = geo_code(eta, phi, regions)
    want = np.asarray(jax_geo_code(jeta, jphi, jnp.asarray(regions.numpy())))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 3, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prepare_event_zero_matches_jax():
    """The zero branch: codes from `geo_code`, invalid = ~valid, pad coords
    zeroed, x and the row order untouched; bit for bit against JAX's
    `_prepare_event`."""
    batch = event()
    x, coords, valid = batch["x"][0], batch["coords"][0], batch["valid"][0]
    assert not valid.all()
    regions = get_regions(torch.Generator().manual_seed(1), 16, 2, 2)
    cfg = JaxConfig(in_dim=10, coords_dim=6, **BASE, **ZERO)
    want = jax.jit(lambda a, b, m, r: _prepare_event(a, b, m, r, cfg)[:4])(
        x, coords, valid, jnp.asarray(regions.numpy()))
    got = prepare_event(t(x), t(coords), t(valid), regions, BASE["block_size"],
                        padding_mode="zero")
    for g, w, nm in zip(got, want, ("x", "coords", "codes", "invalid")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=nm)
    assert got[2].dtype == torch.float32
    np.testing.assert_array_equal(got[3].numpy(), ~valid)


@pytest.mark.parametrize("path", [{}, SHARE_HEADS, STATIC],
                         ids=["parity", "share_heads", "static_plan"])
def test_zero_padded_model_matches_jax(monkeypatch, path):
    """Each path JAX runs zero padding on, with JAX's weights and constants:
    the parity model (per-head keys before the sort), the dynamic share_heads
    model and the static plan (whose `static_bucket_plan` takes head 0's
    float codes), f32, JAX on its einsum path."""
    compare_model(monkeypatch, dict(path, **ZERO), 1e-4, 1e-3)


def test_zero_padded_train_step_matches_jax():
    """One train_step of the zero-padded parity model (dropout off, Adam lr
    1e-2) against `make_single_device_train_step` on an event without pads
    (tie-free keys, the port on its own): loss 1e-5, gradient norm 1e-3,
    Adam's first moment 1e-3 of scale + 1e-7."""
    from hept_tpu.models import HeptTransformer as JaxHept
    from hept_tpu.parallel.dp import make_single_device_train_step
    from hept_tpu.train.config import ExperimentConfig as JaxExperimentConfig
    from hept_tpu.train.optim import make_lr_schedule
    from hept_tpu.train.optim import make_optimizer as jax_make_optimizer
    from hept_tpu.train.state import TrainState
    from hept_tpu.train.trainer import make_loss_fn as jax_make_loss_fn
    from hept_tpu.train.trainer import make_model_apply
    from hept_tpu_torch.train import trainer
    from hept_tpu_torch.train.config import ExperimentConfig
    from hept_tpu_torch.utils.convert import from_jax_variables

    batch = event(384)
    mk = dict(BASE, dropout=0.0)
    loss_kw = dict(tau=0.05, dist_metric="l2_rbf")
    jcfg = JaxExperimentConfig(model_kwargs=dict(mk), attn_impl="xla", loss_kwargs=loss_kw,
                               padding_mode="zero")
    jmodel = JaxHept(jcfg.model_config(10, 6))
    variables = jax.block_until_ready(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), batch["x"][0], batch["coords"][0], batch["valid"][0]))
    tx = jax_make_optimizer("adam", schedule=make_lr_schedule("step", 1e-2))
    step = jax.jit(make_single_device_train_step(make_model_apply(jmodel),
                                                 jax_make_loss_fn(jcfg), tx))
    new_state, jm = jax.block_until_ready(step(
        TrainState.create(variables, tx, jax.random.PRNGKey(1)),
        jax.tree_util.tree_map(jnp.asarray, batch)))
    cfg = ExperimentConfig(model_kwargs=dict(mk), device="cpu", attn_impl="pallas",
                           loss_kwargs=loss_kw, padding_mode="zero")
    model = trainer.build_model(cfg, 10, 6, torch.Generator().manual_seed(0), "cpu")
    assert model.cfg.padding_mode == "zero"
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


def test_zero_padding_flat_batching_is_refused():
    """Zero-mode pads sort to the end of the whole flat row, so an event
    whose real count is not a multiple of block_size would share a bucket
    with the next event: flat batching refuses it, as JAX asserts
    (`hept_tpu/models/transformer.py:906`)."""
    model = HeptTransformer(TransformerConfig(in_dim=10, coords_dim=6, **BASE, **ZERO),
                            torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="replicate"):
        make_flat_batched_apply(model)
