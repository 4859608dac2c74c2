"""Zero padding and `use_ckpt` under the bucket-axis SP (`parallel/bp.py`)
against the JAX package's (`hept_tpu/parallel/bp.py`) on the conftest's
virtual CPU devices.

One spawn per world size (2 and 4 gloo ranks, processes of
`torch_parallel_workers.py:bucket_padding_task`) runs both parts:
- `bucket_sharded_core` over all the ranks with invalid rows (the last 20,
  not a whole bucket) and float AND codes, each transport, against JAX's
  `make_bucket_sharded_attention` (its own invalid-row case is
  `tests/test_bucket_sharding.py:71`): output on the valid rows and the
  gradients of x, coords, wq, wk, wv, sqrt_w through a cotangent that is
  zero on the invalid rows (the model reads nothing there) at
  `test_torch_bucket_sp.py`'s bars (rtol 1e-4, atol 2e-5 of scale);
- `make_bucket_train_step` on a ("data", "buckets") mesh of (1, 2) / (2, 2)
  ranks, one Adam step on events of 192 and 170 points in 192 rows (22 pad
  rows), each transport: zero padding (the pads invalid, `geo_code`'s float
  codes), zero padding with use_ckpt and replicate padding with use_ckpt,
  each against JAX's `make_bucket_train_step` of the same config and
  transport (loss rtol 1e-5, gradient norm rtol 1e-4, JAX's own bars,
  `tests/test_bucket_sharding.py:262-263`); zero padding against the
  port's single-device zero-padded step (loss 1e-5, gradient norm 1e-4 and
  every parameter gradient 1e-4 of scale); each use_ckpt run the bits of
  the same run without it.
Replicate padding is held against JAX with use_ckpt only: without it the
port's own step gives the bits (`test_ckpt_gives_the_plain_bits`), and its
pads tie with their source rows, which JAX's unstable sort may bucket apart
where the port's stable one does not (`torch_dynamic_keys.py`); zero
padding's pads are invalid and identical, so their ties move nothing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hept_tpu_torch.data.batching import pack_events  # noqa: E402
from hept_tpu_torch.data.synthetic import synthetic_tracking_event  # noqa: E402
from hept_tpu_torch.train import trainer  # noqa: E402
from hept_tpu_torch.train.config import ExperimentConfig  # noqa: E402
from hept_tpu_torch.utils.convert import from_jax_variables  # noqa: E402
from test_torch_bucket_sp import BS, LOSS, STEP_SIZES, _close, _core_inputs, _jit_run  # noqa: E402
from torch_ranks import spawn  # noqa: E402

CORE_MODES = {"replicated": dict(transport="replicated"),
              "distributed": dict(transport="distributed", cap_factor=4.0)}
TRANSPORTS = tuple(CORE_MODES)
MK = dict(h_dim=8, num_heads=2, n_layers=2, block_size=BS, n_hashes=2, num_regions=9,
          num_w_per_dist=3, dropout=0.0, qkv_post_sort=True, shared_sort=True,
          share_heads=True)
# name -> (padding_mode, use_ckpt, held against JAX)
RUNS = {"zero": ("zero", False, True), "zero_ckpt": ("zero", True, True),
        "replicate": ("replicate", False, False), "replicate_ckpt": ("replicate", True, True)}


def _exp(name):
    padding, ckpt = RUNS[name][:2]
    return dict(model_kwargs=dict(MK, use_ckpt=ckpt), attn_impl="xla", loss_kwargs=LOSS,
                batch_size=2, padding_mode=padding)


def _batch():
    evs = [synthetic_tracking_event(np.random.default_rng(s), n_points=n, pairs_per_point=8)
           for s, n in ((3, 192), (4, 170))]
    batch = pack_events(evs, block_size=BS, n_max=192, window_pairs=128)
    assert int((~batch["valid"]).sum()) == 22
    return batch


def _jax_core(world, a, invalid):
    """JAX's bucket-sharded layer with invalid rows on `world` virtual
    devices, each transport: output (n, h * d) rows and the six
    gradients."""
    import jax
    import jax.numpy as jnp

    from hept_tpu.parallel.bp import make_bucket_sharded_attention
    from hept_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(world, ("buckets",), (world,))
    h, d, n = a["wq"].shape[0], a["wq"].shape[2], a["x"].shape[1]
    w = a["cot"].T.reshape(h, d, n)
    res = {}
    for name, kw in CORE_MODES.items():
        fn = make_bucket_sharded_attention(mesh, "buckets", block_size=BS, **kw)

        def loss(*diff):
            out = fn(*diff, jnp.asarray(a["alpha"]), jnp.asarray(a["codes"]),
                     jnp.asarray(invalid))
            return jnp.sum(out * w), out

        diff = [jnp.asarray(a[k]) for k in ("x", "coords", "wq", "wk", "wv", "sqrt_w")]
        (_, out), grads = _jit_run(jax.value_and_grad(loss, argnums=tuple(range(6)),
                                                      has_aux=True), *diff)
        res[name] = (np.asarray(out).reshape(h * d, n).T, [np.asarray(g) for g in grads])
    return res


def _jax_steps(sizes, batch):
    """JAX's make_bucket_train_step on a (data, buckets) mesh of `sizes`
    for each run held against it and each transport: (loss, grad_norm);
    and the initial variables (the same for every run)."""
    import jax
    import jax.numpy as jnp

    from hept_tpu.models import HeptTransformer as JaxHept
    from hept_tpu.parallel.bp import make_bucket_train_step
    from hept_tpu.parallel.mesh import make_mesh
    from hept_tpu.train.config import ExperimentConfig as JaxExperimentConfig
    from hept_tpu.train.optim import make_optimizer
    from hept_tpu.train.state import TrainState
    from hept_tpu.train.trainer import make_loss_fn

    mesh = make_mesh(sizes[0] * sizes[1], ("data", "buckets"), sizes)
    tx = make_optimizer("adam", lr=1e-3)
    variables, res = None, {}
    for name, (_, _, held) in RUNS.items():
        if not held:
            continue
        jcfg = JaxExperimentConfig(**_exp(name))
        cfg = jcfg.model_config(10, 6)
        if variables is None:
            variables = jax.block_until_ready(jax.jit(JaxHept(cfg).init)(
                jax.random.PRNGKey(0), batch["x"][0], batch["coords"][0], batch["valid"][0]))
        for transport in TRANSPORTS:
            step = make_bucket_train_step(JaxHept, cfg, make_loss_fn(jcfg), tx, mesh,
                                          transport=transport, cap_factor=4.0)
            _, m = _jit_run(step, TrainState.create(variables, tx, jax.random.PRNGKey(1)),
                            jax.tree_util.tree_map(jnp.asarray, batch))
            res[name, transport] = (float(m["loss"]), float(m["grad_norm"]))
    return variables, res


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def padded_run(request, tmp_path_factory):
    world = request.param
    a = _core_inputs(world, seed=11)
    n = a["x"].shape[1]
    invalid = np.arange(n) >= n - 20
    # an invalid row's output depends on which bucket the tie among the
    # invalid rows puts it in, which JAX's unstable sort leaves open; the
    # model never reads it (the next layer zeroes the row, the loss masks
    # it), so the cotangent is zero there and the output is compared on the
    # valid rows
    a["cot"][invalid] = 0.0
    a["codes"] = a["codes"] + np.random.default_rng(1).uniform(
        0, 0.5, size=a["codes"].shape[:1] + (1, n)).astype(np.float32)  # float codes
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()}
    core_in = dict(t, invalid=torch.from_numpy(invalid), block_size=BS, modes=CORE_MODES)
    batch = _batch()
    variables, jstep = _jax_steps(STEP_SIZES[world], batch)
    state = from_jax_variables(variables)
    runs = {(name, tr): dict(exp=dict(_exp(name), attn_impl="pallas", device="cpu"),
                             transport=tr) for name in RUNS for tr in TRANSPORTS}
    outs = spawn("bucket_padding", world, tmp_path_factory.mktemp(f"padding{world}"), dict(
        core=core_in, step=dict(runs=runs, in_dim=10, coords_dim=6, sizes=STEP_SIZES[world],
                                state_dict=state, batch=batch, lr=1e-3)))
    # the port's single-device zero-padded step on the same weights and batch
    cfg = ExperimentConfig(**runs["zero", "replicated"]["exp"])
    model = trainer.build_model(cfg, 10, 6, None, "cpu")
    model.load_state_dict(state)
    m = trainer.train_step(model, trainer.make_optimizer(model.parameters(), lr=1e-3),
                           trainer.make_loss_fn(cfg), trainer.batch_to_device(batch, "cpu"))
    single = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
              "grads": {k: p.grad for k, p in model.named_parameters()}}
    return dict(outs=outs, jcore=_jax_core(world, a, invalid), jstep=jstep, single=single,
                valid=~invalid)


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_core_with_invalid_rows_matches_jax(padded_run, transport):
    want, wgrads = padded_run["jcore"][transport]
    for o in padded_run["outs"]:
        got = o["core"][transport]
        valid = padded_run["valid"]
        _close(got["out"].numpy()[valid], want[valid], 1e-4, 2e-5, "out")
        for g, w, nm in zip(got["grads"], wgrads, ("x", "coords", "wq", "wk", "wv", "sqrt_w")):
            _close(g.numpy(), w, 1e-4, 2e-5, nm)


@pytest.mark.parametrize("name", [n for n, r in RUNS.items() if r[2]])
@pytest.mark.parametrize("transport", TRANSPORTS)
def test_padded_step_matches_jax(padded_run, name, transport):
    jloss, jnorm = padded_run["jstep"][name, transport]
    for o in padded_run["outs"]:
        s = o["step"][name, transport]
        np.testing.assert_allclose(s["loss"], jloss, rtol=1e-5)
        np.testing.assert_allclose(s["grad_norm"], jnorm, rtol=1e-4)


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_zero_padded_step_matches_single_device(padded_run, transport):
    single = padded_run["single"]
    for o in padded_run["outs"]:
        s = o["step"]["zero", transport]
        np.testing.assert_allclose(s["loss"], single["loss"], rtol=1e-5)
        np.testing.assert_allclose(s["grad_norm"], single["grad_norm"], rtol=1e-4)
        for name, g in single["grads"].items():
            _close(s["grads"][name].numpy(), g.numpy(), 1e-4, 1e-4, name)


@pytest.mark.parametrize("padding", ["zero", "replicate"])
@pytest.mark.parametrize("transport", TRANSPORTS)
def test_ckpt_gives_the_plain_bits(padded_run, padding, transport):
    """use_ckpt's recompute re-issues the layer's all-gathers and
    all-to-alls in the backward on the recorded sort orders: the loss, the
    gradient norm and every gradient are the plain step's, bit for bit."""
    for o in padded_run["outs"]:
        a, b = o["step"][f"{padding}_ckpt", transport], o["step"][padding, transport]
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
        for k, g in b["grads"].items():
            assert torch.equal(a["grads"][k], g), k
