"""The port's bucket-axis SP (`parallel/bp.py`) against the JAX package's
(`hept_tpu/parallel/bp.py`) on the conftest's virtual CPU devices.

One spawn per world size (2 and 4 gloo ranks, processes of
`torch_parallel_workers.py`) runs both parts:
- `bucket_sharded_core` over all the ranks, each transport, against JAX's
  `make_bucket_sharded_attention` on a "buckets" mesh of the same size:
  output and the gradients of x, coords, wq, wk, wv, sqrt_w at JAX's bars
  (rtol 1e-4, atol 2e-5 of scale, `tests/test_bucket_sharding.py`); the
  overflow case (cap_factor 1e-6) gives NaN everywhere;
- `make_bucket_train_step` on a ("data", "buckets") mesh of (1, 2) / (2, 2)
  ranks, each transport, one step on two 192-point events (no pads, so no
  tied keys): loss (rtol 1e-5) and gradient norm (rtol 1e-4) against JAX's
  `make_bucket_train_step` on the matching mesh (JAX's own bars against its
  single-device step, `tests/test_bucket_sharding.py:262-263`), and loss
  and every parameter gradient against the port's single-device step
  (loss 1e-5, gradients 1e-4 of scale).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hept_tpu_torch.data.batching import pack_events  # noqa: E402
from hept_tpu_torch.data.synthetic import synthetic_tracking_event  # noqa: E402
from hept_tpu_torch.train import trainer  # noqa: E402
from hept_tpu_torch.train.config import ExperimentConfig  # noqa: E402
from hept_tpu_torch.utils.convert import from_jax_variables  # noqa: E402
from torch_ranks import spawn  # noqa: E402

BS = 16
CORE_MODES = {"replicated": dict(transport="replicated"),
              "distributed": dict(transport="distributed", cap_factor=4.0),
              "overflow": dict(transport="distributed", cap_factor=1e-6)}
# scan_layers: JAX's layers as one scanned block (a smaller compile); the
# port reads and ignores it
MK = dict(h_dim=8, num_heads=2, n_layers=2, block_size=BS, n_hashes=2, num_regions=9,
          num_w_per_dist=3, dropout=0.0, qkv_post_sort=True, shared_sort=True,
          share_heads=True, scan_layers=True)
LOSS = dict(tau=0.05, dist_metric="l2_rbf")
STEP_SIZES = {2: (1, 2), 4: (2, 2)}


def _close(got, want, rtol, atol_scale, name=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * scale, err_msg=name)


def _jit_run(fn, *args):
    """fn(*args) as one jitted call, compiled at XLA's optimisation level 0
    (a reference compiled once and run once) and waited for."""
    import jax

    compiled = jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    return jax.block_until_ready(compiled(*args))


def _core_inputs(world, seed=7, h=2, dm=8, d=8, cd=3, c=2):
    """`tests/test_bucket_sharding.py:_inputs`' recipe at 4 buckets a rank."""
    rng = np.random.default_rng(seed)
    n = 4 * world * BS
    x = rng.normal(size=(dm, n)).astype(np.float32)
    coords = rng.normal(size=(cd, n)).astype(np.float32)
    wq, wk, wv = (rng.normal(size=(h, dm, d)).astype(np.float32) * 0.2 for _ in range(3))
    sqrt_w = np.abs(rng.normal(size=(h, cd)).astype(np.float32)) + 0.5
    alpha = rng.normal(size=(1, dm + cd, c)).astype(np.float32)
    codes = np.broadcast_to(rng.integers(0, 4, size=(c, 1, n)), (c, h, n)).astype(np.float32)
    cot = rng.normal(size=(n, h * d)).astype(np.float32)
    return dict(x=x, coords=coords, wq=wq, wk=wk, wv=wv, sqrt_w=sqrt_w, alpha=alpha,
                codes=codes, cot=cot)


def _jax_core(world, a):
    """JAX's bucket-sharded layer on `world` virtual devices, each
    transport: output (n, h * d) rows and the six gradients; and the
    overflow case's output."""
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
            out = fn(*diff, jnp.asarray(a["alpha"]), jnp.asarray(a["codes"]), None)
            return jnp.sum(out * w), out

        diff = [jnp.asarray(a[k]) for k in ("x", "coords", "wq", "wk", "wv", "sqrt_w")]
        (_, out), grads = _jit_run(jax.value_and_grad(loss, argnums=tuple(range(6)),
                                                      has_aux=True), *diff)
        res[name] = (np.asarray(out).reshape(h * d, n).T, [np.asarray(g) for g in grads])
    return res


def _batch(n=192, seeds=(3, 4)):
    evs = [synthetic_tracking_event(np.random.default_rng(s), n_points=n, pairs_per_point=8)
           for s in seeds]
    batch = pack_events(evs, block_size=BS, n_max=n, window_pairs=128)
    assert batch["valid"].all()
    return batch


def _jax_step(sizes, batch, exp):
    """JAX's make_bucket_train_step on a (data, buckets) mesh of `sizes`,
    each transport: (loss, grad_norm); and its initial variables."""
    import jax
    import jax.numpy as jnp

    from hept_tpu.models import HeptTransformer as JaxHept
    from hept_tpu.parallel.bp import make_bucket_train_step
    from hept_tpu.parallel.mesh import make_mesh
    from hept_tpu.train.config import ExperimentConfig as JaxExperimentConfig
    from hept_tpu.train.optim import make_optimizer
    from hept_tpu.train.state import TrainState
    from hept_tpu.train.trainer import make_loss_fn

    jcfg = JaxExperimentConfig(**exp)
    cfg = jcfg.model_config(10, 6)
    variables = jax.block_until_ready(jax.jit(JaxHept(cfg).init)(
        jax.random.PRNGKey(0), batch["x"][0], batch["coords"][0], batch["valid"][0]))
    tx = make_optimizer("adam", lr=1e-3)
    mesh = make_mesh(sizes[0] * sizes[1], ("data", "buckets"), sizes)
    res = {}
    for transport in ("replicated", "distributed"):
        step = make_bucket_train_step(JaxHept, cfg, make_loss_fn(jcfg), tx, mesh,
                                      transport=transport, cap_factor=4.0)
        _, m = _jit_run(step, TrainState.create(variables, tx, jax.random.PRNGKey(1)),
                        jax.tree_util.tree_map(jnp.asarray, batch))
        res[transport] = (float(m["loss"]), float(m["grad_norm"]))
    return variables, res


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def bucket_run(request, tmp_path_factory):
    world = request.param
    a = _core_inputs(world)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()}
    core_in = dict(t, invalid=None, block_size=BS, modes=CORE_MODES)
    batch = _batch()
    exp = dict(model_kwargs=MK, attn_impl="xla", loss_kwargs=LOSS, batch_size=2)
    variables, jstep = _jax_step(STEP_SIZES[world], batch, exp)
    state = from_jax_variables(variables)
    step_in = dict(exp=dict(exp, attn_impl="pallas", device="cpu"), in_dim=10, coords_dim=6,
                   sizes=STEP_SIZES[world], state_dict=state, batch=batch, lr=1e-3)
    outs = spawn("bucket_sp", world, tmp_path_factory.mktemp(f"bucket{world}"),
                 {"core": core_in, "step": step_in})
    # the port's single-device step on the same weights and batch
    cfg = ExperimentConfig(**step_in["exp"])
    model = trainer.build_model(cfg, 10, 6, None, "cpu")
    model.load_state_dict(state)
    m = trainer.train_step(model, trainer.make_optimizer(model.parameters(), lr=1e-3),
                           trainer.make_loss_fn(cfg), trainer.batch_to_device(batch, "cpu"))
    single = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
              "grads": {k: p.grad for k, p in model.named_parameters()}}
    return dict(world=world, outs=outs, jcore=_jax_core(world, a), jstep=jstep, single=single)


@pytest.mark.parametrize("transport", ["replicated", "distributed"])
def test_core_forward_matches_jax(bucket_run, transport):
    want = bucket_run["jcore"][transport][0]
    for o in bucket_run["outs"]:
        _close(o["core"][transport]["out"].numpy(), want, 1e-4, 2e-5, "out")


@pytest.mark.parametrize("transport", ["replicated", "distributed"])
def test_core_gradients_match_jax(bucket_run, transport):
    want = bucket_run["jcore"][transport][1]
    for o in bucket_run["outs"]:
        for g, w, nm in zip(o["core"][transport]["grads"], want,
                            ("x", "coords", "wq", "wk", "wv", "sqrt_w")):
            _close(g.numpy(), w, 1e-4, 2e-5, nm)


def test_core_overflow_is_nan(bucket_run):
    """cap_factor 1e-6 (a cap of one point a cell) overflows: every output
    is NaN on every rank, as JAX's."""
    assert np.isnan(bucket_run["jcore"]["overflow"][0]).all()
    for o in bucket_run["outs"]:
        assert torch.isnan(o["core"]["overflow"]["out"]).all()


@pytest.mark.parametrize("transport", ["replicated", "distributed"])
def test_train_step_matches_jax(bucket_run, transport):
    jloss, jnorm = bucket_run["jstep"][transport]
    for o in bucket_run["outs"]:
        s = o["step"][transport]
        np.testing.assert_allclose(s["loss"], jloss, rtol=1e-5)
        np.testing.assert_allclose(s["grad_norm"], jnorm, rtol=1e-4)


@pytest.mark.parametrize("transport", ["replicated", "distributed"])
def test_train_step_matches_single_device(bucket_run, transport):
    single = bucket_run["single"]
    for o in bucket_run["outs"]:
        s = o["step"][transport]
        np.testing.assert_allclose(s["loss"], single["loss"], rtol=1e-5)
        np.testing.assert_allclose(s["grad_norm"], single["grad_norm"], rtol=1e-4)
        for name, g in single["grads"].items():
            _close(s["grads"][name].numpy(), g.numpy(), 1e-4, 1e-4, name)
