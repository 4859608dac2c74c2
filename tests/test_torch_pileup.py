"""The port's pileup task against the JAX package's: synthetic events and
their packing, the focal loss, AP / ROC-AUC / F1, the plateau schedule, the
whole pileup model (PID embedding, sigmoid head) on both pileup profiles with
carried weights, one Adam step, `evaluate`, the `run_one_seed` round trip and
the pileup YAMLs.

Every input is made with numpy from a seed and fed to both packages. JAX's
bucket attention runs its TPU column kernels (K6 / K7) in Pallas interpret
mode where the test says so, each JAX computation as one `jax.jit` on traced
inputs, waited for before the next dispatch: eager dispatch from the test
thread can deadlock with the interpreter's callback thread. JAX sorts
unstably and the port stably, so the model comparisons run the port on JAX's
own permutations (the parity profile) or its own static plan (hept_fast),
both recorded from JAX's run with `jax.debug.callback`.
"""

import contextlib
import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import hept_tpu.ops.bucket_attn as jba  # noqa: E402
from hept_tpu.data import batching as jbatching  # noqa: E402
from hept_tpu.data import datasets as jdatasets  # noqa: E402
from hept_tpu.data import synthetic as jsynthetic  # noqa: E402
from hept_tpu.models import HeptTransformer as JaxHept  # noqa: E402
from hept_tpu.ops.bucket_attn_pallas import bucket_rbf_attention_cols_pallas  # noqa: E402
from hept_tpu.parallel.dp import make_single_device_train_step  # noqa: E402
from hept_tpu.train.config import ExperimentConfig as JaxExperimentConfig  # noqa: E402
from hept_tpu.train.config import load_config as jax_load_config  # noqa: E402
from hept_tpu.train.losses import focal_loss as jax_focal_loss  # noqa: E402
from hept_tpu.train.metrics import binary_classification_metrics as jax_metrics  # noqa: E402
from hept_tpu.train.optim import PlateauState  # noqa: E402
from hept_tpu.train.optim import make_lr_schedule  # noqa: E402
from hept_tpu.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from hept_tpu.train.state import TrainState  # noqa: E402
from hept_tpu.train.trainer import evaluate as jax_evaluate  # noqa: E402
from hept_tpu.train.trainer import make_eval_step, make_model_apply  # noqa: E402
from hept_tpu.train.trainer import make_loss_fn as jax_make_loss_fn  # noqa: E402
from hept_tpu_torch.data.batching import pack_events, slab_friendly_n  # noqa: E402
from hept_tpu_torch.data.datasets import (  # noqa: E402
    SplitDataset,
    get_dataset,
    make_synthetic_pileup,
)
from hept_tpu_torch.data.synthetic import synthetic_pileup_event  # noqa: E402
from hept_tpu_torch.models.transformer import HeptTransformer  # noqa: E402
from hept_tpu_torch.train import trainer  # noqa: E402
from hept_tpu_torch.train.config import (  # noqa: E402
    CONFIG_ROOT,
    ExperimentConfig,
    profile_config,
)
from hept_tpu_torch.train.losses import focal_loss  # noqa: E402
from hept_tpu_torch.train.metrics import binary_classification_metrics  # noqa: E402
from hept_tpu_torch.train.optim import make_lr_scheduler  # noqa: E402
from hept_tpu_torch.train.state import CheckpointManager  # noqa: E402
from hept_tpu_torch.utils.convert import from_jax_variables  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
BS = 16
IN_DIM, COORDS_DIM = 8, 4  # the pileup events: 7 features + PID; eta, phi, x[:, :2]
PARITY = dict(h_dim=8, num_heads=2, n_layers=2, block_size=BS, n_hashes=2, num_regions=16,
              num_w_per_dist=10)
STATIC = dict(PARITY, static_rounds=4, qkv_post_sort=True, shared_sort=True, share_heads=True,
              static_keys="x0", unsort_rows=True, sort_ops=8)
F32_MODES = dict(sort_pack=False, unsort_pack=False, kernel_bf16=False, kernel_center=False)
FAST_MODES = dict(sort_pack=True, unsort_pack=True, kernel_bf16=True, kernel_center=True)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(got, want, tol, name=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=name)


def _jax_event(ev):
    return jbatching.Event(x=ev.x, coords=ev.coords, y=ev.y, is_neu=ev.is_neu)


def _batch(n_points, seed=5):
    """One pileup event packed to a multiple of BS (378 points: 6
    replication pads; 384: none)."""
    ev = synthetic_pileup_event(np.random.default_rng(seed), n_points=n_points)
    return pack_events([ev], block_size=BS)


# --- data ------------------------------------------------------------------


def test_pileup_event_and_packing_bit_equal_jax():
    """The generator draws the same event from a seed; pack_events packs y
    (f32) and is_neu (bool), zero beyond the event, exactly as JAX's; the
    dataset split, `get_dataset("synthetic-pileup")` included."""
    for seed, n in ((0, 300), (3, 377)):
        ev = synthetic_pileup_event(np.random.default_rng(seed), n_points=n)
        jev = jsynthetic.synthetic_pileup_event(np.random.default_rng(seed), n_points=n)
        for name in ("x", "coords", "y", "is_neu"):
            a, b = getattr(ev, name), getattr(jev, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert ev.cluster_ids is None and ev.pairs is None
    evs = [synthetic_pileup_event(np.random.default_rng(s), n_points=n)
           for s, n in ((1, 290), (2, 333))]
    got = pack_events(evs, BS, n_max=352)
    want = jbatching.pack_events([_jax_event(e) for e in evs], BS, n_max=352)
    assert set(got) == set(want) == {"x", "coords", "valid", "y", "is_neu"}
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert got["y"].dtype == np.float32 and got["is_neu"].dtype == bool
    assert not got["is_neu"][0, 290:].any() and not got["y"][0, 290:].any()

    ds = make_synthetic_pileup(n_events=10, n_points=200, seed=4)
    jds = jdatasets.make_synthetic_pileup(n_events=10, n_points=200, seed=4)
    for split in ("train", "valid", "test"):
        a, b = getattr(ds, split), getattr(jds, split)
        assert len(a) == len(b)
        for e, je in zip(a, b):
            assert np.array_equal(e.x, je.x) and np.array_equal(e.is_neu, je.is_neu)
    assert (ds.in_dim, ds.coords_dim) == (jds.in_dim, jds.coords_dim) == (IN_DIM, COORDS_DIM)
    named = get_dataset("synthetic-pileup", seed=4, n_events=10, n_points=200)
    assert all(np.array_equal(e.y, je.y) for e, je in zip(named.train, jds.train))


# --- focal loss, metrics, plateau -------------------------------------------


@pytest.mark.parametrize("case", ["random", "clip_edges", "no_mask"])
def test_focal_loss_and_gradient_match_jax(case):
    """focal_loss and its gradient in the probabilities against JAX's
    `focal_loss` / `jax.grad`, alpha 0.25 and 0.5, gamma 2 and 1.5: value to
    1e-6 relative, gradient to 1e-5 x its scale (f32 both sides). The
    clip-edge case puts probabilities at 0, 1, below 1e-7 and just inside
    the clip range, where the gradient is zero outside."""
    rng = np.random.default_rng(11)
    n = 257
    p = rng.uniform(0, 1, n).astype(np.float32)
    if case == "clip_edges":
        p[:40] = np.array([0.0, 1.0, 1e-9, 5e-8, 2e-7, 1 - 2e-7, 1e-6, 0.999999] * 5, np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    mask = None if case == "no_mask" else rng.uniform(size=n) < 0.6
    for alpha, gamma in ((0.25, 2.0), (0.5, 1.5)):
        def jf(pp):
            return jax_focal_loss(pp, y, None if mask is None else jnp.asarray(mask),
                                  alpha=alpha, gamma=gamma)

        jval, jgrad = jax.block_until_ready(jax.jit(jax.value_and_grad(jf))(p))
        tp = _t(p).requires_grad_(True)
        val = focal_loss(tp, _t(y), None if mask is None else _t(mask), alpha=alpha,
                         gamma=gamma)
        val.backward()
        np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-6)
        _close(tp.grad, jgrad, 1e-5, f"grad alpha={alpha} gamma={gamma}")
    if mask is not None:  # an empty mask divides by one
        empty = focal_loss(_t(p), _t(y), torch.zeros(n, dtype=torch.bool))
        assert float(empty) == 0.0


@pytest.mark.parametrize("case", ["random", "ties", "quantized", "f1_edge"])
def test_binary_classification_metrics_match_jax(case):
    """AP, ROC-AUC and F1 against JAX's (scikit-learn) within 1e-9, on 20
    draws each: continuous probabilities, heavy ties, probabilities on a
    coarse grid, and values at 0.5 (F1's strict > 0.5)."""
    rng = np.random.default_rng({"random": 0, "ties": 1, "quantized": 2, "f1_edge": 3}[case])
    for _ in range(20):
        n = int(rng.integers(5, 400))
        t = (rng.uniform(size=n) < rng.uniform(0.1, 0.9)).astype(np.float32)
        t[:2] = (0.0, 1.0)
        p = rng.uniform(size=n).astype(np.float32)
        if case == "ties":
            p = rng.choice(np.asarray([0.1, 0.3, 0.7, 0.9], np.float32), n)
        elif case == "quantized":
            p = (np.round(p * 16) / 16).astype(np.float32)
        elif case == "f1_edge":
            p[rng.uniform(size=n) < 0.3] = np.float32(0.5)
        got, want = binary_classification_metrics(p, t), jax_metrics(p, t)
        assert set(got) == set(want) == {"auc", "roc", "f1"}
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-9, (k, got[k], want[k])


@pytest.mark.parametrize("mode", ["min", "max"])
def test_plateau_lr_sequence_matches_jax(mode):
    """The "impatient" schedule's lr after each epoch's metric against JAX's
    PlateauState (strict improvement, reset after each cut) over a sequence
    with four cuts at patience 2, a NaN included; the scheduler's and the
    optimizer's state_dicts carry the rest of the sequence into fresh ones,
    as a resumed run loads them."""
    seq = [1.0, 0.9, 0.95, 0.9, 0.91, 0.8, 0.8, 0.85, 0.9, 0.7, float("nan"), 0.75, 0.76,
           0.6, 0.61, 0.62, 0.63]
    if mode == "max":
        seq = [-v for v in seq]
    param = torch.nn.Parameter(torch.zeros(1))

    def fresh():
        opt = torch.optim.Adam([param], lr=1e-3)
        return opt, make_lr_scheduler(opt, "impatient", factor=0.5, patience=2, mode=mode)

    opt, sched = fresh()
    ref = PlateauState(factor=0.5, patience=2, mode=mode)
    lrs, want = [], []
    for i, v in enumerate(seq):
        if i == 9:  # a resumed run: the state goes through a checkpoint
            states = opt.state_dict(), sched.state_dict()
            opt, sched = fresh()
            opt.load_state_dict(states[0])
            sched.load_state_dict(states[1])
        sched.step(v)
        lrs.append(opt.param_groups[0]["lr"])
        want.append(1e-3 * ref.update(v))
    np.testing.assert_allclose(lrs, want, rtol=1e-12)
    assert sum(a != b for a, b in zip(want, want[1:])) == 4


# --- the model ---------------------------------------------------------------


def _jax_model(modes, attn_impl):
    from hept_tpu.models import TransformerConfig as JaxConfig

    cfg = JaxConfig(in_dim=IN_DIM, coords_dim=COORDS_DIM, task="pileup", attn_impl=attn_impl,
                    padding_mode="replicate", **modes)
    return JaxHept(cfg)


def _port_model(variables, modes, attn_impl):
    from hept_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(in_dim=IN_DIM, coords_dim=COORDS_DIM, task="pileup",
                            attn_impl=attn_impl, padding_mode="replicate", **modes)
    model = HeptTransformer(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(from_jax_variables(variables))
    return model


@contextlib.contextmanager
def _jax_recording(monkeypatch, kernels: str, static: bool):
    """JAX's bucket attention through its TPU column kernels in interpret
    mode (`kernels`: "pallas" K6 + K7 v1; "hybrid2" the einsum forward + K7
    v2), recording what the port needs to sort as JAX did: each layer's
    (q_src, k_src) (dynamic keys) or the step's static plan (src, inv,
    scoords)."""
    rec = []
    if static:
        plan_fn = jba.static_bucket_plan

        def recording_plan(*a, **kw):
            plan = plan_fn(*a, **kw)
            jax.debug.callback(lambda *xs: rec.append(tuple(np.asarray(x) for x in xs)),
                               *plan[:3], ordered=True)
            return plan

        monkeypatch.setattr(jba, "static_bucket_plan", recording_plan)
    else:
        sort = jba.grouped_sort_carry

        def recording_sort(keys, payloads, **kw):
            outs, srcs = sort(keys, payloads, **kw)
            if len(keys) == 2:  # the q / k sort; the unsort has one group
                jax.debug.callback(lambda a, b: rec.append((np.asarray(a), np.asarray(b))),
                                   *srcs, ordered=True)
            return outs, srcs

        monkeypatch.setattr(jba, "grouped_sort_carry", recording_sort)
    einsum = jba.bucket_rbf_attention_cols_xla
    inside = []

    def cols(sq, sk, sv, block_size, precision=None):
        if inside:  # the hybrid modes' einsum forward calls back in here
            return einsum(sq, sk, sv, block_size, precision=precision)
        inside.append(True)
        try:
            return bucket_rbf_attention_cols_pallas(sq, sk, sv, block_size=block_size,
                                                    hybrid=kernels)
        finally:
            inside.pop()

    monkeypatch.setattr(jba, "bucket_rbf_attention_cols_xla", cols)
    jba.hept_attention_core_cols.clear_cache()
    jba.hept_attention_core_xcols.clear_cache()
    try:
        with pltpu.force_tpu_interpret_mode():
            yield rec
    finally:
        jba.hept_attention_core_cols.clear_cache()
        jba.hept_attention_core_xcols.clear_cache()


def _check_model(monkeypatch, modes, attn_impl, kernels, out_tol, loss_tol, grad_tol):
    """Outputs, the focal loss over the event's real neutral points and every
    parameter gradient, JAX's weights and constants carried across."""
    batch = _batch(378)
    x, coords, valid = batch["x"][0], batch["coords"][0], batch["valid"][0]
    y, mask = batch["y"][0], batch["is_neu"][0] & valid
    assert not valid.all() and 0 < y[mask].sum() < mask.sum()
    static = bool(modes.get("static_keys"))
    jmodel = _jax_model(modes, attn_impl)
    with _jax_recording(monkeypatch, kernels, static) as rec:
        variables = jax.block_until_ready(
            jax.jit(jmodel.init)(jax.random.PRNGKey(1), x, coords, valid))
        rec.clear()

        def jloss(params, x_, coords_, valid_):
            out = jmodel.apply({"params": params, "constants": variables["constants"]},
                               x_, coords_, valid_)
            return jax_focal_loss(out[..., 0], y, mask), out

        (jl, jout), jgrads = jax.block_until_ready(jax.jit(
            jax.value_and_grad(jloss, has_aux=True))(variables["params"], x, coords, valid))
    assert {"pids_enc", "out_proj"} <= set(variables["params"])
    model = _port_model(variables, modes, attn_impl)
    if static:
        (plan,) = rec
        kw = {"plan": tuple(_t(a, torch.int64) for a in plan[:2]) + (_t(plan[2]).float(),)}
    else:
        assert len(rec) == modes["n_layers"]
        kw = {"perms": [tuple(_t(p, torch.int64) for p in layer) for layer in rec]}
    out = model(_t(x), _t(coords), _t(valid), **kw)
    assert out.shape == (x.shape[0], 1) and bool(((out > 0) & (out < 1)).all())
    _close(out, jout, out_tol, "output")
    loss = focal_loss(out[..., 0], _t(y), _t(mask))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=loss_tol)
    loss.backward()
    ref = from_jax_variables({"params": jgrads, "constants": variables["constants"]})
    assert {"pids_enc.weight", "out_proj.weight", "out_proj.bias"} <= set(ref)
    for name, p in model.named_parameters():
        _close(p.grad, ref[name], grad_tol, name)


def test_pileup_parity_model_matches_jax(monkeypatch):
    """The parity profile's model (dynamic per-layer keys, f32, attn_impl
    pallas: K6 / K7 v1) on JAX's recorded permutations, JAX running K6 / K7
    v1 in interpret mode: outputs 1e-4 x scale, focal loss 1e-5, every
    parameter gradient (the PID embedding's and the classifier's included)
    1e-3 x its scale."""
    _check_model(monkeypatch, PARITY, "pallas", "pallas", 1e-4, 1e-5, 1e-3)


def test_pileup_hept_fast_model_matches_jax(monkeypatch):
    """The hept_fast flags (static plan, bf16 transport and kernels,
    per-bucket centering; attn_impl hybrid2: K6 exact-bias bf16 and K7 v2)
    on JAX's static plan, JAX running its einsum forward and K7 v2 in
    interpret mode: 2e-2 x scale, the bf16 rounding level, for outputs,
    loss and gradients."""
    _check_model(monkeypatch, dict(STATIC, **FAST_MODES), "hybrid2", "hybrid2", 2e-2, 2e-2,
                 2e-2)


def test_pileup_head_init_and_pid_embedding():
    """The port's own initial draw: the PID table N(0, 1/10) (flax's
    nn.Embed default), feat_enc_0 taking in_dim - 1 + 10 inputs, and
    replication pads carrying their source row's PID, inert slots PID 0."""
    from hept_tpu_torch.models.transformer import TransformerConfig, prepare_event

    cfg = TransformerConfig(in_dim=IN_DIM, coords_dim=COORDS_DIM, task="pileup",
                            attn_impl="slab2", padding_mode="replicate", **PARITY)
    model = HeptTransformer(cfg, torch.Generator().manual_seed(3))
    assert tuple(model.pids_enc.weight.shape) == (7, 10)
    assert tuple(model.feat_enc_0.weight.shape) == (8, IN_DIM - 1 + 10)
    assert tuple(model.out_proj.weight.shape) == (1, 4)
    big = HeptTransformer(dataclasses.replace(cfg), torch.Generator().manual_seed(4))
    w = torch.cat([model.pids_enc.weight, big.pids_enc.weight]).flatten()
    assert abs(float(w.detach().std()) - math.sqrt(0.1)) < 0.1
    batch = pack_events([synthetic_pileup_event(np.random.default_rng(2), n_points=40)], BS,
                        n_max=64)
    xp, _, _, inert = prepare_event(_t(batch["x"][0]), _t(batch["coords"][0]),
                                    _t(batch["valid"][0]), model.regions, BS)
    pid = xp[:, -1]
    assert bool((pid[inert] == 0).all()) and set(pid[40:48].tolist()) <= set(pid[:40].tolist())
    out = model(_t(batch["x"][0]), _t(batch["coords"][0]), _t(batch["valid"][0]))
    assert out.shape == (64, 1) and bool(torch.isfinite(out).all())


# --- training and evaluation -------------------------------------------------


def _train_cfgs(model_kwargs, attn_impl, **kw):
    common = dict(task="pileup", model_kwargs=dict(model_kwargs), attn_impl=attn_impl,
                  padding_mode="replicate", loss_name="focal", main_metric="auc", **kw)
    return JaxExperimentConfig(**common), ExperimentConfig(device="cpu", **common)


def test_pileup_train_step_matches_jax():
    """One train_step of the parity pileup configuration (dropout off)
    against make_single_device_train_step on a tie-free event (no
    replication pads): focal loss 1e-5, gradient norm 1e-3, Adam's first
    moment 1e-3 x scale + 1e-7, and the update wherever the gradient is
    clear of zero (Adam's first step is lr * sign(g) there) to 1e-6."""
    batch = _batch(384, seed=8)
    jcfg, cfg = _train_cfgs(dict(PARITY, dropout=0.0), "pallas")
    jmodel = JaxHept(jcfg.model_config(IN_DIM, COORDS_DIM))
    variables = jax.block_until_ready(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), batch["x"][0], batch["coords"][0], batch["valid"][0]))
    tx = jax_make_optimizer("adam", schedule=make_lr_schedule("impatient", 1e-2))
    state = TrainState.create(variables, tx, jax.random.PRNGKey(1))
    step = make_single_device_train_step(make_model_apply(jmodel), jax_make_loss_fn(jcfg), tx)
    new_state, jm = jax.block_until_ready(step(state, jax.tree_util.tree_map(jnp.asarray, batch)))

    model = trainer.build_model(cfg, IN_DIM, COORDS_DIM, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(from_jax_variables(variables))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = trainer.make_optimizer(model.parameters(), lr=1e-2)
    m = trainer.train_step(model, opt, trainer.make_loss_fn(cfg),
                           trainer.batch_to_device(batch, "cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    after = from_jax_variables(new_state.variables)
    mu = from_jax_variables({"params": new_state.opt_state.inner_state[0].mu,
                             "constants": variables["constants"]})
    for name, p in model.named_parameters():
        want = mu[name].numpy()
        np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(), want, rtol=1e-3,
                                   atol=1e-3 * np.abs(want).max() + 1e-7, err_msg=name)
        g = want / 0.1
        clear = np.abs(g) > max(1e-2 * np.abs(g).max(), 1e-5)
        d_port = (p.detach() - before[name]).numpy()
        d_jax = (after[name] - before[name]).numpy()
        np.testing.assert_allclose(d_port[clear], d_jax[clear], rtol=0, atol=1e-6, err_msg=name)


def _datasets(seed=5, sizes=(330, 378, 301, 352)):
    """The same pileup events as the port's SplitDataset and as JAX's (train
    1, valid 1, test 2)."""
    rng = np.random.default_rng(seed)
    evs = [synthetic_pileup_event(rng, n_points=s) for s in sizes]
    split = lambda e: dict(train=e[:1], valid=e[1:2], test=e[2:], in_dim=IN_DIM,  # noqa: E731
                           coords_dim=COORDS_DIM)
    return SplitDataset(**split(evs)), jdatasets.SplitDataset(**split([_jax_event(e)
                                                                       for e in evs]))


def test_pileup_evaluate_matches_jax():
    """`evaluate` of the test split (two batches) with JAX's weights against
    JAX's `evaluate` (static plan, f32 modes, one jitted eval step per batch,
    waited for): the mean focal loss 1e-5 relative, the per-batch mean AP,
    ROC-AUC and F1 1e-6; the packed split is cached on the dataset."""
    tds, jds = _datasets()
    n_max = slab_friendly_n(378, BS)
    jcfg, cfg = _train_cfgs(dict(STATIC, **F32_MODES), "slab2")
    jmodel = JaxHept(jcfg.model_config(IN_DIM, COORDS_DIM))
    b0 = jbatching.pack_events(jds.train, BS, n_max=n_max)
    variables = jax.block_until_ready(jax.jit(jmodel.init)(
        jax.random.PRNGKey(2), b0["x"][0], b0["coords"][0], b0["valid"][0]))
    jstep = make_eval_step(jcfg, make_model_apply(jmodel))

    def waited(g):
        step = jstep(g)
        return lambda *a: jax.block_until_ready(step(*a))

    waited.chunk = jstep.chunk
    want = jax_evaluate(jcfg, make_model_apply(jmodel), variables, jds, "test", BS, n_max, 0,
                        eval_step=waited)
    model = trainer.build_model(cfg, IN_DIM, COORDS_DIM, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(from_jax_variables(variables))
    got = trainer.evaluate(cfg, model, tds, "test", BS, n_max)
    assert set(got) == set(want) == {"auc", "roc", "f1", "loss"}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for k in ("auc", "roc", "f1"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
        assert 0.0 <= got[k] <= 1.0
    assert got["auc"] > 0 and got["roc"] > 0
    assert [k[0] for k in tds._eval_batch_cache] == ["test"]


def _records(run_dir):
    return [json.loads(line) for line in (run_dir / "scalars.jsonl").read_text().splitlines()]


def _run(cfg, ds):
    lines = []
    res = trainer.run_one_seed(cfg, ds, log=lambda *a: lines.append(" ".join(map(str, a))))
    return res, lines


def test_pileup_run_one_seed_round_trip(tmp_path):
    """Three epochs of the pileup trainer (dropout on, the plateau on the
    train loss at patience 0, so any epoch without a lower loss cuts the lr;
    the logged scales follow JAX's PlateauState on the logged losses):
    the best checkpoint is restored and re-evaluated to the in-loop best
    test metrics; `only_eval` scores the same; a 1-epoch run resumed for
    two more equals the unbroken run, its plateau state carried by the
    checkpoint."""
    tds, _ = _datasets(seed=7, sizes=(300, 280, 310, 290, 270))
    tds.train, tds.valid, tds.test = tds.train + tds.valid[:1], tds.test[:1], tds.test[1:]
    _, cfg = _train_cfgs(dict(STATIC, **F32_MODES), "slab2", num_epochs=3,
                         optimizer_kwargs=dict(lr=1e-2), lr_scheduler_name="impatient",
                         lr_scheduler_metric="loss",
                         lr_scheduler_kwargs=dict(factor=0.5, patience=0, mode="min"))
    cfg = dataclasses.replace(cfg, log_dir=str(tmp_path / "a"))
    res, lines = _run(cfg, tds)
    (run_dir,) = (tmp_path / "a").iterdir()
    assert CheckpointManager(run_dir / "ckpt").latest_step() is not None
    recs = _records(run_dir)
    in_loop = [r for r in recs if "test/loss" in r][-1]
    assert set(res) == {"auc", "roc", "f1", "loss"}
    for k, v in res.items():
        assert abs(v - in_loop[f"test/{k}"]) <= 1e-6, k
    assert not any("WARNING" in ln for ln in lines)
    losses = [r["train/loss"] for r in recs if "train/loss" in r]
    lrs = [float(ln.split(" lr=")[1].split()[0]) for ln in lines if ln.startswith("epoch")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    ref = PlateauState(factor=0.5, patience=0, mode="min")
    assert lrs == [1e-2 * ref.update(v) for v in losses] and lrs[1] == 5e-3

    only, _ = _run(dataclasses.replace(cfg, resume=str(run_dir), only_eval=True,
                                       log_dir=str(tmp_path / "b")), tds)
    for k, v in res.items():
        assert abs(only[k] - v) <= 1e-6, k

    _run(dataclasses.replace(cfg, num_epochs=1, log_dir=str(tmp_path / "c")), tds)
    (dir_c,) = (tmp_path / "c").iterdir()
    _, lines = _run(dataclasses.replace(cfg, resume=str(dir_c), log_dir=str(tmp_path / "d")),
                    tds)
    assert any("resumed" in ln for ln in lines)
    assert [ln.split(":")[0] for ln in lines if ln.startswith("epoch")] == ["epoch 1", "epoch 2"]
    (dir_d,) = (tmp_path / "d").iterdir()
    assert [r["train/loss"] for r in _records(dir_d) if "train/loss" in r] == losses[1:]


# --- configs and entry points -------------------------------------------------


def test_pileup_width_is_compiled_for_the_column_kernels_only():
    """d = 28 (h_dim 24 + the pileup coords_dim 4) is built for K6 / K7, the
    kernels of the pileup paths, and for nothing else: K1 / K2 and K10 refuse
    it before any launch, as every wrapper refuses a (d, dv) not built; on
    the CPU the K6 / K7 wrappers run their plain versions, and their CUDA
    launchers refuse CPU tensors rather than fall back."""
    from hept_tpu_torch.ops import bucket_attn_cuda as ba

    assert (28, 24) in ba.COLS_DIMS and (28, 24) not in ba.SUPPORTED_DIMS
    q, v = torch.zeros(1, 28, 100), torch.zeros(1, 24, 100)
    with pytest.raises(ValueError, match="not compiled"):
        ba.bucket_attn_fwd_cuda(q, q, v, 100)
    with pytest.raises(ValueError, match="not compiled"):
        ba.rows_fwd_cuda(q.transpose(1, 2).contiguous(), q.transpose(1, 2).contiguous(),
                         v.transpose(1, 2).contiguous())
    with pytest.raises(ValueError, match="not compiled"):
        ba.cols_fwd_cuda(torch.zeros(1, 29, 100), torch.zeros(1, 29, 100), v, 100)
    for call in (lambda: ba.cols_fwd_cuda(q, q, v, 100),
                 lambda: ba.cols_bwd_cuda(q, q, v, torch.zeros(1, 1, 100), v, 100, False)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    den, so = ba.cols_fwd(q, q, v, 100)
    assert den.shape == (1, 1, 100) and so.shape == (1, 24, 100)


@pytest.mark.parametrize("profile,shape", [
    ("hept", (100, 3, 4, 8, 24, 0, 140)),
    ("hept_fast", (100, 2, 4, 8, 24, 8, 140)),
])
def test_pileup_yaml_equals_jax(profile, shape):
    """The port's pileup YAMLs equal the JAX package's `load_config` of its
    own files, key by key; the port runs each (the parity profile on the
    dynamic-key path) at the pileup width; hept_fast's model equals tracking
    hept_fast's but for the regions."""
    pytest.importorskip("yaml")
    cfg = profile_config(profile, task="pileup")
    assert cfg == profile_config(profile, task="pileup", device=None)
    jcfg = jax_load_config(REPO / "hept_tpu" / "configs" / "pileup"
                           / f"pileup_trans_{profile}.yaml")
    for f in dataclasses.fields(ExperimentConfig):
        if hasattr(jcfg, f.name) and f.name != "device":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert (cfg.task, cfg.loss_name, cfg.main_metric, cfg.lr_scheduler_name,
            cfg.lr_scheduler_metric) == ("pileup", "focal", "auc", "impatient", "loss")
    mc = cfg.model_config(IN_DIM, COORDS_DIM)
    mc.check_supported()
    assert (mc.block_size, mc.n_hashes, mc.n_layers, mc.num_heads, mc.h_dim, mc.static_rounds,
            mc.num_regions) == shape
    assert (CONFIG_ROOT / "pileup" / f"pileup_trans_{profile}.yaml").exists()
    if profile == "hept_fast":
        track = profile_config("hept_fast").model_kwargs
        assert {**track, "num_regions": 140} == cfg.model_kwargs
        assert cfg.attn_impl == profile_config("hept_fast").attn_impl


def test_pileup_cli_and_demo_on_cpu(monkeypatch, capsys, tmp_path):
    """`python -m hept_tpu_torch.pileup_trainer -m hept_fast --device cpu` at
    full width on three small events: one epoch, eval, checkpoint; it prints
    the best test AP, ROC, F1 and loss. The demo's config is the profile's
    YAML with the demo's lr, seed and epochs."""
    pytest.importorskip("yaml")
    from hept_tpu_torch import pileup_trainer
    from hept_tpu_torch.scripts.train_pileup_60k_demo import VARIANTS, demo_config

    monkeypatch.setattr(trainer, "get_dataset",
                        lambda name, seed: make_synthetic_pileup(3, 300, seed))
    pileup_trainer.main(["-m", "hept_fast", "--epochs", "1", "--device", "cpu",
                         "--log-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert " lr=0.001 " in out
    best = out.split("best test:")[1]
    assert "auc=" in best and "roc=" in best and "f1=" in best and "nan" not in best
    assert list(tmp_path.glob("*_pileup_*/ckpt/step_*.pt"))
    for profile in VARIANTS:
        base = profile_config(profile, task="pileup")
        cfg = demo_config(profile, 2e-3, 0, 25, "runs/pileup60k")
        assert cfg.model_kwargs == base.model_kwargs and cfg.attn_impl == base.attn_impl
        assert (cfg.num_epochs, cfg.optimizer_kwargs["lr"], cfg.seed) == (25, 2e-3, 0)
        assert cfg.lr_scheduler_kwargs == base.lr_scheduler_kwargs
    if not torch.cuda.is_available():
        from hept_tpu_torch.scripts import train_pileup_60k_demo

        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_pileup_60k_demo.main([])
