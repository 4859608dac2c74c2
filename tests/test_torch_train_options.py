"""The trainer's loss and optimizer options against the JAX package's: the
InfoNCE loss with the cosine and l2_inverse similarities on the windowed
layout (`partner_gather`) and on the pair list as packed, `pair_filter`,
the triplet margin loss, `make_loss_fn`'s dispatch, AdamW and global-norm
clipping against optax, the per-step cosine schedule, `only_flops` and
`ckpt_every`. Inputs are numpy-seeded synthetic events packed by the port;
JAX runs on the CPU (no Pallas kernel: its pair ops take their XLA path
there)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hept_tpu.train import losses as jlosses  # noqa: E402
from hept_tpu.train.config import ExperimentConfig as JaxExperimentConfig  # noqa: E402
from hept_tpu.train.optim import make_lr_schedule  # noqa: E402
from hept_tpu.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from hept_tpu.train.trainer import build_model as jax_build_model  # noqa: E402
from hept_tpu.train.trainer import make_loss_fn as jax_make_loss_fn  # noqa: E402
from hept_tpu_torch.data.batching import pack_events  # noqa: E402
from hept_tpu_torch.data.datasets import make_synthetic_tracking  # noqa: E402
from hept_tpu_torch.data.synthetic import synthetic_tracking_event  # noqa: E402
from hept_tpu_torch.ops import pair_ops  # noqa: E402
from hept_tpu_torch.train import losses, trainer  # noqa: E402
from hept_tpu_torch.train.config import ExperimentConfig, load_config  # noqa: E402
from hept_tpu_torch.train.optim import (  # noqa: E402
    clip_by_global_norm_, global_norm, make_lr_scheduler, make_optimizer)

KEYS = ("pairs", "pair_mask", "pair_rev", "pair_weight", "pair_neg", "cluster_ids", "recons",
        "pts")
SMALL_GNN = dict(hidden_dim=16, num_layers=2, graph_k=4, out_dim=6)


def _events(n_events=1, n_points=600, seed=7):
    rng = np.random.default_rng(seed)
    return [synthetic_tracking_event(rng, n_points=n_points - 37 * i, pairs_per_point=6)
            for i in range(n_events)]


def _batch(layout="sorted", n_events=1):
    """A packed batch: "sorted" one windowed block, "two_block" the training
    loader's cached base + augmentation blocks, "list" the pair list as
    packed (windowed_pairs: false)."""
    evs = _events(n_events)
    if layout == "list":
        return pack_events(evs, block_size=64)
    if layout == "two_block":
        return pack_events(evs, block_size=64, window_pairs=128, aug_pair_p=0.3,
                           aug_rng=np.random.default_rng(8), cache=True)
    return pack_events(evs, block_size=64, window_pairs=128)


def _emb(n, seed=3, d=12):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32) * 0.5


def _close_grad(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


# --- losses -------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["sorted", "two_block"])
@pytest.mark.parametrize("metric", ["cosine", "l2_inverse"])
def test_windowed_infonce_metric_matches_jax(metric, layout):
    """The windowed InfoNCE with the cosine / l2_inverse similarity (the
    anchor rows by pair_gather, the partner rows by partner_gather): loss to
    1e-6 relative, the embedding gradient to 1e-5 of its scale; one CSR a
    loss."""
    b = _batch(layout)
    n = b["x"].shape[1]
    emb = _emb(n)
    jb = {k: jnp.asarray(b[k][0]) for k in KEYS}

    def jloss(e):
        return jlosses.infonce_loss(e, jb["pairs"], jb["pair_mask"], jb["cluster_ids"],
                                    jb["recons"], jb["pts"], tau=0.05, dist_metric=metric,
                                    windowed_pairs=True, pair_rev=jb["pair_rev"],
                                    pair_weight=jb["pair_weight"], pair_neg=jb["pair_neg"])

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(emb))
    te = torch.tensor(emb, requires_grad=True)
    tb = {k: torch.tensor(b[k][0]) for k in KEYS}
    before = pair_ops.CSR_BUILDS["anchor_csr"]
    tl = losses.infonce_loss(te, tb["pairs"], tb["pair_mask"], tb["pair_rev"],
                             tb["pair_weight"], tb["pair_neg"], tau=0.05, dist_metric=metric)
    tl.backward()
    assert pair_ops.CSR_BUILDS["anchor_csr"] == before + 1
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    _close_grad(te.grad.numpy(), jg)


@pytest.mark.parametrize("metric", ["l2_rbf", "cosine", "l2_inverse"])
def test_pair_list_infonce_matches_jax(metric):
    """`windowed_pairs: false`: the masks built in the step and the
    per-cluster mean of means, against JAX's non-windowed path."""
    b = _batch("list")
    assert "pair_rev" not in b
    n = b["x"].shape[1]
    emb = _emb(n, seed=4)
    keys = ("pairs", "pair_mask", "cluster_ids", "recons", "pts")
    jb = [jnp.asarray(b[k][0]) for k in keys]

    def jloss(e):
        return jlosses.infonce_loss(e, *jb, tau=0.05, dist_metric=metric)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(emb))
    te = torch.tensor(emb, requires_grad=True)
    tl = losses.infonce_loss_pairs(te, *(torch.tensor(b[k][0]) for k in keys), tau=0.05,
                                   dist_metric=metric)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    _close_grad(te.grad.numpy(), jg)


@pytest.mark.parametrize("pt_thres", [0.9, 0.0])
def test_pair_filter_matches_jax(pt_thres):
    b = _batch("list")
    args = [b[k][0] for k in ("cluster_ids", "pairs", "recons", "pts")]
    want = np.asarray(jlosses.pair_filter(*(jnp.asarray(a) for a in args), pt_thres))
    got = losses.pair_filter(*(torch.tensor(a) for a in args), pt_thres)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("margin", [0.5, 2.0])
def test_triplet_margin_loss_matches_jax(margin):
    b = _batch("list")
    n = b["x"].shape[1]
    emb = _emb(n, seed=5)
    keys = ("pairs", "pair_mask", "cluster_ids", "recons", "pts")
    jb = [jnp.asarray(b[k][0]) for k in keys]
    jl, jg = jax.jit(jax.value_and_grad(
        lambda e: jlosses.triplet_margin_loss(e, *jb, margin=margin)))(jnp.asarray(emb))
    te = torch.tensor(emb, requires_grad=True)
    tl = losses.triplet_margin_loss(te, *(torch.tensor(b[k][0]) for k in keys), margin=margin)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    _close_grad(te.grad.numpy(), jg)


@pytest.mark.parametrize("layout", ["sorted", "two_block"])
def test_partner_gather_backward_is_the_take_gradient(layout):
    """partner_gather's forward is the take at p1; its backward (the reversed
    cotangent summed at the anchor, pads masked) is autograd's gradient of
    the plain take for a cotangent that is zero on the pads, to 1e-6 of
    scale (another summation order)."""
    b = _batch(layout)
    n = b["x"].shape[1]
    emb = _emb(n, seed=6, d=7)
    tb = {k: torch.tensor(b[k][0]) for k in KEYS}
    p0, p1, mask, rev = tb["pairs"][0], tb["pairs"][1], tb["pair_mask"], tb["pair_rev"]
    g = torch.tensor(np.random.default_rng(1).normal(size=(p0.shape[0], 7)),
                     dtype=torch.float32) * mask[:, None]
    for csr in (None, pair_ops.anchor_csr(p0, n)):
        a = torch.tensor(emb, requires_grad=True)
        out = pair_ops.partner_gather(a, p1, p0, rev, mask, csr)
        torch.sum(out * g).backward()
        ref = torch.tensor(emb, requires_grad=True)
        want = ref[p1.long()]
        torch.sum(want * g).backward()
        torch.testing.assert_close(out.detach(), want.detach(), rtol=0, atol=0)
        _close_grad(a.grad.numpy(), ref.grad.numpy(), 1e-6)


@pytest.mark.parametrize("case", ["infonce_cosine", "infonce_list", "triplet",
                                  "triplet_windowed"])
def test_make_loss_fn_dispatch_matches_jax(case):
    """make_loss_fn on a two-event batch against JAX's: the windowed InfoNCE
    (a loop over events), the pair-list InfoNCE and the triplet loss (the
    mean over events), loss and output gradient to 1e-6 / 1e-5; the packing
    follows `windowed_pairs`."""
    windowed = case in ("infonce_cosine", "triplet_windowed")
    kw = dict(loss_name="triplet" if case.startswith("triplet") else "infonce",
              loss_kwargs=dict(tau=0.05, dist_metric="cosine", margin=0.7),
              windowed_pairs=windowed)
    cfg = ExperimentConfig(**kw)
    assert trainer._window_pairs(cfg) == (128 if windowed else 0)
    b = _batch("sorted" if windowed else "list", n_events=2)
    out = np.stack([_emb(b["x"].shape[1], seed=s) for s in (1, 2)])
    jfn = jax_make_loss_fn(JaxExperimentConfig(**kw))
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    jl, jg = jax.value_and_grad(lambda o: jfn(o, jb))(jnp.asarray(out))
    to = torch.tensor(out, requires_grad=True)
    tl = trainer.make_loss_fn(cfg)(to, trainer.batch_to_device(b, "cpu"))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    _close_grad(to.grad.numpy(), jg)


def test_make_loss_fn_refuses_unknown_losses():
    with pytest.raises(NotImplementedError, match="triplet"):
        trainer.make_loss_fn(ExperimentConfig(loss_name="focal"))
    b = _batch("list")
    with pytest.raises(NotImplementedError, match="dist_metric"):
        losses.infonce_loss_pairs(*(torch.tensor(b[k][0]) for k in
                                    ("x", "pairs", "pair_mask", "cluster_ids", "recons", "pts")),
                                  dist_metric="l1")


# --- optimizers and schedules -------------------------------------------------------


@pytest.mark.parametrize("warmup", [0, 1, 2])
def test_cosine_schedule_matches_jax(warmup, tmp_path, monkeypatch):
    """run_one_seed with the cosine schedule (3 epochs of 2 steps): the lr of
    every update equals JAX's make_lr_schedule at that update's count
    (1e-6 relative); AdamW with clipping trains through it."""
    ds = make_synthetic_tracking(3, 200, seed=1)
    kw = dict(num_warmup_epochs=warmup, eta_min_ratio=0.05)
    cfg = ExperimentConfig(model_name="gnn_gcn", device="cpu", num_epochs=3,
                           log_dir=str(tmp_path), model_kwargs=SMALL_GNN,
                           optimizer_name="adamw",
                           optimizer_kwargs=dict(lr=2e-3, weight_decay=0.01, clip_norm=1.0),
                           lr_scheduler_name="cosine", lr_scheduler_kwargs=kw)
    seen = []
    step = trainer.train_step

    def spy(model, opt, *a, **k):
        seen.append(opt.param_groups[0]["lr"])
        return step(model, opt, *a, **k)

    monkeypatch.setattr(trainer, "train_step", spy)
    res = trainer.run_one_seed(cfg, ds, log=lambda *a: None)
    assert np.isfinite(res["loss"])
    sched = make_lr_schedule("cosine", 2e-3, steps_per_epoch=2, num_epochs=3, **kw)
    assert len(seen) == 6
    np.testing.assert_allclose(seen, [float(sched(i)) for i in range(6)], rtol=1e-6)


def _optax_run(name, lr, wd, clip, params, grads):
    tx = jax_make_optimizer(name, schedule=make_lr_schedule(None, lr), weight_decay=wd,
                            clip_norm=clip)
    p = [jnp.asarray(a) for a in params]
    state = tx.init(p)
    for g in grads:
        upd, state = tx.update([jnp.asarray(a) for a in g], state, p)
        p = [a + u for a, u in zip(p, upd)]
    return [np.asarray(a) for a in p]


@pytest.mark.parametrize("clip", [0.0, 1.5])
@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_optimizer_matches_optax(name, clip):
    """Three updates from the same gradients: the port's make_optimizer
    (adam ignores weight_decay, adamw decays decoupled) after
    clip_by_global_norm_ where clip_norm > 0 (the norm crossing it between
    steps), as train_step clips, against JAX's make_optimizer chain,
    parameters to 1e-6 of their scale (the two round the Adam arithmetic
    in different orders)."""
    rng = np.random.default_rng(0)
    params = [rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(7,)).astype(np.float32)]
    grads = [[rng.normal(size=a.shape).astype(np.float32) * s for a in params]
             for s in (0.1, 1.0, 0.2)]
    want = _optax_run(name, 1e-2, 0.1, clip, params, grads)
    tp = [torch.tensor(a, requires_grad=True) for a in params]
    opt = make_optimizer(tp, name, 1e-2, weight_decay=0.1)
    for g in grads:
        for p, a in zip(tp, g):
            p.grad = torch.tensor(a)
        if clip:
            gs = [p.grad for p in tp]
            clip_by_global_norm_(gs, global_norm(gs), clip)
        opt.step()
    for got, w in zip(tp, want):
        np.testing.assert_allclose(got.detach().numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max())
    if clip:  # clipping changes the result: the norms straddle the bound
        unclipped = _optax_run(name, 1e-2, 0.1, 0.0, params, grads)
        assert not np.allclose(unclipped[0], want[0], rtol=1e-5)


def test_refusals():
    with pytest.raises(NotImplementedError, match="adamw"):
        make_optimizer([torch.zeros(1, requires_grad=True)], "sgd")
    opt = make_optimizer([torch.zeros(1, requires_grad=True)])
    with pytest.raises(NotImplementedError, match="cosine"):
        make_lr_scheduler(opt, "linear")


# --- only_flops, ckpt_every ---------------------------------------------------------


def test_only_flops_returns_jax_param_count(tmp_path):
    """only_flops returns JAX's parameter count (from `jax.eval_shape` of its
    init) and a positive matmul FLOP count, without training or a run dir."""
    ds = make_synthetic_tracking(3, 200, seed=1)
    kw = dict(model_name="gnn_gravnet", model_kwargs=dict(SMALL_GNN, k=4, knn_dim=3))
    cfg = ExperimentConfig(device="cpu", only_flops=True, log_dir=str(tmp_path / "runs"), **kw)
    res = trainer.run_one_seed(cfg, ds, log=lambda *a: None)
    jmodel, _ = jax_build_model(JaxExperimentConfig(**kw), ds.in_dim, ds.coords_dim)
    n = 200
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((n, ds.in_dim)),
                            jnp.zeros((n, ds.coords_dim)), jnp.ones((n,), bool))
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    assert res["params"] == want and res["flops"] > 0
    assert set(res) == {"params", "flops"}
    assert not (tmp_path / "runs").exists()


def test_ckpt_every_loads_and_changes_nothing(tmp_path):
    """ckpt_every is a known key (the JAX config declares it) that neither
    trainer reads: a run with it equals one without, checkpoints included."""
    pytest.importorskip("yaml")
    path = tmp_path / "cfg.yaml"
    path.write_text("model_name: gnn_gcn\nckpt_every: 1\nnum_epochs: 2\n")
    cfg = load_config(path, device="cpu", model_kwargs=SMALL_GNN)
    assert cfg.ckpt_every == 1
    ds = make_synthetic_tracking(3, 200, seed=1)
    res = {}
    for every in (0, 1):
        cfg.ckpt_every, cfg.log_dir = every, str(tmp_path / f"runs{every}")
        res[every] = trainer.run_one_seed(cfg, ds, log=lambda *a: None)
    assert res[0] == res[1]
    ckpts = [sorted(p.name for p in (tmp_path / f"runs{e}").glob("*/ckpt/*")) for e in (0, 1)]
    assert ckpts[0] == ckpts[1] and ckpts[0]
