"""The port's GNN baselines (GatedGNN, GCN, DGCNN, GravNet) against the JAX
package's.

Both sides get the same numpy inputs (300 points, 20 of them invalid), the
same parameters (`from_jax_variables`) and the same neighbour lists: the
fixed (eta, phi) graph is JAX's, passed to both, and DGCNN's / GravNet's
learned-space neighbours are recorded as JAX's modules find them (a
`jax.debug.callback` on `hept_tpu.models.gnns.knn_brute_force`, patched from
here) and imposed on the port through `nbrs=`; a separate test holds the
port's own kNN lists to JAX's on the same data. Widths are cut to hidden
16, 2 layers, k 4, knn_dim 3. Every JAX computation is one `jax.jit`,
waited for. Tolerances (float32, summation order only): outputs 1e-5 x
their scale, gradients 1e-4 x the larger of their own scale and 1e-3 of the
largest gradient (DGCNN's lin_s has no gradient: the neighbour index is not
differentiable).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import hept_tpu.models.gnns as jgnns  # noqa: E402
from hept_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from hept_tpu.ops.knn import knn_brute_force as jax_knn  # noqa: E402
from hept_tpu.train.config import ExperimentConfig as JaxExperimentConfig  # noqa: E402
from hept_tpu.train.config import load_config as jax_load_config  # noqa: E402
from hept_tpu.train.trainer import build_model as jax_build_model  # noqa: E402
from hept_tpu.train.trainer import make_loss_fn as jax_make_loss_fn  # noqa: E402
from hept_tpu.train.trainer import make_model_apply  # noqa: E402
from hept_tpu_torch.data.batching import pack_events  # noqa: E402
from hept_tpu_torch.data.datasets import (  # noqa: E402
    make_synthetic_pileup,
    make_synthetic_tracking,
)
from hept_tpu_torch.data.synthetic import synthetic_tracking_event  # noqa: E402
from hept_tpu_torch.models import gnns  # noqa: E402
from hept_tpu_torch.ops.knn import knn_brute_force  # noqa: E402
from hept_tpu_torch.train import trainer  # noqa: E402
from hept_tpu_torch.train.config import (  # noqa: E402
    CONFIG_ROOT,
    ExperimentConfig,
    gnn_config_path,
    load_config,
)
from hept_tpu_torch.utils.convert import from_jax_variables  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
N, N_PAD, IN_DIM, CD = 300, 20, 5, 4
H, LAYERS, K, KNN_DIM, GRAPH_K = 16, 2, 4, 3, 4
SMALL = dict(hidden_dim=H, num_layers=LAYERS, k=K, knn_dim=KNN_DIM, graph_k=GRAPH_K)
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
# parameters at the YAMLs' widths and the synthetic sets' in_dim (tracking)
YAML_PARAMS = {"gcn": 322_960, "gravnet": 338_864, "dgcnn": 324_492, "gatedgnn": 334_652}
TASK_DIMS = {"tracking": (10, 6), "pileup": (8, 4)}  # (in_dim, coords_dim) of the synthetic sets


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(got, want, tol, name="", floor=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, floor, 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=name)


def _event(task="tracking", seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, IN_DIM)).astype(np.float32)
    if task == "pileup":  # the last column is the PID
        x[:, -1] = rng.integers(0, 7, size=N)
    coords = rng.normal(size=(N, CD)).astype(np.float32)
    coords[:, 1] *= 2.5  # phi differences beyond pi, so the wrap is exercised
    return x, coords, np.arange(N) < N - N_PAD


def _variables(init, *args, seed=0, **kw) -> dict:
    """Variables of a flax module's tree as `init` would build them, filled
    from numpy (jax.eval_shape traces the init without compiling it):
    kernels U(+-1/sqrt(fan_in)), biases U(+-0.1), LayerNorm scales
    1 + N(0, 0.1), the rest N(0, 1)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            val = rng.uniform(-1, 1, size=shape) / np.sqrt(shape[0])
        elif name == "bias":
            val = rng.uniform(-0.1, 0.1, size=shape)
        elif name == "scale":
            val = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            val = rng.normal(size=shape)
        return jnp.asarray(val, leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init, jax.random.PRNGKey(0),
                                                                 *args, **kw))


def _jit_run(fn, *args):
    """fn(*args) as one jitted call at XLA optimisation level 0, waited for."""
    compiled = jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    return jax.block_until_ready(compiled(*args))


def _jax_graph(coords, valid, k=GRAPH_K):
    """JAX's fixed graph, as its trainer builds it (trainer.py:132-145)."""
    n = coords.shape[0]
    d2, idx = jax_knn(jnp.asarray(coords[:, :2]), jnp.asarray(coords[:, :2]), k + 1,
                      valid=jnp.asarray(valid))
    dst = jnp.repeat(jnp.arange(n, dtype=jnp.int32), k)
    src = idx[:, 1:].reshape(-1).astype(jnp.int32)
    v = jnp.asarray(valid)
    return jnp.stack([src, dst]), v[src] & v[dst], -d2[:, 1:].reshape(-1, 1)


def _port_graph(graph):
    edges, mask, ew = (np.asarray(a) for a in graph)
    return _t(edges, torch.int64), _t(mask), _t(ew)


class _KnnRecorder:
    """Records the index of each kNN call inside JAX's GNN modules."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.n, self.vals = 0, {}

    def knn(self, *a, **k):
        d2, idx = jax_knn(*a, **k)
        i, self.n = self.n, self.n + 1
        jax.debug.callback(lambda v, i=i: self.vals.__setitem__(i, np.asarray(v)), idx)
        return d2, idx

    def nbrs(self) -> list:
        """Per call: the (n, k) neighbours after JAX drops column 0 (of the
        one event, where the call ran under the trainer's vmap)."""
        vals = [np.array(self.vals[i]) for i in range(self.n)]
        return [torch.from_numpy((v[0] if v.ndim == 3 else v)[:, 1:]) for v in vals]


@pytest.fixture
def recorder(monkeypatch):
    rec = _KnnRecorder()
    monkeypatch.setattr(jgnns, "knn_brute_force", rec.knn)
    return rec


def _check_grads(named_grads, ref: dict, tol=GRAD_TOL):
    floor = 1e-3 * max(float(np.abs(r.numpy()).max()) for r in ref.values())
    for name, g, shape in named_grads:
        g = torch.zeros(shape) if g is None else g
        _close(g, ref[name].numpy(), tol, name, floor)


# --- each conv alone ----------------------------------------------------------------


def _port_conv(conv, variables):
    cfg = gnns.GNNConfig(in_dim=H, coords_dim=CD, conv_type=conv, h_dim=H, k=K,
                         knn_dim=KNN_DIM)
    mod = gnns.make_conv(cfg, torch.Generator().manual_seed(0))
    sd = {k[len("convs.0."):]: v for k, v in
          from_jax_variables({"params": {"pre_ff_0": {}, "conv_0": variables["params"]}}).items()
          if k.startswith("convs.0.")}
    mod.load_state_dict(sd)
    return mod


@pytest.mark.parametrize("conv", gnns.CONVS)
def test_conv_matches_jax(conv, recorder):
    """Each conv alone: output, the input's gradient and every parameter's."""
    _, coords, valid = _event(seed=1)
    x = np.random.default_rng(2).normal(size=(N, H)).astype(np.float32)
    jcls = jgnns._CONVS[conv]
    jmod = jcls(H, k=K, knn_dim=KNN_DIM) if conv in ("dgcnn", "gravnet") else jcls(H)
    graph = _jax_graph(coords, valid)
    kw = dict(coords=jnp.asarray(coords), valid=jnp.asarray(valid))
    if conv in gnns.GRAPH_CONVS:
        kw.update(edges=graph[0], edge_mask=graph[1], edge_weight=graph[2])
    variables = _variables(jmod.init, jnp.asarray(x), **kw)
    wo = np.random.default_rng(3).normal(size=(N, H)).astype(np.float32)

    def jloss(params, x):
        out = jmod.apply({"params": params}, x, **kw)
        return jnp.sum(out * wo), out

    recorder.reset()  # the init's trace ran the callbacks' tracing too
    (_, jout), (jgp, jgx) = _jit_run(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True),
                                     variables["params"], jnp.asarray(x))
    mod = _port_conv(conv, variables)
    tx = _t(x).requires_grad_(True)
    pkw = {}
    if conv in gnns.GRAPH_CONVS:
        pkw = dict(zip(("edges", "edge_mask", "edge_weight"), _port_graph(graph)))
    else:
        pkw = dict(nbrs=recorder.nbrs()[0])
        assert recorder.n == 1
    out = mod(tx, _t(coords), _t(valid), **pkw)
    torch.sum(out * _t(wo)).backward()
    _close(out, jout, OUT_TOL, conv)
    _close(tx.grad, jgx, GRAD_TOL, f"{conv} d x")
    ref = {k[len("convs.0."):]: v for k, v in
           from_jax_variables({"params": {"pre_ff_0": {}, "conv_0": jgp}}).items()}
    _check_grads([(n, p.grad, p.shape) for n, p in mod.named_parameters()], ref)


# --- the whole model ----------------------------------------------------------------


def _jax_stack(conv, task, in_dim=IN_DIM, coords_dim=CD, **kw):
    jc = JaxConfig(in_dim=in_dim, coords_dim=coords_dim, task=task, h_dim=kw.get("h", H),
                   n_layers=kw.get("layers", LAYERS), out_dim=kw.get("out_dim"),
                   knn_k=GRAPH_K)
    return jgnns.GNNStack(jc, conv_type=conv, k=kw.get("k", K),
                          knn_dim=kw.get("knn_dim", KNN_DIM))


def _port_stack(conv, task, variables=None, in_dim=IN_DIM, coords_dim=CD, **kw):
    cfg = gnns.GNNConfig(in_dim=in_dim, coords_dim=coords_dim, conv_type=conv, task=task,
                         h_dim=kw.get("h", H), n_layers=kw.get("layers", LAYERS),
                         out_dim=kw.get("out_dim"), graph_k=GRAPH_K, k=kw.get("k", K),
                         knn_dim=kw.get("knn_dim", KNN_DIM))
    model = gnns.GNNStack(cfg, torch.Generator().manual_seed(0))
    if variables is not None:
        model.load_state_dict(from_jax_variables(variables))
    return model


@pytest.mark.parametrize("task", ["tracking", "pileup"])
@pytest.mark.parametrize("conv", gnns.CONVS)
def test_gnn_stack_matches_jax(conv, task, recorder):
    """GNNStack of each conv for both tasks, JAX's weights carried across,
    JAX's graph and neighbour lists imposed: output 1e-5 x scale, every
    parameter gradient 1e-4 (tracking at out_dim 6, as the YAMLs set one)."""
    x, coords, valid = _event(task, seed=6)
    kw = {"out_dim": 6} if task == "tracking" else {}
    jmodel = _jax_stack(conv, task, **kw)
    graph = _jax_graph(coords, valid)
    gkw = dict(edges=graph[0], edge_mask=graph[1], edge_weight=graph[2])
    variables = _variables(jmodel.init, x, coords, jnp.asarray(valid), **gkw)
    model = _port_stack(conv, task, variables, **kw)
    assert model.out_width == (1 if task == "pileup" else 6)
    wo = np.random.default_rng(7).normal(size=(N, model.out_width)).astype(np.float32)

    def jloss(params, x, coords, valid):
        out = jmodel.apply({"params": params}, x, coords, valid, **gkw)
        return jnp.sum(out * wo), out

    recorder.reset()
    (_, jout), jg = _jit_run(jax.value_and_grad(jloss, has_aux=True), variables["params"], x,
                             coords, jnp.asarray(valid))
    learned = conv in ("dgcnn", "gravnet")
    assert recorder.n == (LAYERS if learned else 0)
    out = model(_t(x), _t(coords), _t(valid), graph=_port_graph(graph),
                nbrs=recorder.nbrs() if learned else None)
    torch.sum(out * _t(wo)).backward()
    _close(out, jout, OUT_TOL, f"{conv} {task}")
    _check_grads([(n, p.grad, p.shape) for n, p in model.named_parameters()],
                 from_jax_variables({"params": jg}))


@pytest.mark.parametrize("space", ["eta_phi", "learned"])
def test_port_knn_lists_equal_jax(space):
    """The port's own kNN (k + 1 with self, as the convs ask) gives JAX's
    index lists on the tests' data: (eta, phi) of the event, and a 3-wide
    learned-space projection of it."""
    x, coords, valid = _event(seed=6)
    if space == "eta_phi":
        pts = coords[:, :2]
    else:
        w = np.random.default_rng(8).normal(size=(IN_DIM, KNN_DIM)).astype(np.float32)
        pts = x @ w
    k = max(GRAPH_K, K) + 1
    jd, ji = jax_knn(jnp.asarray(pts), jnp.asarray(pts), k, valid=jnp.asarray(valid))
    pd, pi = knn_brute_force(_t(pts), _t(pts), k, valid=_t(valid))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(jd)).max()))


def test_gnn_graph_matches_jax():
    """`gnn_graph`: JAX's edges and edge mask exactly, -d^2 to 1e-5 of scale;
    and the model builds that graph itself when none is given (its output
    to 1e-5 of scale: the weights differ by rounding)."""
    x, coords, valid = _event(seed=6)
    want = _jax_graph(coords, valid)
    edges, mask, ew = gnns.gnn_graph(_t(coords), _t(valid), GRAPH_K)
    np.testing.assert_array_equal(edges.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want[1]))
    _close(ew, want[2], 1e-5, "edge_weight")
    model = _port_stack("gcn", "tracking")
    with torch.no_grad():
        own = model(_t(x), _t(coords), _t(valid))
        given = model(_t(x), _t(coords), _t(valid), graph=_port_graph(want))
    _close(own, given.numpy(), 1e-5, "own graph")


def test_nbrs_recorded_and_imposed():
    """A forward's recorded learned-space neighbours (one (n, k) index a
    layer), imposed on another forward, give its output (the distances
    recomputed for them to f32 rounding)."""
    x, coords, valid = _event(seed=6)
    model = _port_stack("gravnet", "tracking")
    rec = []
    with torch.no_grad():
        a = model(_t(x), _t(coords), _t(valid), record_nbrs=rec)
        b = model(_t(x), _t(coords), _t(valid), nbrs=rec)
    assert len(rec) == LAYERS and rec[0].shape == (N, K)
    _close(b, a.numpy(), 1e-6, "imposed")


@pytest.mark.parametrize("conv", ["gatedgnn", "gravnet"])
def test_adam_step_matches_optax(conv, recorder):
    """One train_step (lr 1e-3, dropout off) of a tracking GNN against JAX's
    loss, gradient and optax Adam update on the same packed event and
    weights, JAX's neighbour lists imposed on gravnet: loss 1e-5, gradient
    norm 1e-4, the update wherever the gradient is clear of zero (Adam's
    first step is lr * sign(g)) to 1e-6."""
    ev = synthetic_tracking_event(np.random.default_rng(5), n_points=280, pairs_per_point=8)
    batch = pack_events([ev], block_size=100, window_pairs=128)
    kw = dict(model_name=f"gnn_{conv}", loss_kwargs=dict(tau=0.05, dist_metric="l2_rbf"),
              model_kwargs=dict(SMALL, out_dim=6))
    jcfg = JaxExperimentConfig(**kw)
    jmodel, jmc = jax_build_model(jcfg, 10, 6)
    apply = make_model_apply(jmodel, jmc)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    graph = _jax_graph(batch["coords"][0], batch["valid"][0])
    variables = _variables(jmodel.init, jb["x"][0], jb["coords"][0], jb["valid"][0],
                           edges=graph[0], edge_mask=graph[1], edge_weight=graph[2])
    tx = optax.adam(1e-3)
    jloss_fn = jax_make_loss_fn(jcfg)

    def step(params, b):
        loss, g = jax.value_and_grad(lambda p: jloss_fn(apply({"params": p}, b), b))(params)
        upd, _ = tx.update(g, tx.init(params), params)
        return loss, optax.global_norm(g), optax.apply_updates(params, upd), g

    recorder.reset()
    jl, jnorm, jnew, jg = _jit_run(step, variables["params"], jb)

    cfg = ExperimentConfig(device="cpu", **kw)
    model = trainer.build_model(cfg, 10, 6, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(from_jax_variables(variables))
    if conv == "gravnet":
        nbrs = recorder.nbrs()
        forward = model.forward
        model.forward = lambda *a, **k: forward(*a, nbrs=nbrs, **k)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = trainer.make_optimizer(model.parameters(), lr=1e-3)
    m = trainer.train_step(model, opt, trainer.make_loss_fn(cfg),
                           trainer.batch_to_device(batch, "cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jnorm), rtol=1e-4)
    after = from_jax_variables({"params": jnew})
    grads = from_jax_variables({"params": jg})
    for name, p in model.named_parameters():
        g = grads[name].numpy()
        clear = np.abs(g) > max(1e-2 * np.abs(g).max(), 1e-6)
        d_port = (p.detach() - before[name]).numpy()
        d_jax = (after[name] - before[name]).numpy()
        np.testing.assert_allclose(d_port[clear], d_jax[clear], rtol=0, atol=1e-6, err_msg=name)


# --- configs and the trainer --------------------------------------------------------


@pytest.mark.parametrize("task", ["tracking", "pileup"])
@pytest.mark.parametrize("conv", gnns.CONVS)
def test_param_count_equals_jax(conv, task):
    """At the YAMLs' widths and the synthetic sets' in_dim, the port's model
    has JAX's parameter count (JAX's from `jax.eval_shape` of its init);
    tracking's are the known 322,960 / 338,864 / 324,492 / 334,652."""
    pytest.importorskip("yaml")
    in_dim, coords_dim = TASK_DIMS[task]
    cfg = load_config(gnn_config_path(conv, task), device="cpu")
    jcfg = jax_load_config(REPO / "hept_tpu" / "configs" / task / f"{task}_gnn_{conv}.yaml")
    jmodel, _ = jax_build_model(jcfg, in_dim, coords_dim)
    n = 200
    x = jnp.zeros((n, in_dim))
    coords = jnp.zeros((n, coords_dim))
    valid = jnp.ones((n,), bool)
    graph = _jax_graph(np.zeros((n, coords_dim), np.float32), np.ones(n, bool),
                       jcfg.model_kwargs.get("graph_k", 16))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, coords, valid,
                            edges=graph[0], edge_mask=graph[1], edge_weight=graph[2])
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    model = trainer.build_model(cfg, in_dim, coords_dim, torch.Generator().manual_seed(0), "cpu")
    assert sum(p.numel() for p in model.parameters()) == want
    if task == "tracking":
        assert want == YAML_PARAMS[conv]


@pytest.mark.parametrize("task", ["tracking", "pileup"])
@pytest.mark.parametrize("conv", gnns.CONVS)
def test_gnn_yaml_equals_jax(conv, task):
    """The port's YAML is the JAX package's file, byte for byte; loaded, it
    equals JAX's load_config key by key (attn_impl, which no GNN reads,
    keeps each package's default)."""
    pytest.importorskip("yaml")
    name = f"{task}_gnn_{conv}.yaml"
    assert (CONFIG_ROOT / task / name).read_bytes() == \
        (REPO / "hept_tpu" / "configs" / task / name).read_bytes()
    cfg = load_config(gnn_config_path(conv, task))
    jcfg = jax_load_config(REPO / "hept_tpu" / "configs" / task / name)
    for f in dataclasses.fields(ExperimentConfig):
        if hasattr(jcfg, f.name) and f.name not in ("device", "attn_impl"):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    gc = cfg.gnn_config(*TASK_DIMS[task])
    assert gc.conv_type == conv and gc.task == task


@pytest.mark.parametrize("task", ["tracking", "pileup"])
@pytest.mark.parametrize("conv", gnns.CONVS)
def test_run_one_seed_of_each_gnn(conv, task, tmp_path):
    """One epoch of each GNN at the test width on three tiny synthetic events
    on the CPU: finite loss, metrics in [0, 1], a checkpoint restored and
    re-evaluated to the in-loop best."""
    if task == "tracking":
        ds = make_synthetic_tracking(3, 300, seed=1)
        extra = {}
    else:
        ds = make_synthetic_pileup(3, 300, seed=1)
        extra = dict(loss_name="focal", main_metric="auc", lr_scheduler_name="impatient")
    cfg = ExperimentConfig(task=task, model_name=f"gnn_{conv}", device="cpu", num_epochs=1,
                           log_dir=str(tmp_path), model_kwargs=dict(SMALL), **extra)
    lines = []
    res = trainer.run_one_seed(cfg, ds, log=lambda *a: lines.append(" ".join(map(str, a))))
    assert not any("WARNING" in x for x in lines)
    assert np.isfinite(res["loss"])
    for k, v in res.items():
        if k != "loss":
            assert 0.0 <= v <= 1.0, (k, v)
