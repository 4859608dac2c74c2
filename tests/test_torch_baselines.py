"""The port's seven baseline attentions against the JAX package's.

Both sides get the same numpy inputs (64 points, 11 of them invalid), the
same parameters and frozen matrices (`from_jax_variables`) and the same
random rotations: JAX's draws are recorded as its modules make them (a
`jax.debug.callback` on `jax.random.normal` / `uniform` inside the reformer,
smyrf and sb modules) and passed to the port through `rotations=`. Every JAX
computation is one `jax.jit` on traced inputs, waited for before the next
dispatch. Tolerances (float32, summation order only): outputs 1e-5 x their
scale, gradients 1e-4 x the larger of their own scale and 1e-3 of the
largest gradient (pct's attn_nn bias has a zero gradient up to rounding:
the per-destination softmax does not depend on it).
"""

import dataclasses
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hept_tpu.models.attention.flatformer as jflat  # noqa: E402
import hept_tpu.models.attention.flt as jflt  # noqa: E402
import hept_tpu.models.attention.pct as jpct  # noqa: E402
import hept_tpu.models.attention.performer as jperf  # noqa: E402
import hept_tpu.models.attention.reformer as jref  # noqa: E402
import hept_tpu.models.attention.sb as jsb  # noqa: E402
import hept_tpu.models.attention.smyrf as jsmyrf  # noqa: E402
from hept_tpu.core import buckets as jbuckets  # noqa: E402
from hept_tpu.models import HeptTransformer as JaxHept  # noqa: E402
from hept_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from hept_tpu.models.transformer import PESinusoidal as JaxPESinusoidal  # noqa: E402
from hept_tpu.ops import rff as jrff  # noqa: E402
from hept_tpu.ops import segment as jseg  # noqa: E402
from hept_tpu.parallel.dp import make_single_device_train_step  # noqa: E402
from hept_tpu.train.config import ExperimentConfig as JaxExperimentConfig  # noqa: E402
from hept_tpu.train.config import load_config as jax_load_config  # noqa: E402
from hept_tpu.train.optim import make_lr_schedule  # noqa: E402
from hept_tpu.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from hept_tpu.train.state import TrainState  # noqa: E402
from hept_tpu.train.trainer import make_loss_fn as jax_make_loss_fn  # noqa: E402
from hept_tpu.train.trainer import make_model_apply  # noqa: E402
from hept_tpu_torch.core.buckets import gather_rows  # noqa: E402
from hept_tpu_torch.data.batching import pack_events  # noqa: E402
from hept_tpu_torch.data.datasets import make_synthetic_tracking  # noqa: E402
from hept_tpu_torch.data.synthetic import synthetic_tracking_event  # noqa: E402
from hept_tpu_torch.models.attention.flatformer import (  # noqa: E402
    FlatformerAttention,
    discretize_coords,
    serpentine_keys,
)
from hept_tpu_torch.models.attention.flt import FLTAttention  # noqa: E402
from hept_tpu_torch.models.attention.pct import PCTAttention, knn_graph  # noqa: E402
from hept_tpu_torch.models.attention.performer import PerformerAttention  # noqa: E402
from hept_tpu_torch.models.attention.reformer import ReformerAttention  # noqa: E402
from hept_tpu_torch.models.attention.sb import SBAttention  # noqa: E402
from hept_tpu_torch.models.attention.smyrf import SmyrfAttention  # noqa: E402
from hept_tpu_torch.models.transformer import (  # noqa: E402
    BASELINES,
    HeptTransformer,
    PESinusoidal,
    TransformerConfig,
)
from hept_tpu_torch.ops import rff, segment  # noqa: E402
from hept_tpu_torch.train import trainer  # noqa: E402
from hept_tpu_torch.train.config import CONFIG_ROOT, ExperimentConfig, profile_config  # noqa: E402
from hept_tpu_torch.utils.convert import from_jax_variables  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
N, N_PAD = 64, 11
BASE = dict(in_dim=5, coords_dim=4, h_dim=8, num_heads=2, n_layers=2, block_size=16,
            bucket_size=16, n_hashes=2, num_regions=9, num_w_per_dist=4, nb_features=16,
            nb_features_inner=4, knn_k=4, dropout=0.0)
H, D, CD = BASE["num_heads"], BASE["h_dim"], BASE["coords_dim"]
BASE_MODEL = {k: v for k, v in BASE.items() if k not in ("in_dim", "coords_dim")}
OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(got, want, tol, name="", floor=0.0):
    """|got - want| <= tol * max(scale of want, floor)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, floor, 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=name)


def _event(task="tracking", seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, BASE["in_dim"])).astype(np.float32)
    if task == "pileup":  # the last column is the PID
        x[:, -1] = rng.integers(0, 7, size=N)
    coords = rng.normal(size=(N, CD)).astype(np.float32)
    return x, coords, np.arange(N) < N - N_PAD


class _Recorder:
    """Records JAX's rotation draws (normal / uniform), in the order the
    modules trace them, through `jax.debug.callback`."""

    def __init__(self):
        self.n, self.vals = 0, {}

    def wrap(self, fn):
        def f(*a, **k):
            out = fn(*a, **k)
            i, self.n = self.n, self.n + 1
            jax.debug.callback(lambda v, i=i: self.vals.__setitem__(i, np.asarray(v)), out)
            return out
        return f

    def reset(self):
        self.n, self.vals = 0, {}

    def draws(self, attn_type: str, n_layers: int) -> list | None:
        """Per layer: reformer's rotations, smyrf's / sb's (alpha, beta)."""
        vals = [torch.from_numpy(np.array(self.vals[i])) for i in range(self.n)]
        if attn_type == "reformer":
            assert len(vals) == n_layers
            return vals
        if attn_type in ("smyrf", "sb"):
            assert len(vals) == 2 * n_layers
            return [(vals[2 * i], vals[2 * i + 1]) for i in range(n_layers)]
        assert not vals
        return None


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    rnd = types.SimpleNamespace(normal=rec.wrap(jax.random.normal),
                                uniform=rec.wrap(jax.random.uniform),
                                split=jax.random.split, PRNGKey=jax.random.PRNGKey)
    proxy = types.SimpleNamespace(random=rnd, lax=jax.lax, nn=jax.nn)
    for mod in (jref, jsmyrf, jsb):
        monkeypatch.setattr(mod, "jax", proxy)
    return rec


def _variables(init, *args, seed=0, **kw) -> dict:
    """Variables of a flax module's tree as `init` would build them, filled
    from numpy (jax.eval_shape traces the init without compiling it):
    TorchLinear kernels and w_rpe U(+-1/sqrt(fan_in)), biases U(+-0.1),
    LayerNorm scales 1 + N(0, 0.1), embeddings and frozen matrices N(0, 1)."""
    rng = np.random.default_rng(seed)
    keys = {"params": jax.random.PRNGKey(0), "rotations": jax.random.PRNGKey(1)}

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in ("kernel", "w_rpe"):
            bound = 1.0 / np.sqrt(shape[0] if name == "kernel" else shape[1])
            val = rng.uniform(-bound, bound, size=shape)
        elif name == "bias":
            val = rng.uniform(-0.1, 0.1, size=shape)
        elif name == "scale":
            val = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            val = rng.normal(size=shape)
        return jnp.asarray(val, leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init, keys, *args, **kw))


def _jit_run(fn, *args):
    """fn(*args) as one jitted call, waited for. XLA's CPU backend compiles
    it at optimisation level 0: these references are compiled once and run
    once, and their compile time is most of the file's."""
    compiled = jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    return jax.block_until_ready(compiled(*args))


def _check_grads(named_grads, ref: dict, tol=GRAD_TOL):
    """Every parameter gradient (None: not on the loss's path, so zero)
    against JAX's, floored at 1e-3 of the largest."""
    floor = 1e-3 * max(float(np.abs(r.numpy()).max()) for r in ref.values())
    for name, g, shape in named_grads:
        g = torch.zeros(shape) if g is None else g
        _close(g, ref[name].numpy(), tol, name, floor)


# --- ops ----------------------------------------------------------------------


def test_orthogonal_matrix_on_jax_draws():
    """gaussian_orthogonal_random_matrix / orthogonal_gaussian: on JAX's own
    Gaussian draws the port's QR + sign + scaling gives JAX's matrix (1e-5);
    the port's own draw is block-orthogonal, from its generator."""
    for nrows, ncols, scaling, transpose in ((10, 4, 0, False), (3, 1, 0, False),
                                             (6, 4, 1, False), (3, 4, 0, True)):
        nb = -(-nrows // ncols)

        def jax_side(key, nrows=nrows, ncols=ncols, scaling=scaling, nb=nb, tr=transpose):
            k1, k2 = jax.random.split(key)
            want = (jrff.orthogonal_gaussian(key, ncols, 2 * nrows) if tr else
                    jrff.gaussian_orthogonal_random_matrix(key, nrows, ncols, scaling))
            return (want, jax.random.normal(k1, (nb, ncols, ncols)),
                    jax.random.normal(k2, (nrows, ncols)))

        want, blocks, gauss = jax.jit(jax_side)(jax.random.PRNGKey(nrows + ncols))
        got = rff.orthogonal_from_draws(_t(blocks), _t(gauss), nrows, scaling)
        _close(got.t() if transpose else got, want, 1e-5, f"{nrows}x{ncols}")
    m = rff.gaussian_orthogonal_random_matrix(8, 8, 1, torch.Generator().manual_seed(0))
    torch.testing.assert_close(m @ m.t(), 8.0 * torch.eye(8), atol=1e-4, rtol=0)
    assert rff.orthogonal_gaussian(3, 6, torch.Generator().manual_seed(1)).shape == (3, 3)
    torch.testing.assert_close(
        rff.gaussian_orthogonal_random_matrix(10, 4, 0, torch.Generator().manual_seed(2)),
        rff.gaussian_orthogonal_random_matrix(10, 4, 0, torch.Generator().manual_seed(2)))


@pytest.mark.parametrize("fn", ["softmax_q", "softmax_k", "linear_attention", "favor", "rff"])
def test_feature_maps_match_jax(fn):
    """The feature maps and linear attention: value and input gradients 1e-5."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(2, 12, 6)).astype(np.float32)
    b = rng.normal(size=(2, 12, 6)).astype(np.float32)
    consts = dict(proj=rng.normal(size=(10, 6)), omega=rng.normal(size=(6, 5)),
                  off=rng.normal(size=(2, 12, 1)))

    def run(mod, exp, c, x, y):
        if fn == "softmax_q":
            return mod.softmax_kernel(x, c["proj"], True)
        if fn == "softmax_k":
            return mod.softmax_kernel(x, c["proj"], False, softmax_temp=0.7)
        if fn == "linear_attention":  # positive feature maps, as FAVOR+ gives them
            return mod.linear_attention(exp(x), exp(y), y)
        if fn == "favor":
            return mod.favor_features(x, c["omega"], c["off"])
        return mod.rff_features(x, c["omega"], gamma=0.5)

    jc = {k: jnp.asarray(v, jnp.float32) for k, v in consts.items()}
    tc = {k: _t(v, torch.float32) for k, v in consts.items()}
    w = rng.normal(size=np.asarray(run(jrff, jnp.exp, jc, a, b)).shape).astype(np.float32)
    want, jg = jax.block_until_ready(jax.jit(jax.value_and_grad(
        lambda x, y: jnp.sum(run(jrff, jnp.exp, jc, x, y) * w), argnums=(0, 1)))(a, b))
    x, y = _t(a).requires_grad_(), _t(b).requires_grad_()
    got = torch.sum(run(rff, torch.exp, tc, x, y) * _t(w))
    got.backward()
    _close(got, want, 1e-5, fn)
    _close(x.grad, jg[0], 1e-5, fn + " dx")
    _close(torch.zeros(b.shape) if y.grad is None else y.grad, jg[1], 1e-5, fn + " dy")


@pytest.mark.parametrize("op", ["sum", "mean", "max", "softmax", "softmax_mask"])
def test_segment_ops_match_jax(op):
    """The four segment ops with empty segments (ids skip 3 and 7), a
    weighted mean and a mask that empties a segment: value 1e-6 and input
    gradient 1e-5 (max: exact)."""
    rng = np.random.default_rng(2)
    ids = np.array([0, 0, 1, 2, 2, 2, 4, 5, 5, 6, 8, 8, 8, 1], np.int32)
    data = rng.normal(size=(ids.size, 3)).astype(np.float32)
    mask = np.ones(ids.size, bool)
    mask[[6, 2, 3]] = False  # segment 4 fully masked, segment 2 partly
    wts = rng.uniform(size=ids.size).astype(np.float32)

    def run(mod, x, ids_):
        arr = jnp.asarray if mod is jseg else _t
        if op == "sum":
            return mod.segment_sum(x, ids_, 9)
        if op == "mean":
            return mod.segment_mean(x, ids_, 9, weights=arr(wts))
        if op == "max":
            return mod.segment_max(x, ids_, 9)
        return mod.segment_softmax(x, ids_, 9, mask=None if op == "softmax" else arr(mask))

    want = np.asarray(jax.jit(lambda x: run(jseg, x, ids))(data))
    x = _t(data).requires_grad_()
    got = run(segment, x, _t(ids, torch.int64))
    if op == "max":
        np.testing.assert_array_equal(got.detach().numpy(), want)
        assert np.isneginf(want[[3, 7]]).all()
        return
    _close(got, want, 1e-6, op)
    if op in ("sum", "mean"):
        assert (want[[3, 7]] == 0).all()
    w = rng.normal(size=want.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda x: jnp.sum(run(jseg, x, ids) * w)))(data)
    torch.sum(got * _t(w)).backward()
    _close(x.grad, jg, 1e-5, op + " grad")


def test_segment_sum_same_bits_on_the_cpu():
    """The segment sum on the CPU at a size where index_put_ with accumulate
    would add with atomics from several threads (200000 x 8 values into 500
    segments): the same bits on repeated calls, and the float64 sum to f32
    rounding."""
    rng = np.random.default_rng(4)
    ids = _t(rng.integers(0, 500, 200000), torch.int64)
    vals = _t(rng.normal(size=(200000, 8)).astype(np.float32))
    first = segment.segment_sum(vals, ids, 500)
    for _ in range(5):
        assert torch.equal(segment.segment_sum(vals, ids, 500), first)
    want = np.zeros((500, 8))
    np.add.at(want, ids.numpy(), vals.numpy().astype(np.float64))
    np.testing.assert_allclose(first.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_gather_rows_matches_jax():
    rng = np.random.default_rng(3)
    perm = np.stack([np.stack([rng.permutation(10) for _ in range(2)]) for _ in range(3)])
    for shape in ((2, 10, 4), (3, 2, 10, 4)):
        x = rng.normal(size=shape).astype(np.float32)
        want = np.asarray(jbuckets.gather_rows(jnp.asarray(x), jnp.asarray(perm)))
        np.testing.assert_array_equal(gather_rows(_t(x), _t(perm, torch.int64)).numpy(), want)


# --- attention modules ----------------------------------------------------------

MODULES = {
    # name: (jax module, port class, kwargs, rpe-style pe_type)
    "performer": (jperf.PerformerAttention, PerformerAttention,
                  dict(nb_features=16, num_w_per_dist=4, coords_dim=CD)),
    "performer_rpe": (jperf.PerformerAttention, PerformerAttention,
                      dict(nb_features=16, num_w_per_dist=4, coords_dim=CD, pe_type="rpe")),
    "flt": (jflt.FLTAttention, FLTAttention,
            dict(nb_features=16, nb_features_inner=4, num_w_per_dist=4, coords_dim=CD)),
    "reformer": (jref.ReformerAttention, ReformerAttention, dict(bucket_size=16, n_hashes=2)),
    "reformer_no_cross": (jref.ReformerAttention, ReformerAttention,
                          dict(bucket_size=16, n_hashes=2, attend_across_buckets=False)),
    "reformer_no_dup": (jref.ReformerAttention, ReformerAttention,
                        dict(bucket_size=16, n_hashes=2, allow_duplicate_attention=False)),
    "smyrf": (jsmyrf.SmyrfAttention, SmyrfAttention,
              dict(bucket_size=16, n_hashes=2, num_w_per_dist=4, coords_dim=CD)),
    "smyrf_rpe": (jsmyrf.SmyrfAttention, SmyrfAttention,
                  dict(bucket_size=16, n_hashes=2, num_w_per_dist=4, coords_dim=CD,
                       pe_type="rpe")),
    "sb": (jsb.SBAttention, SBAttention,
           dict(bucket_size=16, n_hashes=2, nb_features=16, num_w_per_dist=4, coords_dim=CD)),
    "pct": (jpct.PCTAttention, PCTAttention, dict(coords_dim=CD)),
    "flatformer": (jflat.FlatformerAttention, FlatformerAttention,
                   dict(group_size=16, num_w_per_dist=4, b_grid=40, num_slices_per_axis=4)),
    "flatformer_rpe": (jflat.FlatformerAttention, FlatformerAttention,
                       dict(group_size=16, num_w_per_dist=4, b_grid=40, num_slices_per_axis=4,
                            pe_type="rpe")),
}


def _flax_to_torch(tree, prefix="") -> dict:
    """A flax module tree -> torch names (kernel -> weight (out, in), scale ->
    weight; flatformer's block_j -> layers.j)."""
    out = {}
    for k, v in tree.items():
        name = f"layers.{k.split('_')[1]}" if k.startswith("block_") else k
        if hasattr(v, "items"):
            out.update(_flax_to_torch(v, f"{prefix}{name}."))
        elif k == "kernel":
            out[prefix + "weight"] = _t(v).t().contiguous()
        elif k == "scale":
            out[prefix + "weight"] = _t(v)
        else:
            out[prefix + k] = _t(v)
    return out


@pytest.mark.parametrize("case", sorted(MODULES))
def test_attention_module_matches_jax(case, recorder):
    """Each attention module alone on the same inputs, constants and
    rotations: output 1e-5 x scale, input and parameter gradients 1e-4."""
    jcls, pcls, kw = MODULES[case]
    rng = np.random.default_rng(4)
    x, coords, valid = _event()
    coords[~valid] = 0.0
    width = H * D
    name = case.split("_")[0]
    qkv = [rng.normal(size=(N, D if name == "flatformer" else width)).astype(np.float32)
           for _ in range(3)]
    w_rpe = (0.3 * rng.normal(size=(width, 4 * (CD - 1)))).astype(np.float32)
    pe = rng.normal(size=(N, D)).astype(np.float32)
    jkw = dict(h_dim=D, num_heads=H, **kw)
    module = jcls(**jkw)
    edges = edge_mask = None
    if name == "pct":
        te, tm = knn_graph(_t(coords), _t(valid), 4)
        edges, edge_mask = te.numpy().astype(np.int32), tm.numpy()

    def call(variables, q, k, v, w_rpe, pe):
        extra = dict(coords=jcoords, valid=jvalid)
        if name == "pct":
            return module.apply(variables, q, edges=edges, edge_mask=edge_mask, **extra)
        if name == "flatformer":
            pe_in = jcoords if kw.get("pe_type") == "rpe" else pe
            out, inner = module.apply(variables, q, pe=pe_in, w_rpe_weight=w_rpe, **extra)
            return out + sum(inner)
        return module.apply(variables, q, k, v, w_rpe_weight=w_rpe, **extra,
                            rngs={"rotations": jax.random.PRNGKey(7)})

    jvalid, jcoords = jnp.asarray(valid), jnp.asarray(coords)
    if name == "pct":
        variables = _variables(module.init, qkv[0], coords=coords, valid=jvalid, edges=edges,
                               edge_mask=edge_mask)
    elif name == "flatformer":
        variables = _variables(module.init, qkv[0], coords=coords, valid=jvalid,
                               pe=coords if kw.get("pe_type") == "rpe" else pe,
                               w_rpe_weight=w_rpe)
    else:
        variables = _variables(module.init, *qkv, coords=coords, valid=jvalid,
                               w_rpe_weight=w_rpe)
    wo = rng.normal(size=(N, D)).astype(np.float32) * valid[:, None]

    def jloss(p, q, k, v, w, e):
        out = call({**variables, "params": p}, q, k, v, w, e)
        return jnp.sum(out * wo), out

    recorder.reset()
    (_, jout), jg = _jit_run(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4, 5), has_aux=True),
                             variables["params"], *qkv, w_rpe, pe)
    draws = recorder.draws(name, 1)

    # sb's JAX module keeps fields it never reads (num_w_per_dist, coords_dim)
    pkw = {k: v for k, v in kw.items() if not (name == "sb" and k in ("num_w_per_dist",
                                                                       "coords_dim"))}
    port = pcls(h_dim=D, num_heads=H, generator=torch.Generator().manual_seed(0), **pkw)
    sd = _flax_to_torch(variables["params"])
    sd.update(_flax_to_torch(variables.get("constants", {})))
    port.load_state_dict(sd)
    tq, tk, tv, tw, tpe = (_t(a).requires_grad_() for a in (*qkv, w_rpe, pe))
    tc, tvalid = _t(coords), _t(valid)
    if name == "pct":
        out = port(tq, tc, tvalid, _t(edges, torch.int64), _t(edge_mask))
    elif name == "flatformer":
        o, inner = port(tq, tc, tc if kw.get("pe_type") == "rpe" else tpe, tvalid, tw)
        out = o + sum(inner)
    elif name in ("reformer", "sb"):
        out = port(tq, tk, tv, tvalid, rotations=draws[0])
    elif name == "smyrf":
        out = port(tq, tk, tv, tc, tvalid, tw, rotations=draws[0])
    else:
        out = port(tq, tk, tv, tc, tvalid, tw)
    torch.sum(out * _t(wo)).backward()
    _close(out, jout, OUT_TOL, case)
    pg, *ig = jg
    ref = _flax_to_torch(pg)
    _check_grads([(n, p.grad, p.shape) for n, p in port.named_parameters()], ref)
    for t, want, nm in zip((tq, tk, tv, tw, tpe), ig, ("q", "k", "v", "w_rpe", "pe")):
        _check_grads([(nm, t.grad, t.shape)], {nm: torch.from_numpy(np.array(want))})


def test_flatformer_orderings_and_sinusoidal_pe_match_jax():
    """discretize_coords, the serpentine keys (exact) and the fixed
    sinusoidal embedding (1e-6)."""
    rng = np.random.default_rng(5)
    coords = rng.normal(size=(N, CD)).astype(np.float32)
    dis = discretize_coords(_t(coords[:, :2]), 1000)
    jdis = jflat.discretize_coords(jnp.asarray(coords[:, :2]), 1000)
    np.testing.assert_array_equal(dis.numpy(), np.asarray(jdis))
    for shifted in (False, True):
        for got, want in zip(serpentine_keys(dis, 1000, 30, shifted),
                             jflat.serpentine_keys(jdis, 1000, 30, shifted)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mod = JaxPESinusoidal(D)
    want = mod.apply(mod.init(jax.random.PRNGKey(0), coords), coords)
    _close(PESinusoidal(D)(_t(coords)), want, 1e-6, "pe fixed")


# --- whole models -----------------------------------------------------------------


def _jax_model(attn_type, task, **kw):
    cfg = JaxConfig(attn_type=attn_type, task=task, **{**BASE, "pe_type": "learned", **kw})
    return JaxHept(cfg)


def _port_model(variables, attn_type, task, **kw):
    cfg = TransformerConfig(attn_type=attn_type, task=task,
                            **{**BASE, "pe_type": "learned", **kw})
    model = HeptTransformer(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(from_jax_variables(variables))
    return model


def _model_case(recorder, attn_type, task, **kw):
    x, coords, valid = _event(task, seed=6)
    jmodel = _jax_model(attn_type, task, **kw)
    variables = _variables(jmodel.init, x, coords, jnp.asarray(valid))
    width = 1 if task == "pileup" else D // 2
    wo = np.random.default_rng(7).normal(size=(N, width)).astype(np.float32) * valid[:, None]
    consts = {k: v for k, v in variables.items() if k != "params"}

    def jloss(params, x, coords, valid):
        out = jmodel.apply({"params": params, **consts}, x, coords, valid,
                           rngs={"rotations": jax.random.PRNGKey(2)})
        return jnp.sum(out * wo), out

    recorder.reset()
    (_, jout), jg = _jit_run(jax.value_and_grad(jloss, has_aux=True), variables["params"], x,
                             coords, jnp.asarray(valid))
    model = _port_model(variables, attn_type, task, **kw)
    out = model(_t(x), _t(coords), _t(valid),
                rotations=recorder.draws(attn_type, kw.get("n_layers", BASE["n_layers"])))
    torch.sum(out * _t(wo)).backward()
    _close(out, jout, OUT_TOL, f"{attn_type} {task}")
    ref = from_jax_variables({"params": jg, "constants": variables.get("constants", {})})
    _check_grads([(n, p.grad, p.shape) for n, p in model.named_parameters()], ref)


@pytest.mark.parametrize("task", ["tracking", "pileup"])
@pytest.mark.parametrize("attn_type", BASELINES)
def test_model_matches_jax(attn_type, task, recorder):
    """Each baseline as a whole model for both tasks, JAX's weights carried
    across: output 1e-5 x scale, every parameter gradient 1e-4. Pileup runs
    one layer: its difference, the PID embedding and the sigmoid head, is
    outside the layer stack that tracking runs at two."""
    _model_case(recorder, attn_type, task, n_layers=1 if task == "pileup" else 2)


def test_model_fixed_pe_matches_jax(recorder):
    """pe_type "fixed" (the sinusoidal embedding in every block and in each
    of flatformer's group layers)."""
    _model_case(recorder, "flatformer", "tracking", pe_type="fixed")


def test_smyrf_adam_step_matches_jax(recorder):
    """One train_step of smyrf (lr 1e-3, dropout off) against
    make_single_device_train_step, JAX's per-event rotations (drawn from the
    step's key) recorded and passed in: loss 1e-5, gradient norm 1e-4,
    Adam's first moment 1e-4 x scale + 1e-8, and the update wherever the
    gradient is clear of zero (Adam's first step is lr * sign(g)) to 1e-6."""
    ev = synthetic_tracking_event(np.random.default_rng(5), n_points=378, pairs_per_point=8)
    batch = pack_events([ev], block_size=16, window_pairs=128)
    kw = dict(model_name="trans_smyrf", loss_kwargs=dict(tau=0.05, dist_metric="l2_rbf"),
              model_kwargs=dict(BASE_MODEL, pe_type="learned"))
    jcfg = JaxExperimentConfig(**kw)
    jmodel = JaxHept(jcfg.model_config(10, 6))
    variables = _variables(jmodel.init, batch["x"][0], batch["coords"][0],
                           jnp.asarray(batch["valid"][0]))
    tx = jax_make_optimizer("adam", schedule=make_lr_schedule("step", 1e-3))
    state = TrainState.create(variables, tx, jax.random.PRNGKey(3))
    step = make_single_device_train_step(make_model_apply(jmodel), jax_make_loss_fn(jcfg), tx)
    recorder.reset()
    new_state, jm = _jit_run(step, state, jax.tree_util.tree_map(jnp.asarray, batch))
    draws = recorder.draws("smyrf", BASE_MODEL["n_layers"])

    cfg = ExperimentConfig(device="cpu", **kw)
    model = trainer.build_model(cfg, 10, 6, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(from_jax_variables(variables))
    forward = model.forward
    model.forward = lambda *a, **k: forward(*a, rotations=draws, **k)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = trainer.make_optimizer(model.parameters(), lr=1e-3)
    m = trainer.train_step(model, opt, trainer.make_loss_fn(cfg),
                           trainer.batch_to_device(batch, "cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    after = from_jax_variables(new_state.variables)
    mu = from_jax_variables({"params": new_state.opt_state.inner_state[0].mu,
                             "constants": {}})
    for name, p in model.named_parameters():
        want = mu[name].numpy()
        got = opt.state[p]["exp_avg"].numpy() if p in opt.state else np.zeros_like(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-8,
                                   err_msg=name)
        g = want / 0.1
        clear = np.abs(g) > max(1e-2 * np.abs(g).max(), 1e-5)
        d_port = (p.detach() - before[name]).numpy()
        d_jax = (after[name] - before[name]).numpy()
        np.testing.assert_allclose(d_port[clear], d_jax[clear], rtol=0, atol=1e-6, err_msg=name)


# --- configs and the trainer --------------------------------------------------------


@pytest.mark.parametrize("task", ["tracking", "pileup"])
@pytest.mark.parametrize("attn_type", BASELINES)
def test_baseline_yaml_equals_jax(attn_type, task):
    """The port's YAML is the JAX package's file, byte for byte; loaded, it
    equals JAX's load_config key by key (attn_impl, which no baseline reads,
    keeps each package's default); the port builds its model."""
    pytest.importorskip("yaml")
    name = f"{task}_trans_{attn_type}.yaml"
    assert (CONFIG_ROOT / task / name).read_bytes() == \
        (REPO / "hept_tpu" / "configs" / task / name).read_bytes()
    cfg = profile_config(attn_type, task=task)
    jcfg = jax_load_config(REPO / "hept_tpu" / "configs" / task / name)
    for f in dataclasses.fields(ExperimentConfig):
        if hasattr(jcfg, f.name) and f.name not in ("device", "attn_impl"):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    mc = cfg.model_config(10, 6)
    mc.check_supported()
    assert mc.attn_type == attn_type and mc.h_dim == (20 if attn_type == "flatformer" else 24)


def test_check_supported_accepts_the_baselines_and_refuses_use_ckpt():
    """Every attn_type runs, with use_ckpt too (`test_torch_ckpt.py`), and
    HEPT's use_ckpt under head sharding (`test_torch_tp_post_sort.py`);
    use_ckpt with a baseline's head sharding is refused, as JAX's TP step
    refuses any baseline (naming hept_tpu/parallel/tp.py:125)."""
    for t in ("hept",) + BASELINES:
        TransformerConfig(in_dim=5, coords_dim=4, attn_type=t).check_supported()
        TransformerConfig(in_dim=5, coords_dim=4, attn_type=t, use_ckpt=True).check_supported()
    TransformerConfig(in_dim=5, coords_dim=4, attn_type="hept", use_ckpt=True,
                      head_shards=2).check_supported()
    with pytest.raises(NotImplementedError, match="tp.py:125"):
        TransformerConfig(in_dim=5, coords_dim=4, attn_type="performer", use_ckpt=True,
                          head_shards=2).check_supported()
    with pytest.raises(NotImplementedError, match="attn_type"):
        TransformerConfig(in_dim=5, coords_dim=4, attn_type="gcn").check_supported()
    # the hept modes are checked for hept only
    TransformerConfig(in_dim=5, coords_dim=4, attn_type="performer",
                      padding_mode="zero").check_supported()


@pytest.mark.parametrize("attn_type", BASELINES)
def test_run_one_seed_of_each_tracking_baseline(attn_type, tmp_path):
    """One epoch of each tracking baseline at the test width on three tiny
    synthetic events (400 points: n a multiple of 200, as reformer and
    flatformer need): finite loss, metrics in [0, 1], and the train step
    draws its rotations from the step's generator."""
    ds = make_synthetic_tracking(3, 400, seed=1)
    cfg = ExperimentConfig(model_name=f"trans_{attn_type}", device="cpu", num_epochs=1,
                           log_dir=str(tmp_path),
                           model_kwargs=dict(BASE_MODEL, block_size=100, bucket_size=100,
                                             pe_type="learned", dropout=0.1))
    res = trainer.run_one_seed(cfg, ds, log=lambda *a: None)
    assert np.isfinite(res["loss"])
    for k, v in res.items():
        if k != "loss":
            assert 0.0 <= v <= 1.0, (k, v)


@pytest.mark.parametrize("attn_type", ["reformer", "smyrf", "sb"])
def test_lsh_draws_fixed_without_generator(attn_type):
    """Without a generator the LSH baselines take one fixed draw (the same
    for every model and call, also when first made under inference_mode,
    as `evaluate` makes it, and then used by a training forward); with the
    step's generator each forward draws anew; recorded sort orders imposed
    on another call give its output."""
    x, coords, valid = _event()
    args = (_t(x), _t(coords), _t(valid))
    cfg = TransformerConfig(attn_type=attn_type, **{**BASE, "pe_type": "learned"})
    model = HeptTransformer(cfg, torch.Generator().manual_seed(0))
    with torch.inference_mode():
        first = model(*args)
    out = model(*args)
    out.sum().backward()  # the cached fixed draw is no inference tensor
    torch.testing.assert_close(out.detach(), first, rtol=0, atol=0)
    other = HeptTransformer(cfg, torch.Generator().manual_seed(0))
    torch.testing.assert_close(other(*args).detach(), first, rtol=0, atol=0)
    gen = torch.Generator().manual_seed(5)
    drawn = model(*args, generator=gen)
    assert not torch.allclose(drawn, first)
    perms = []
    with torch.no_grad():
        a = model(*args, generator=torch.Generator().manual_seed(6), record_perms=perms)
        b = model(*args, perms=perms)
    assert len(perms) == BASE["n_layers"]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_demo_block_size_packs_a_baseline(monkeypatch):
    """`train_60k_demo --block-size 200` packs a baseline's events to
    multiples of 200 (reformer and flatformer need it); a HEPT profile,
    whose block size is its bucket size, refuses the option."""
    pytest.importorskip("yaml")
    from hept_tpu_torch.scripts import train_60k_demo

    seen = {}
    monkeypatch.setattr(train_60k_demo, "make_synthetic_tracking", lambda **kw: None)
    monkeypatch.setattr(train_60k_demo, "run_one_seed",
                        lambda cfg, dataset: seen.update(cfg=cfg) or dict.fromkeys(
                            ("accuracy@0.9", "recall@0.9", "precision@0.9", "loss"), 0.0))
    train_60k_demo.main(["1e-3", "42", "1", "1", "--profile", "reformer", "--block-size", "200",
                         "--device", "cpu"])
    assert seen["cfg"].model_kwargs["block_size"] == 200
    assert seen["cfg"].model_kwargs["bucket_size"] == 100
    with pytest.raises(SystemExit):
        train_60k_demo.main(["--profile", "hept", "--block-size", "200", "--device", "cpu"])
