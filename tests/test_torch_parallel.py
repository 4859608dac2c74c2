"""The port's parallel modes against the JAX package's on the conftest's 8
virtual CPU devices: DP at world 2 (`make_dp_train_step`), DP x hash-TP x
head-TP at world 4 (`make_tp_train_step`), `head_sharded_attention` at
world 2 (`sp.py`), `shard_state_dict` against `param_specs`' slices, and a
one-epoch `run_one_seed` over two ranks (DP, and head-TP) in which only rank
0 writes.

The port's ranks are processes of `torch_parallel_workers.py` (torch only)
in a gloo group that meets through a file in the test's tmp dir. Every
spawn has a join timeout that kills the ranks and fails the test. JAX is
imported inside the tests. Tolerances: f32 loss 1e-5; gradients, parameter
updates and attention outputs 1e-4 of their scale; Adam's update, lr *
sign(g) wherever g is clear of zero, 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hept_tpu_torch.data.batching import pack_events  # noqa: E402
from hept_tpu_torch.data.synthetic import synthetic_tracking_event  # noqa: E402
from hept_tpu_torch.utils.convert import from_jax_variables  # noqa: E402
from torch_ranks import spawn as _spawn  # noqa: E402

STATIC_MK = dict(h_dim=8, num_heads=2, n_layers=2, block_size=16, n_hashes=2, static_rounds=4,
                 num_regions=16, num_w_per_dist=10, qkv_post_sort=True, shared_sort=True,
                 share_heads=True, static_keys="x0", unsort_rows=True, dropout=0.0)
DYNAMIC_MK = dict(h_dim=8, num_heads=4, n_layers=2, block_size=16, n_hashes=2, num_regions=9,
                  num_w_per_dist=3, dropout=0.0)
LOSS = dict(tau=0.05, dist_metric="l2_rbf")


def _batch(sizes=(96, 80), seed=5):
    rng = np.random.default_rng(seed)
    evs = [synthetic_tracking_event(rng, n_points=n, pairs_per_point=8) for n in sizes]
    return pack_events(evs, block_size=16, n_max=112 if max(sizes) > 96 else 96,
                       window_pairs=128)


def _jax_init(exp_kw, batch):
    import jax

    from hept_tpu.models import HeptTransformer as JaxHept
    from hept_tpu.train.config import ExperimentConfig as JaxExperimentConfig

    jcfg = JaxExperimentConfig(**exp_kw)
    jmodel = JaxHept(jcfg.model_config(10, 6))
    variables = jax.block_until_ready(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), batch["x"][0], batch["coords"][0], batch["valid"][0]))
    return jcfg, jmodel, variables


def _close(a, b, tol, name="", floor=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * max(np.abs(b).max(), 1e-12) + floor,
                               err_msg=name)


def test_dp_world2_matches_jax(tmp_path):
    """Two data ranks, an event each, one Adam step (lr 1e-2), the static
    plan in f32, against JAX's DP step on 2 devices: both ranks end equal
    (bit for bit), the loss to 1e-5, the gradient norm to 1e-4, Adam's
    first moment (0.1 g) to 1e-4 of scale + 1e-7 (the output bias's
    gradient is zero up to rounding, ~1e-9: the loss reads embedding
    differences only, as in `test_torch_train.py`), the update where g is
    clear of zero to 1e-6."""
    import jax
    import jax.numpy as jnp

    from hept_tpu.parallel.dp import make_dp_train_step, shard_batch
    from hept_tpu.parallel.mesh import make_mesh
    from hept_tpu.train.optim import make_lr_schedule
    from hept_tpu.train.optim import make_optimizer as jax_make_optimizer
    from hept_tpu.train.state import TrainState
    from hept_tpu.train.trainer import make_loss_fn, make_model_apply

    batch = _batch()
    exp = dict(model_kwargs=STATIC_MK, attn_impl="slab2", loss_kwargs=LOSS, batch_size=2)
    jcfg, jmodel, variables = _jax_init(exp, batch)
    tx = jax_make_optimizer("adam", schedule=make_lr_schedule("step", 1e-2))
    mesh = make_mesh(2)
    step = make_dp_train_step(make_model_apply(jmodel), make_loss_fn(jcfg), tx, mesh,
                              donate=False)
    new_state, jm = jax.block_until_ready(step(
        TrainState.create(variables, tx, jax.random.PRNGKey(1)),
        shard_batch(jax.tree_util.tree_map(jnp.asarray, batch), mesh)))

    before = from_jax_variables(variables)
    outs = _spawn("dp", 2, tmp_path, dict(exp=dict(exp, device="cpu"), in_dim=10, coords_dim=6,
                                          state_dict=before, batch=batch, lr=1e-2))
    for k, v in outs[0]["state_dict"].items():
        assert torch.equal(v, outs[1]["state_dict"][k]), k
    o = outs[0]
    np.testing.assert_allclose(o["loss"], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(o["grad_norm"], float(jm["grad_norm"]), rtol=1e-4)
    after = from_jax_variables(new_state.variables)
    mu = from_jax_variables({"params": new_state.opt_state.inner_state[0].mu,
                             "constants": variables["constants"]})
    for name, m in o["exp_avg"].items():
        r = mu[name].numpy()
        _close(m.numpy(), r, 1e-4, name, floor=1e-7)
        g = r / 0.1
        clear = np.abs(g) > max(1e-2 * np.abs(g).max(), 1e-5)
        d_port = (o["state_dict"][name] - before[name]).numpy()
        d_jax = (after[name] - before[name]).numpy()
        np.testing.assert_allclose(d_port[clear], d_jax[clear], rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("sizes,padding", [
    pytest.param((1, 2, 2), "replicate", id="hashes2xheads2"),
    pytest.param((2, 1, 2), "replicate", id="data2xheads2"),
    pytest.param((2, 1, 2), "zero", id="data2xheads2_zero"),
])
def test_tp_world4_matches_jax(tmp_path, sizes, padding):
    """DP x hash-TP x head-TP over ("data", "hashes", "heads") at world 4,
    the dynamic-key path (4 heads, 2 OR rounds; events of 90 and 75 points,
    so the replication pads follow global hash 0 / head 0), one SGD step
    (lr 1: the update is the gradient). Against the port's single-process
    step on the whole batch (same ranks' threads): the loss equal, the
    gradient norm and every parameter's update to 1e-4 of scale (the
    decomposition is exact up to f32 summation order). Against JAX's
    `make_tp_train_step` on the same mesh: the loss to 1e-5, the gradient
    norm to 1e-4, the updates to 1e-3 of scale, the port-vs-JAX level of the
    dynamic-key step on one device (7.3e-4 of scale on w_rpe here, JAX's
    single-device step against the port's; `test_torch_parity_model.py`
    holds gradients at 1e-3 too). Each with a 1e-7 floor: the output bias's
    gradient is zero up to rounding (~1e-8). With zero padding (the
    reference's src variant) each shard computes its own heads' float codes
    and no pad plan is shared."""
    import jax
    import jax.numpy as jnp
    import optax

    from hept_tpu.models import HeptTransformer as JaxHept
    from hept_tpu.parallel.mesh import make_mesh
    from hept_tpu.parallel.tp import make_tp_train_step, shard_batch_2d
    from hept_tpu.train.state import TrainState
    from hept_tpu.train.trainer import make_loss_fn

    batch = _batch((90, 75), seed=0)
    exp = dict(model_kwargs=DYNAMIC_MK, attn_impl="pallas", loss_kwargs=LOSS, batch_size=2,
               padding_mode=padding)
    jcfg, jmodel, variables = _jax_init(exp, batch)
    tx = optax.sgd(1.0)
    mesh = make_mesh(4, ("data", "hashes", "heads"), sizes)
    step = make_tp_train_step(JaxHept, jcfg.model_config(10, 6), make_loss_fn(jcfg), tx, mesh,
                              variables, head_axis="heads", hash_axis="hashes")
    new_state, jm = jax.block_until_ready(step(
        TrainState.create(variables, tx, jax.random.PRNGKey(1)),
        shard_batch_2d(jax.tree_util.tree_map(jnp.asarray, batch), mesh)))

    before = from_jax_variables(variables)
    outs = _spawn("tp", 4, tmp_path, dict(exp=dict(exp, device="cpu"), in_dim=10, coords_dim=6,
                                          sizes=sizes, state_dict=before, batch=batch, lr=1.0))
    o, single = outs[0], outs[0]["single"]
    assert all(x["loss"] == o["loss"] for x in outs)
    np.testing.assert_allclose(o["loss"], single["loss"], rtol=1e-6)
    np.testing.assert_allclose(o["grad_norm"], single["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(o["loss"], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(o["grad_norm"], float(jm["grad_norm"]), rtol=1e-4)
    after = from_jax_variables(new_state.variables)
    for name, v in o["state_dict"].items():
        assert v.shape == before[name].shape, name
        d = (v - before[name]).numpy()
        _close(d, (single["state_dict"][name] - before[name]).numpy(), 1e-4, name, floor=1e-7)
        _close(d, (after[name] - before[name]).numpy(), 1e-3, name, floor=1e-7)


def test_head_sharded_attention_world2_matches_jax(tmp_path):
    """`head_sharded_attention` over two ranks (4 heads each) against JAX's
    `sp.py` on 2 devices: the output and the input gradients (through a
    fixed random cotangent) to 1e-4 of scale, on both ranks."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from hept_tpu.ops import hept_attention_core
    from hept_tpu.parallel.sp import head_sharded_attention

    h, n, d, dv, c, bs = 8, 64, 5, 4, 2, 16
    rng = np.random.default_rng(0)
    q, k = (rng.normal(size=(h, n, d)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(h, n, dv)).astype(np.float32)
    alpha = rng.normal(size=(h, d, c)).astype(np.float32)
    codes = rng.integers(0, 4, size=(c, h, n)).astype(np.float32)
    invalid = np.zeros(n, bool)
    invalid[-5:] = True
    cot = rng.normal(size=(h, n, dv)).astype(np.float32)
    sharded = head_sharded_attention(Mesh(np.asarray(jax.devices()[:2]), ("heads",)), "heads",
                                     block_size=bs)

    def loss(q, k, v):
        out = sharded(q, k, v, alpha, codes, invalid)
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.block_until_ready(jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v))
    ref = np.asarray(hept_attention_core(q, k, v, alpha, codes, invalid, block_size=bs))
    _close(np.asarray(jout), ref, 1e-5)

    t = torch.from_numpy
    outs = _spawn("sp", 2, tmp_path, dict(q=t(q), k=t(k), v=t(v), alpha=t(alpha),
                                          codes=t(codes), invalid=t(invalid), cot=t(cot),
                                          block_size=bs))
    for o in outs:
        _close(o["out"].numpy(), np.asarray(jout), 1e-4, "out")
        for name, g in zip(("dq", "dk", "dv"), jgrads):
            _close(o[name].numpy(), np.asarray(g), 1e-4, name)


def test_shard_state_dict_matches_param_specs():
    """The port's slice of carried weights (`from_jax_variables` with a
    mesh's sizes and coordinates) equals the slice JAX's `param_specs`
    gives every leaf, at each (hashes, heads) coordinate of a 2 x 2 mesh,
    and, for a share_heads model (its e2lsh_alpha one head wide, so JAX's
    TP step runs it with one head shard), of a 2 x 1 mesh."""
    import jax
    from jax.sharding import PartitionSpec

    from hept_tpu.parallel.tp import param_specs

    batch = _batch((90, 75), seed=0)
    share_heads = dict(DYNAMIC_MK, qkv_post_sort=True, shared_sort=True, share_heads=True)
    for mk, heads in ((DYNAMIC_MK, 2), (share_heads, 1)):
        _, _, variables = _jax_init(dict(model_kwargs=mk, attn_impl="pallas"), batch)
        sizes = {"data": 1, "hashes": 2, "heads": heads}
        specs = {col: param_specs(variables[col], "heads", "hashes") for col in variables}

        def take(leaf, spec, coords):
            a = np.asarray(leaf)
            for dim, axis in enumerate(spec):
                if axis is not None:
                    w = a.shape[dim] // sizes[axis]
                    a = np.take(a, range(coords[axis] * w, (coords[axis] + 1) * w), axis=dim)
            return a

        sharded_any = False
        for hh in range(2):
            for hd in range(heads):
                coords = {"data": 0, "hashes": hh, "heads": hd}
                sliced = {col: jax.tree_util.tree_map(
                    lambda x, s: take(x, s, coords), variables[col], specs[col],
                    is_leaf=lambda s: isinstance(s, PartitionSpec)) for col in variables}
                want = from_jax_variables(sliced)
                got = from_jax_variables(variables, sizes, coords)
                assert set(got) == set(want)
                for name in want:
                    assert torch.equal(got[name], want[name]), name
                    sharded_any |= got[name].shape != from_jax_variables(variables)[name].shape
        assert sharded_any
        if heads == 1:  # the one-head alpha splits its rounds over the hash shards
            alpha = from_jax_variables(variables, sizes, {"data": 0, "hashes": 1, "heads": 0})
            assert alpha["blocks.0.attn.e2lsh_alpha"].shape == (1, mk["h_dim"] + 6, 1)


def test_static_plan_tp_is_refused():
    """What JAX cannot run (head-TP of a static plan) or runs as another
    model (its hash-TP) the port refuses, naming the JAX lines."""
    from hept_tpu_torch.models.transformer import TransformerConfig
    from hept_tpu_torch.parallel.tp import local_config

    cfg = TransformerConfig(in_dim=10, coords_dim=6, **STATIC_MK)
    with pytest.raises(NotImplementedError, match="tp.py:70-72"):
        local_config(cfg, 2, 1).check_supported()
    with pytest.raises(NotImplementedError, match="tp.py:34-78"):
        local_config(cfg, 1, 2).check_supported()
    with pytest.raises(ValueError, match="not divisible by 3 head shards"):
        local_config(cfg, 3, 1)


@pytest.mark.parametrize("mode", ["dp", "tp"])
def test_run_one_seed_two_ranks(tmp_path, mode):
    """One epoch of `run_one_seed` over two ranks, DP (an event a rank) or
    head-TP (the dynamic-key path, shard_heads 2): both ranks return the
    same metrics, only rank 0 writes a run dir, and its checkpoint holds
    the whole model."""
    mk = STATIC_MK if mode == "dp" else DYNAMIC_MK
    exp = dict(model_kwargs=mk, attn_impl="slab2" if mode == "dp" else "pallas",
               loss_kwargs=LOSS, batch_size=2 if mode == "dp" else 1, num_epochs=1,
               device="cpu", n_devices=2, shard_heads=1 if mode == "dp" else 2,
               log_dir=str(tmp_path / "runs"), pair_aug_p=0.0)
    outs = _spawn("run", 2, tmp_path / "w", dict(
        exp=exp, dataset=dict(n_events=5, n_points=60, seed=0)))
    assert outs[0]["res"] == outs[1]["res"]
    assert np.isfinite(outs[0]["res"]["accuracy@0.9"])
    runs = list((tmp_path / "runs").iterdir())
    assert len(runs) == 1
    ckpts = list((runs[0] / "ckpt").glob("step_*.pt"))
    assert ckpts and (runs[0] / "scalars.jsonl").exists()
    sd = torch.load(ckpts[0], weights_only=True)["model"]
    assert sd["blocks.0.w_q.weight"].shape == (mk["num_heads"] * mk["h_dim"], mk["h_dim"])


def check_collectives(tmp_path, device: str) -> None:
    """Two ranks: all_gather's forward and its backward (this rank's slice
    of the cotangent), all_reduce_fwd's sum and identity backward,
    copy_to_group's identity and summed backward, broadcast from group rank
    0, all_to_all's exchange of cells and its backward (the same exchange
    of the cotangent), every result on `device`; exact (small integers)."""
    outs = _spawn("collectives", 2, tmp_path, dict(device=device))
    w = torch.arange(12.0).reshape(4, 3)
    whole = torch.cat([torch.arange(6.0).reshape(2, 3) + 10 * r for r in range(2)])
    for rank, o in enumerate(outs):
        assert o["on_device"].all()
        assert torch.equal(o["gathered"], whole)
        assert torch.equal(o["dx"], w[2 * rank:2 * rank + 2])
        assert torch.equal(o["summed"], torch.full((2, 3), 3.0))
        assert torch.equal(o["dz"], w[:2])
        assert torch.equal(o["du"], torch.full((2, 3), 3.0))
        assert torch.equal(o["b"], torch.full((3,), 5.0))
        # cell i of rank r's result is rank i's cell r; the gradient of rank
        # r's cell j is rank j's weight row r
        cells = torch.arange(6.0).reshape(2, 3)
        assert torch.equal(o["swapped"], cells[rank] + 10 * torch.arange(2.0)[:, None])
        assert torch.equal(o["da"], cells[rank] + 100 * torch.arange(2.0)[:, None])


def test_collectives_autograd(tmp_path):
    """The collectives' gradients, on CPU tensors (the card's case is in
    `test_torch_cuda.py`)."""
    check_collectives(tmp_path, "cpu")
