"""The post-sort dynamic-key paths and `use_ckpt` under head / hash tensor
parallelism, the port's DP x hash-TP x head-TP step against the JAX
package's `make_tp_train_step` on the conftest's virtual CPU devices.

One spawn per ("data", "hashes", "heads") mesh of world 4 runs every mode
of that mesh (`torch_parallel_workers.py:tp_modes_task`): one SGD step (lr
1, so the update is the gradient), 4 heads and 2 OR rounds, on two events
of 90 and 75 points (the replication pads follow global hash 0 / head 0)
against the port's single process, and on two of 96 points (no pads, so
no tied keys) against JAX.
- per-head post-sort keys (qkv_post_sort), with and without shared_sort,
  on every mesh; share_heads' keys (f32, and with hept_fast's modes:
  unsort_rows and the bf16 transport and kernels) and the fp8 unsort under
  hash TP only: JAX's shard_map refuses share_heads under head TP, and so
  does the port (`test_share_heads_head_tp_is_refused`);
- the gather_sort and fold_unsort / unsort_rows twins: their base run's
  bits;
- use_ckpt on the pre-sort and per-head post-sort paths at (1, 2, 2):
  against JAX's use_ckpt step, and the bits of the port's own step without
  it (with dropout too, and the dropout generator left where it was).

Tolerances, `test_torch_parallel.py::test_tp_world4_matches_jax`'s: against
JAX the loss to 1e-5, the gradient norm to 1e-4 and every parameter's
update to 1e-3 of its scale; against the port's single-process step the
loss to 1e-6, the gradient norm and the updates to 1e-4 of scale; each
with a floor (`FLOOR`: the output bias's gradient is zero up to rounding). The
bf16 and fp8 modes take `test_torch_dynamic_bf16.py`'s: the updates to 2e-2
of each tensor's scale floored at 2e-2 of the largest one's and the whole
to 1e-3 relative L2, the loss to 1e-3 and the gradient norm to 1e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hept_tpu_torch.models.transformer import TransformerConfig  # noqa: E402
from hept_tpu_torch.parallel.tp import local_config  # noqa: E402
from hept_tpu_torch.utils.convert import from_jax_variables  # noqa: E402
from test_torch_parallel import DYNAMIC_MK, LOSS, _batch, _close, _jax_init  # noqa: E402
from torch_dynamic_keys import check_bf16_grads, tpu_kernels  # noqa: E402
from torch_ranks import spawn  # noqa: E402

POST = dict(DYNAMIC_MK, qkv_post_sort=True)
SHARED = dict(POST, shared_sort=True)
SHARE = dict(SHARED, share_heads=True)
FAST = dict(SHARE, unsort_rows=True, sort_pack=True, unsort_pack=True, kernel_bf16=True,
            kernel_center=True)
FP8 = dict(SHARE, unsort_pack="fp8")
# name -> (model kwargs, attn_impl, the run whose weights it starts from,
# held against JAX, dropout seed)
MODES = {
    "post": (POST, "pallas", "post", True, None),
    "shared_sort": (SHARED, "pallas", "shared_sort", True, None),
    "post_gather": (dict(POST, gather_sort=True), "pallas", "post", False, None),
    "shared_gather": (dict(SHARED, gather_sort=True), "pallas", "shared_sort", False, None),
    "pre": (DYNAMIC_MK, "pallas", "pre", False, None),
    "pre_ckpt": (dict(DYNAMIC_MK, use_ckpt=True), "pallas", "pre", True, None),
    "post_ckpt": (dict(POST, use_ckpt=True), "pallas", "post", True, None),
    "post_drop": (dict(POST, dropout=0.1), "pallas", "post", False, 3),
    "post_ckpt_drop": (dict(POST, dropout=0.1, use_ckpt=True), "pallas", "post", False, 3),
    "share_heads": (SHARE, "pallas", "share_heads", True, None),
    "share_rows": (dict(SHARE, unsort_rows=True), "pallas", "share_heads", False, None),
    "share_fold": (dict(SHARE, fold_unsort=True), "pallas", "share_heads", False, None),
    "share_gather": (dict(SHARE, gather_sort=True), "pallas", "share_heads", False, None),
    "fast": (FAST, "hybrid2", "fast", True, None),
    "fp8": (FP8, "pallas", "fp8", True, None),
}
BF16_MODES = ("fast", "fp8")
# twin -> the run whose bits it must give
TWINS = {"post_gather": "post", "shared_gather": "shared_sort", "pre_ckpt": "pre",
         "post_ckpt": "post", "post_ckpt_drop": "post_drop", "share_rows": "share_heads",
         "share_fold": "share_heads", "share_gather": "share_heads"}
MESHES = {
    "hashes2xheads2": ((1, 2, 2), ("post", "shared_sort", "post_gather", "pre", "pre_ckpt",
                                   "post_ckpt", "post_drop", "post_ckpt_drop")),
    "data2xheads2": ((2, 1, 2), ("post", "shared_sort", "shared_gather")),
    "data2xhashes2": ((2, 2, 1), ("post", "shared_sort", "share_heads", "share_rows",
                                  "share_fold", "share_gather", "fast", "fp8")),
}
SINGLE = ("post", "shared_sort", "share_heads", "fast", "fp8")
# the update's floor: the output bias's gradient is zero up to rounding,
# ~1e-8 on the padded events and up to 2e-7 on the tie-free ones
FLOOR = {"padded": 1e-7, "tie_free": 5e-7}


def _exp(name):
    mk, impl = MODES[name][:2]
    return dict(model_kwargs=mk, attn_impl=impl, loss_kwargs=LOSS, batch_size=2)


def _jax_step(sizes, exp, variables, batch):
    """JAX's make_tp_train_step on a mesh of `sizes`, one SGD (lr 1) step:
    (loss, grad_norm, the variables after it). A bf16-kernel mode runs
    JAX's TPU kernels of its attn_impl in interpret mode, as on the TPU
    (`torch_dynamic_keys.tpu_kernels`)."""
    if exp["model_kwargs"].get("kernel_bf16"):
        with pytest.MonkeyPatch.context() as mp, tpu_kernels(mp, exp["attn_impl"]):
            return _jax_step_run(sizes, exp, variables, batch)
    return _jax_step_run(sizes, exp, variables, batch)


def _jax_step_run(sizes, exp, variables, batch):
    import jax
    import jax.numpy as jnp
    import optax

    from hept_tpu.models import HeptTransformer as JaxHept
    from hept_tpu.parallel.mesh import make_mesh
    from hept_tpu.parallel.tp import make_tp_train_step, shard_batch_2d
    from hept_tpu.train.config import ExperimentConfig as JaxExperimentConfig
    from hept_tpu.train.state import TrainState
    from hept_tpu.train.trainer import make_loss_fn

    jcfg = JaxExperimentConfig(**exp)
    tx = optax.sgd(1.0)
    mesh = make_mesh(int(np.prod(sizes)), ("data", "hashes", "heads"), sizes)
    step = make_tp_train_step(JaxHept, jcfg.model_config(10, 6), make_loss_fn(jcfg), tx, mesh,
                              variables, head_axis="heads", hash_axis="hashes")
    args = (TrainState.create(variables, tx, jax.random.PRNGKey(1)),
            shard_batch_2d(jax.tree_util.tree_map(jnp.asarray, batch), mesh))
    # a reference compiled once and run once: XLA's optimisation level 0
    # (`test_torch_bucket_sp.py:_jit_run`)
    compiled = step.lower(*args).compile({"xla_backend_optimization_level": 0,
                                          "xla_llvm_disable_expensive_passes": True})
    new_state, jm = jax.block_until_ready(compiled(*args))
    return float(jm["loss"]), float(jm["grad_norm"]), new_state.variables


@pytest.fixture(scope="module", params=list(MESHES))
def tp_run(request, tmp_path_factory):
    sizes, names = MESHES[request.param]
    batches = {"padded": _batch((90, 75), seed=0), "tie_free": _batch((96, 96), seed=0)}
    assert batches["tie_free"]["valid"].all()
    variables = {}
    for name in names:
        base = MODES[name][2]
        if base not in variables:
            variables[base] = _jax_init(_exp(base), batches["padded"])[2]
    jax_res = {name: _jax_step(sizes, _exp(name), variables[MODES[name][2]],
                               batches["tie_free"]) for name in names if MODES[name][3]}
    states = {k: from_jax_variables(v) for k, v in variables.items()}
    runs = {}
    for name in names:
        mode = dict(exp=dict(_exp(name), device="cpu"), state=MODES[name][2],
                    seed=MODES[name][4])
        runs[f"padded:{name}"] = dict(mode, batch="padded", single=name in SINGLE)
        if MODES[name][3]:
            runs[f"tie_free:{name}"] = dict(mode, batch="tie_free", single=False)
    outs = spawn("tp_modes", 4, tmp_path_factory.mktemp(request.param), dict(
        modes=runs, states=states, batches=batches, in_dim=10, coords_dim=6, sizes=sizes,
        lr=1.0))
    return dict(mesh=request.param, names=names, outs=outs, jax=jax_res, states=states)


def _updates(sd, before):
    return {k: v - before[k] for k, v in sd.items()}


def _mesh_modes(tp_run, want):
    names = [n for n in tp_run["names"] if want(n)]
    assert names
    return names


def test_ranks_agree(tp_run):
    """Every rank ends each run with the same loss and the same whole
    model."""
    o = tp_run["outs"][0]
    for r in tp_run["outs"][1:]:
        for key in o:
            assert r[key]["loss"] == o[key]["loss"], key
            for k, v in o[key]["state_dict"].items():
                assert torch.equal(r[key]["state_dict"][k], v), (key, k)


def test_step_matches_jax(tp_run):
    """Each mode held against JAX's make_tp_train_step on the same mesh, on
    two events without pads: JAX sorts unstably, so where a replication pad
    and its source row tie across a bucket boundary the two may bucket
    them apart (`torch_dynamic_keys.py`)."""
    for name in _mesh_modes(tp_run, lambda n: MODES[n][3]):
        o = tp_run["outs"][0][f"tie_free:{name}"]
        jloss, jnorm, jvars = tp_run["jax"][name]
        before = tp_run["states"][MODES[name][2]]
        got = _updates(o["state_dict"], before)
        want = _updates(from_jax_variables(jvars), before)
        if name in BF16_MODES:
            np.testing.assert_allclose(o["loss"], jloss, rtol=1e-3, err_msg=name)
            np.testing.assert_allclose(o["grad_norm"], jnorm, rtol=1e-3, err_msg=name)
            check_bf16_grads(got, want, 2e-2, 1e-3)
            continue
        np.testing.assert_allclose(o["loss"], jloss, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(o["grad_norm"], jnorm, rtol=1e-4, err_msg=name)
        for k, d in got.items():
            assert d.shape == want[k].shape, (name, k)
            _close(d.numpy(), want[k].numpy(), 1e-3, f"{name} {k}", floor=FLOOR["tie_free"])


def test_step_matches_single_process(tp_run):
    """Each mode held against the port's single-process step on the whole
    batch (rank 0's), on the events of 90 and 75 points, whose replication
    pads must follow global hash 0 / head 0 on every shard."""
    for name in _mesh_modes(tp_run, lambda n: n in SINGLE):
        o = tp_run["outs"][0][f"padded:{name}"]
        single = o["single"]
        before = tp_run["states"][MODES[name][2]]
        got = _updates(o["state_dict"], before)
        want = _updates(single["state_dict"], before)
        if name in BF16_MODES:
            np.testing.assert_allclose(o["loss"], single["loss"], rtol=1e-3, err_msg=name)
            np.testing.assert_allclose(o["grad_norm"], single["grad_norm"], rtol=1e-3,
                                       err_msg=name)
            check_bf16_grads(got, want, 2e-2, 1e-3)
            continue
        np.testing.assert_allclose(o["loss"], single["loss"], rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(o["grad_norm"], single["grad_norm"], rtol=1e-4,
                                   err_msg=name)
        for k, d in got.items():
            _close(d.numpy(), want[k].numpy(), 1e-4, f"{name} {k}", floor=FLOOR["padded"])


def test_twins_give_their_base_bits(tp_run):
    """gather_sort, fold_unsort / unsort_rows and use_ckpt (with dropout
    too) give their base run's loss, gradient norm and model bit for bit,
    and leave the dropout generator where the base run leaves it, on every
    rank."""
    for name in _mesh_modes(tp_run, lambda n: n in TWINS):
        for out in tp_run["outs"]:
            a, b = out[f"padded:{name}"], out[f"padded:{TWINS[name]}"]
            assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"], name
            for k, v in b["state_dict"].items():
                assert torch.equal(a["state_dict"][k], v), (name, k)
            assert (a["gen"] is None) == (b["gen"] is None), name
            if a["gen"] is not None:
                assert torch.equal(a["gen"], b["gen"]), name


@pytest.mark.parametrize("heads,hashes", [(2, 1), (2, 2)], ids=["heads2", "heads2xhashes2"])
def test_share_heads_head_tp_is_refused(heads, hashes):
    """share_heads under head sharding stays refused, quoting JAX's
    shard_map error on the one-head e2lsh_alpha (`make_tp_train_step`
    raises it at these mesh sizes)."""
    cfg = TransformerConfig(in_dim=10, coords_dim=6, **SHARE)
    with pytest.raises(NotImplementedError, match="not evenly divisible by the corresponding "
                                                  "mesh axis sizes"):
        local_config(cfg, heads, hashes).check_supported()
    local_config(cfg, 1, 2).check_supported()


def test_run_one_seed_post_sort_hash_tp(tmp_path):
    """A one-epoch `run_one_seed` of the share_heads post-sort model over two
    hash-TP ranks (shard_hashes 2): both ranks return the same metrics and
    the checkpoint holds the whole model, its one-head e2lsh_alpha whole."""
    exp = dict(model_kwargs=SHARE, attn_impl="pallas", loss_kwargs=LOSS, batch_size=1,
               num_epochs=1, device="cpu", n_devices=2, shard_hashes=2,
               log_dir=str(tmp_path / "runs"), pair_aug_p=0.0)
    outs = spawn("run", 2, tmp_path / "w", dict(exp=exp, dataset=dict(n_events=5, n_points=60,
                                                                      seed=0)))
    assert outs[0]["res"] == outs[1]["res"]
    assert np.isfinite(outs[0]["res"]["accuracy@0.9"])
    (run,) = list((tmp_path / "runs").iterdir())
    sd = torch.load(sorted((run / "ckpt").glob("step_*.pt"))[0], weights_only=True)["model"]
    assert sd["blocks.0.attn.e2lsh_alpha"].shape == (1, SHARE["h_dim"] + 6, SHARE["n_hashes"])
