"""The port's evaluation path and best-by-valid run against the JAX
package's.

`evaluate` gets JAX's weights (`from_jax_variables`) and the same events,
and is held against `hept_tpu.train.trainer.evaluate`: at f32 modes (loss
1e-5 relative, the nine metrics 1e-6), and at the hept_acc flags with JAX
running its slab2 Pallas kernels in interpret mode (loss 1e-3 relative,
metrics 1e-2: bf16 rounding differs between the two kernels and can flip a
neighbour). `run_one_seed` is driven on the CPU: checkpoint written,
restored and re-evaluated, `only_eval` and `resume`.
"""

import contextlib
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from hept_tpu.data import batching as jbatching  # noqa: E402
from hept_tpu.data import datasets as jdatasets  # noqa: E402
from hept_tpu.models import HeptTransformer as JaxHept  # noqa: E402
from hept_tpu.train.config import ExperimentConfig as JaxExperimentConfig  # noqa: E402
from hept_tpu.train.trainer import evaluate as jax_evaluate  # noqa: E402
from hept_tpu.train.trainer import make_eval_step, make_model_apply  # noqa: E402
from hept_tpu_torch.data.batching import slab_friendly_n  # noqa: E402
from hept_tpu_torch.data.datasets import SplitDataset  # noqa: E402
from hept_tpu_torch.data.synthetic import synthetic_tracking_event  # noqa: E402
from hept_tpu_torch.train import trainer  # noqa: E402
from hept_tpu_torch.train.config import ExperimentConfig  # noqa: E402
from hept_tpu_torch.train.state import CheckpointManager  # noqa: E402
from hept_tpu_torch.utils.convert import from_jax_variables  # noqa: E402

BS = 16
MODEL = dict(h_dim=8, num_heads=2, n_layers=2, block_size=BS, n_hashes=2, static_rounds=4,
             num_regions=16, qkv_post_sort=True, shared_sort=True, share_heads=True,
             static_keys="x0", unsort_rows=True, sort_ops=8)
F32_MODES = dict(sort_pack=False, unsort_pack=False, kernel_bf16=False, kernel_center=False)
ACC_MODES = dict(sort_pack=True, unsort_pack=True, kernel_bf16=True, kernel_center=True)
METRICS = [f"{m}@{t}" for t in ("0", "0.5", "0.9") for m in ("accuracy", "precision", "recall")]


def _datasets(seed=5, sizes=(330, 378, 301, 352)):
    """The same events as the port's SplitDataset and as JAX's (train 1,
    valid 1, test 2)."""
    rng = np.random.default_rng(seed)
    evs = [synthetic_tracking_event(rng, n_points=s, pairs_per_point=8) for s in sizes]
    jevs = [jbatching.Event(x=e.x, coords=e.coords, cluster_ids=e.cluster_ids, recons=e.recons,
                            pts=e.pts, pairs=e.pairs) for e in evs]
    split = lambda e: dict(train=e[:1], valid=e[1:2], test=e[2:], in_dim=10,  # noqa: E731
                           coords_dim=6)
    return SplitDataset(**split(evs)), jdatasets.SplitDataset(**split(jevs))


def _tpu_kernels(monkeypatch):
    """JAX's bucket attention through its slab2 Pallas kernels (interpret
    mode), as tests/test_torch_model.py runs the hept_acc flags."""
    import hept_tpu.ops.bucket_attn as jba
    from hept_tpu.ops.bucket_attn_pallas import bucket_rbf_attention_cols_pallas

    def slab2(sq, sk, sv, block_size, precision=None):
        return bucket_rbf_attention_cols_pallas(sq, sk, sv, block_size=block_size,
                                                hybrid="slab2")

    jba.hept_attention_core_xcols.clear_cache()
    monkeypatch.setattr(jba, "bucket_rbf_attention_cols_xla", slab2)
    return pltpu.force_tpu_interpret_mode()


def _waited(eval_step):
    """JAX's eval step with every call waited for."""
    def get_step(g):
        step = eval_step(g)
        return lambda *a: jax.block_until_ready(step(*a))

    get_step.chunk = eval_step.chunk
    return get_step


def _compare_eval(modes, loss_rtol, metric_atol, ctx=None):
    tds, jds = _datasets()
    n_max = slab_friendly_n(378, BS)
    kw = dict(model_kwargs=dict(MODEL, **modes), loss_kwargs=dict(tau=0.05, dist_metric="l2_rbf"))
    jcfg = JaxExperimentConfig(attn_impl="slab2", **kw)
    jmodel = JaxHept(jcfg.model_config(10, 6))
    b0 = jbatching.pack_events(jds.train, BS, n_max=n_max)
    with ctx or contextlib.nullcontext():
        # each JAX computation is one jitted call, waited for before the next
        # dispatch: eager dispatch from this thread while an interpret-mode
        # kernel's callbacks dispatch on XLA's can deadlock (the 6-worker
        # suite hung here in JAX's eager flax init)
        variables = jax.block_until_ready(jax.jit(jmodel.init)(
            jax.random.PRNGKey(2), b0["x"][0], b0["coords"][0], b0["valid"][0]))
        want = jax_evaluate(jcfg, make_model_apply(jmodel), variables, jds, "test", BS, n_max, 0,
                            eval_step=_waited(make_eval_step(jcfg, make_model_apply(jmodel))))

    cfg = ExperimentConfig(device="cpu", attn_impl="slab2", **kw)
    model = trainer.build_model(cfg, 10, 6, torch.Generator().manual_seed(0), "cpu")
    model.load_state_dict(from_jax_variables(variables))
    model.train()
    got = trainer.evaluate(cfg, model, tds, "test", BS, n_max)
    assert model.training  # evaluate restores the mode it found
    assert set(got) == set(want) == {"loss", *METRICS}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol)
    for k in METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=metric_atol, err_msg=k)
        assert 0.0 < got[k] <= 1.0
    return tds


def test_evaluate_f32_modes_matches_jax():
    tds = _compare_eval(F32_MODES, 1e-5, 1e-6)
    # the packed test split is cached on the dataset
    assert [k[0] for k in tds._eval_batch_cache] == ["test"]


def test_evaluate_hept_acc_modes_matches_jax(monkeypatch):
    import hept_tpu.ops.bucket_attn as jba

    try:
        _compare_eval(ACC_MODES, 1e-3, 1e-2, ctx=_tpu_kernels(monkeypatch))
    finally:
        jba.hept_attention_core_xcols.clear_cache()


def _records(run_dir):
    return [json.loads(line) for line in (run_dir / "scalars.jsonl").read_text().splitlines()]


def _run(cfg, ds):
    lines = []
    res = trainer.run_one_seed(cfg, ds, log=lambda *a: lines.append(" ".join(map(str, a))))
    return res, lines


def test_run_one_seed_checkpoint_round_trip(tmp_path):
    """Two epochs (dropout on): the best checkpoint is written, restored into
    a fresh model and re-evaluated to the in-loop best test metrics;
    `only_eval` of that run dir scores the same; `resume` goes on from the
    epoch after the checkpoint with the saved optimizer and generators, so a
    run of 1 epoch resumed for a second equals an unbroken 2-epoch run."""
    tds, _ = _datasets(seed=7, sizes=(300, 280, 310, 290, 270))
    tds.train, tds.valid, tds.test = tds.train + tds.valid[:1], tds.test[:1], tds.test[1:]
    cfg = ExperimentConfig(model_kwargs=dict(MODEL, **F32_MODES), device="cpu", num_epochs=2,
                           optimizer_kwargs=dict(lr=1e-2), log_dir=str(tmp_path / "a"),
                           attn_impl="slab2")
    res, lines = _run(cfg, tds)
    (run_dir,) = (tmp_path / "a").iterdir()
    assert CheckpointManager(run_dir / "ckpt").latest_step() is not None
    recs = _records(run_dir)
    in_loop = [r for r in recs if "test/loss" in r][-1]
    assert set(res) == {"loss", *METRICS}
    for k, v in res.items():
        assert abs(v - in_loop[f"test/{k}"]) <= 1e-6, k
    assert not any("WARNING" in ln for ln in lines)
    losses_ab = [r["train/loss"] for r in recs if "train/loss" in r]
    assert len(losses_ab) == 2 and np.isfinite(losses_ab).all()

    only, _ = _run(dataclasses.replace(cfg, resume=str(run_dir), only_eval=True,
                                       log_dir=str(tmp_path / "b")), tds)
    for k, v in res.items():
        assert abs(only[k] - v) <= 1e-6, k

    one = dataclasses.replace(cfg, num_epochs=1, log_dir=str(tmp_path / "c"))
    _run(one, tds)
    (dir_c,) = (tmp_path / "c").iterdir()
    _, lines = _run(dataclasses.replace(cfg, resume=str(dir_c), log_dir=str(tmp_path / "d")),
                    tds)
    assert any("resumed" in ln for ln in lines)
    assert [ln.split(":")[0] for ln in lines if ln.startswith("epoch")] == ["epoch 1"]
    (dir_d,) = (tmp_path / "d").iterdir()
    resumed = [r["train/loss"] for r in _records(dir_d) if "train/loss" in r]
    assert resumed == losses_ab[1:]
