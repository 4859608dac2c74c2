"""The port's train step, trainer and config against the JAX package, the
import isolation of the port, and the translation traps between the two
frameworks, each pinned by a small check."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hept_tpu.models import HeptTransformer as JaxHept  # noqa: E402
from hept_tpu.parallel.dp import make_single_device_train_step  # noqa: E402
from hept_tpu.train.config import ExperimentConfig as JaxExperimentConfig  # noqa: E402
from hept_tpu.train.optim import make_lr_schedule  # noqa: E402
from hept_tpu.train.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from hept_tpu.train.state import TrainState  # noqa: E402
from hept_tpu.train.trainer import make_loss_fn as jax_make_loss_fn  # noqa: E402
from hept_tpu.train.trainer import make_model_apply  # noqa: E402
from hept_tpu_torch.data.batching import pack_events  # noqa: E402
from hept_tpu_torch.data.datasets import make_synthetic_tracking  # noqa: E402
from hept_tpu_torch.data.synthetic import synthetic_tracking_event  # noqa: E402
from hept_tpu_torch.models.transformer import AttnBlock, TransformerConfig  # noqa: E402
from hept_tpu_torch.ops.bucket_attn import static_hash  # noqa: E402
from hept_tpu_torch.train import trainer  # noqa: E402
from hept_tpu_torch.train.config import (  # noqa: E402
    CONFIG_DIR,
    ExperimentConfig,
    load_config,
    profile_config,
)
from hept_tpu_torch.utils.convert import from_jax_variables  # noqa: E402
from hept_tpu_torch.utils.device import resolve_device  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
MODEL = dict(h_dim=8, num_heads=2, n_layers=2, block_size=16, n_hashes=2, static_rounds=4,
             num_regions=16, qkv_post_sort=True, shared_sort=True, share_heads=True,
             static_keys="x0", unsort_rows=True, sort_pack=False, unsort_pack=False,
             kernel_bf16=False, kernel_center=False, dropout=0.0)


def test_train_step_matches_jax_single_device_step():
    """One loss + Adam step (lr 1e-2, dropout off) against
    make_single_device_train_step: loss 1e-5, gradient norm and Adam's first
    moment 1e-3 x scale + 1e-7 (f32 modes), and the update wherever the
    gradient is clear of zero (Adam's first step is lr * sign(g) there) to
    1e-6. The output bias's gradient is zero up to rounding (~1e-8: the loss
    depends on embedding differences only), hence the absolute floors."""
    ev = synthetic_tracking_event(np.random.default_rng(5), n_points=378, pairs_per_point=8)
    batch = pack_events([ev], block_size=16, window_pairs=128)
    jcfg = JaxExperimentConfig(model_kwargs=dict(MODEL), attn_impl="slab2",
                               loss_kwargs=dict(tau=0.05, dist_metric="l2_rbf"))
    jmodel = JaxHept(jcfg.model_config(10, 6))
    variables = jmodel.init(jax.random.PRNGKey(0), batch["x"][0], batch["coords"][0],
                            batch["valid"][0])
    tx = jax_make_optimizer("adam", schedule=make_lr_schedule("step", 1e-2))
    state = TrainState.create(variables, tx, jax.random.PRNGKey(1))
    step = make_single_device_train_step(make_model_apply(jmodel), jax_make_loss_fn(jcfg), tx)
    new_state, jm = step(state, jax.tree_util.tree_map(jnp.asarray, batch))

    cfg = ExperimentConfig(model_kwargs=dict(MODEL), device="cpu", attn_impl="slab2",
                           loss_kwargs=dict(tau=0.05, dist_metric="l2_rbf"))
    model = trainer.build_model(cfg, 10, 6, torch.Generator().manual_seed(0), "cpu")
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
        g = mu[name].numpy() / 0.1  # Adam's first moment after one step: 0.1 g
        np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(), mu[name].numpy(),
                                   rtol=1e-3, atol=1e-3 * np.abs(mu[name].numpy()).max() + 1e-7,
                                   err_msg=name)
        d_port = (p.detach() - before[name]).numpy()
        d_jax = (after[name] - before[name]).numpy()
        clear = np.abs(g) > max(1e-2 * np.abs(g).max(), 1e-5)
        np.testing.assert_allclose(d_port[clear], d_jax[clear], rtol=0, atol=1e-6, err_msg=name)
        assert np.abs(d_port).max() <= 1e-2 * (1 + 1e-5)


def test_hept_acc_yaml_equals_dataclass():
    """`profile_config("hept_acc")` is the port's YAML with the overrides
    applied, and the YAML equals the JAX package's."""
    pytest.importorskip("yaml")
    cfg = load_config(CONFIG_DIR / "tracking_trans_hept_acc.yaml")
    assert cfg == profile_config("hept_acc")
    assert profile_config("hept_acc", seed=3) == dataclasses.replace(cfg, seed=3)
    jaxyaml = REPO / "hept_tpu" / "configs" / "tracking" / "tracking_trans_hept_acc.yaml"
    from hept_tpu.train.config import load_config as jax_load_config

    jcfg = jax_load_config(jaxyaml)
    for f in dataclasses.fields(ExperimentConfig):
        if hasattr(jcfg, f.name) and f.name != "device":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    mc = cfg.model_config(10, 6)
    mc.check_supported()
    assert (mc.block_size, mc.n_hashes, mc.n_layers, mc.num_heads, mc.h_dim,
            mc.static_rounds) == (512, 2, 4, 8, 24, 8)


@pytest.mark.parametrize("profile,shape", [
    ("hept", (100, 3, 4, 8, 24, 0)),
    ("hept_fast", (100, 2, 4, 8, 24, 8)),
    ("hept_turbo", (100, 1, 4, 8, 24, 4)),
    ("hept_max", (512, 3, 4, 8, 24, 12)),
])
def test_profile_yaml_equals_jax(profile, shape):
    """The profiles beside hept_acc (the bs-100 ones and hept_max): the port's
    YAML equals the JAX package's, and the port runs each (the parity profile
    on the dynamic-key path)."""
    pytest.importorskip("yaml")
    from hept_tpu.train.config import load_config as jax_load_config

    cfg = profile_config(profile)
    jcfg = jax_load_config(REPO / "hept_tpu" / "configs" / "tracking"
                           / f"tracking_trans_{profile}.yaml")
    for f in dataclasses.fields(ExperimentConfig):
        if hasattr(jcfg, f.name) and f.name != "device":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    mc = cfg.model_config(10, 6)
    mc.check_supported()
    assert (mc.block_size, mc.n_hashes, mc.n_layers, mc.num_heads, mc.h_dim,
            mc.static_rounds) == shape
    assert bool(mc.static_keys) == (profile != "hept")


def test_demo_config_takes_the_profile():
    """The demo's config is the profile's YAML with the demo's lr, seed,
    epochs and schedule."""
    pytest.importorskip("yaml")
    from hept_tpu_torch.scripts.train_60k_demo import VARIANTS, demo_config

    assert {f"tracking_trans_{p}.yaml" for p in VARIANTS} <= {
        f.name for f in CONFIG_DIR.glob("*.yaml")}
    for profile in VARIANTS:
        base = profile_config(profile)
        cfg = demo_config(profile, 2e-3, 0, 25, "runs/train60k")
        assert cfg.model_kwargs == base.model_kwargs and cfg.attn_impl == base.attn_impl
        assert (cfg.num_epochs, cfg.optimizer_kwargs["lr"], cfg.seed) == (25, 2e-3, 0)
        assert cfg.lr_scheduler_kwargs == {"step_size": 500, "gamma": 0.5}


@pytest.mark.parametrize("profile", ["hept", "hept_fast"])
def test_trainer_cli_runs_profile_on_cpu(monkeypatch, capsys, tmp_path, profile):
    """`-m hept` (dynamic keys, f32) and `-m hept_fast` (static plan, bf16,
    hybrid2) at full width on three small events: one epoch with eval and
    checkpoint; the best test metrics are printed."""
    pytest.importorskip("yaml")
    from hept_tpu_torch import tracking_trainer

    monkeypatch.setattr(trainer, "get_dataset",
                        lambda name, seed: make_synthetic_tracking(3, 300, seed))
    tracking_trainer.main(["-m", profile, "--epochs", "1", "--device", "cpu",
                           "--dataset", "synthetic-tracking-300", "--log-dir", str(tmp_path)])
    best = capsys.readouterr().out.split("best test:")[1]
    assert "accuracy@0.9=" in best and "nan" not in best
    assert list(tmp_path.glob("*/ckpt/step_*.pt"))


def test_trainer_cli_runs_an_epoch_on_cpu(monkeypatch, capsys, tmp_path):
    """The CLI's epoch loop at full hept_acc width on three small events:
    one epoch, valid and test eval, checkpoint, re-eval of the restored
    best; it prints the best test metrics."""
    pytest.importorskip("yaml")
    from hept_tpu_torch import tracking_trainer

    monkeypatch.setattr(trainer, "get_dataset",
                        lambda name, seed: make_synthetic_tracking(3, 300, seed))
    tracking_trainer.main(["-m", "hept_acc", "--epochs", "1", "--device", "cpu",
                           "--dataset", "synthetic-tracking-300", "--log-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "epoch 0: train_loss=" in out
    best = out.split("best test:")[1]
    assert "accuracy@0.9=" in best and "nan" not in best
    assert list(tmp_path.glob("*/ckpt/step_*.pt"))


def test_entry_points_default_to_cuda():
    """Without a card an entry point raises unless the CPU is asked for."""
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trainer.run_one_seed(profile_config("hept_acc", num_epochs=0))
        from hept_tpu_torch.scripts import train_60k_demo

        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_60k_demo.main([])
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


_BANNED = ("jax", "jaxlib", "flax", "optax", "hept_tpu")


def _port_files():
    files = sorted((REPO / "hept_tpu_torch").rglob("*.py"))
    smoke = REPO / "chip_smoke.py"
    return files + ([smoke] if smoke.exists() else [])


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    """No file of the port (nor chip_smoke.py) imports JAX, flax, optax or
    anything of the JAX package."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for nm in names:
            assert nm.split(".")[0] not in _BANNED, f"{path}: imports {nm}"


def test_port_import_leaves_jax_unloaded():
    code = ("import sys, importlib, pkgutil, hept_tpu_torch\n"
            "for m in pkgutil.walk_packages(hept_tpu_torch.__path__, 'hept_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'hept_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_trap_layernorm_eps_and_linear_layout():
    """flax LayerNorm's eps is 1e-6 (torch's default 1e-5); TorchLinear
    kernels are (in, out) and become nn.Linear weights (out, in)."""
    from flax import linen as nn

    from hept_tpu.models.mlp import TorchLinear as JaxLinear
    from hept_tpu_torch.models.mlp import TorchLinear, layer_norm

    x = np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32) * 1e-3
    ln = nn.LayerNorm()
    want = np.asarray(ln.apply(ln.init(jax.random.PRNGKey(0), x), x))
    got = layer_norm(8)(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert np.abs(torch.nn.LayerNorm(8)(torch.tensor(x)).detach().numpy() - want).max() > 1e-3

    jl = JaxLinear(3)
    v = jl.init(jax.random.PRNGKey(1), x)
    tl = TorchLinear(8, 3)
    tl.weight.data = torch.tensor(np.asarray(v["params"]["kernel"])).t().contiguous()
    tl.bias.data = torch.tensor(np.asarray(v["params"]["bias"]))
    np.testing.assert_allclose(tl(torch.tensor(x)).detach().numpy(),
                               np.asarray(jl.apply(v, x)), rtol=1e-6, atol=1e-7)


def test_trap_head_major_kernels():
    """transformer.py's heads(): kernel (d, h*d) -> (h, d, d), head-major."""
    d, h = 4, 3
    cfg = TransformerConfig(in_dim=10, coords_dim=6, h_dim=d, num_heads=h, n_hashes=2,
                            block_size=16, qkv_post_sort=True, share_heads=True,
                            static_keys="x0", unsort_rows=True)
    blk = AttnBlock(cfg, torch.Generator().manual_seed(0))
    kern = blk.w_q.weight.detach().t().numpy()  # flax layout (d, h*d)
    want = kern.reshape(d, h, d).transpose(1, 0, 2)
    np.testing.assert_array_equal(blk._heads(blk.w_q).detach().numpy(), want)


def test_trap_static_hash_standardises_each_point():
    """static_hash standardises x0 over each point's features (axis 0 of the
    (d, n) columns), so a per-point affine change of x0 leaves it unchanged;
    it matches JAX's static_hash to 1e-5."""
    from hept_tpu.ops.bucket_attn import static_hash as jax_static_hash

    rng = np.random.default_rng(1)
    x0 = rng.normal(size=(8, 50)).astype(np.float32)
    co = rng.normal(size=(6, 50)).astype(np.float32)
    alpha = rng.normal(size=(1, 14, 4)).astype(np.float32)
    h = static_hash(torch.tensor(x0), torch.tensor(co), torch.tensor(alpha), 4.5)
    np.testing.assert_allclose(
        h.numpy(), np.asarray(jax_static_hash(x0, co, alpha, 4.5, "x0")), rtol=1e-5, atol=1e-5)
    a, b = rng.uniform(0.5, 2.0, size=50), rng.normal(size=50)
    h2 = static_hash(torch.tensor((x0 * a + b).astype(np.float32)), torch.tensor(co),
                     torch.tensor(alpha), 4.5)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), rtol=1e-4, atol=1e-4)
