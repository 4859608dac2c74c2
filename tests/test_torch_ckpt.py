"""`use_ckpt`: each block runs under `torch.utils.checkpoint` and is
recomputed in the backward (JAX's `_remat_block`, the reference's
use_ckpt). The recompute must draw the same dropout masks and LSH rotations
as the forward from the step's explicit generator, and leave that generator
where a plain step leaves it: a training step with use_ckpt gives the plain
step's loss, gradient norm and every updated parameter bit for bit, for the
HEPT parity model, hept_acc's modes at a small size and reformer, and the
generator's state after it. At eval the model's output equals JAX's
use_ckpt model's (1e-4 of scale, f32)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hept_tpu_torch.train import trainer  # noqa: E402
from hept_tpu_torch.train.config import ExperimentConfig  # noqa: E402
from torch_dynamic_keys import BASE, STATIC, close, event, t  # noqa: E402

LOSS = dict(tau=0.05, dist_metric="l2_rbf")
MODELS = {
    "parity": ("trans_hept", dict(BASE), "pallas"),
    "hept_acc": ("trans_hept", dict(BASE, **STATIC, static_rounds=4, sort_pack=True,
                                    unsort_pack=True, kernel_bf16=True, kernel_center=True),
                 "slab2"),
    "reformer": ("trans_reformer", dict(h_dim=8, num_heads=2, n_layers=2, n_hashes=2,
                                        block_size=16, bucket_size=16), "pallas"),
}


def step(name: str, use_ckpt: bool, batch: dict):
    """Two Adam steps (lr 1e-2, dropout 0.1) from the same seeded weights
    and generator. Returns the steps' metrics, the parameters after them,
    the recorded sort orders of a forward, and the generator's state."""
    model_name, mk, impl = MODELS[name]
    cfg = ExperimentConfig(model_name=model_name, model_kwargs=dict(mk, dropout=0.1,
                                                                    use_ckpt=use_ckpt),
                           device="cpu", attn_impl=impl, loss_kwargs=LOSS)
    model = trainer.build_model(cfg, 10, 6, torch.Generator().manual_seed(0), "cpu")
    assert model.cfg.use_ckpt == use_ckpt
    opt = trainer.make_optimizer(model.parameters(), lr=1e-2)
    gen = torch.Generator().manual_seed(1)
    loss_fn = trainer.make_loss_fn(cfg)
    metrics = [trainer.train_step(model, opt, loss_fn, batch, gen) for _ in range(2)]
    perms = []
    out = model(batch["x"][0], batch["coords"][0], batch["valid"][0],
                torch.Generator().manual_seed(2), record_perms=perms)
    out.sum().backward()
    return metrics, {n: p.detach().clone() for n, p in model.named_parameters()}, perms, \
        gen.get_state()


@pytest.mark.parametrize("name", list(MODELS))
def test_ckpt_step_is_plain_step(name):
    """Bit for bit: the loss and gradient norm of each step, every
    parameter after them, the generator's state, and the sort orders a
    forward records (once a layer, not again in the recompute)."""
    batch = trainer.batch_to_device(event(384), "cpu")
    plain = step(name, False, batch)
    ckpt = step(name, True, batch)
    for mp, mc in zip(plain[0], ckpt[0]):
        for k in ("loss", "grad_norm"):
            assert torch.equal(mp[k], mc[k]), k
    for n, p in plain[1].items():
        assert torch.equal(p, ckpt[1][n]), n
    assert torch.equal(plain[3], ckpt[3])
    assert len(plain[2]) == len(ckpt[2]) == (0 if name == "hept_acc" else BASE["n_layers"])
    for a, b in zip(plain[2], ckpt[2]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_ckpt_recompute_redraws_nothing(monkeypatch):
    """The recompute runs each block again (its dropout drawn from a
    generator set to the block's snapshot, not the step's generator): the
    step's generator advances exactly as in the plain step, and the blocks
    run twice a step under use_ckpt."""
    from hept_tpu_torch.models.transformer import AttnBlock

    runs = []
    forward = AttnBlock.forward

    def counting(self, *a, **kw):
        runs.append(kw.get("generator"))
        return forward(self, *a, **kw)

    monkeypatch.setattr(AttnBlock, "forward", counting)
    batch = trainer.batch_to_device(event(384), "cpu")
    plain = step("parity", False, batch)
    n_plain = len(runs)
    ckpt = step("parity", True, batch)
    # two steps and one more forward + backward: each block once a forward
    # plainly, twice under use_ckpt (the recompute)
    assert n_plain == 3 * BASE["n_layers"]
    assert len(runs) - n_plain == 6 * BASE["n_layers"]
    assert torch.equal(plain[3], ckpt[3])


def test_ckpt_model_matches_jax():
    """JAX's use_ckpt model (`nn.remat` blocks) at eval against the port's,
    JAX's weights carried, the port's checkpointed forward (autograd on):
    output to 1e-4 of scale on a tie-free event."""
    import jax

    from hept_tpu.models import HeptTransformer as JaxHept
    from hept_tpu.models import TransformerConfig as JaxConfig
    from hept_tpu_torch.models.transformer import HeptTransformer, TransformerConfig
    from hept_tpu_torch.utils.convert import from_jax_variables

    batch = event(384)
    x, coords, valid = batch["x"][0], batch["coords"][0], batch["valid"][0]
    kw = dict(BASE, use_ckpt=True, padding_mode="replicate")
    jmodel = JaxHept(JaxConfig(in_dim=10, coords_dim=6, attn_impl="xla", **kw))
    variables = jax.block_until_ready(jax.jit(jmodel.init)(jax.random.PRNGKey(4), x, coords,
                                                           valid))
    jout = jax.block_until_ready(jax.jit(jmodel.apply)(variables, x, coords, valid))
    model = HeptTransformer(TransformerConfig(in_dim=10, coords_dim=6, attn_impl="pallas", **kw),
                            torch.Generator().manual_seed(0))
    model.load_state_dict(from_jax_variables(variables))
    out = model(t(x), t(coords), t(valid))
    assert out.requires_grad
    close(out, jout, 1e-4)
    out.sum().backward()
    assert all(p.grad is not None for p in model.parameters())
