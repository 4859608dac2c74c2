"""The frozen event packer is the port's, bit for bit, and the plain
reference agrees with the port's CPU path at a tiny size, for both
configurations (forward with dropout, loss and first gradients)."""

import numpy as np
import pytest
import torch

from bench_h100 import harness
from bench_h100.generators import tracking
from bench_h100.reference import common
from bench_h100.weights import make_weights


@pytest.mark.parametrize("events", [1, 2])
def test_packer_is_the_ports(events):
    from hept_tpu_torch.data.batching import Event, pack_events

    rng = np.random.default_rng(1)
    evs = [tracking.tracking_event(rng, 3000 - 500 * i, 16, 0.5) for i in range(events)]
    mine = tracking.pack_batch(evs, tracking.bucket_n(3000, 512), 0.2, np.random.default_rng(2))
    port = pack_events([Event(**ev) for ev in evs], 512, n_max=3000, aug_pair_p=0.2,
                       aug_rng=np.random.default_rng(2), window_pairs=128)
    assert sorted(mine) == sorted(port)
    for k in mine:
        np.testing.assert_array_equal(mine[k], port[k], err_msg=k)
        assert mine[k].flags["C_CONTIGUOUS"], k


def test_batches_hold_the_configurations_batch_size():
    cfg = dict(harness.cell_files("tracking_hept.train")["config"], batch_size=2)
    traffic = dict(harness.cell_files("tracking_hept.train")["traffic"], points=500, batches=2)
    batches = tracking.make_batches(cfg, traffic, harness.seeds(3))
    assert len(batches) == 2 and all(b["x"].shape[0] == 2 for b in batches)
    dev = tracking.to_device(batches[0], "cpu")
    assert {k: v.dtype for k, v in dev.items()} == tracking.DTYPES


# f32: rounding only (parity; hept_acc with its bf16 modes off); hept_acc
# as configured: the port's bf16 kernels and transport against the f32
# reference, the gradient by its difference norm leaf by leaf (0.17 on the
# first block's w_q at 1000 points; the gap of the norms is ~1e-2)
F32_MODES = {"sort_pack": False, "unsort_pack": False, "kernel_bf16": False}


@pytest.mark.parametrize("workload,f32,batch,tol_out,tol_grad", [
    ("tracking_hept.train", False, 1, 1e-5, 1e-4),
    ("tracking_hept.train", False, 2, 1e-5, 1e-4),
    ("tracking_hept_acc.train", True, 1, 1e-5, 1e-4),
    ("tracking_hept_acc.train", False, 1, 2e-2, 0.3),
])
def test_reference_agrees_with_the_port(workload, f32, batch, tol_out, tol_grad):
    from hept_tpu_torch.train import trainer

    torch.manual_seed(0)
    f = harness.cell_files(workload)
    cfg, ref = dict(f["config"], batch_size=batch), f["reference"]
    if f32:
        cfg["model_kwargs"] = dict(cfg["model_kwargs"], **F32_MODES)
    traffic = dict(f["traffic"], points=1000, batches=1)
    b = tracking.make_batches(cfg, traffic, harness.seeds(7))[0]
    dev = torch.device("cpu")
    weights = make_weights(ref.param_spec(cfg), cfg, 11, dev)
    pcfg = harness.port_config(cfg)
    model = trainer.build_model(pcfg, cfg["in_dim"], cfg["coords_dim"], None, dev)
    model.load_state_dict(weights, strict=True)
    batch_p = trainer.batch_to_device(b, dev)
    out = trainer.model_apply(model, batch_p, torch.Generator().manual_seed(5))
    loss = trainer.make_loss_fn(pcfg)(out, batch_p)
    loss.backward()
    W = {k: v.clone().requires_grad_(common.trainable(k)) for k, v in weights.items()}
    r_loss, r_out, _ = ref.REFERENCE.batch_loss(W, cfg, tracking.to_device(b, dev),
                                                torch.Generator().manual_seed(5), common.EXACT)
    r_loss.backward()
    for i in range(batch):
        v = batch_p["valid"][i]
        assert float((out[i][v] - r_out[i][v]).detach().norm() / r_out[i][v].norm()) < tol_out
    assert abs(float(loss) - float(r_loss)) < tol_out * abs(float(r_loss))
    for name, p in model.named_parameters():
        g, rg = p.grad, W[name].grad
        assert float((g - rg).norm()) <= tol_grad * max(float(rg.norm()), 1e-3), name
