"""Training step and epoch loop (port of `hept_tpu/parallel/dp.py:
make_single_device_train_step` and the training part of
`hept_tpu/train/trainer.py:run_one_seed`).

Evaluation, retrieval metrics and checkpoints are not ported yet; the loop
trains and reports the mean training loss per epoch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..data.batching import slab_friendly_n
from ..data.datasets import SplitDataset, get_dataset
from ..models.transformer import HeptTransformer
from ..utils.device import resolve_device
from .config import ExperimentConfig
from .losses import infonce_loss
from .optim import make_lr_scheduler, make_optimizer

_DTYPES = {"x": torch.float32, "coords": torch.float32, "valid": torch.bool,
           "cluster_ids": torch.int32, "recons": torch.float32, "pts": torch.float32,
           "pairs": torch.int32, "pair_mask": torch.bool, "pair_rev": torch.int32,
           "pair_weight": torch.float32, "pair_neg": torch.bool}


def batch_to_device(batch: dict, device) -> dict:
    """Packed numpy batch (data/batching.py) -> tensors on `device`."""
    return {k: torch.as_tensor(v).to(device=device, dtype=_DTYPES.get(k))
            for k, v in batch.items()}


def build_model(cfg: ExperimentConfig, in_dim: int, coords_dim: int,
                generator: torch.Generator | None = None, device=None) -> HeptTransformer:
    return HeptTransformer(cfg.model_config(in_dim, coords_dim), generator, device)


def make_loss_fn(cfg: ExperimentConfig):
    """InfoNCE over the events of a batch (mean over events)."""
    if cfg.task != "tracking" or cfg.loss_name != "infonce":
        raise NotImplementedError("the port trains the tracking InfoNCE loss")
    tau = cfg.loss_kwargs.get("tau", 0.05)
    dist = cfg.loss_kwargs.get("dist_metric", "l2_rbf")

    def loss_fn(outputs, batch):
        if "pair_rev" not in batch:
            raise ValueError("the loss needs the windowed pair layout (window_pairs=128) "
                             "with reverse index and cluster weights")
        losses = [
            infonce_loss(outputs[i], batch["pairs"][i], batch["pair_mask"][i],
                         batch["pair_rev"][i], batch["pair_weight"][i], batch["pair_neg"][i],
                         tau=tau, dist_metric=dist)
            for i in range(outputs.shape[0])
        ]
        return sum(losses) / len(losses)

    return loss_fn


def model_apply(model: HeptTransformer, batch: dict,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """(B, N, out) outputs, one event at a time."""
    return torch.stack([
        model(batch["x"][i], batch["coords"][i], batch["valid"][i], generator)
        for i in range(batch["x"].shape[0])
    ])


def train_step(model, optimizer, loss_fn, batch, generator: torch.Generator | None = None):
    """One step: loss, gradients, Adam update. `generator` draws dropout
    (none: no dropout). Returns detached {"loss", "grad_norm"} tensors; no
    host synchronisation."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(model_apply(model, batch, generator), batch)
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    grad_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    optimizer.step()
    return {"loss": loss.detach(), "grad_norm": grad_norm.detach()}


def run_training(cfg: ExperimentConfig, dataset: SplitDataset | None = None,
                 log=print) -> dict:
    """Train for cfg.num_epochs on the training split; returns the per-epoch
    mean training losses."""
    device = resolve_device(cfg.device)
    if dataset is None:
        dataset = get_dataset(cfg.dataset_name, seed=cfg.seed)
    block_size = cfg.model_kwargs.get("block_size", 100)
    n_max = slab_friendly_n(max(ev.n for s in ("train", "valid", "test")
                                for ev in getattr(dataset, s)), block_size)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    init_gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    model = build_model(cfg, dataset.in_dim, dataset.coords_dim, init_gen, device)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model {cfg.model_name}: {n_params:,} params on {device}")
    optimizer = make_optimizer(model.parameters(), cfg.optimizer_name,
                               cfg.optimizer_kwargs.get("lr", 1e-3))
    scheduler = make_lr_scheduler(
        optimizer, cfg.lr_scheduler_name,
        **{k: v for k, v in cfg.lr_scheduler_kwargs.items() if k in ("gamma", "step_size")})
    loss_fn = make_loss_fn(cfg)
    data_rng = np.random.default_rng(cfg.seed)
    history = []
    model.train()
    for epoch in range(cfg.num_epochs):
        t0 = time.time()
        losses = []
        for b in dataset.iter_batches("train", cfg.batch_size, block_size, n_max=n_max,
                                      shuffle_rng=data_rng, aug_pair_p=cfg.pair_aug_p,
                                      window_pairs=128):
            metrics = train_step(model, optimizer, loss_fn, batch_to_device(b, device), gen)
            losses.append(metrics["loss"])
        scheduler.step()
        train_loss = float(torch.stack(losses).mean()) if losses else float("nan")
        history.append(train_loss)
        log(f"epoch {epoch}: train_loss={train_loss:.4f} ({time.time() - t0:.1f} s)")
    return {"train_loss": history, "model": model}
