"""Optimizers and LR schedules (port of `hept_tpu/train/optim.py`: "adam",
"adamw", global-norm clipping; the "step", "cosine" and "impatient"
schedules).

optax's `scale_by_adam` defaults (b1 0.9, b2 0.999, eps 1e-8 outside the
square root) are torch.optim.Adam's. "adamw" is optax's chain scale_by_adam
-> add_decayed_weights(wd) -> scale_by_learning_rate, decoupled decay:
p - lr (adam + wd p), which torch.optim.AdamW computes as p (1 - lr wd) -
lr adam. `clip_by_global_norm_` is optax's clip_by_global_norm, which the
JAX package chains before the update when `clip_norm` > 0: g / norm *
clip_norm where norm >= clip_norm (`torch.nn.utils.clip_grad_norm_` adds
1e-6 to the norm, so it differs); the trainer's `train_step` applies it
with the global norm it already reports.

Schedules: "step" is epoch-granular StepLR, lr * gamma ** (epoch //
step_size), stepped once per epoch. "cosine" is per optimizer step:
update i takes lr(i) (optax's `inject_hyperparams` reads the count before
it increments), a linear warm-up base * max(i, 1) / warm over the first
warm = num_warmup_epochs * steps_per_epoch updates, then eta_min + (base -
eta_min) (1 + cos(pi prog)) / 2 with eta_min = base * eta_min_ratio and
prog the share of the remaining updates done; stepped after every update.
"impatient" keeps the lr constant and cuts it on a plateau of a metric: the
JAX package's `PlateauState` is ReduceLROnPlateau with no threshold, no
cooldown and no floor (a strict improvement resets the count of bad epochs;
more than `patience` of them scale the lr by `factor` and reset it). Each
schedule's state goes into the run's checkpoint with the scheduler's.
"""

from __future__ import annotations

import math

import torch

# the schedules stepped after every optimizer update, not once per epoch
PER_STEP_SCHEDULES = ("cosine",)


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def clip_by_global_norm_(grads, norm: torch.Tensor, max_norm: float) -> None:
    """Every gradient scaled in place by max_norm / norm where `norm`, their
    global norm, reaches max_norm (no host synchronisation)."""
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))


def make_optimizer(params, name: str = "adam", lr: float = 1e-3,
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """Adam ("adam"; weight_decay unused, as in the JAX package) or AdamW
    ("adamw")."""
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    raise NotImplementedError(f"optimizer {name}: the port has adam and adamw")


def cosine_factor(step: int, steps_per_epoch: int, num_epochs: int, num_warmup_epochs: int,
                  eta_min_ratio: float) -> float:
    """The cosine schedule's lr at update `step`, over the base lr."""
    warm = num_warmup_epochs * steps_per_epoch
    total = num_epochs * steps_per_epoch
    if step < warm:
        return max(step, 1) / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return eta_min_ratio + 0.5 * (1.0 - eta_min_ratio) * (1.0 + math.cos(math.pi * prog))


def make_lr_scheduler(optimizer, name: str | None, gamma: float = 0.5, step_size: int = 500,
                      factor: float = 0.5, patience: int = 20, mode: str = "min", *,
                      steps_per_epoch: int = 1, num_epochs: int = 1,
                      num_warmup_epochs: int = 5, eta_min_ratio: float = 0.01):
    """The schedule of `name`: call `.step()` once per epoch, after every
    update for the schedules in PER_STEP_SCHEDULES, or for "impatient"
    (ReduceLROnPlateau) `.step(metric)` once per epoch."""
    if name in (None, "none"):
        return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda epoch: 1.0)
    if name == "step":
        return torch.optim.lr_scheduler.StepLR(optimizer, step_size=step_size, gamma=gamma)
    if name == "cosine":
        return torch.optim.lr_scheduler.LambdaLR(
            optimizer, lambda step: cosine_factor(step, steps_per_epoch, num_epochs,
                                                  num_warmup_epochs, eta_min_ratio))
    if name == "impatient":
        return torch.optim.lr_scheduler.ReduceLROnPlateau(
            optimizer, mode=mode, factor=factor, patience=patience, threshold=0.0, eps=0.0)
    raise NotImplementedError(f"lr scheduler {name}: the port has step, cosine and impatient")
