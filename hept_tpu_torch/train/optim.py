"""Optimizer and LR schedules (port of `hept_tpu/train/optim.py`'s "adam",
"step" and "impatient").

optax's `scale_by_adam` defaults (b1 0.9, b2 0.999, eps 1e-8 outside the
square root) are torch.optim.Adam's; the "step" schedule is epoch-granular
StepLR: lr * gamma ** (epoch // step_size), stepped once per epoch. The
"impatient" schedule keeps the lr constant and cuts it on a plateau of a
metric: the JAX package's `PlateauState` is ReduceLROnPlateau with no
threshold, no cooldown and no floor (a strict improvement resets the count
of bad epochs; more than `patience` of them scale the lr by `factor` and
reset it). Its state goes into the run's checkpoint with the scheduler's.
"""

from __future__ import annotations

import torch


def make_optimizer(params, name: str = "adam", lr: float = 1e-3) -> torch.optim.Optimizer:
    if name != "adam":
        raise NotImplementedError(f"optimizer {name}: the port has adam")
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_lr_scheduler(optimizer, name: str | None, gamma: float = 0.5, step_size: int = 500,
                      factor: float = 0.5, patience: int = 20, mode: str = "min"):
    """Epoch-granular schedule: call `.step()` once per epoch, or for
    "impatient" (ReduceLROnPlateau) `.step(metric)`."""
    if name in (None, "none"):
        return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda epoch: 1.0)
    if name == "step":
        return torch.optim.lr_scheduler.StepLR(optimizer, step_size=step_size, gamma=gamma)
    if name == "impatient":
        return torch.optim.lr_scheduler.ReduceLROnPlateau(
            optimizer, mode=mode, factor=factor, patience=patience, threshold=0.0, eps=0.0)
    raise NotImplementedError(f"lr scheduler {name}: the port has step and impatient")
