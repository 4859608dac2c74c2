"""Optimizer and LR schedule (port of `hept_tpu/train/optim.py`'s "adam"
and "step").

optax's `scale_by_adam` defaults (b1 0.9, b2 0.999, eps 1e-8 outside the
square root) are torch.optim.Adam's; the "step" schedule is epoch-granular
StepLR: lr * gamma ** (epoch // step_size), stepped once per epoch.
"""

from __future__ import annotations

import torch


def make_optimizer(params, name: str = "adam", lr: float = 1e-3) -> torch.optim.Optimizer:
    if name != "adam":
        raise NotImplementedError(f"optimizer {name}: the port has adam")
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_lr_scheduler(optimizer, name: str | None, gamma: float = 0.5, step_size: int = 500):
    """Epoch-granular schedule; call `.step()` once per epoch."""
    if name in (None, "none"):
        return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda epoch: 1.0)
    if name == "step":
        return torch.optim.lr_scheduler.StepLR(optimizer, step_size=step_size, gamma=gamma)
    raise NotImplementedError(f"lr scheduler {name}: the port has step")
