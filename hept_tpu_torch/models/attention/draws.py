"""The per-forward random draws of the LSH baselines (reformer's rotations,
smyrf's and sb's E2LSH directions and shifts).

The JAX package draws them from a "rotations" rng stream that its trainer
splits per event in training, and from `PRNGKey(0)` without one (eval). The
port draws them from the step's generator in training (as it draws dropout)
and, without one, takes a fixed draw: a CPU generator seeded 0, so the draw
is the same on every device. The fixed draw equals JAX's in distribution,
not in value; a caller that needs JAX's values passes them in
(`rotations=`).
"""

from __future__ import annotations

import torch


def _one(kind: str, shape: tuple, generator, device) -> torch.Tensor:
    if kind == "normal":
        return torch.randn(shape, generator=generator, device=device)
    return torch.rand(shape, generator=generator, device=device)


def draw(specs: tuple, generator: torch.Generator | None, device, fixed: dict) -> tuple:
    """One tensor per (kind, shape) of `specs` ("normal" or "uniform" on
    [0, 1)): from `generator`, or the fixed draw, kept in `fixed` per device
    so that no forward copies it to the card again."""
    if generator is not None:
        return tuple(_one(kind, shape, generator, generator.device) for kind, shape in specs)
    key = (str(device), specs)
    if key not in fixed:
        gen = torch.Generator().manual_seed(0)
        # kept as normal tensors even when first drawn under inference_mode
        # (evaluate), so that a later training forward can use them
        with torch.inference_mode(False):
            fixed[key] = tuple(_one(kind, shape, gen, "cpu").to(device) for kind, shape in specs)
    return fixed[key]
