"""Linear / MLP building blocks (port of `hept_tpu/models/mlp.py`).

`TorchLinear` is `nn.Linear` with torch's default init law, U(+-1/sqrt(fan_in))
for weight and bias, drawn from an explicit generator. Its weight is stored
(out, in) as nn.Linear's; the flax module keeps its kernel (in, out), and
utils/convert.py transposes it. LayerNorms use flax's eps = 1e-6 (torch
defaults to 1e-5).
"""

from __future__ import annotations

import math

import torch
from torch import nn

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator | None) -> torch.Tensor:
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class TorchLinear(nn.Linear):
    """nn.Linear initialised as torch does, from `generator`."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 generator: torch.Generator | None = None, device=None):
        self._generator = generator
        super().__init__(in_features, out_features, bias=bias, device=device)
        del self._generator

    def reset_parameters(self) -> None:
        gen = getattr(self, "_generator", None)
        bound = 1.0 / math.sqrt(self.in_features)
        uniform_(self.weight, bound, gen)
        if self.bias is not None:
            uniform_(self.bias, bound, gen)


def layer_norm(features: int, device=None) -> nn.LayerNorm:
    return nn.LayerNorm(features, eps=LN_EPS, device=device)


class OutMLP(nn.Module):
    """The output head MLP: 5 layers, hidden 256, LayerNorm + tanh after every
    layer but the last."""

    def __init__(self, in_features: int, out_features: int, hidden: int = 256,
                 num_layers: int = 5, generator=None, device=None):
        super().__init__()
        dims = [in_features] + [hidden] * (num_layers - 1) + [out_features]
        self.lins = nn.ModuleList(
            TorchLinear(a, b, generator=generator, device=device)
            for a, b in zip(dims[:-1], dims[1:])
        )
        self.norms = nn.ModuleList(layer_norm(hidden, device) for _ in range(num_layers - 1))

    def forward(self, x):
        for lin, norm in zip(self.lins[:-1], self.norms):
            x = torch.tanh(norm(lin(x)))
        return self.lins[-1](x)


class FeedForward(nn.Module):
    """Per-block FF: Linear -> ReLU -> Linear."""

    def __init__(self, features: int, generator=None, device=None):
        super().__init__()
        self.fc1 = TorchLinear(features, features, generator=generator, device=device)
        self.fc2 = TorchLinear(features, features, generator=generator, device=device)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def dropout(x: torch.Tensor, p: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout drawn from `generator`; identity without one (the
    deterministic, evaluation mode)."""
    if generator is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
