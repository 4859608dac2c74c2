"""Parameter and FLOP counts (port of `hept_tpu/utils/flops.py`).

The JAX package reads XLA's cost analysis of the compiled forward, which has
no torch counterpart. `forward_flops` counts with
`torch.utils.flop_counter.FlopCounterMode`, which counts the FLOPs of matrix
products and convolutions (2 per multiply-add) and nothing else: the number
is not XLA's, which also counts elementwise work.
"""

from __future__ import annotations

import torch


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def forward_flops(fn) -> int:
    """FLOPs of the matmuls and convolutions `fn()` runs, without autograd."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())
