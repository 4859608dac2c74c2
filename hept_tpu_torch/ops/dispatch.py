"""Which version a kernel wrapper runs.

A wrapper runs its plain PyTorch version only for tensors on the CPU, and its
CUDA kernel for tensors on a CUDA device. `plain_reference()` is the one
exception: inside it the wrappers run their plain versions on CUDA tensors
too, so a caller can compute the same step both ways on the card and compare
(chip_smoke.py does). It is never entered implicitly.
"""

from __future__ import annotations

import contextlib

import torch

_plain_on_cuda = False


@contextlib.contextmanager
def plain_reference():
    """Run every kernel wrapper's plain PyTorch version, on any device."""
    global _plain_on_cuda
    prev = _plain_on_cuda
    _plain_on_cuda = True
    try:
        yield
    finally:
        _plain_on_cuda = prev


def use_kernel(t: torch.Tensor) -> bool:
    """True where the CUDA kernel must run, False for the plain version."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return not _plain_on_cuda
