"""Per-row multi-operand sort: kernel K12 (`csrc/sort.cu`) and its plain
version.

    bitonic_sort_rows(keys, payloads) -> payloads, each row sorted by
    (keys, payloads[-1]) lexicographically, ascending

Port of `hept_tpu/ops/sort_pallas.py:bitonic_sort_rows`: keys (rows, n)
float32; payloads (rows, n) 32-bit tensors whose last entry is the
row-position iota, the tie-break (compared as int32: a row index below 2^31
orders the same way signed). Unsigned payloads travel as int32 bit patterns
(`.view(torch.int32)`), since PyTorch has few uint32 ops. The order is total
on non-NaN keys, so the result does not depend on how the sort runs; -0.0
and +0.0 compare equal, as in the TPU kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .dispatch import use_kernel

# most payload operands one call carries (the kernel's pointer table)
MAX_OPS = 32
# launches of the kernel since the last reset (a plain integer counter; one
# per call, which runs the sort's few grid launches on one stream)
LAUNCHES = {"bitonic_sort": 0}


def bitonic_sort_rows_plain(keys: torch.Tensor, payloads: list[torch.Tensor]) -> list[torch.Tensor]:
    """Plain K12: a stable lexsort (by the tie-break, then stably by the
    keys) and one gather per payload."""
    by_tie = torch.argsort(payloads[-1], dim=-1, stable=True)
    keys = keys.gather(-1, by_tie) + 0.0  # -0.0 + 0.0 is +0.0: signed zeros tie
    perm = by_tie.gather(-1, torch.argsort(keys, dim=-1, stable=True))
    return [p.gather(-1, perm) for p in payloads]


def _check(keys: torch.Tensor, payloads: list[torch.Tensor]) -> None:
    if keys.dim() != 2 or keys.dtype != torch.float32 or not keys.is_cuda \
            or not keys.is_contiguous():
        raise ValueError(f"keys must be a contiguous (rows, n) float32 CUDA tensor, got "
                         f"{tuple(keys.shape)} {keys.dtype} on {keys.device}")
    if not 1 <= len(payloads) <= MAX_OPS or payloads[-1].dtype != torch.int32:
        raise ValueError(f"need 1 to {MAX_OPS} payloads, the last (the tie-break) int32")
    for p in payloads:
        if p.shape != keys.shape or p.element_size() != 4 or p.device != keys.device \
                or not p.is_contiguous():
            raise ValueError(f"payloads must be contiguous 4-byte {tuple(keys.shape)} tensors "
                             f"on {keys.device}, got {tuple(p.shape)} {p.dtype} on {p.device}")
    if keys.shape[0] > 65535 or keys.shape[1] >= 2**30:
        raise ValueError(f"keys {tuple(keys.shape)}: at most 65535 rows of < 2^30 keys")


def bitonic_sort_rows_cuda(keys: torch.Tensor, payloads: list[torch.Tensor]) -> list[torch.Tensor]:
    """K12 on the card. Raises on any input the kernel does not take."""
    _check(keys, payloads)
    rows, n = keys.shape
    n_pad = 1 << max(1, (n - 1).bit_length())
    scratch = torch.empty((3, rows, n_pad), dtype=torch.int32, device=keys.device)
    outs = [torch.empty_like(p) for p in payloads]
    ops = len(payloads)
    ins_arr = (ctypes.c_void_p * ops)(*(p.data_ptr() for p in payloads))
    outs_arr = (ctypes.c_void_p * ops)(*(o.data_ptr() for o in outs))
    lib = cuda_lib.load("sort")
    fn = lib.hept_bitonic_sort_rows
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p, ctypes.c_void_p]
    err = fn(keys.data_ptr(), ins_arr, outs_arr, ops, rows, n, n_pad, scratch.data_ptr(),
             cuda_lib.stream_ptr(keys.device))
    cuda_lib.check(err, lib, "hept_sort_error_string", "bitonic_sort_rows")
    LAUNCHES["bitonic_sort"] += 1
    return outs


def bitonic_sort_rows(keys: torch.Tensor, payloads: list[torch.Tensor]) -> list[torch.Tensor]:
    """Sort each row of `keys` ascending, carrying `payloads` through the
    same permutation; ties in the key are broken by `payloads[-1]`.

    Args:
      keys: (rows, n) float32, not NaN.
      payloads: (rows, n) 32-bit tensors; the last is the int32 tie-break
        (the row-position iota of `sort_pallas.bitonic_sort_rows`).
    Returns: the sorted payloads (the keys are not returned).
    K12 for CUDA tensors, its plain version for CPU tensors.
    """
    if use_kernel(keys):
        return bitonic_sort_rows_cuda(keys, payloads)
    return bitonic_sort_rows_plain(keys, payloads)
