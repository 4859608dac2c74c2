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

The kernel has two routes, picked by shape before launch (`sort_route`):
rows of up to 65536 keys sort inside one thread-block cluster's shared
memory, and each payload then moves once through it; longer rows take the
bitonic network through device memory. See `csrc/sort.cu`.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .dispatch import use_kernel

# most payload operands one call carries (the kernel's pointer table)
MAX_OPS = 32
# longest row the cluster route takes: 8 CTAs of 8192 (key, position) pairs
CLUSTER_MAX_N = 65536
# launches of the kernel per route since the last reset (plain integer
# counters; one per call, which runs its route's few grid launches on one
# stream)
LAUNCHES = {"sort_cluster": 0, "sort_bitonic": 0}

_ENTRIES: dict[str, object] = {}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"hept_sort_rows_cluster": [_PTR, _PTR, _PTR] + [_INT] * 3 + [_PTR, _PTR],
             "hept_bitonic_sort_rows": [_PTR, _PTR, _PTR] + [_INT] * 4 + [_PTR, _PTR]}


def bitonic_sort_rows_plain(keys: torch.Tensor, payloads: list[torch.Tensor]) -> list[torch.Tensor]:
    """Plain K12: a stable lexsort (by the tie-break, then stably by the
    keys) and one gather per payload."""
    by_tie = torch.argsort(payloads[-1], dim=-1, stable=True)
    keys = keys.gather(-1, by_tie) + 0.0  # -0.0 + 0.0 is +0.0: signed zeros tie
    perm = by_tie.gather(-1, torch.argsort(keys, dim=-1, stable=True))
    return [p.gather(-1, perm) for p in payloads]


def sort_route(rows: int, n: int, ops: int) -> str:
    """The kernel route for a (rows, n) sort carrying `ops` payloads, chosen
    by shape before launch: "cluster" (a row held in one thread-block
    cluster's shared memory) up to CLUSTER_MAX_N keys a row, else "bitonic"
    (the network through device memory). Raises on shapes neither takes."""
    if not 1 <= ops <= MAX_OPS:
        raise ValueError(f"need 1 to {MAX_OPS} payloads, got {ops}")
    if not (0 <= rows <= 65535 and 0 <= n < 2**30):
        raise ValueError(f"keys ({rows}, {n}): at most 65535 rows of < 2^30 keys")
    return "cluster" if n <= CLUSTER_MAX_N else "bitonic"


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


def _entry(name: str):
    """The library's entry point, its argument types set once per process."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(cuda_lib.load("sort"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _ENTRIES[name] = fn
    return fn


def bitonic_sort_rows_cuda(keys: torch.Tensor, payloads: list[torch.Tensor]) -> list[torch.Tensor]:
    """K12 on the card, on the route `sort_route` picks. Raises on any input
    no route takes, and on a failed build or launch."""
    _check(keys, payloads)
    rows, n = keys.shape
    ops = len(payloads)
    route = sort_route(rows, n, ops)
    outs = [torch.empty_like(p) for p in payloads]
    if keys.numel() == 0:
        return outs
    ins_arr = (ctypes.c_void_p * ops)(*(p.data_ptr() for p in payloads))
    outs_arr = (ctypes.c_void_p * ops)(*(o.data_ptr() for o in outs))
    stream = cuda_lib.stream_ptr(keys.device)
    if route == "cluster":
        # the sorted positions (< 65536) as uint16 bit patterns
        scratch = torch.empty((rows, n), dtype=torch.int16, device=keys.device)
        err = _entry("hept_sort_rows_cluster")(keys.data_ptr(), ins_arr, outs_arr, ops, rows,
                                               n, scratch.data_ptr(), stream)
    else:
        n_pad = 1 << max(1, (n - 1).bit_length())
        # (key, tie-break, position) triples
        scratch = torch.empty((3, rows, n_pad), dtype=torch.int32, device=keys.device)
        err = _entry("hept_bitonic_sort_rows")(keys.data_ptr(), ins_arr, outs_arr, ops, rows,
                                               n, n_pad, scratch.data_ptr(), stream)
    cuda_lib.check(err, cuda_lib.load("sort"), "hept_sort_error_string",
                   f"bitonic_sort_rows ({route} route)")
    LAUNCHES[f"sort_{route}"] += 1
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
