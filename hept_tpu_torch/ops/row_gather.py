"""Flat row gather: kernel K5 (`csrc/row_gather.cu`), which also carries
K11's contract, and its plain version.

    out[r, p, :] = src[r % S, idx[r, p], :]    with S | R

src (S, n, W) of 2- or 4-byte elements, copied bit for bit; idx (R, n)
int64. It is the [num|denom] unsort of every HEPT layer
(`core/buckets.py:permute_gather_rows`), forward and backward. Port of the
contract of `hept_tpu/ops/gather_pallas.py:row_gather_dma` /
`row_gather_vreg`, without their 128-lane padding: the output keeps the
source's width.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .dispatch import use_kernel

# launches of the kernel since the last reset (a plain integer counter)
LAUNCHES = {"row_gather": 0}


def row_gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain K5: one flat index gather over the (S * n, W) source rows."""
    s, n, w = src.shape
    r = idx.shape[0]
    offs = (torch.arange(r, device=idx.device) % s) * n
    flat = src.reshape(s * n, w)
    return flat[(idx + offs[:, None]).reshape(-1)].reshape(r, n, w)


def _check(src: torch.Tensor, idx: torch.Tensor) -> None:
    if src.dim() != 3 or src.element_size() not in (2, 4) or not src.is_contiguous() \
            or not src.is_cuda:
        raise ValueError("row_gather: need a contiguous (S, n, W) CUDA tensor of 2- or 4-byte "
                         f"elements, got {tuple(src.shape)} {src.dtype} on {src.device}")
    if idx.dim() != 2 or idx.dtype != torch.int64 or not idx.is_contiguous() \
            or idx.device != src.device:
        raise ValueError(f"row_gather: index must be a contiguous (R, n) int64 tensor on "
                         f"{src.device}, got {tuple(idx.shape)} {idx.dtype} on {idx.device}")
    if idx.shape[1] != src.shape[1] or idx.shape[0] % src.shape[0]:
        raise ValueError(f"row_gather: index {tuple(idx.shape)} does not fit source "
                         f"{tuple(src.shape)} (need n equal and S | R)")


def row_gather_cuda(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K5 on the card. Raises on any input the kernel does not take."""
    _check(src, idx)
    s, n, w = src.shape
    r = idx.shape[0]
    out = torch.empty((r, n, w), dtype=src.dtype, device=src.device)
    lib = cuda_lib.load("row_gather")
    fn = lib.hept_row_gather
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_void_p]
    err = fn(src.data_ptr(), idx.data_ptr(), out.data_ptr(), r * n, n, s,
             w * src.element_size(), cuda_lib.stream_ptr(src.device))
    cuda_lib.check(err, lib, "hept_row_gather_error_string", "row_gather")
    LAUNCHES["row_gather"] += 1
    return out


def row_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K5 for CUDA tensors, its plain version for CPU tensors."""
    if use_kernel(src):
        return row_gather_cuda(src.contiguous(), idx)
    return row_gather_plain(src, idx)
