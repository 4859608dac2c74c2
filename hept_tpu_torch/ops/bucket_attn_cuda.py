"""Per-bucket RBF attention: CUDA kernels K1 (forward) and K2 (backward)
with their plain PyTorch versions (`csrc/bucket_attn.cu`).

Replaces `hept_tpu/ops/bucket_attn_pallas.py`'s flat-slab kernels
(`_fwd_slab128_kernel`, `_bwd_slab128_kernel`). Layout (r, d, n) columns with
n = nb * block_size sorted points. bf16 inputs run the mixed-precision
contract of the JAX kernels: products of bf16 values summed in f32, exact f32
norms, pt rounded to bf16 for the value product, g_so rounded to bf16 in the
backward, gradients cast to the input dtype.

The plain forward is `bucket_rbf_attention_cols_xla`'s einsum math; the plain
backward is the explicit formula of `_bwd_slab128_kernel`, per bucket, with
the same hi/lo bf16 split of the dl cotangent and the row/column sums taken
from the same split operands.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .dispatch import use_kernel

DENOM_EPS = 1e-20
# (d, dv) pairs compiled into csrc/bucket_attn.cu (HEPT_DIMS there)
SUPPORTED_DIMS = ((30, 24), (7, 5))
# launches of each kernel since the last reset (plain integer counters)
LAUNCHES = {"bucket_attn_fwd": 0, "bucket_attn_bwd": 0}


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def bucket_attn_fwd_plain(sq, sk, sv, block_size: int):
    """Plain K1: returns (denom (r, 1, n), so (r, dv, n)) float32."""
    r, d, n = sq.shape
    dv = sv.shape[1]
    nb = n // block_size
    bf16 = sq.dtype == torch.bfloat16
    q = sq.to(torch.float32).reshape(r, d, nb, block_size)
    k = sk.to(torch.float32).reshape(r, d, nb, block_size)
    v = sv.to(torch.float32).reshape(r, dv, nb, block_size)
    logits = torch.einsum("rdgi,rdgj->rgij", q, k)
    q_sq = -0.5 * torch.sum(q * q, dim=1)  # (r, nb, B)
    k_sq = -0.5 * torch.sum(k * k, dim=1)
    logits = logits + q_sq[..., :, None] + k_sq[..., None, :]
    p = torch.exp(torch.clamp(logits, max=0.0))
    denom = torch.sum(p, dim=-1) + DENOM_EPS
    so = torch.einsum("rdgj,rgij->rdgi", v, _bf16_round(p) if bf16 else p)
    return denom.reshape(r, 1, n), so.reshape(r, dv, n)


def bucket_attn_bwd_plain(sq, sk, sv, g_denom, g_so, block_size: int):
    """Plain K2: returns (dq, dk, dv) in the input dtypes."""
    r, d, n = sq.shape
    dv = sv.shape[1]
    nb = n // block_size
    bf16 = sq.dtype == torch.bfloat16
    q = sq.to(torch.float32).reshape(r, d, nb, block_size)
    k = sk.to(torch.float32).reshape(r, d, nb, block_size)
    v = sv.to(torch.float32).reshape(r, dv, nb, block_size)
    g = g_so.to(torch.float32).reshape(r, dv, nb, block_size)
    if bf16:
        g = _bf16_round(g)
    gd = g_denom.to(torch.float32).reshape(r, nb, block_size)
    q_sq = -0.5 * torch.sum(q * q, dim=1)
    k_sq = -0.5 * torch.sum(k * k, dim=1)
    # key-major (r, nb, Bk, Bq), as the TPU kernel's logits_t
    logits_t = torch.einsum("rdgj,rdgi->rgji", k, q) + k_sq[..., :, None] + q_sq[..., None, :]
    pt = torch.exp(torch.clamp(logits_t, max=0.0))
    gp = torch.einsum("rdgj,rdgi->rgji", v, g) + gd[..., None, :]
    dlt = torch.where(logits_t < 0.0, pt * gp, torch.zeros_like(pt))
    if bf16:
        hi = _bf16_round(dlt)
        parts = (hi, _bf16_round(dlt - hi))
    else:
        parts = (dlt,)
    # ones-augmented k/q: the row and column sums come from the same operands
    dq = sum(torch.einsum("rdgj,rgji->rdgi", k, p) for p in parts)
    rowsum = sum(p.sum(dim=2) for p in parts)  # (r, nb, Bq)
    dk = sum(torch.einsum("rdgi,rgji->rdgj", q, p) for p in parts)
    colsum = sum(p.sum(dim=3) for p in parts)  # (r, nb, Bk)
    dq = dq - rowsum[:, None] * q
    dk = dk - colsum[:, None] * k
    dv_out = torch.einsum("rdgi,rgji->rdgj", g, _bf16_round(pt) if bf16 else pt)
    return (dq.reshape(r, d, n).to(sq.dtype), dk.reshape(r, d, n).to(sk.dtype),
            dv_out.reshape(r, dv, n).to(sv.dtype))


def _check_inputs(sq, sk, sv, block_size):
    r, d, n = sq.shape
    dv = sv.shape[1]
    if sk.shape != sq.shape or sv.shape != (r, dv, n):
        raise ValueError(f"shapes sq {tuple(sq.shape)} sk {tuple(sk.shape)} sv {tuple(sv.shape)}")
    if sq.dtype not in (torch.bfloat16, torch.float32) or sk.dtype != sq.dtype \
            or sv.dtype != sq.dtype:
        raise ValueError(f"dtypes {sq.dtype} {sk.dtype} {sv.dtype}: need one of bf16/f32")
    if (d, dv) not in SUPPORTED_DIMS:
        raise ValueError(f"(d, dv) = {(d, dv)} not compiled; have {SUPPORTED_DIMS}")
    if n % block_size or block_size * (d + dv + 2) * 4 > 227 * 1024:
        raise ValueError(f"n={n} / block_size={block_size} unsupported")
    for t in (sq, sk, sv):
        if not t.is_cuda or t.device != sq.device or not t.is_contiguous():
            raise ValueError("inputs must be contiguous CUDA tensors on one device")
    return r, d, dv, n


def bucket_attn_fwd_cuda(sq, sk, sv, block_size: int):
    """K1 on the card: (denom (r, 1, n), so (r, dv, n)) float32."""
    r, d, dv, n = _check_inputs(sq, sk, sv, block_size)
    denom = torch.empty((r, 1, n), dtype=torch.float32, device=sq.device)
    so = torch.empty((r, dv, n), dtype=torch.float32, device=sq.device)
    lib = cuda_lib.load("bucket_attn")
    fn = lib.hept_bucket_attn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    err = fn(sq.data_ptr(), sk.data_ptr(), sv.data_ptr(), denom.data_ptr(), so.data_ptr(),
             r, d, dv, n, block_size, int(sq.dtype == torch.bfloat16),
             cuda_lib.stream_ptr(sq.device))
    cuda_lib.check(err, lib, "hept_bucket_attn_error_string", "bucket_attn_fwd")
    LAUNCHES["bucket_attn_fwd"] += 1
    return denom, so


def bucket_attn_bwd_cuda(sq, sk, sv, g_denom, g_so, block_size: int):
    """K2 on the card: (dq, dk, dv) in the input dtypes."""
    r, d, dv, n = _check_inputs(sq, sk, sv, block_size)
    for t, shp in ((g_denom, (r, 1, n)), (g_so, (r, dv, n))):
        if t.shape != shp or t.dtype != torch.float32 or t.device != sq.device \
                or not t.is_contiguous():
            raise ValueError(f"cotangent {tuple(t.shape)} {t.dtype}: need contiguous f32 {shp}")
    dq = torch.empty_like(sq)
    dk = torch.empty_like(sk)
    dv_out = torch.empty_like(sv)
    lib = cuda_lib.load("bucket_attn")
    fn = lib.hept_bucket_attn_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    err = fn(sq.data_ptr(), sk.data_ptr(), sv.data_ptr(), g_so.data_ptr(), g_denom.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv_out.data_ptr(), r, d, dv, n, block_size,
             int(sq.dtype == torch.bfloat16), cuda_lib.stream_ptr(sq.device))
    cuda_lib.check(err, lib, "hept_bucket_attn_error_string", "bucket_attn_bwd")
    LAUNCHES["bucket_attn_bwd"] += 1
    return dq, dk, dv_out


def bucket_attn_fwd(sq, sk, sv, block_size: int):
    if use_kernel(sq):
        return bucket_attn_fwd_cuda(sq, sk, sv, block_size)
    return bucket_attn_fwd_plain(sq, sk, sv, block_size)


def bucket_attn_bwd(sq, sk, sv, g_denom, g_so, block_size: int):
    if use_kernel(sq):
        return bucket_attn_bwd_cuda(sq, sk, sv, g_denom.contiguous(), g_so.contiguous(),
                                    block_size)
    return bucket_attn_bwd_plain(sq, sk, sv, g_denom, g_so, block_size)


class _BucketRBFAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sq, sk, sv, block_size):
        ctx.save_for_backward(sq, sk, sv)
        ctx.block_size = block_size
        return bucket_attn_fwd(sq, sk, sv, block_size)

    @staticmethod
    def backward(ctx, g_denom, g_so):
        sq, sk, sv = ctx.saved_tensors
        dq, dk, dv = bucket_attn_bwd(sq, sk, sv, g_denom.to(torch.float32),
                                     g_so.to(torch.float32), ctx.block_size)
        return dq, dk, dv, None


def bucket_rbf_attention_cols(sq: torch.Tensor, sk: torch.Tensor, sv: torch.Tensor,
                              block_size: int):
    """Column-major per-bucket RBF attention with the K2 backward.

    Args: sq, sk (r, d, n); sv (r, dv, n), all bf16 or all f32.
    Returns: (denom (r, 1, n), so (r, dv, n)) float32.
    """
    return _BucketRBFAttention.apply(sq, sk, sv, block_size)
