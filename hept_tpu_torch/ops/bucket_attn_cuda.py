"""Per-bucket RBF attention: CUDA kernels K1/K2 (flat-slab replacements),
K6/K7 (per-bucket column kernels for small buckets) and K10 (the row-major
kernel of `hept_attention_core`), their plain PyTorch versions, and the
`attn_impl` dispatch (`csrc/bucket_attn.cu`).

Replaces `hept_tpu/ops/bucket_attn_pallas.py`'s flat-slab kernels
(`_fwd_slab128_kernel`, `_bwd_slab128_kernel`: K1/K2) and column kernels
(`_fwd_cols_kernel` / `_fwd_cols_kernel_loop`: K6; `_bwd_cols_kernel`,
`_bwd_cols_kernel_v2` / `_bwd_v2_bucket` / `_bwd_cols_kernel_v2_loop`: K7),
its row-major kernel (`_fwd_kernel` / `_bwd_kernel`: K10), and runs the
contracts of its slab kernels (`_fwd_slab_kernel`: K8, `_bwd_slab_kernel`:
K9) on K6/K7 (`cols_routes`). Layout of K1/K2/K6/K7: (r, d, n) columns with
n = nb * block_size sorted points; K10: (..., B, d) rows. bf16 inputs
run the mixed-precision contract of the JAX kernels: products of bf16 values
summed in f32, exact f32 norms, pt rounded to bf16 for the value product,
g_so rounded to bf16 in the backward, gradients cast to the input dtype.
K1/K2 run bf16 inputs at block sizes that are multiples of 16 on the tensor
cores and everything else on scalar FMAs (`bucket_attn_route`); K6 on bf16
and K7 v2 run at block sizes that are multiples of 4 on the same tensor-core
scheme, with buckets padded to 16 points, and f32 K6 and K7 v1 on FP32 FMAs
(`cols_fwd_route`, `cols_bwd_route`); each route with its own launch
counters. K10 runs f32 K6's and K7 v1's register-tiled kernels on the row
layout up to bs 100 and the first-cut ones otherwise (`rows_fwd_route`,
`rows_bwd_route`; one counter each way).

The plain forward is `bucket_rbf_attention_cols_xla`'s einsum math (K6 in
`pallas` mode on bf16 adds the bias terms as hi/lo bf16 pairs instead); the
plain backward is the explicit formula of `_bwd_v2_bucket` per bucket, with
the same hi/lo bf16 split of the dl cotangent and the row/column sums taken
from the same split operands (bf16), or plain f32 (K7 v1, which upcasts bf16
residuals as `_bwd_cols_impl` does).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .dispatch import use_kernel

DENOM_EPS = 1e-20
# (d, dv) pairs compiled into csrc/bucket_attn.cu (HEPT_DIMS there): d = 30
# the tracking width (h_dim 24 + coords_dim 6), 7 / 5 the tests'
SUPPORTED_DIMS = ((30, 24), (7, 5))
# and for the column kernels K6 / K7 (HEPT_COLS_DIMS): also the pileup width,
# coords_dim 4
COLS_DIMS = SUPPORTED_DIMS + ((28, 24),)
# the attn_impl modes (`cols_routes`): every mode of the JAX package
ATTN_IMPLS = ("xla", "slab2", "hybrid", "hybrid2", "hybrid2l", "pallas", "loop2", "slab",
              "hybrid_slab")
# launches of each kernel since the last reset (plain integer counters);
# K1 / K2, K6 and K7 count per route: "_tc" the tensor-core kernels, the bare
# names the FP32 ones (`bucket_attn_route`, `cols_fwd_route`, `cols_bwd_route`)
LAUNCHES = {"bucket_attn_fwd_tc": 0, "bucket_attn_bwd_tc": 0, "bucket_attn_fwd": 0,
            "bucket_attn_bwd": 0, "cols_fwd_tc": 0, "cols_fwd": 0, "cols_bwd_tc": 0,
            "cols_bwd": 0, "rows_fwd": 0, "rows_bwd": 0}
# shared bytes per padded point of K7's tensor-core tiles at the widest
# compiled (d, dv) = (30, 24), and at (28, 24) alike (d + 1 rounds up to 32
# at both): bf16 rows of 40 (q / k, ones column) and 24 (v / g_so) values,
# and two f32 norms (TcDims in csrc/bucket_attn.cu)
_TC_COLS_BYTES_PER_POINT = (40 + 24) * 2 + 8
# and of K6's: bf16 rows of 40 (k) and 24 (v) values and one f32 norm
# (tc_cols_fwd_smem)
_TC_COLS_FWD_BYTES_PER_POINT = (40 + 24) * 2 + 4
_SMEM_BYTES = 227 * 1024


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _bias(x_sq: torch.Tensor, hilo: bool) -> torch.Tensor:
    """A -|x|^2/2 bias as K6's `pallas` bf16 mode carries it: hi + lo, two
    bf16 rows (`_split_rows`); exact f32 otherwise."""
    if not hilo:
        return x_sq
    hi = _bf16_round(x_sq)
    return hi + _bf16_round(x_sq - hi)


def _fwd_plain(sq, sk, sv, block_size: int, hilo: bool = False):
    r, d, n = sq.shape
    dv = sv.shape[1]
    nb = n // block_size
    bf16 = sq.dtype == torch.bfloat16
    q = sq.to(torch.float32).reshape(r, d, nb, block_size)
    k = sk.to(torch.float32).reshape(r, d, nb, block_size)
    v = sv.to(torch.float32).reshape(r, dv, nb, block_size)
    logits = torch.einsum("rdgi,rdgj->rgij", q, k)
    hilo = hilo and bf16
    q_sq = _bias(-0.5 * torch.sum(q * q, dim=1), hilo)  # (r, nb, B)
    k_sq = _bias(-0.5 * torch.sum(k * k, dim=1), hilo)
    logits = logits + q_sq[..., :, None] + k_sq[..., None, :]
    p = torch.exp(torch.clamp(logits, max=0.0))
    denom = torch.sum(p, dim=-1) + DENOM_EPS
    so = torch.einsum("rdgj,rgij->rdgi", v, _bf16_round(p) if bf16 else p)
    return denom.reshape(r, 1, n), so.reshape(r, dv, n)


def bucket_attn_fwd_plain(sq, sk, sv, block_size: int):
    """Plain K1: returns (denom (r, 1, n), so (r, dv, n)) float32."""
    return _fwd_plain(sq, sk, sv, block_size)


def cols_fwd_plain(sq, sk, sv, block_size: int, hilo: bool = False):
    """Plain K6: K1's math, or with `hilo` (bf16 inputs, `pallas` mode)
    logit = sum q.k + (q_hi + q_lo) + (k_hi + k_lo), the bias terms carried
    as hi/lo bf16 pairs (`_fwd_cols_kernel`). Returns (denom, so) float32."""
    return _fwd_plain(sq, sk, sv, block_size, hilo)


def bucket_attn_bwd_plain(sq, sk, sv, g_denom, g_so, block_size: int):
    """Plain K2 (and K7 v2 on bf16): returns (dq, dk, dv) in the input dtypes."""
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


def cols_bwd_plain(sq, sk, sv, g_denom, g_so, block_size: int, v2: bool):
    """Plain K7: v2 on bf16 inputs is K2's bf16 math (`_bwd_v2_bucket`);
    otherwise v1, the f32 math on residuals upcast to f32, with the
    gradients cast back to the input dtypes (`_bwd_cols_impl`)."""
    if v2 and sq.dtype == torch.bfloat16:
        return bucket_attn_bwd_plain(sq, sk, sv, g_denom, g_so, block_size)
    grads = bucket_attn_bwd_plain(sq.float(), sk.float(), sv.float(), g_denom, g_so.float(),
                                  block_size)
    return tuple(g.to(t.dtype) for g, t in zip(grads, (sq, sk, sv)))


def bucket_attn_route(dtype: torch.dtype, block_size: int) -> str:
    """K1 / K2's route, fixed by dtype and bucket size before launch: "tc"
    (bf16 tensor cores) for bf16 inputs with block_size % 16 == 0, every
    shape the hept_acc step and its eval launch; "scalar" (f32 FMAs)
    otherwise: f32 inputs must not use TF32, the reference asks for HIGHEST."""
    return "tc" if dtype == torch.bfloat16 and block_size % 16 == 0 else "scalar"


def _tc_cols_fits(block_size: int, bytes_per_point: int) -> bool:
    """A bucket padded to a multiple of 16 points fits a CTA's shared memory
    on the column kernels' tensor-core route (staged with 8-byte loads, so
    block_size % 4 == 0)."""
    padded = -(-block_size // 16) * 16
    return block_size % 4 == 0 and padded * bytes_per_point <= _SMEM_BYTES


def cols_fwd_route(dtype: torch.dtype, block_size: int) -> str:
    """K6's route, fixed by dtype and bucket size before launch: "tc" (K1's
    bf16 tensor-core products on buckets padded to a multiple of 16 points)
    for bf16 inputs where block_size % 4 == 0 and the padded tiles fit in
    shared memory; "scalar" (FP32 FMAs) otherwise: f32, whose math must not
    use TF32 or bf16, and bf16 at any other block size."""
    if dtype == torch.bfloat16 and _tc_cols_fits(block_size, _TC_COLS_FWD_BYTES_PER_POINT):
        return "tc"
    return "scalar"


def cols_bwd_route(dtype: torch.dtype, block_size: int, v2: bool) -> str:
    """K7's route, fixed by dtype, bucket size and variant before launch:
    "tc" (K2's bf16 tensor-core halves on buckets padded to a multiple of 16
    points) for v2 on bf16 inputs where block_size % 4 == 0 (the staging's
    8-byte loads) and the padded tiles fit in shared memory; "scalar" (FP32
    FMAs) otherwise: v1, whose f32 math must not use TF32 or bf16, and v2 at
    any other block size."""
    if dtype == torch.bfloat16 and v2 and _tc_cols_fits(block_size, _TC_COLS_BYTES_PER_POINT):
        return "tc"
    return "scalar"


def _check_inputs(sq, sk, sv, block_size, route="scalar", cotangents=(), dims=SUPPORTED_DIMS):
    r, d, n = sq.shape
    dv = sv.shape[1]
    if sk.shape != sq.shape or sv.shape != (r, dv, n):
        raise ValueError(f"shapes sq {tuple(sq.shape)} sk {tuple(sk.shape)} sv {tuple(sv.shape)}")
    if sq.dtype not in (torch.bfloat16, torch.float32) or sk.dtype != sq.dtype \
            or sv.dtype != sq.dtype:
        raise ValueError(f"dtypes {sq.dtype} {sk.dtype} {sv.dtype}: need one of bf16/f32")
    if (d, dv) not in dims:
        raise ValueError(f"(d, dv) = {(d, dv)} not compiled; have {dims}")
    # the scalar route (and K6 / K7) stages f32 rows; the tensor-core
    # launchers refuse a bucket whose bf16 tiles overflow shared memory
    if n % block_size or (route == "scalar" and block_size * (d + dv + 2) * 4 > _SMEM_BYTES):
        raise ValueError(f"n={n} / block_size={block_size} unsupported")
    for t in (sq, sk, sv):
        if not t.is_cuda or t.device != sq.device or not t.is_contiguous():
            raise ValueError("inputs must be contiguous CUDA tensors on one device")
    for t, shp in zip(cotangents, ((r, 1, n), (r, dv, n))):
        if t.shape != shp or t.dtype != torch.float32 or t.device != sq.device \
                or not t.is_contiguous():
            raise ValueError(f"cotangent {tuple(t.shape)} {t.dtype}: need contiguous f32 {shp}")
    # the tensor-core kernels stage with 16-byte loads
    if route == "tc" and any(t.data_ptr() % 16 for t in (sq, sk, sv, *cotangents)):
        raise ValueError("the tensor-core route needs 16-byte aligned tensors")
    return r, d, dv, n


def bucket_attn_fwd_cuda(sq, sk, sv, block_size: int):
    """K1 on the card, on the route `bucket_attn_route` picks:
    (denom (r, 1, n), so (r, dv, n)) float32."""
    route = bucket_attn_route(sq.dtype, block_size)
    r, d, dv, n = _check_inputs(sq, sk, sv, block_size, route)
    denom = torch.empty((r, 1, n), dtype=torch.float32, device=sq.device)
    so = torch.empty((r, dv, n), dtype=torch.float32, device=sq.device)
    lib = cuda_lib.load("bucket_attn")
    args = [sq.data_ptr(), sk.data_ptr(), sv.data_ptr(), denom.data_ptr(), so.data_ptr(),
            r, d, dv, n, block_size]
    if route == "tc":
        fn, name = lib.hept_bucket_attn_fwd_tc, "bucket_attn_fwd_tc"
    else:
        fn, name = lib.hept_bucket_attn_fwd, "bucket_attn_fwd"
        args.append(int(sq.dtype == torch.bfloat16))
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * (len(args) - 5) + [ctypes.c_void_p]
    err = fn(*args, cuda_lib.stream_ptr(sq.device))
    cuda_lib.check(err, lib, "hept_bucket_attn_error_string", name)
    LAUNCHES[name] += 1
    return denom, so


def bucket_attn_bwd_cuda(sq, sk, sv, g_denom, g_so, block_size: int):
    """K2 on the card, on the route `bucket_attn_route` picks: (dq, dk, dv)
    in the input dtypes."""
    route = bucket_attn_route(sq.dtype, block_size)
    r, d, dv, n = _check_inputs(sq, sk, sv, block_size, route, (g_denom, g_so))
    dq = torch.empty_like(sq)
    dk = torch.empty_like(sk)
    dv_out = torch.empty_like(sv)
    lib = cuda_lib.load("bucket_attn")
    args = [sq.data_ptr(), sk.data_ptr(), sv.data_ptr(), g_so.data_ptr(), g_denom.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv_out.data_ptr(), r, d, dv, n, block_size]
    if route == "tc":
        fn, name = lib.hept_bucket_attn_bwd_tc, "bucket_attn_bwd_tc"
    else:
        fn, name = lib.hept_bucket_attn_bwd, "bucket_attn_bwd"
        args.append(int(sq.dtype == torch.bfloat16))
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * (len(args) - 8) + [ctypes.c_void_p]
    err = fn(*args, cuda_lib.stream_ptr(sq.device))
    cuda_lib.check(err, lib, "hept_bucket_attn_error_string", name)
    LAUNCHES[name] += 1
    return dq, dk, dv_out


def cols_fwd_cuda(sq, sk, sv, block_size: int, hilo: bool = False):
    """K6 on the card, on the route `cols_fwd_route` picks: (denom (r, 1, n),
    so (r, dv, n)) float32. `hilo` applies to bf16 inputs only."""
    route = cols_fwd_route(sq.dtype, block_size)
    r, d, dv, n = _check_inputs(sq, sk, sv, block_size, route, dims=COLS_DIMS)
    denom = torch.empty((r, 1, n), dtype=torch.float32, device=sq.device)
    so = torch.empty((r, dv, n), dtype=torch.float32, device=sq.device)
    lib = cuda_lib.load("bucket_attn")
    bf16 = sq.dtype == torch.bfloat16
    args = [sq.data_ptr(), sk.data_ptr(), sv.data_ptr(), denom.data_ptr(), so.data_ptr(),
            r, d, dv, n, block_size]
    if route == "tc":
        fn, name = lib.hept_cols_fwd_tc, "cols_fwd_tc"
        args.append(int(hilo))
    else:
        fn, name = lib.hept_cols_fwd, "cols_fwd"
        args += [int(bf16), int(hilo and bf16)]
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * (len(args) - 5) + [ctypes.c_void_p]
    err = fn(*args, cuda_lib.stream_ptr(sq.device))
    cuda_lib.check(err, lib, "hept_bucket_attn_error_string", name)
    LAUNCHES[name] += 1
    return denom, so


def cols_bwd_cuda(sq, sk, sv, g_denom, g_so, block_size: int, v2: bool):
    """K7 on the card, on the route `cols_bwd_route` picks: (dq, dk, dv) in
    the input dtypes. v2 runs on bf16 inputs only; v1 runs the f32 kernel,
    on upcast copies of bf16 inputs."""
    route = cols_bwd_route(sq.dtype, block_size, v2)
    r, d, dv, n = _check_inputs(sq, sk, sv, block_size, route, (g_denom, g_so), COLS_DIMS)
    v2 = v2 and sq.dtype == torch.bfloat16
    ins = (sq, sk, sv) if v2 else tuple(t.float() for t in (sq, sk, sv))
    outs = tuple(torch.empty_like(t) for t in ins)
    lib = cuda_lib.load("bucket_attn")
    args = [*(t.data_ptr() for t in ins), g_so.data_ptr(), g_denom.data_ptr(),
            *(t.data_ptr() for t in outs), r, d, dv, n, block_size]
    if route == "tc":
        fn, name = lib.hept_cols_bwd_tc, "cols_bwd_tc"
    else:
        fn, name = lib.hept_cols_bwd, "cols_bwd"
        args.append(int(v2))
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * (len(args) - 8) + [ctypes.c_void_p]
    err = fn(*args, cuda_lib.stream_ptr(sq.device))
    cuda_lib.check(err, lib, "hept_bucket_attn_error_string", name)
    LAUNCHES[name] += 1
    return tuple(o.to(t.dtype) for o, t in zip(outs, (sq, sk, sv)))


def bucket_attn_fwd(sq, sk, sv, block_size: int):
    if use_kernel(sq):
        return bucket_attn_fwd_cuda(sq, sk, sv, block_size)
    return bucket_attn_fwd_plain(sq, sk, sv, block_size)


def bucket_attn_bwd(sq, sk, sv, g_denom, g_so, block_size: int):
    if use_kernel(sq):
        return bucket_attn_bwd_cuda(sq, sk, sv, g_denom.contiguous(), g_so.contiguous(),
                                    block_size)
    return bucket_attn_bwd_plain(sq, sk, sv, g_denom, g_so, block_size)


def cols_fwd(sq, sk, sv, block_size: int, hilo: bool = False):
    if use_kernel(sq):
        return cols_fwd_cuda(sq, sk, sv, block_size, hilo)
    return cols_fwd_plain(sq, sk, sv, block_size, hilo)


def cols_bwd(sq, sk, sv, g_denom, g_so, block_size: int, v2: bool):
    if use_kernel(sq):
        return cols_bwd_cuda(sq, sk, sv, g_denom.contiguous(), g_so.contiguous(), block_size,
                             v2)
    return cols_bwd_plain(sq, sk, sv, g_denom, g_so, block_size, v2)


def _slab128_g(nb: int, bs: int, cap_bytes: int = 6 << 20) -> int:
    """Buckets per flat slab of the JAX package's slab2 kernels
    (`bucket_attn_pallas.py:_slab128_g`): the largest g with nb % g == 0,
    (g * bs) % 128 == 0 and (g * bs)^2 f32 temporaries within the cap; 0 if
    none. slab2 takes K1/K2 where g >= 2, as JAX takes its slab kernels."""
    best = 0
    for g in range(1, nb + 1):
        if nb % g == 0 and (g * bs) % 128 == 0 and (g * bs) ** 2 * 4 <= cap_bytes:
            best = g
    return best


def cols_routes(mode: str, n: int, block_size: int, dtype: torch.dtype) -> tuple[str, str]:
    """The (forward, backward) kernels an `attn_impl` mode runs, decided per
    call as `_make_cols_pallas` does:

        slab2, g >= 2                        K1          K2
        slab2 otherwise, hybrid2, hybrid2l   K6          K7 v2
        xla, hybrid, hybrid_slab             K6          K7 v1
        pallas, slab                         K6 (hilo)   K7 v1
        loop2                                K6          K7 v2

    K6 adds exact f32 bias terms (the einsum / loop contract) except in
    `pallas` and `slab` mode on bf16 ("K6 hilo"); K7 v2 runs on bf16 only
    (v1 for f32). The JAX package's slab kernels K8/K9 compute K6 hilo's and
    K7 v1's contracts on a block-diagonal (S, S) slab of g buckets, where the
    mask zeroes every cross-bucket term (`_fwd_slab_kernel`,
    `_bwd_slab_kernel`, which upcasts its operands to f32); the slab is a
    TPU device against a serial per-bucket MXU chain, so `slab` and
    `hybrid_slab` run K6/K7 for every block size. Off a TPU the JAX package
    runs `xla` for every mode: its einsum forward, which is `hybrid`'s, and
    autodiff's backward; `xla` runs `hybrid`'s kernels, whose K7 v1 is the
    gradient of that forward (f32-upcast operands), as the bf16-gradient
    contract asks.
    """
    if mode not in ATTN_IMPLS:
        raise NotImplementedError(f"attn_impl {mode!r}: not a mode of the JAX package; "
                                  f"modes: {ATTN_IMPLS}")
    bf16 = dtype == torch.bfloat16
    if mode == "slab2" and _slab128_g(n // block_size, block_size) >= 2:
        return "K1", "K2"
    fwd = "K6 hilo" if mode in ("pallas", "slab") and bf16 else "K6"
    v2 = bf16 and mode in ("slab2", "hybrid2", "hybrid2l", "loop2")
    return fwd, "K7 v2" if v2 else "K7 v1"


class _BucketRBFAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sq, sk, sv, block_size, mode):
        fwd, ctx.bwd = cols_routes(mode, sq.shape[-1], block_size, sq.dtype)
        ctx.save_for_backward(sq, sk, sv)
        ctx.block_size = block_size
        if fwd == "K1":
            return bucket_attn_fwd(sq, sk, sv, block_size)
        return cols_fwd(sq, sk, sv, block_size, hilo=fwd == "K6 hilo")

    @staticmethod
    def backward(ctx, g_denom, g_so):
        sq, sk, sv = ctx.saved_tensors
        g_denom, g_so = g_denom.to(torch.float32), g_so.to(torch.float32)
        if ctx.bwd == "K2":
            dq, dk, dv = bucket_attn_bwd(sq, sk, sv, g_denom, g_so, ctx.block_size)
        else:
            dq, dk, dv = cols_bwd(sq, sk, sv, g_denom, g_so, ctx.block_size,
                                  v2=ctx.bwd == "K7 v2")
        return dq, dk, dv, None, None


def bucket_rbf_attention_cols(sq: torch.Tensor, sk: torch.Tensor, sv: torch.Tensor,
                              block_size: int, mode: str = "slab2"):
    """Column-major per-bucket RBF attention; `mode` (attn_impl) picks the
    forward and backward kernels (`cols_routes`).

    Args: sq, sk (r, d, n); sv (r, dv, n), all bf16 or all f32.
    Returns: (denom (r, 1, n), so (r, dv, n)) float32.
    """
    return _BucketRBFAttention.apply(sq, sk, sv, block_size, mode)


# ---------------------------------------------------------------------------
# K10: row-major per-bucket RBF attention, f32 (the contract of
# `hept_tpu/ops/bucket_attn_pallas.py:bucket_rbf_attention_pallas`).


def _rows_logits(sq, sk):
    """(..., B, B) logits q.k - |q|^2/2 - |k|^2/2 and p = exp(min(logit, 0))."""
    q_sq = -0.5 * torch.sum(sq * sq, dim=-1, keepdim=True)
    k_sq = -0.5 * torch.sum(sk * sk, dim=-1, keepdim=True)
    logits = torch.einsum("...id,...jd->...ij", sq, sk) + q_sq + k_sq.transpose(-1, -2)
    return logits, torch.exp(torch.clamp(logits, max=0.0))


def rows_fwd_plain(sq, sk, sv):
    """Plain K10 forward, `bucket_rbf_attention_xla`'s einsums: sq, sk
    (..., B, D), sv (..., B, Dv) -> (denom (..., B, 1), so (..., B, Dv))."""
    _, p = _rows_logits(sq, sk)
    denom = torch.sum(p, dim=-1, keepdim=True) + DENOM_EPS
    return denom, torch.einsum("...ij,...jd->...id", p, sv)


def rows_bwd_plain(sq, sk, sv, g_denom, g_so):
    """Plain K10 backward, `_bwd_kernel`'s formula: dl = p (g_so.v + g_den)
    where the logit is < 0; dq = dl k - rowsum(dl) q, dk = dl^T q -
    colsum(dl) k, dv = p^T g_so."""
    logits, p = _rows_logits(sq, sk)
    gp = torch.einsum("...id,...jd->...ij", g_so, sv) + g_denom
    dl = torch.where(logits < 0.0, p * gp, torch.zeros_like(p))
    dq = torch.einsum("...ij,...jd->...id", dl, sk) - dl.sum(dim=-1, keepdim=True) * sq
    dk = torch.einsum("...ij,...id->...jd", dl, sq) - dl.sum(dim=-2)[..., None] * sk
    dv = torch.einsum("...ij,...id->...jd", p, g_so)
    return dq, dk, dv


# the most points a bucket of K10's tiled kernels holds (kFwdTileMaxBs,
# kTiledMaxBs in csrc/bucket_attn.cu)
_ROWS_TILED_MAX_BS = 100


def _tiled_bwd_smem(block_size: int, d: int, dv: int) -> int:
    """Shared bytes of the tiled backward's CTA (TiledDims::smem): dl, its
    transpose and pt [bp][sl], two staging buffers of q, k, g_so, v, g_den,
    four [bp] vectors; bp the bucket padded to a multiple of 20, sl >= bp at
    4 words modulo 32, rows of q / k (g_so / v) padded to 4 floats + 4."""
    bp = -(-block_size // 20) * 20
    sl = bp + (36 - bp % 32) % 32
    sq, sv = -(-d // 4) * 4 + 4, -(-dv // 4) * 4 + 4
    return (3 * bp * sl + 2 * bp * (2 * sq + 2 * sv + 1) + 4 * bp) * 4


def rows_fwd_route(block_size: int) -> str:
    """K10 forward's route, fixed by the bucket size before launch: "tiled"
    (K6 f32's register-tiled kernel on the row layout: two queries x four
    keys a thread) at block_size % 4 == 0 up to 100, the parity width's
    buckets; "first_cut" (the first-cut column kernel on rows) otherwise."""
    if block_size % 4 == 0 and block_size <= _ROWS_TILED_MAX_BS:
        return "tiled"
    return "first_cut"


def rows_bwd_route(block_size: int, d: int, dv: int) -> str:
    """K10 backward's route, fixed by bucket size and widths before launch:
    "tiled" (K7 v1's persistent one-pass kernel on the row layout) up to
    block_size 100 where its CTA's shared memory fits; "first_cut" (the
    two-half column kernel on rows) otherwise."""
    if block_size <= _ROWS_TILED_MAX_BS and _tiled_bwd_smem(block_size, d, dv) <= _SMEM_BYTES:
        return "tiled"
    return "first_cut"


def _check_rows(sq, sk, sv, *cotangents):
    b, d = sq.shape[-2:]
    dv = sv.shape[-1]
    if sk.shape != sq.shape or sv.shape != (*sq.shape[:-1], dv):
        raise ValueError(f"shapes sq {tuple(sq.shape)} sk {tuple(sk.shape)} sv {tuple(sv.shape)}")
    if (d, dv) not in SUPPORTED_DIMS:
        raise ValueError(f"(d, dv) = {(d, dv)} not compiled; have {SUPPORTED_DIMS}")
    if b * (d + dv + 2) * 4 > _SMEM_BYTES:
        raise ValueError(f"bucket size {b} unsupported")
    for t in (sq, sk, sv, *cotangents):
        if t.dtype != torch.float32 or not t.is_cuda or t.device != sq.device \
                or not t.is_contiguous():
            raise ValueError("K10 takes contiguous float32 CUDA tensors on one device")
    g = sq.numel() // (b * d)
    return g, b, d, dv


def rows_fwd_cuda(sq, sk, sv):
    """K10 forward on the card, on the route `rows_fwd_route` picks:
    (denom (..., B, 1), so (..., B, Dv)) f32."""
    g, b, d, dv = _check_rows(sq, sk, sv)
    denom = torch.empty((*sq.shape[:-1], 1), dtype=torch.float32, device=sq.device)
    so = torch.empty(sv.shape, dtype=torch.float32, device=sq.device)
    lib = cuda_lib.load("bucket_attn")
    fn = lib.hept_rows_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    err = fn(sq.data_ptr(), sk.data_ptr(), sv.data_ptr(), denom.data_ptr(), so.data_ptr(),
             d, dv, g * b, b, int(rows_fwd_route(b) == "tiled"), cuda_lib.stream_ptr(sq.device))
    cuda_lib.check(err, lib, "hept_bucket_attn_error_string", "rows_fwd")
    LAUNCHES["rows_fwd"] += 1
    return denom, so


def rows_bwd_cuda(sq, sk, sv, g_denom, g_so):
    """K10 backward on the card, on the route `rows_bwd_route` picks: (dq,
    dk, dv) f32."""
    g, b, d, dv = _check_rows(sq, sk, sv, g_denom, g_so)
    if g_denom.shape != (*sq.shape[:-1], 1) or g_so.shape != sv.shape:
        raise ValueError(f"cotangents {tuple(g_denom.shape)} {tuple(g_so.shape)}")
    outs = tuple(torch.empty_like(t) for t in (sq, sk, sv))
    lib = cuda_lib.load("bucket_attn")
    fn = lib.hept_rows_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    err = fn(sq.data_ptr(), sk.data_ptr(), sv.data_ptr(), g_so.data_ptr(), g_denom.data_ptr(),
             *(t.data_ptr() for t in outs), d, dv, g * b, b,
             int(rows_bwd_route(b, d, dv) == "tiled"), cuda_lib.stream_ptr(sq.device))
    cuda_lib.check(err, lib, "hept_bucket_attn_error_string", "rows_bwd")
    LAUNCHES["rows_bwd"] += 1
    return outs


def rows_fwd(sq, sk, sv):
    if use_kernel(sq):
        return rows_fwd_cuda(sq, sk, sv)
    return rows_fwd_plain(sq, sk, sv)


def rows_bwd(sq, sk, sv, g_denom, g_so):
    if use_kernel(sq):
        return rows_bwd_cuda(sq, sk, sv, g_denom.contiguous(), g_so.contiguous())
    return rows_bwd_plain(sq, sk, sv, g_denom, g_so)


class _BucketRBFAttentionRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sq, sk, sv):
        ctx.save_for_backward(sq, sk, sv)
        return rows_fwd(sq, sk, sv)

    @staticmethod
    def backward(ctx, g_denom, g_so):
        return rows_bwd(*ctx.saved_tensors, g_denom, g_so)


def bucket_rbf_attention_rows(sq: torch.Tensor, sk: torch.Tensor, sv: torch.Tensor):
    """Row-major per-bucket RBF attention (K10), float32 only as the JAX
    kernel (`bucket_rbf_attention_pallas`); any bucket size B (no padding).

    Args: sq, sk (..., B, D); sv (..., B, Dv), float32.
    Returns: (denom (..., B, 1), so (..., B, Dv)) float32.
    """
    if any(t.dtype != torch.float32 for t in (sq, sk, sv)):
        raise ValueError(f"K10 is float32 only, got {sq.dtype} {sk.dtype} {sv.dtype}")
    return _BucketRBFAttentionRows.apply(sq, sk, sv)
