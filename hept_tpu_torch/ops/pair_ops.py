"""Pair gather / anchor segment sum: the InfoNCE loss's kernels K3 and K4
(`csrc/pair_ops.cu`) and the ops built on them (port of
`hept_tpu/ops/pair_ops.py`).

Embeddings travel as (n, d) f32 rows and pair values as (E, d) rows. The
anchor index comes from the pack-time layout (`data/batching.py`):
anchor-sorted aligned 128-pair windows, in one block, or two (base and
augmentation) under the training loader's cache. K3 is a plain indexed copy
and K4 a CSR segment sum over the pairs in stable anchor order, so neither
needs the windows or a globally sorted index.

  gather_rows (K3):  out[e] = emb[idx[e]]     plain version: index_select
  segment_sum (K4):  out[i] = sum_{idx[e]=i} vals[e]   plain: index_add_

`pair_gather` (K3 forward, K4 backward), `anchor_segment_sum` (K4, K3),
`pair_l2rbf_sim` (the l2_rbf loss's similarity: K3, K4) and `partner_gather`
(a plain take forward, K4 backward: the cosine and l2_inverse losses' p1
side) are built on them.

K4 takes the CSR of its index (`anchor_csr`: the pairs in stable anchor
order and the row pointers). The loss builds it once for its anchor index
and hands it to the ops below, whose forward or backward runs K4; without
one, `segment_sum_cuda` builds its own. K4's plain version ignores it.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .dispatch import use_kernel

# launches of each kernel since the last reset (plain integer counters);
# "pair_gather_d1" / "pair_segment_sum_d1": those of K3's / K4's launches at
# d = 1 (also in "pair_gather" / "pair_segment_sum")
LAUNCHES = {"pair_gather": 0, "pair_gather_d1": 0, "pair_segment_sum": 0,
            "pair_segment_sum_d1": 0}
# CSRs built by `anchor_csr` since the last reset (PyTorch's sort, no kernel
# of csrc/)
CSR_BUILDS = {"anchor_csr": 0}


def gather_rows_plain(emb: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain K3: emb (n, d) f32, idx (E,) in [0, n) -> (E, d)."""
    return emb.index_select(0, idx.to(torch.int64))


def segment_sum_plain(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Plain K4: vals (E, d) f32, idx (E,) -> (n, d) sums by index."""
    out = torch.zeros((n, vals.shape[1]), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx.to(torch.int64), vals)


def anchor_csr(idx: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The CSR of the anchor index idx (E,): (order, rowptr), both int32,
    with the pairs of anchor i at order[rowptr[i]:rowptr[i + 1]] in stable
    order (a stable sort and searchsorted, on idx's device). An index outside
    [0, n) falls in no row."""
    if idx.shape[0] >= 2**31 or n >= 2**31:
        raise ValueError(f"anchor_csr: {idx.shape[0]} pairs, n={n}: int32 row pointers")
    if n < 2**16 - 1:
        # -1..n fit 16 bits: a radix sort of 16-bit keys takes half the passes
        # of 32-bit ones (indices outside [0, n) clamped, so they stay out of
        # every row)
        key = (idx.clamp(-1, n) - (2**15 - 1)).to(torch.int16)
        bounds = torch.arange(1 - 2**15, n + 2 - 2**15, dtype=torch.int16, device=idx.device)
    else:
        key = idx
        bounds = torch.arange(n + 1, dtype=idx.dtype, device=idx.device)
    sorted_key, order = torch.sort(key, stable=True)
    rowptr = torch.searchsorted(sorted_key, bounds, out_int32=True)
    CSR_BUILDS["anchor_csr"] += 1
    return order.to(torch.int32), rowptr


def _check(t: torch.Tensor, idx: torch.Tensor, what: str):
    if t.dim() != 2 or t.dtype != torch.float32 or not t.is_contiguous() or not t.is_cuda:
        raise ValueError(f"{what}: need a contiguous 2-D f32 CUDA tensor, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if idx.dim() != 1 or idx.dtype != torch.int32 or not idx.is_contiguous() \
            or idx.device != t.device:
        raise ValueError(f"{what}: index must be a contiguous int32 vector on {t.device}")


def gather_rows_cuda(emb: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K3 on the card: out[e, :] = emb[idx[e], :] (NaN where idx is out of range)."""
    _check(emb, idx, "gather_rows")
    n, d = emb.shape
    e = idx.shape[0]
    out = torch.empty((e, d), dtype=torch.float32, device=emb.device)
    lib = cuda_lib.load("pair_ops")
    fn = lib.hept_pair_gather
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_void_p]
    err = fn(emb.data_ptr(), idx.data_ptr(), out.data_ptr(), n, d, e,
             cuda_lib.stream_ptr(emb.device))
    cuda_lib.check(err, lib, "hept_pair_error_string", "pair_gather")
    LAUNCHES["pair_gather"] += 1
    LAUNCHES["pair_gather_d1"] += int(d == 1)
    return out


def segment_sum_cuda(vals: torch.Tensor, idx: torch.Tensor, n: int,
                     csr: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """K4 on the card: sums of vals (E, d) by the index idx (E,) in [0, n),
    over `csr` = anchor_csr(idx, n) (built here when not given)."""
    _check(vals, idx, "segment_sum")
    e, d = vals.shape
    if e != idx.shape[0]:
        raise ValueError(f"segment_sum: {e} values for {idx.shape[0]} indices")
    order, rowptr = anchor_csr(idx, n) if csr is None else csr
    for t, size, what in ((order, e, "order"), (rowptr, n + 1, "rowptr")):
        if t.shape != (size,) or t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != vals.device:
            raise ValueError(f"segment_sum: CSR {what} must be a contiguous ({size},) int32 "
                             f"vector on {vals.device}, got {tuple(t.shape)} {t.dtype}")
    out = torch.empty((n, d), dtype=torch.float32, device=vals.device)
    lib = cuda_lib.load("pair_ops")
    fn = lib.hept_pair_segment_sum
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    err = fn(vals.data_ptr(), order.data_ptr(), rowptr.data_ptr(), out.data_ptr(), n, d,
             cuda_lib.stream_ptr(vals.device))
    cuda_lib.check(err, lib, "hept_pair_error_string", "pair_segment_sum")
    LAUNCHES["pair_segment_sum"] += 1
    LAUNCHES["pair_segment_sum_d1"] += int(d == 1)
    return out


def gather_rows(emb: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if use_kernel(emb):
        return gather_rows_cuda(emb.contiguous(), idx)
    return gather_rows_plain(emb, idx)


def segment_sum(vals: torch.Tensor, idx: torch.Tensor, n: int, csr=None) -> torch.Tensor:
    if use_kernel(vals):
        return segment_sum_cuda(vals.contiguous(), idx, n, csr)
    return segment_sum_plain(vals, idx, n)


class _PairGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, idx, csr):
        ctx.save_for_backward(idx)
        ctx.n, ctx.csr = emb.shape[0], csr
        return gather_rows(emb, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return segment_sum(g, idx, ctx.n, ctx.csr), None, None


def pair_gather(emb: torch.Tensor, idx: torch.Tensor, csr=None) -> torch.Tensor:
    """emb (n, d) gathered at the anchor idx (E,) -> (E, d); the backward is
    the K4 segment sum (over `csr`, the index's `anchor_csr`, when given)."""
    return _PairGather.apply(emb, idx, csr)


class _AnchorSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, idx, n, csr):
        ctx.save_for_backward(idx)
        return segment_sum(vals[:, None], idx, n, csr)[:, 0]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return gather_rows(g[:, None], idx)[:, 0], None, None, None


def anchor_segment_sum(vals: torch.Tensor, idx: torch.Tensor, n: int, csr=None) -> torch.Tensor:
    """Sum vals (E,) into (n,) segments keyed by the anchor idx (over `csr`
    when given); the backward is the K3 gather."""
    return _AnchorSegmentSum.apply(vals, idx, n, csr)


class _PartnerGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, p1, p0, rev, mask, csr):
        ctx.save_for_backward(p0, rev, mask)
        ctx.n, ctx.csr = emb.shape[0], csr
        return emb.index_select(0, p1.to(torch.int64))

    @staticmethod
    def backward(ctx, g):
        p0, rev, mask = ctx.saved_tensors
        # d_emb[i] = sum_{p1[e] = i} g[e] = sum_{p0[e'] = i} g[rev[e']]: the
        # reversed cotangents summed at the anchor (pads masked: rev[pad]
        # aliases a real pair)
        g_rev = torch.where(mask[:, None], g.index_select(0, rev.to(torch.int64)),
                            torch.zeros((), dtype=g.dtype, device=g.device))
        return (segment_sum(g_rev, p0, ctx.n, ctx.csr),) + (None,) * 5


def partner_gather(emb, p1, p0, rev, mask, csr=None) -> torch.Tensor:
    """emb (n, d) gathered at the partner index p1 (E,) -> (E, d). The
    forward is a plain row take (p1 is not windowed). The backward's sum by
    p1 is rewritten with the pack-time reverse-pair index as a sum by the
    anchor p0 of the cotangent taken at rev, pads masked: the K4 segment sum
    (over `csr`, p0's `anchor_csr`, when given). Requires the reversal-
    closed windowed layout, and a zero cotangent on the pad pairs (the
    loss's case)."""
    return _PartnerGather.apply(emb, p1, p0, rev, mask, csr)


class _PairL2RBFSim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, p0, p1, rev, mask, sigma, csr):
        e0 = gather_rows(emb, p0)
        e1 = emb[p1]
        diff = e0 - e1
        d = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
        sim = torch.exp(-d / (2 * sigma**2))
        ctx.save_for_backward(diff, d, sim, p0, rev, mask)
        ctx.sigma, ctx.csr = sigma, csr
        ctx.n = emb.shape[0]
        return sim

    @staticmethod
    def backward(ctx, c):
        diff, d, sim, p0, rev, mask = ctx.saved_tensors
        sigma = ctx.sigma
        # v_e = d sim_e / d e0 = -sim / (2 sigma^2 d) * (e0 - e1). The partner
        # side's contribution at row p1[e] is the reversed pair's anchor-side
        # term, so the whole backward is ONE anchor-side segment sum of
        # (c_e + c_rev[e]) * v_e (pads masked: rev[pad] aliases a real pair).
        g = (-sim / (2 * sigma**2 * d))[:, None] * diff
        c2 = torch.where(mask, c + c[rev], torch.zeros_like(c))
        return (segment_sum(c2[:, None] * g, p0, ctx.n, ctx.csr),) + (None,) * 6


def pair_l2rbf_sim(emb, p0, p1, rev, mask, sigma: float = 0.75, csr=None) -> torch.Tensor:
    """Per-pair RBF similarity exp(-|e0 - e1| / (2 sigma^2)) with the
    symmetry-folded backward (over `csr`, p0's `anchor_csr`, when given).
    Requires the pack-time reversal-closed windowed layout; the folded
    backward equals the unfolded gradient there."""
    return _PairL2RBFSim.apply(emb, p0, p1, rev, mask, sigma, csr)
