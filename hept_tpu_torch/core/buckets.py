"""Bucket transport (port of the parts of `hept_tpu/core/buckets.py` the
ported profiles run).

`permute_gather` and `permute_gather_rows` apply KNOWN per-round permutations
(from `ops.bucket_attn.static_bucket_plan`) with index gathers, and their
backward gathers the cotangent by the inverse permutation; `gather_copies`
moves permuted copies of a column payload as row gathers (gather_sort). `sort_carry` and
`unsort_carry` are the dynamic-key transport on top of them: a stable
argsort of each key row, then the same gathers (`sort_carry_rows` moves row
payloads, for the row-major `hept_attention_core`). The row gather,
forward and backward, is kernel K5 (`ops/row_gather.py`,
`csrc/row_gather.cu`) on CUDA tensors. `pack=True` keeps
the JAX package's transport rounding: values (and, in the backward,
cotangents) pass through bfloat16. The JAX side moved them as bf16 pairs
bit-packed into u32 words, which was a TPU transport trick; only the rounding
is carried over. `pack="fp8"` (row payloads only: the [num | denom] unsort)
rounds every column but the last to float8_e4m3fn and the last to bfloat16,
JAX's e4m3-quad encoding (`hept_tpu/core/buckets.py:_cols_to_u32`); the
rounded values ride as bfloat16 rows, which hold every e4m3fn value and NaN
exactly.
"""

from __future__ import annotations

import torch

from ..ops.row_gather import row_gather


def bit_shift(base: torch.Tensor, shift_idx: torch.Tensor) -> torch.Tensor:
    """Pack `shift_idx` into the bits above `base`, per row of (R, n):
    `num_bits = ceil(log2(max(base) + 1))`, then `(shift_idx << num_bits) |
    base` (the AND-code packing of the replicate padding mode)."""
    base = base.to(torch.int32)
    shift_idx = shift_idx.to(torch.int32)
    max_base = base.amax(dim=1, keepdim=True)
    num_bits = torch.ceil(torch.log2(max_base.to(torch.float32) + 1.0)).to(torch.int32)
    return torch.bitwise_left_shift(shift_idx, num_bits) | base


def invert_permutation(perm: torch.Tensor) -> torch.Tensor:
    """`inv[..., perm[..., i]] = i` along the last axis."""
    ar = torch.arange(perm.shape[-1], dtype=perm.dtype, device=perm.device)
    return torch.empty_like(perm).scatter_(-1, perm, ar.expand_as(perm).contiguous())


def gather_rows(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Permute the rows of per-(hash, head) feature arrays: x (h, n, d)
    (shared across the c hash rounds) or (c, h, n, d), perm (c, h, n) row
    indices into the n axis -> (c, h, n, d). Plain indexing of the flattened
    rows (the baseline attentions' gather; JAX runs it as an XLA gather)."""
    c, h, n = perm.shape
    d = x.shape[-1]
    if x.dim() == 3:
        flat = x.reshape(h * n, d)
        offs = (torch.arange(h, dtype=perm.dtype, device=perm.device) * n)[None, :, None]
    else:
        flat = x.reshape(c * h * n, d)
        offs = (torch.arange(c * h, dtype=perm.dtype, device=perm.device) * n).reshape(c, h, 1)
    return flat[(perm + offs).reshape(-1)].reshape(c, h, n, d)


# |x| above this rounds past e4m3fn's largest finite value (448; 464 is the
# tie between 448 and the NaN encoding above it, and rounds to even, 448)
E4M3_OVERFLOW = 464.0


def e4m3_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8_e4m3fn and back to float32, with JAX's overflow:
    |x| > 464 and +-inf give NaN, as `astype(jnp.float8_e4m3fn)` does. The
    torch cast saturates them to +-448 instead, so the NaN is put back here;
    inside the range the two roundings agree bit for bit."""
    y = x.to(torch.float8_e4m3fn).to(torch.float32)
    return y.masked_fill_(x.abs() > E4M3_OVERFLOW, float("nan"))


def pack_mode(pack):
    """A transport flag as `_transport` takes it: False, True or "fp8"."""
    return pack if pack == "fp8" else bool(pack)


def _transport(x: torch.Tensor, pack) -> torch.Tensor:
    if pack == "fp8":
        # JAX's [num | denom] encoding: e4m3 for all but the last column,
        # bf16 for the last (e4m3 would flush the 1e-20 denominator floor)
        x = x.to(torch.float32)
        y = e4m3_round(x)
        y[..., -1] = x[..., -1]
        return y.to(torch.bfloat16)
    return x.to(torch.bfloat16) if pack else x.to(torch.float32)


def _gather_cols(payload: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """payload (n_ev, d, ne), src (c, n_ev, ne) -> (c, n_ev, d, ne) with
    out[r, b, :, s] = payload[b, :, src[r, b, s]]."""
    c, n_ev, ne = src.shape
    d = payload.shape[1]
    idx = src[:, :, None, :].expand(c, n_ev, d, ne)
    return torch.gather(payload[None].expand(c, n_ev, d, ne), 3, idx)


class _PermuteGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, payload, src, inv, pack, out_bf16):
        ctx.save_for_backward(inv)
        ctx.pack = pack
        ctx.in_dtype = payload.dtype
        out = _gather_cols(_transport(payload, pack), src)
        return out if (pack and out_bf16) else out.to(torch.float32)

    @staticmethod
    def backward(ctx, ct):
        (inv,) = ctx.saved_tensors
        # out[r,b,:,s] = payload[b,:,src[r,b,s]] with src a permutation per
        # (r, b): d payload[b,:,i] = sum_r ct[r,b,:,inv[r,b,i]]
        c, n_ev, d, ne = ct.shape
        g = torch.gather(_transport(ct, ctx.pack), 3,
                         inv[:, :, None, :].expand(c, n_ev, d, ne))
        return g.to(torch.float32).sum(dim=0).to(ctx.in_dtype), None, None, None, None


def permute_gather(payload: torch.Tensor, src: torch.Tensor, inv: torch.Tensor,
                   pack: bool = False, out_bf16: bool = False) -> torch.Tensor:
    """Apply known per-round permutations to a column payload.

    Args:
      payload: (n_ev, d, ne) column payload.
      src: (c, n_ev, ne) int64 source slot of each sorted position.
      inv: (c, n_ev, ne) inverse permutations (used by the backward).
      pack: round values (and cotangents) through bfloat16.
      out_bf16: with pack, return bfloat16 instead of float32.
    Returns: (c, n_ev, d, ne) with payload[b, :, src[r, b, s]] at [r, b, :, s].
    """
    return _PermuteGather.apply(payload, src, inv, bool(pack), bool(out_bf16))


class _PermuteGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, idx, inv, pack):
        ctx.save_for_backward(inv)
        ctx.pack = pack
        ctx.s = rows.shape[0]
        return row_gather(_transport(rows, pack), idx).to(torch.float32)

    @staticmethod
    def backward(ctx, ct):
        (inv,) = ctx.saved_tensors
        # out[p] = rows[idx[p]] with idx a permutation: d rows[s] = ct[inv[s]];
        # broadcast sources (S < R) sum their R/S copies' cotangents
        g = row_gather(_transport(ct, ctx.pack), inv).to(torch.float32)
        if g.shape[0] != ctx.s:
            g = g.reshape(-1, ctx.s, *g.shape[1:]).sum(dim=0)
        return g, None, None, None


def permute_gather_rows(rows: torch.Tensor, idx: torch.Tensor, inv: torch.Tensor,
                        pack: bool = False) -> torch.Tensor:
    """Apply known per-batch-row permutations to a row-major payload.

    Args:
      rows: (S, ne, W) row payload; S may divide R (broadcast source).
      idx: (R, ne) -- out[r, p, :] = rows[r % S, idx[r, p], :].
      inv: (R, ne) idx's inverse permutation (for the backward).
      pack: round values (and cotangents) through bfloat16; "fp8": the
        last of the W columns through bfloat16, the others through e4m3.
    Returns: (R, ne, W) float32.
    """
    # an index broadcast over heads from one round (a hash shard's) reshapes
    # to a stride-0 view; K5 takes contiguous indices
    return _PermuteGatherRows.apply(rows, idx.contiguous(), inv.contiguous(), pack_mode(pack))


class _GatherCopies(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cols, src, inv, pack, out_bf16):
        ctx.save_for_backward(inv)
        ctx.pack = pack
        ctx.in_dtype = cols.dtype
        rows = row_gather(_transport(cols, pack).t().contiguous()[None], src)  # (R, n, d)
        out = rows.transpose(1, 2).contiguous()
        return out if (pack and out_bf16) else out.to(torch.float32)

    @staticmethod
    def backward(ctx, ct):
        (inv,) = ctx.saved_tensors
        rows = row_gather(_transport(ct, ctx.pack).transpose(1, 2).contiguous(), inv)
        # the copies' cotangents summed in the column layout, as
        # permute_gather's backward sums them: a sum's order follows the
        # layout, on the CPU and on the card
        g = rows.to(torch.float32).transpose(1, 2).contiguous().sum(dim=0)
        return g.to(ctx.in_dtype), None, None, None, None


def gather_copies(cols: torch.Tensor, src: torch.Tensor, inv: torch.Tensor,
                  pack: bool = False, out_bf16: bool = False) -> torch.Tensor:
    """Permuted copies of one column payload, moved as rows: the payload's
    (n, d) rows are gathered once per permutation (one broadcast-source row
    gather, kernel K5 on CUDA tensors) and laid out as columns again; the
    backward is a row gather of the cotangents by `inv`, summed over the
    copies. The same values and gradient, bit for bit, as the column gather
    `permute_gather(cols[None], src[:, None], inv[:, None])`.

    Args:
      cols: (d, n) column payload.
      src: (R, n) int64 permutations: copy r's slot s holds column src[r, s].
      inv: (R, n) their inverses.
      pack: round values (and cotangents) through bfloat16.
      out_bf16: with pack, return bfloat16 instead of float32.
    Returns: (R, d, n).
    """
    return _GatherCopies.apply(cols, src.contiguous(), inv.contiguous(), bool(pack),
                               bool(out_bf16))


def sort_carry(keys: torch.Tensor | None, payload: torch.Tensor,
               src: torch.Tensor | None = None, pack: bool = False, out_bf16: bool = False):
    """Sort column payloads by per-(round, head) keys (the column layout of
    JAX's `grouped_sort_carry`, one group per call).

    Args:
      keys: (c, h, n) sort keys; each row is argsorted stably. Ignored when
        `src` is given.
      payload: (h, d, n) (broadcast over rounds), (d, n) (broadcast over
        rounds and heads) or (c, h, d, n) columns.
      src: optional (c, h, n) int64 permutations to apply instead of sorting.
      pack: round values (and, in the backward, cotangents) through bfloat16.
      out_bf16: with pack, return bfloat16 instead of float32.
    Returns: (sorted (c, h, d, n), src (c, h, n)): sorted slot s holds
      column src[..., s]. The backward gathers the cotangent by the
      inverse permutation and sums it over the broadcast axes.

    JAX sorts unstably and carries the payload through one sort call for
    several groups (the TPU pays per call); the port sorts the keys stably
    and gathers, so rows with equal keys keep their order.
    """
    if src is None:
        src = torch.argsort(keys, dim=-1, stable=True)
    c, h, n = src.shape
    kw = dict(pack=pack, out_bf16=out_bf16)
    if payload.dim() == 4:  # one source row per (round, head)
        flat = payload.reshape(c * h, -1, n)
        out = permute_gather(flat, src.reshape(1, c * h, n),
                             invert_permutation(src).reshape(1, c * h, n), **kw)
    elif payload.dim() == 3:  # (h, d, n): one source row per head
        out = permute_gather(payload, src, invert_permutation(src), **kw)
    else:  # (d, n): one source row
        out = permute_gather(payload[None], src.reshape(c * h, 1, n),
                             invert_permutation(src).reshape(c * h, 1, n), **kw)
    return out.reshape(c, h, -1, n), src


def sort_carry_rows(keys: torch.Tensor | None, payload: torch.Tensor, pack: bool = False,
                    src: torch.Tensor | None = None):
    """Sort ROW payloads by per-(round, head) keys (JAX's `sort_carry`).

    Args:
      keys: (c, h, n) sort keys; each row is argsorted stably. Ignored when
        `src` is given.
      payload: (h, n, d) (broadcast over rounds) or (c, h, n, d) rows.
      pack: round values (and, in the backward, cotangents) through bfloat16.
      src: optional (c, h, n) int64 permutations to apply instead of sorting.
    Returns: (sorted (c, h, n, d) float32, src (c, h, n)): sorted slot s
      holds row src[..., s]. One row gather (kernel K5 on CUDA tensors):
      output row r = round * h + head reads source r % S, S = h or c * h.
      The backward gathers the cotangent by the inverse permutation and sums
      the rounds' copies of a broadcast payload.
    """
    if src is None:
        src = torch.argsort(keys, dim=-1, stable=True)
    c, h, n = src.shape
    d = payload.shape[-1]
    src2 = src.reshape(c * h, n)
    out = permute_gather_rows(payload.reshape(-1, n, d), src2, invert_permutation(src2),
                              pack=pack)
    return out.reshape(c, h, n, d), src


def unsort_carry(src: torch.Tensor, rows: torch.Tensor, pack: bool = False,
                 inv: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse of `sort_carry` for ROW payloads (JAX's `unsort_carry`).

    Args:
      src: (c, h, n) permutations of the sort (sorted slot s holds row src[s]).
      rows: (c, h, n, w) rows in sorted order.
      pack: round values (and cotangents) through bfloat16 (or "fp8", see
        `permute_gather_rows`).
      inv: optional (c, h, n) inverse of `src`, when the caller has it.
    Returns: (c, h, n, w) float32 rows in the original order: row j is
      sorted slot inv[j]. One row gather (kernel K5 on CUDA tensors); the
      backward gathers by `src`.
    """
    c, h, n, w = rows.shape
    src2 = src.reshape(c * h, n)
    inv2 = invert_permutation(src2) if inv is None else inv.reshape(c * h, n)
    out = permute_gather_rows(rows.reshape(c * h, n, w), inv2, src2, pack=pack)
    return out.reshape(c, h, n, w)
