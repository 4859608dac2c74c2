"""HEPT bucket attention (port of the ported profiles' parts of
`hept_tpu/ops/bucket_attn.py`).

Per bucket of `block_size` sorted points the core computes the unnormalised
RBF kernel exp(min(q.k - |q|^2/2 - |k|^2/2, 0)), its row sums (denominator)
and the value sums (numerator), then OR-combines the rounds as
sum num / sum denom. The paths:
- the static plan (hept_acc, hept_fast, hept_turbo): keys are hashed once
  per step (`static_hash`), one sort builds every round's permutation
  (`static_bucket_plan`), and each layer gathers its x columns by the plan,
  projects them after the gather, runs the bucket kernel and unsorts
  [num|denom] with a row gather (`hept_attention_core_xcols`); the plan's
  family: the "coords" hash and an AND-composed second direction
  (`static_and_bins`), the residual stream in round 0's order
  (canon_residual) or in a (cell, Morton) order with transport groups;
- dynamic keys after the sort (qkv_post_sort): each layer hashes [x |
  coords] once per round for every head (share_heads) or per (round, head)
  with the hashes composed through the projections, sorts it (for q and k
  apart, or once by the k keys under shared_sort), then the same
  projections, kernel and unsort (`hept_attention_core_xcols` without a
  plan; the share_heads pieces are what the bucket-axis SP,
  `parallel/bp.py`, splits over ranks); `gather_sort` moves the sorted
  copies by row gathers, with the sort-carry's bits;
- dynamic keys (the reference-parity `hept` profile): each layer hashes its
  own projected q and k per head, sorts them by their own keys and unsorts
  by the q permutation (`hept_attention_core_cols`);
The bf16 modes (sort_pack, unsort_pack, kernel_bf16, kernel_center), and
the fp8 unsort (unsort_pack "fp8"), run on every path that JAX runs them on.
- the same pipeline on row-major (h, n, d) operands, the one the JAX package
  exports and shards over heads (`hept_attention_core`, kernel K10).
The column kernel is chosen by `attn_impl` (`bucket_attn_cuda`).
"""

from __future__ import annotations

import torch

from ..core.buckets import (
    gather_copies,
    invert_permutation,
    permute_gather,
    permute_gather_rows,
    sort_carry,
    sort_carry_rows,
    unsort_carry,
)
from ..core.hashing import lsh_mapping
from ..parallel.collectives import all_reduce_fwd
from .bucket_attn_cuda import (
    DENOM_EPS,
    bucket_rbf_attention_cols,
    bucket_rbf_attention_rows,
    rows_fwd_plain,
)

__all__ = [
    "DENOM_EPS", "stable_ratio", "bucket_rbf_attention_cols", "bucket_rbf_attention_rows",
    "dense_rbf_attention", "static_hash", "static_bucket_plan", "hept_attention_core",
    "hept_attention_core_xcols", "hept_attention_core_cols", "share_heads_keys",
    "post_sort_keys", "argsort_keys", "sort_payload", "project_attend", "combine_rounds",
    "unsort_heads", "unsort_combine",
]

# sort key of rows forced into trailing buckets
_BIG_KEY = 3.0e38


class _StableRatio(torch.autograd.Function):
    @staticmethod
    def forward(ctx, num, den):
        o = num / den
        ctx.save_for_backward(o, den)
        return o

    @staticmethod
    def backward(ctx, g):
        o, den = ctx.saved_tensors
        inv = 1.0 / den
        d_num = g * inv
        # reduce over the broadcast axes (den has size 1 where num does not)
        go = g * o
        axes = tuple(i for i, (a, b) in enumerate(zip(go.shape, den.shape)) if b == 1 and a != 1)
        d_den = -torch.sum(go, dim=axes, keepdim=True) * inv if axes else -go * inv
        return d_num, d_den


def stable_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den with a denominator-square-free backward.

    Plain autograd of num/den computes -g*num/den**2; with DENOM_EPS = 1e-20
    a row whose probabilities all underflow has den**2 underflow to 0 and
    the gradient becomes NaN. With o = num/den: d num = g/den and
    d den = -sum(g*o)/den. `den` broadcasts to num with size 1 on exactly
    the axes it reduces over.
    """
    return _StableRatio.apply(num, den)


def static_hash(x0_cols: torch.Tensor, coords_cols: torch.Tensor, alpha: torch.Tensor,
                scale: float, variant: str = "x0", and_bins: int = 0) -> torch.Tensor:
    """Layer-invariant bucket hashes: one hash per step in [x0|coords] space.

    Args:
      x0_cols: (d_model, n) encoder-output columns.
      coords_cols: (cd, n).
      alpha: (1 or 2, d_model + cd, c) E2LSH directions (two rows when
        and_bins > 0: the primary and the secondary direction).
      scale: the coords part's weight.
      variant: "x0" hashes x0 standardised per point (over its d_model
        features) plus the coords scaled by `scale`; "coords" hashes the
        scaled coords alone.
      and_bins: > 0: a second direction, quantised into this many bins over
        its range, is AND-composed above the primary hash: key = h1 + bin *
        1.001 * span(h1) (strictly above the span, so that a bin's top key
        sorts below the next bin's bottom one).
    Returns: (c, n) hash values, detached.
    """
    with torch.no_grad():
        d_model = x0_cols.shape[0]
        xs = None
        if variant == "x0":
            mu = x0_cols.mean(dim=0, keepdim=True)
            sd = torch.sqrt(((x0_cols - mu) ** 2).mean(dim=0, keepdim=True) + 1e-6)
            xs = (x0_cols - mu) / sd

        def one(a):  # (d_model + cd, c) -> (c, n)
            h = torch.einsum("rc,rn->cn", scale * a[d_model:], coords_cols)
            if xs is not None:
                h = h + torch.einsum("ec,en->cn", a[:d_model], xs)
            return h

        hashed = one(alpha[0])
        if and_bins:
            h2 = one(alpha[1])
            lo = h2.amin(dim=1, keepdim=True)
            hi = h2.amax(dim=1, keepdim=True)
            q2 = torch.clamp(torch.floor((h2 - lo) / (hi - lo + 1e-12) * and_bins),
                             0, and_bins - 1)
            span = 1.001 * (hashed.amax(dim=1, keepdim=True) - hashed.amin(dim=1, keepdim=True))
            hashed = hashed + q2 * span
        return hashed


def _quantise_rank(a: torch.Tensor, bits: int) -> torch.Tensor:
    """(n_ev, ne) -> integer ranks in [0, 2^bits - 1] over each row's range
    of finite values below 1e30 (an invalid row's coordinate sentinel)."""
    ok = torch.isfinite(a) & (a.abs() < 1e30)
    lo = torch.where(ok, a, float("inf")).amin(dim=1, keepdim=True)
    hi = torch.where(ok, a, float("-inf")).amax(dim=1, keepdim=True)
    q = torch.floor((a - lo) / (hi - lo + 1e-9) * (2 ** bits - 1))
    return torch.clamp(q, 0, 2 ** bits - 1).to(torch.int64)


def morton_order(cell: torch.Tensor, eta: torch.Tensor, phi: torch.Tensor, bits: int = 10):
    """The transport groups' storage order sigma of each event row: sorted
    by (AND cell, Morton code of the 10-bit ranks of (eta, phi)), ties by
    position (JAX's sort is unstable there). cell, eta, phi: (n_ev, ne).
    Returns (src0, inv0), each (n_ev, ne) int64."""
    qe, qp = _quantise_rank(eta, bits), _quantise_rank(phi, bits)
    mort = torch.zeros_like(qe)
    for i in range(bits):
        mort = mort | (((qe >> i) & 1) << (2 * i + 1))
        mort = mort | (((qp >> i) & 1) << (2 * i))
    by_mort = torch.argsort(mort, dim=-1, stable=True)
    by_cell = torch.argsort(torch.gather(cell, 1, by_mort), dim=-1, stable=True)
    src0 = torch.gather(by_mort, 1, by_cell)
    return src0, invert_permutation(src0)


def static_bucket_plan(hashed: torch.Tensor, codes0: torch.Tensor,
                       invalid: torch.Tensor | None, coords_cols: torch.Tensor,
                       sort_events: int = 1, sort_pack: bool = False,
                       coords_f32: bool = False, canonical: bool = False,
                       group_size: int = 1):
    """The once-per-step bucket plan of the static-keys mode.

    key = hash + code * span(hash) per round; invalid rows key to +BIG so
    they fill trailing buckets. One sort gives every round's permutation;
    each layer then reorders its x columns with `permute_gather` and reuses
    the sorted coords.

    Args:
      hashed: (c, n) hash values (`static_hash`).
      codes0: (n,) or (c, n) AND codes.
      invalid: optional (n,) bool.
      coords_cols: (cd, n).
      sort_events: stacked flat batching: the n points are this many
        equal-size events, each sorted as its own row (JAX's `sort_events`;
        the span is still taken over all n).
      sort_pack: round the sorted coords through bf16 (returned as bf16)
        unless `coords_f32`.
      coords_f32: carry the sorted coords exactly (kernel_center).
      canonical: canon_residual: also the maps relative to round 0's order
        (the canonical order the residual stream rides in): f[r] = inv_0 o
        src_r takes round r's sorted slot to its canonical position (f[0]
        the identity) and finv[r] = inv_r o src_0 is its inverse.
      group_size: transport groups (g > 1, not with `canonical`): the
        storage order becomes sigma (`morton_order` of round 0's AND cell
        and (eta, phi)); groups are g consecutive points of sigma, each
        round sorts the groups by their smallest member key, and every
        permutation is relative to sigma.
    Returns: (src, inv, scoords): (c, n_ev, ne) int64 permutations within
      each event row (sorted slot s holds row src[s]; row j sits at slot
      inv[j]) and (c, n_ev, cd, ne) sorted coords, ne = n / sort_events;
      canonical: (src, inv, scoords, f, finv); groups: (src, inv, scoords,
      gsrc, ginv, src0, inv0) with src / inv the per-point expansions
      gsrc * g + r of the (c, n_ev, ne / g) group permutations gsrc / ginv,
      and (1, n_ev, ne) sigma's entry map src0 and its inverse inv0 (JAX's
      tuples, `hept_tpu/ops/bucket_attn.py:370-549`).

    Ties occur only between rows with identical payloads (replication pads
    copy a real row exactly; inert pads share +BIG), so the sorted coords do
    not depend on how ties break; sigma and the group keys can tie between
    distinct points. The JAX package sorts unstably; these sorts are stable.
    """
    with torch.no_grad():
        c, n = hashed.shape
        n_ev = sort_events
        ne = n // n_ev
        hash_shift = hashed.amax(dim=1, keepdim=True) - hashed.amin(dim=1, keepdim=True)
        codes_s = codes0.to(torch.float32)
        if codes_s.dim() == 1:
            codes_s = codes_s[None]
        key = hashed + codes_s * hash_shift
        if invalid is not None:
            key = torch.where(invalid[None, :], torch.full_like(key, _BIG_KEY), key)
        pack = sort_pack and not coords_f32
        coords = coords_cols.to(torch.bfloat16) if pack else coords_cols.to(torch.float32)
        rows = coords.reshape(-1, n_ev, ne).permute(1, 0, 2)  # (n_ev, cd, ne)
        cd = rows.shape[1]

        def sort_coords(perm):  # (c, n_ev, ne) -> (c, n_ev, cd, ne)
            return torch.gather(rows[None].expand(c, n_ev, cd, ne), 3,
                                perm[:, :, None, :].expand(c, n_ev, cd, ne)).contiguous()

        if group_size > 1:
            if canonical:
                raise ValueError("transport groups have their own storage order (sigma)")
            g = group_size
            if ne % g:
                raise ValueError(f"ne={ne} is not a multiple of group_size={g}")
            cell = codes_s[0].reshape(n_ev, ne)
            if invalid is not None:
                cell = torch.where(invalid.reshape(n_ev, ne), _BIG_KEY, cell)
            f32 = coords_cols.to(torch.float32)
            src0, inv0 = morton_order(cell, f32[0].reshape(n_ev, ne), f32[1].reshape(n_ev, ne))
            key3 = key.reshape(c, n_ev, ne)
            key_s = torch.gather(key3, 2, src0[None].expand(c, n_ev, ne))
            gkey = key_s.reshape(c, n_ev, ne // g, g).amin(dim=-1)
            gsrc, ginv = argsort_keys(gkey)  # (c, n_ev, ng)
            off = torch.arange(g, device=gsrc.device)
            src = (gsrc[..., None] * g + off).reshape(c, n_ev, ne)
            inv = (ginv[..., None] * g + off).reshape(c, n_ev, ne)
            rows = torch.gather(rows, 2, src0[:, None, :].expand(n_ev, cd, ne))  # sigma order
            return src, inv, sort_coords(src), gsrc, ginv, src0[None], inv0[None]
        src = torch.argsort(key.reshape(c, n_ev, ne), dim=-1, stable=True)  # (c, n_ev, ne)
        inv = torch.argsort(src, dim=-1)
        scoords = sort_coords(src)
        if not canonical:
            return src, inv, scoords
        f = torch.gather(inv[:1].expand(c, n_ev, ne), 2, src)
        finv = torch.gather(inv, 2, src[:1].expand(c, n_ev, ne))
        return src, inv, scoords, f, finv


def share_heads_keys(x_cols: torch.Tensor, coords_cols: torch.Tensor, sqrt_w: torch.Tensor,
                     alpha: torch.Tensor, codes: torch.Tensor,
                     invalid: torch.Tensor | None) -> torch.Tensor:
    """The dynamic-key share_heads sort keys: one E2LSH key row per OR round
    in [x | coords] space, shared by every head.

    hash = a1 . x + (mean_h(sqrt_w) * a2) . coords with alpha = [a1; a2];
    key = hash + codes[:, 0] * span(hash) per round (head 0's AND codes);
    invalid rows key to +BIG. Detached.

    Args: x_cols (d_model, n) and coords_cols (cd, n), invalid rows zeroed;
      sqrt_w (h, cd); alpha (1, d_model + cd, c); codes (c, h, n);
      invalid optional (n,) bool.
    Returns: (c, n) float32 keys.
    """
    with torch.no_grad():
        d_model = x_cols.shape[0]
        a1, a2 = alpha[0, :d_model, :], alpha[0, d_model:, :]
        gamma = sqrt_w.mean(dim=0)[:, None] * a2  # (cd, c)
        hashed = (torch.einsum("ec,en->cn", a1, x_cols)
                  + torch.einsum("rc,rn->cn", gamma, coords_cols))
        hash_shift = hashed.amax(dim=1, keepdim=True) - hashed.amin(dim=1, keepdim=True)
        key = hashed + codes[:, 0].to(torch.float32) * hash_shift
        if invalid is not None:
            key = torch.where(invalid[None, :], torch.full_like(key, _BIG_KEY), key)
        return key


def post_sort_keys(x_cols: torch.Tensor, coords_cols: torch.Tensor, wq: torch.Tensor,
                   wk: torch.Tensor, sqrt_w: torch.Tensor, alpha: torch.Tensor,
                   codes: torch.Tensor, invalid: torch.Tensor | None):
    """The per-head dynamic keys of the post-sort path without share_heads:
    the E2LSH hashes of q_hat and k_hat composed through the bias-free
    projections, hash_q = (wq a1) . x + (sqrt_w * a2) . coords with alpha =
    [a1; a2] per head, and the same for k; the span is taken over q and k
    per (round, head); key = hash + code * span, invalid rows to +BIG.
    Detached.

    Args: x_cols (d_model, n) and coords_cols (cd, n), invalid rows zeroed;
      wq, wk (h, d_model, d); sqrt_w (h, cd); alpha (h, d + cd, c); codes
      (c, h, n); invalid optional (n,) bool.
    Returns: (q_key, k_key), each (c, h, n) float32.
    """
    with torch.no_grad():
        d = wq.shape[-1]
        a1, a2 = alpha[:, :d, :], alpha[:, d:, :]
        beta_q = torch.einsum("hed,hdc->hec", wq, a1)  # (h, d_model, c)
        beta_k = torch.einsum("hed,hdc->hec", wk, a1)
        gamma = sqrt_w[:, :, None] * a2  # (h, cd, c)
        coord_hash = torch.einsum("hrc,rn->chn", gamma, coords_cols)
        both = torch.stack([torch.einsum("hec,en->chn", beta_q, x_cols) + coord_hash,
                            torch.einsum("hec,en->chn", beta_k, x_cols) + coord_hash])
        hash_shift = (both.amax(dim=(0, 3), keepdim=True)
                      - both.amin(dim=(0, 3), keepdim=True))[0]  # (c, h, 1)
        shift = codes.to(torch.float32) * hash_shift
        q_key, k_key = both[0] + shift, both[1] + shift
        if invalid is not None:
            q_key = torch.where(invalid, _BIG_KEY, q_key)
            k_key = torch.where(invalid, _BIG_KEY, k_key)
        return q_key, k_key


def argsort_keys(keys: torch.Tensor):
    """A stable argsort of each key row and its inverse: (src, inv), sorted
    slot s holds row src[s] and row j sits at slot inv[j] (JAX's
    `_argsort_keys`, which sorts unstably)."""
    src = torch.argsort(keys, dim=-1, stable=True)
    return src, invert_permutation(src)


def sort_payload(xc: torch.Tensor, src: torch.Tensor, *, pack: bool = False,
                 gather_sort: bool = False, inv: torch.Tensor | None = None) -> torch.Tensor:
    """Sorted copies of the [x | coords] columns, one per row of `src`.

    Args:
      xc: (d_xc, n) columns.
      src: (c, h, n) permutations (h = 1 for share_heads).
      pack: move the values (and the cotangents) through bfloat16, and
        return bfloat16 (the sort_pack transport).
      gather_sort: move them as one broadcast-source row gather of the
        (n, d_xc) rows (kernel K5 on CUDA tensors; `gather_copies`) instead
        of the column gather of the sort-carry; its backward is a row
        gather by `inv`. The copies are laid out as columns again and their
        cotangents summed in that layout, so both ways give the same
        tensor, and the same gradient, bit for bit.
      inv: gather_sort: `src`'s inverse, when the caller has it.
    Returns: (c, h, d_xc, n).
    """
    c, h, n = src.shape
    if not gather_sort:
        return sort_carry(None, xc, src=src, pack=pack, out_bf16=pack)[0]
    src2 = src.reshape(c * h, n)
    inv2 = invert_permutation(src2) if inv is None else inv.reshape(c * h, n)
    return gather_copies(xc, src2, inv2, pack=pack, out_bf16=pack).reshape(c, h, -1, n)


def head_projection(w: torch.Tensor, sx: torch.Tensor, block_size: int) -> torch.Tensor:
    """Per-head projections of per-head sorted copies: w (h, e, d), sx (c,
    h, e, n) -> (c, h, d, n), proj[c, h] = w[h]^T sx[c, h] (n a multiple of
    `block_size`).

    w enters once per block of `block_size` points (an expanded view), so
    autograd's weight gradient is a batch of GEMMs over the c * block_size
    points of each (head, block), summed over the blocks by the expand's
    backward: as one GEMM per head of 24 x 24 outputs over all c * n points
    it runs on a handful of thread blocks (68.5 of a 118 ms parity-width
    step on an H100)."""
    c, h, e, n = sx.shape
    nb = n // block_size
    wb = w[:, None].expand(h, nb, e, w.shape[-1])
    out = torch.einsum("hged,chegb->chdgb", wb, sx.reshape(c, h, e, nb, block_size))
    return out.reshape(c, h, -1, n)


def project_attend(sxq: torch.Tensor, sqrt_w: torch.Tensor, wq: torch.Tensor,
                   wk: torch.Tensor, wv: torch.Tensor, *, block_size: int, impl: str,
                   sxk: torch.Tensor | None = None, kernel_bf16: bool = False,
                   kernel_center: bool = False) -> torch.Tensor:
    """Project sorted [x | coords] columns per head and run the bucket
    kernel, the dynamic-key post-sort paths' work between sort and unsort.

    Args: sxq (c, d_model + cd, m), one sorted copy per round shared by the
      heads (share_heads), or (c, h, d_model + cd, m), one per (round, head);
      m a multiple of block_size (whole buckets); sxk the copy k and v are
      projected from (default: sxq); sqrt_w (h, cd); wq, wk, wv (h, d_model,
      d) kernels (x @ w); impl the bucket kernels' `attn_impl`.
      kernel_bf16: feed the kernels bf16 operands, each projection's
      products summed in f32 and rounded once. kernel_center: subtract each
      bucket's mean from the RPE columns before any bf16 cast (exact in f32:
      the RBF logits are -|q - k|^2/2, shift-invariant), where q and k ride
      one sorted copy. bf16 copies (sort_pack) are projected with bf16
      weights, as on the static plan.
    Returns: (c, h, dv + 1, m) [numerator | denominator] per round and head.
    """
    h, d_model, d = wq.shape
    dv = wv.shape[-1]
    c, m = sxq.shape[0], sxq.shape[-1]
    ptype = torch.bfloat16 if kernel_bf16 else torch.float32
    spec = "hed,cen->chdn"  # one copy shared by the heads

    def rpe(sx):  # (c, h, cd, m)
        scs = sx[..., d_model:, :]
        r = sqrt_w[None, :, :, None] * (scs[:, None] if sx.dim() == 3 else scs).to(torch.float32)
        if kernel_center:
            b = r.reshape(*r.shape[:-1], m // block_size, block_size)
            r = (b - b.mean(dim=-1, keepdim=True).detach()).reshape(r.shape)
        return r.to(ptype)

    def project(sx, w):
        w32, x32 = w.to(sx.dtype).to(torch.float32), sx[..., :d_model, :].to(torch.float32)
        if sx.dim() == 3:
            return torch.einsum(spec, w32, x32).to(ptype)
        return head_projection(w32, x32, block_size).to(ptype)

    sxk = sxq if sxk is None else sxk
    rq = rpe(sxq)
    rk = rq if sxk is sxq else rpe(sxk)
    cd = rq.shape[2]
    sq = torch.cat([project(sxq, wq), rq], dim=2).reshape(c * h, d + cd, m)
    sk = torch.cat([project(sxk, wk), rk], dim=2).reshape(c * h, d + cd, m)
    sv = project(sxk, wv).reshape(c * h, dv, m)
    denom, so = bucket_rbf_attention_cols(sq.contiguous(), sk.contiguous(), sv.contiguous(),
                                          block_size, impl)
    return torch.cat([so, denom], dim=1).reshape(c, h, dv + 1, m)


def combine_rounds(rows: torch.Tensor) -> torch.Tensor:
    """OR-combine unsorted (c, h, m, dv + 1) [num | denom] rows: sum over
    the rounds, then num / denom (`stable_ratio`). Returns (h, m, dv)."""
    combined = rows.contiguous().sum(dim=0)
    dv = combined.shape[-1] - 1
    return stable_ratio(combined[..., :dv], combined[..., dv:])


def ratio_rows(od: torch.Tensor, axis: int) -> torch.Tensor:
    """The fp8 unsort's reparametrisation: [num | denom] along `axis` ->
    [num / denom | denom]. The per-round ratio is a convex combination of
    values, bounded by max|v|, where the raw numerators pass e4m3's range
    (JAX's `hept_tpu/ops/bucket_attn.py:981-994`)."""
    dv = od.shape[axis] - 1
    num, den = od.narrow(axis, 0, dv), od.narrow(axis, dv, 1)
    return torch.cat([stable_ratio(num, den), den], dim=axis)


def unsort_heads(od: torch.Tensor, q_src: torch.Tensor, pack=False,
                 inv: torch.Tensor | None = None, hash_group=None,
                 ratio: bool = True) -> torch.Tensor:
    """Unsort per-head [num | denom] by each (round, head)'s q permutation
    and OR-combine them (the per-head dynamic-key paths).

    Args: od (c, h, dv + 1, n) in sorted order; q_src (c, h, n); pack: move
      the rows through bf16, or "fp8" (e4m3 numerators, bf16 denominator);
      inv: q_src's inverse, when the caller has it; hash_group: under hash
      sharding, the sums over this rank's rounds are summed over the group
      before the ratio (JAX: a psum over `hash_axis`,
      `hept_tpu/ops/bucket_attn.py:299-303`); ratio: under "fp8", carry
      [num / denom | denom] and rebuild num = ratio * denom from the
      rounded denominator after the unsort (the post-sort core); False
      carries [num | denom] as it is (the pre-sort core, JAX `:290-295`).
    Returns: (n, h * dv) output rows. One row gather of (n, dv + 1) rows per
    (round, head) (K5 on CUDA tensors), which is also JAX's unsort_rows
    gather of this path (`:1026-1050`).
    """
    c, h, w, n = od.shape
    dv = w - 1
    fp8 = pack == "fp8" and ratio
    if fp8:
        od = ratio_rows(od, 2)
    rows = unsort_carry(q_src, od.transpose(2, 3).contiguous(), pack=pack, inv=inv)
    if fp8:
        rows = torch.cat([rows[..., :dv] * rows[..., dv:], rows[..., dv:]], dim=-1)
    combined = all_reduce_fwd(rows.sum(dim=0), hash_group)  # (h, n, dv + 1)
    out = stable_ratio(combined[..., :dv], combined[..., dv:])
    return out.permute(1, 0, 2).reshape(n, h * dv)


def unsort_combine(od: torch.Tensor, src: torch.Tensor, unsort_rows: bool = False,
                   pack=False, inv: torch.Tensor | None = None, keep_first: bool = False,
                   group: int = 1, hash_group=None) -> torch.Tensor:
    """Unsort the share_heads paths' [num | denom] by the rounds'
    permutations, shared by the heads, and OR-combine them; every unsort is
    an exact row gather (K5 on CUDA tensors).

    Args:
      od: (c, h, dv + 1, n) [num | denom] in each round's sorted order, or
        (c, n_ev, h, dv + 1, ne) with `sort_events` event rows.
      src: (c, n) or (c, n_ev, ne) permutations (sorted slot s holds point
        src[s]), at group level under `group` > 1: (c, n_ev, ne / group).
      unsort_rows: one gather of each round's merged (n, h * (dv + 1)) rows
        (JAX's `hept_tpu/ops/bucket_attn.py:1054-1105`); else the
        permutation broadcast to every head, a gather of (n, dv + 1) rows
        per (round, head) (JAX's head-broadcast carry, `:1145-1155`). The
        row gather moves each value exactly and the rounds are summed in
        one layout, so both give the same bits, which are also JAX's
        `fold_unsort` result (one merged-row unsort per round,
        `:1134-1144`).
      pack: move the rows through bf16, or "fp8" (head-broadcast only: e4m3
        [num / denom], bf16 denom, then num = ratio * denom; JAX `:981-994,
        1166-1167`).
      inv: src's inverse, when the caller has it.
      keep_first: canon_residual: round 0 is already in the output order
        and is neither moved nor rounded; src / inv are the canonical maps
        f / finv (JAX `:1065-1075, 1106-1133`).
      group: transport groups (merged rows only): ne / group rows of group *
        h * (dv + 1) values move as units (JAX `:1076-1089`).
      hash_group: under hash sharding, the sums over this rank's rounds are
        summed over the group before the ratio (JAX: a psum over
        `hash_axis`, `:1101-1103, 1169-1171`).
    Returns: (n, h * dv) output rows.
    """
    if od.dim() == 4:
        od, src = od[:, None], src[:, None]
        inv = None if inv is None else inv[:, None]
    c, n_ev, h, w, ne = od.shape
    dv = w - 1
    fp8 = pack == "fp8"
    if fp8:
        od = ratio_rows(od, 3)
    inv = invert_permutation(src) if inv is None else inv
    first = 1 if keep_first else 0
    m = c - first
    parts = [od[:1].permute(0, 1, 4, 2, 3).to(torch.float32)] if first else []
    if m:
        moved, idx, back = od[first:], inv[first:].reshape(m * n_ev, -1), \
            src[first:].reshape(m * n_ev, -1)
        if unsort_rows:
            rows = moved.permute(0, 1, 4, 2, 3).reshape(m * n_ev, ne // group, group * h * w)
            rows = permute_gather_rows(rows, idx, back, pack=pack).reshape(m, n_ev, ne, h, w)
        else:
            rows = moved.permute(0, 1, 2, 4, 3).reshape(m * n_ev * h, ne, w)

            def heads(p):  # (m * n_ev, ne) -> (m * n_ev * h, ne)
                return p[:, None].expand(m * n_ev, h, ne).reshape(m * n_ev * h, ne)

            rows = permute_gather_rows(rows, heads(idx), heads(back), pack=pack)
            rows = rows.reshape(m, n_ev, h, ne, w).permute(0, 1, 3, 2, 4)
        parts.append(rows)
    rows = (torch.cat(parts) if len(parts) > 1 else parts[0]).contiguous()
    if fp8:
        rows = torch.cat([rows[..., :dv] * rows[..., dv:], rows[..., dv:]], dim=-1)
    combined = all_reduce_fwd(rows.sum(dim=0), hash_group)  # (n_ev, ne, h, dv + 1)
    out = stable_ratio(combined[..., :dv], combined[..., dv:])
    return out.reshape(n_ev * ne, h * dv)


def hept_attention_core_xcols(
    x_cols: torch.Tensor,
    coords_cols: torch.Tensor,
    wq: torch.Tensor,
    wk: torch.Tensor,
    wv: torch.Tensor,
    sqrt_w: torch.Tensor,
    alpha: torch.Tensor | None,
    codes: torch.Tensor | None,
    invalid: torch.Tensor | None = None,
    plan=None,
    *,
    block_size: int,
    impl: str = "xla",
    sort_pack: bool = False,
    unsort_pack=False,
    kernel_bf16: bool = False,
    kernel_center: bool = False,
    sort_events: int = 1,
    unsort_rows: bool = False,
    fold_unsort: bool = False,
    canon: bool = False,
    plan_groups: int = 1,
    share_heads: bool = False,
    shared_sort: bool = False,
    gather_sort: bool = False,
    src=None,
    record_perms: list | None = None,
    hash_group=None,
) -> torch.Tensor:
    """Post-sort-projection HEPT attention: [x | coords] is sorted, then
    projected per head (the q/k/v projections are bias-free, so the hashes
    of q_hat and k_hat compose through them).

    The ways to the bucket grid:
    - a static plan (`plan`; the `hept_acc` path, share_heads; one event,
      or `sort_events` stacked events of n / sort_events points, each its
      own row of the plan and the kernels): x gathered by the plan, the
      plan's sorted coords, the unsort by its inverse (`unsort_combine`);
      under `canon` x arrives in round 0's order, under `plan_groups` in
      sigma's (`static_bucket_plan`);
    - dynamic keys shared by the heads (`plan` None, share_heads): each call
      hashes [x | coords] with the one-head `alpha` (`share_heads_keys`),
      sorts it once per round, projects, runs the bucket kernel and unsorts
      [num | denom] (`unsort_combine`, by rows or per head);
    - dynamic per-head keys (`plan` None, share_heads off): per (round,
      head) the keys of q and k (`post_sort_keys`); q's copy of [x | coords]
      sorted by its keys and k's by its own, or both by the k keys
      (`shared_sort`: one sorted copy serves q, k and v); per-head
      projections, the kernel, and the unsort by the q permutation
      (`unsort_heads`, which is the row gather either way of `unsort_rows`).
    On the dynamic paths `gather_sort` moves the sorted copies by row gathers
    (`sort_payload`) with the same bits as the sort-carry.

    Args:
      x_cols: (d_model, n) normed hidden state as columns.
      coords_cols: (cd, n).
      wq, wk, wv: (h, d_model, d) per-head projection kernels (x @ w).
      sqrt_w: (h, cd) RPE column scales.
      alpha: (1, d_model + cd, c) E2LSH directions with share_heads, (h,
        d + cd, c) without (dynamic keys; the plan does not read it).
      codes: (c, h, n) AND codes (dynamic keys).
      invalid: optional (n,) bool rows (zeroed; dynamic keys sort them last).
      plan: (src, inv, scoords) from `static_bucket_plan`, c rounds; with
        `canon` its 5-tuple (+ f, finv), with `plan_groups` its 7-tuple
        (the entry maps are the model's; the core reads the first five).
      impl: the bucket kernels' `attn_impl` mode (`bucket_rbf_attention_cols`).
      sort_pack: move x (with dynamic keys [x | coords]) through bf16 and
        project in bf16.
      unsort_pack: move the [num|denom] rows through bf16 in the unsort;
        "fp8": JAX's e4m3 ratio transport (`unsort_combine`, `unsort_heads`;
        not with the merged rows of unsort_rows or fold_unsort).
      kernel_bf16: feed the bucket kernels bf16 operands.
      kernel_center: subtract a per-bucket mean from the RPE columns of q
        and k before any bf16 cast (exact in f32: the RBF logits are
        -|q - k|^2/2, shift-invariant); q and k must ride one sorted copy
        (the plan, share_heads or shared_sort).
      sort_events: the plan's event rows (n must divide by sort_events *
        block_size).
      unsort_rows: share_heads (plan or dynamic keys): the merged-row
        unsort, else the head-broadcast one (`unsort_combine`).
      fold_unsort: the plan: JAX's one merged-row unsort a round, which the
        row gather gives as `unsort_rows` does.
      canon: canon_residual: x arrives and the output leaves in round 0's
        sorted order; the plan is `static_bucket_plan(canonical=True)`'s.
      plan_groups: transport groups of this many points (the plan is
        `static_bucket_plan(group_size=...)`'s; unsort by merged rows).
      share_heads / shared_sort: dynamic keys: see above.
      gather_sort: dynamic keys: row gathers instead of the sort-carry.
      src: dynamic keys: permutations applied instead of sorting by the keys
        (to hold two runs on the same permutations): (c, n) with
        share_heads, else (q_src, k_src), each (c, h, n).
      record_perms: dynamic keys: optional list; src is appended to it.
      hash_group: dynamic keys under hash sharding: the process group of the
        OR rounds' shards; the OR-combine's sums are summed over it
        (`unsort_combine`, `unsort_heads`).
    Returns: (n, h * d) attention output rows.
    """
    h, d_model, d = wq.shape
    n = x_cols.shape[-1]
    dv = wv.shape[-1]
    if plan is None:
        if n % block_size:
            raise ValueError(f"n={n} is not a multiple of block_size={block_size}")
        if kernel_center and not (share_heads or shared_sort):
            raise ValueError("kernel_center needs a shared q/k bucket grid (share_heads or "
                             "shared_sort; hept_tpu/ops/bucket_attn.py:881-883)")
        if invalid is not None:
            keep = torch.logical_not(invalid)[None, :]
            x_cols = torch.where(keep, x_cols, torch.zeros_like(x_cols))
            coords_cols = torch.where(keep, coords_cols, torch.zeros_like(coords_cols))
        # the q-side inverse permutation serves gather_sort's row gather and
        # the unsort
        q_inv = None
        if share_heads:
            if src is None:
                src, q_inv = argsort_keys(share_heads_keys(x_cols, coords_cols, sqrt_w, alpha,
                                                           codes, invalid))
            q_src = k_src = src[:, None]  # (c, 1, n)
        else:
            if src is None:
                q_key, k_key = post_sort_keys(x_cols, coords_cols, wq, wk, sqrt_w, alpha, codes,
                                              invalid)
                k_src = torch.argsort(k_key, dim=-1, stable=True)
                if not shared_sort:
                    q_src, q_inv = argsort_keys(q_key)
            else:
                q_src, k_src = src
            if shared_sort:
                q_src = k_src  # queries bucketed by the key order
            src = (q_src, k_src)
        if record_perms is not None:
            record_perms.append(src)
        q_inv = invert_permutation(q_src) if q_inv is None else q_inv.reshape(q_src.shape)
        xc = torch.cat([x_cols, coords_cols], dim=0)  # (d_xc, n)
        kw = dict(pack=sort_pack, gather_sort=gather_sort)
        sxq = sort_payload(xc, q_src, inv=q_inv, **kw)  # (c, h or 1, d_xc, n)
        sxk = sxq if k_src is q_src else sort_payload(xc, k_src, **kw)
        if share_heads:
            sxq = sxk = sxq[:, 0]
        od = project_attend(sxq, sqrt_w, wq, wk, wv, block_size=block_size, impl=impl, sxk=sxk,
                            kernel_bf16=kernel_bf16, kernel_center=kernel_center)
        if share_heads:
            return unsort_combine(od, q_src[:, 0], unsort_rows, pack=unsort_pack,
                                  inv=q_inv[:, 0], hash_group=hash_group)
        return unsort_heads(od, q_src, pack=unsort_pack, inv=q_inv, hash_group=hash_group)
    src, inv, scoords = plan[:3]
    c = src.shape[0]
    n_ev = sort_events
    ne = n // n_ev
    if n % (n_ev * block_size):
        raise ValueError(f"n={n} is not a multiple of sort_events * block_size")
    if invalid is not None:
        keep = torch.logical_not(invalid)[None, :]
        x_cols = torch.where(keep, x_cols, torch.zeros_like(x_cols))
    ptype = torch.bfloat16 if kernel_bf16 else torch.float32

    x_rows = x_cols.reshape(d_model, n_ev, ne).permute(1, 0, 2)  # (n_ev, d_model, ne)
    if canon:
        # x arrives in round 0's sorted order: round 0 takes no gather, the
        # other rounds gather by the composed maps f / finv
        fmap, finv = plan[3], plan[4]
        x0 = (x_rows.to(torch.bfloat16) if sort_pack else x_rows)[None]
        sxs = x0 if c == 1 else torch.cat([
            x0, permute_gather(x_rows, fmap[1:], finv[1:], pack=sort_pack, out_bf16=sort_pack)])
    else:  # under transport groups: the per-point expansions, relative to sigma
        sxs = permute_gather(x_rows, src, inv, pack=sort_pack,
                             out_bf16=sort_pack)  # (c, n_ev, d_model, ne)
    # the rpe columns are the same for q and k (both sqrt_w * coords of the
    # same sorted copy): compute and centre once
    rpe = sqrt_w[None, None, :, :, None] * scoords[:, :, None].to(torch.float32)
    if kernel_center:
        b = rpe.reshape(*rpe.shape[:-1], ne // block_size, block_size)
        b = b - b.mean(dim=-1, keepdim=True).detach()
        rpe = b.reshape(rpe.shape)
    rpe = rpe.to(ptype)  # (c, n_ev, h, cd, ne)

    def project(w):
        # products of the transported values summed in f32, one rounding to
        # the kernel dtype (the MXU's bf16-operand, f32-accumulate dot)
        proj = torch.einsum("hed,cben->cbhdn", w.to(sxs.dtype).to(torch.float32),
                            sxs.to(torch.float32))
        return proj.to(ptype)

    sq = torch.cat([project(wq), rpe], dim=3).reshape(c * n_ev * h, d + rpe.shape[3], ne)
    sk = torch.cat([project(wk), rpe], dim=3).reshape(c * n_ev * h, d + rpe.shape[3], ne)
    sv = project(wv).reshape(c * n_ev * h, dv, ne)

    denom, so = bucket_rbf_attention_cols(sq.contiguous(), sk.contiguous(),
                                          sv.contiguous(), block_size, impl)
    od = torch.cat([so, denom], dim=1).reshape(c, n_ev, h, dv + 1, ne)
    # the unsort: natural (canonical, sigma) position j takes round r's slot
    # inv[r, j] (finv; group slot ginv), backward by src (f; gsrc)
    if plan_groups > 1:
        return unsort_combine(od, plan[3], True, pack=unsort_pack, inv=plan[4],
                              group=plan_groups)
    if canon:
        return unsort_combine(od, fmap, unsort_rows or fold_unsort, pack=unsort_pack, inv=finv,
                              keep_first=True)
    return unsort_combine(od, src, unsort_rows or fold_unsort, pack=unsort_pack, inv=inv)


def hept_attention_core_cols(
    q_hat: torch.Tensor,
    k_hat: torch.Tensor,
    v: torch.Tensor,
    alpha: torch.Tensor,
    codes: torch.Tensor,
    invalid: torch.Tensor | None = None,
    *,
    block_size: int,
    impl: str = "xla",
    sort_pack: bool = False,
    unsort_pack: bool = False,
    perms=None,
    record_perms: list | None = None,
    hash_group=None,
) -> torch.Tensor:
    """Dynamic-key HEPT attention, one event (the reference-parity path).

    Per (round, head): hash q and k (`lsh_mapping`, span over both), key =
    hash + code * span, invalid rows to +BIG; q sorted by its keys, k and v
    by theirs (`sort_carry`); the bucket kernel; [num|denom] unsorted by the
    q permutation (`unsort_carry`, a row gather), summed over rounds and
    divided (`stable_ratio`).

    Args:
      q_hat, k_hat: (h, d_hash, n) RPE-folded queries / keys as columns.
      v: (h, dv, n) values as columns.
      alpha: (h, d_hash, c) frozen E2LSH directions.
      codes: (c, h, n) integer AND codes.
      invalid: optional (n,) bool rows sorted into trailing buckets.
      impl: the bucket kernels' `attn_impl` mode (`bucket_rbf_attention_cols`).
      sort_pack: move the sorted q_hat / k_hat / v (and, in the backward,
        their cotangents) through bf16; the kernels still take f32.
      unsort_pack: move the [num|denom] rows through bf16 in the unsort.
      perms: optional (q_src, k_src), each (c, h, n) int64, applied instead
        of sorting by the keys (to hold two runs on the same permutations).
      record_perms: optional list; (q_src, k_src) is appended to it.
      hash_group: under hash sharding, the process group of the OR rounds'
        shards: [num|denom] summed over this rank's rounds is summed over the
        group before the ratio (JAX: a psum over `hash_axis`,
        `hept_tpu/ops/bucket_attn.py:299-303`).
    Returns: (n, h * dv) attention output rows.

    The hash span is taken before invalid rows are pushed to +BIG. Stable
    sorts: rows with equal keys (replication pads and their sources, keys
    quantised to one float) keep their order; JAX's unstable sort may not.
    """
    h, d, n = q_hat.shape
    dv = v.shape[1]
    q_key = k_key = q_src = k_src = None
    if perms is None:
        q_hashed, k_hashed, hash_shift = lsh_mapping(alpha, q_hat.transpose(1, 2),
                                                     k_hat.transpose(1, 2))
        shift = codes.to(torch.float32) * hash_shift
        q_key, k_key = q_hashed + shift, k_hashed + shift
        if invalid is not None:
            q_key = torch.where(invalid, _BIG_KEY, q_key)
            k_key = torch.where(invalid, _BIG_KEY, k_key)
    else:
        q_src, k_src = perms
    sq, q_src = sort_carry(q_key, q_hat, src=q_src, pack=sort_pack)  # (c, h, d, n)
    # k and v go through two gathers on one permutation, not one gather of
    # [k_hat | v]: the kernels take contiguous sk and sv, and splitting a
    # joint payload costs two copies forward and a zero-fill and two adds
    # backward, more than the second gather saves (+4.3 ms of a 50 ms parity
    # step on an H100, utils/profiling.py)
    sk, k_src = sort_carry(k_key, k_hat, src=k_src, pack=sort_pack)
    sv, _ = sort_carry(None, v, src=k_src, pack=sort_pack)
    if record_perms is not None:
        record_perms.append((q_src, k_src))
    c = q_src.shape[0]
    denom, so = bucket_rbf_attention_cols(sq.reshape(c * h, d, n), sk.reshape(c * h, d, n),
                                          sv.reshape(c * h, dv, n), block_size, impl)
    od = torch.cat([so, denom], dim=1).reshape(c, h, dv + 1, n)
    return unsort_heads(od, q_src, pack=unsort_pack, hash_group=hash_group, ratio=False)


def dense_rbf_attention(q_hat: torch.Tensor, k_hat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact O(n^2) RBF attention, the golden reference of the bucketed core:
    normalised kernel attention with exp(min(q.k - |q|^2/2 - |k|^2/2, 0)).

    Args: q_hat, k_hat (h, n, d); v (h, n, dv). Returns (h, n, dv).
    It is plain K10 with one bucket of all n points per head.
    """
    denom, so = rows_fwd_plain(q_hat, k_hat, v)
    return so / denom


def hept_attention_core(
    q_hat: torch.Tensor,
    k_hat: torch.Tensor,
    v: torch.Tensor,
    alpha: torch.Tensor,
    codes: torch.Tensor,
    invalid: torch.Tensor | None = None,
    *,
    block_size: int,
    impl: str = "xla",
    sort_pack: bool = False,
    perms=None,
    record_perms: list | None = None,
) -> torch.Tensor:
    """The HEPT attention pipeline on row-major operands, one event (JAX's
    `hept_attention_core`; reference `src/models/attention/hept.py:93-115`).

    Per (round, head): hash q and k (`lsh_mapping`, span over both), key =
    hash + code * span, invalid rows to +BIG; q sorted by its keys, k and v
    by theirs (`sort_carry_rows`); kernel K10 on the (c * h * nb, B, .)
    buckets; [num|denom] unsorted by the q permutation in f32 (K5), summed
    over rounds and divided (`stable_ratio`).

    Args:
      q_hat, k_hat: (h, n, d_hash) RPE-folded queries / keys.
      v: (h, n, dv) values.
      alpha: (h, d_hash, c) frozen E2LSH directions.
      codes: (c, h, n) integer-valued AND codes.
      invalid: optional (n,) bool rows sorted into trailing buckets.
      block_size: bucket size B; n must be a multiple of B.
      impl: JAX's bucket kernel selection ("xla" | "pallas"), kept for its
        signature: both compute K10's contract, and the port runs K10 for
        every value (its plain version on CPU tensors).
      sort_pack: move the sorted q / k / v through bfloat16.
      perms: optional (q_src, k_src), each (c, h, n) int64, applied instead
        of sorting by the keys (to hold two runs on the same permutations).
      record_perms: optional list; (q_src, k_src) is appended to it.
    Returns: (h, n, dv) attention output.

    Stable sorts: rows with equal keys keep their order; JAX's unstable sort
    may not.
    """
    h, n, d = q_hat.shape
    dv = v.shape[-1]
    if n % block_size:
        raise ValueError(f"n={n} is not a multiple of block_size={block_size}")
    q_key = k_key = q_src = k_src = None
    if perms is None:
        q_hashed, k_hashed, hash_shift = lsh_mapping(alpha, q_hat, k_hat)
        shift = codes.to(torch.float32) * hash_shift
        q_key, k_key = q_hashed + shift, k_hashed + shift
        if invalid is not None:
            q_key = torch.where(invalid, _BIG_KEY, q_key)
            k_key = torch.where(invalid, _BIG_KEY, k_key)
    else:
        q_src, k_src = perms
    sq, q_src = sort_carry_rows(q_key, q_hat, pack=sort_pack, src=q_src)  # (c, h, n, d)
    sk, k_src = sort_carry_rows(k_key, k_hat, pack=sort_pack, src=k_src)
    sv, _ = sort_carry_rows(None, v, pack=sort_pack, src=k_src)
    if record_perms is not None:
        record_perms.append((q_src, k_src))
    c = q_src.shape[0]
    g = c * h * (n // block_size)
    denom, so = bucket_rbf_attention_rows(sq.reshape(g, block_size, d),
                                          sk.reshape(g, block_size, d),
                                          sv.reshape(g, block_size, dv))
    rows = torch.cat([so, denom], dim=-1).reshape(c, h, n, dv + 1)
    rows = unsort_carry(q_src, rows)  # (c, h, n, dv + 1), f32 as in JAX
    combined = rows.sum(dim=0)
    return stable_ratio(combined[..., :dv], combined[..., dv:])
