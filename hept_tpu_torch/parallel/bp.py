"""Bucket-axis sequence parallelism within one event (port of
`hept_tpu/parallel/bp.py`).

After the bucket sort, HEPT attention is block-diagonal over the (rounds x
buckets) grid of independent block_size x block_size tiles. Head and hash
TP (`tp.py`) stop at heads x hashes ranks; splitting the bucket grid does
not: each of P ranks owns a contiguous ne = n / P slab of whole buckets of
every round. Per layer, on the dynamic-key share_heads path:

- replicated: the E2LSH keys (`ops/bucket_attn.py:share_heads_keys`) and,
  with transport "replicated", the sort of [x | coords] on every rank;
- sharded: the per-head projections, the RPE columns and the bucket kernel
  (`project_attend`: K6 / K7 on CUDA tensors) on this rank's slab only;
- collective: one `all_gather` of the disjoint [num | denom] slabs
  (replicated transport; JAX sums zero-padded slabs with a psum, which only
  its replication checker needs: the gather moves P times fewer bytes and
  its backward, this rank's slice of the replicated cotangent, is exact),
  then the unsort and the OR-combine replicated (`unsort_combine`);
  with transport "distributed" only the comparator sort is replicated and
  the payload moves through `dsort.route_local` (one capped all-to-all
  each way); every rank unsorts and combines its own slab, and the output
  slabs are all-gathered.

The inputs are replicated: they enter through `copy_to_group`, so their
gradients are summed over the group (each rank's slab contributes its
part), as the head-sharded core does (`sp.py`). The numbers are the
single-device core's (`hept_attention_core_xcols` without a plan): the same
ops on a slab of whole buckets, and routing only moves values.

`make_bucket_train_step` runs the whole model so over a ("data",
"buckets") mesh: events split over "data" (`dp.train_step`: the loss and
the gradients averaged over data), and inside each data rank every layer's
attention splits its bucket grid over "buckets"; the rest of the model is
computed alike on every bucket rank, dropout included.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.buckets import sort_carry
from ..models.transformer import HeptTransformer, TransformerConfig
from ..ops.bucket_attn import (
    combine_rounds,
    project_attend,
    share_heads_keys,
    unsort_combine,
)
from .collectives import all_gather, copy_to_group, group_rank, group_size
from .dp import shard_batch, train_step
from .dsort import invert_perm, permute_overflows, route_local
from .mesh import Mesh
from .tp import dropout_generator

TRANSPORTS = ("replicated", "distributed")


def bucket_sharded_core(x_cols, coords_cols, wq, wk, wv, sqrt_w, alpha, codes, invalid, group,
                        *, block_size: int, impl: str = "pallas",
                        transport: str = "replicated", cap_factor: float = 2.0,
                        unsort_rows: bool = False, src: torch.Tensor | None = None,
                        record_perms: list | None = None) -> torch.Tensor:
    """The dynamic-key share_heads attention core with its sorted bucket grid
    split over `group` (P ranks; n a multiple of P * block_size).

    Args as `hept_attention_core_xcols` without a plan: x_cols (d_model, n),
    coords_cols (cd, n), wq / wk / wv (h, d_model, d), sqrt_w (h, cd), alpha
    (1, d_model + cd, c), codes (c, h, n), invalid (n,) or None, all the same
    on every rank. `transport`: "replicated" or "distributed" (cells of
    cap = ceil(cap_factor * n / P^2) points; an overflow makes the whole
    output NaN, never a silently wrong one). `unsort_rows`: the replicated
    transport's unsort (`unsort_combine`). `src` / `record_perms`: impose /
    record the (c, n) sort orders. Returns the (n, h * dv) output rows, the
    same on every rank.
    """
    if transport not in TRANSPORTS:
        raise ValueError(f"bucket transport {transport!r}: one of {TRANSPORTS}")
    n_sh, me = group_size(group), group_rank(group)
    h, d_model, _ = wq.shape
    n = x_cols.shape[-1]
    dv = wv.shape[-1]
    if n % (n_sh * block_size):
        raise ValueError(f"n={n} must divide by bucket shards * block_size = "
                         f"{n_sh * block_size}")
    x_cols, coords_cols, wq, wk, wv, sqrt_w = (copy_to_group(t, group) for t in (
        x_cols, coords_cols, wq, wk, wv, sqrt_w))
    if invalid is not None:
        keep = torch.logical_not(invalid)[None, :]
        x_cols = torch.where(keep, x_cols, torch.zeros_like(x_cols))
        coords_cols = torch.where(keep, coords_cols, torch.zeros_like(coords_cols))
    if src is None:
        src = torch.argsort(share_heads_keys(x_cols, coords_cols, sqrt_w, alpha, codes, invalid),
                            dim=-1, stable=True)
    if record_perms is not None:
        record_perms.append(src)
    c = src.shape[0]
    ne = n // n_sh
    sl = slice(me * ne, (me + 1) * ne)
    xc = torch.cat([x_cols, coords_cols], dim=0)  # (d_xc, n)
    if transport == "replicated":
        sxc, _ = sort_carry(None, xc, src=src[:, None])  # (c, 1, d_xc, n)
        od = project_attend(sxc[:, 0, :, sl], sqrt_w, wq, wk, wv, block_size=block_size,
                            impl=impl)  # (c, h, dv + 1, ne)
        od = all_gather(od, 3, group)  # (c, h, dv + 1, n)
        return unsort_combine(od, src, unsort_rows)
    cap = max(1, -(-int(cap_factor * n) // (n_sh * n_sh)))
    slab = xc[:, sl][None].expand(c, xc.shape[0], ne)  # my input-order columns
    sxc = route_local(src, slab, group, cap)  # (c, d_xc, ne) my sorted columns
    od = project_attend(sxc, sqrt_w, wq, wk, wv, block_size=block_size, impl=impl)
    back = route_local(invert_perm(src), od.reshape(c, h * (dv + 1), ne), group, cap)
    out = combine_rounds(back.reshape(c, h, dv + 1, ne).transpose(2, 3))  # (h, ne, dv)
    out = all_gather(out, 1, group).permute(1, 0, 2).reshape(n, h * dv)
    bad = permute_overflows(src, n_sh, cap)
    return torch.where(bad, torch.full_like(out, float("nan")), out)


def make_bucket_sharded_attention(group, *, block_size: int, impl: str = "pallas",
                                  transport: str = "replicated", cap_factor: float = 2.0):
    """The layer-level function over `group` (JAX's
    `make_bucket_sharded_attention` over a mesh axis): fn(x_cols,
    coords_cols, wq, wk, wv, sqrt_w, alpha, codes, invalid) -> (n, h * dv),
    every input and the output the same on every rank."""

    def fn(x_cols, coords_cols, wq, wk, wv, sqrt_w, alpha, codes, invalid=None):
        return bucket_sharded_core(x_cols, coords_cols, wq, wk, wv, sqrt_w, alpha, codes,
                                   invalid, group, block_size=block_size, impl=impl,
                                   transport=transport, cap_factor=cap_factor)

    return fn


def local_config(cfg: TransformerConfig, shards: int, transport: str = "replicated",
                 cap_factor: float = 2.0) -> TransformerConfig:
    """The model config of one bucket rank, with JAX's checks
    (`hept_tpu/models/attention/hept.py:174-179`): HEPT, qkv_post_sort +
    share_heads without a static plan, f32 transport, one event a row."""
    if cfg.attn_type != "hept":
        raise ValueError("bucket SP targets HEPT")
    if not (cfg.qkv_post_sort and cfg.share_heads) or cfg.static_keys:
        raise ValueError("bucket SP runs the dynamic-key share_heads path (qkv_post_sort + "
                         "share_heads, no static plan)")
    lcfg = dataclasses.replace(cfg, bucket_shards=shards, bucket_transport=transport,
                               bucket_cap_factor=cap_factor)
    lcfg.check_supported()
    return lcfg


def make_bucket_model(cfg: TransformerConfig, mesh: Mesh, generator=None, device=None,
                      state_dict: dict | None = None, transport: str = "replicated",
                      cap_factor: float = 2.0) -> HeptTransformer:
    """This rank's model of `cfg` with its attention split over the mesh's
    "buckets" group: the whole model, built from `generator` (the same draws
    on every rank) or loaded from `state_dict`; nothing is sliced."""
    lcfg = local_config(cfg, mesh.size("buckets"), transport, cap_factor)
    model = HeptTransformer(lcfg, generator, device, {"buckets": mesh.group("buckets")})
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def make_bucket_train_step(model: HeptTransformer, optimizer, loss_fn, mesh: Mesh, *,
                           seed: int | None = None, clip_norm: float = 0.0, apply_fn=None):
    """DP x bucket-SP train step of a `make_bucket_model` model over a
    ("data", "buckets") mesh (JAX's `make_bucket_train_step`).

    Returns step(batch) -> {"loss", "grad_norm"}: `batch` is the whole event
    batch (its event axis divides over "data"); this rank takes its data
    slice, runs the model (each layer's attention over the bucket group),
    and `dp.train_step` averages the loss and the gradients over "data"
    before the optimizer's step. Dropout (with `seed`; None: no dropout)
    draws one stream per data rank, the same on every bucket rank of it
    (`tp.dropout_generator`), as JAX folds the data index into its key.
    `apply_fn(model, batch, generator)`: the forward (default the
    trainer's `model_apply`; e.g. one that imposes sort orders)."""
    from ..train.trainer import model_apply

    apply_fn = apply_fn or model_apply
    gen = None if seed is None else dropout_generator(seed, mesh.rank("data"),
                                                      next(model.parameters()).device)

    def step(batch: dict) -> dict:
        local = shard_batch(batch, mesh.rank("data"), mesh.size("data"))
        return train_step(model, optimizer, loss_fn, apply_fn, local, mesh.group("data"), gen,
                          clip_norm)

    return step
