"""HEPT attention module (port of `hept_tpu/models/attention/hept.py`): the
post-sort branch (on a static bucket plan, or with per-layer dynamic keys,
shared by the heads (optionally bucket-sharded) or per head) and the
pre-sort branch with per-layer, per-head dynamic keys."""

from __future__ import annotations

import torch
from torch import nn

from ...core.hashing import e2lsh_init
from ...ops.bucket_attn import hept_attention_core_cols, hept_attention_core_xcols
from ...parallel.collectives import all_gather, copy_to_group
from ..mlp import TorchLinear


def rpe_scales(w_rpe: torch.Tensor, num_heads: int, h_dim: int, coords_dim: int,
               num_w_per_dist: int) -> torch.Tensor:
    """Per-head RPE column scales sqrt(2 w) (h, coords_dim): per distance
    group, w = sum_k exp(min(sum_d W[h, d, r, k], 50)); eta and phi share
    the first group's width (they form dR)."""
    w = w_rpe.reshape(num_heads, h_dim, coords_dim - 1, num_w_per_dist)
    qw = torch.exp(torch.clamp(w.sum(dim=1), max=50.0)).sum(dim=-1)
    qw_expanded = torch.cat([qw[:, :1], qw], dim=-1)
    return torch.sqrt(2.0 * qw_expanded)


class HeptAttention(nn.Module):
    """LSH-bucketed block-local RBF attention for one event.

    Post-sort (qkv_post_sort): the caller passes the shared normed hidden
    state and the per-head q/k/v kernels, applied after the sort. A static
    plan does not read `e2lsh_alpha` (1 head), which is kept so weights
    carry across unchanged; with dynamic keys and share_heads it hashes
    [x | coords] once per round for every head, without share_heads it is
    h wide and hashes each head through the projections. Pre-sort (dynamic
    keys): the caller passes the q/k/v projections, and `e2lsh_alpha` (h,
    d + cd, n_hashes) hashes each head.

    Under tensor parallelism (dynamic keys; `groups` {"heads", "hashes"})
    the module holds its rank's heads and OR rounds: the operands of this
    rank's heads enter the core through `copy_to_group` over hashes (their
    gradient sums the rounds' shards: q_hat / k_hat / v before the sort, the
    kernels and RPE scales after it), the core sums the OR-combine over
    hashes, and the (n, h_local * d) output is all-gathered over heads into
    `out_linear`, which stays whole (JAX: `hept_tpu/models/attention/
    hept.py:215-216, 264-267`). share_heads' one-head `e2lsh_alpha` shards
    over hashes only.
    """

    def __init__(self, cfg, generator=None, device=None, groups: dict | None = None):
        super().__init__()
        self.cfg = cfg
        groups = groups or {}
        self.head_group, self.hash_group = groups.get("heads"), groups.get("hashes")
        self.bucket_group = groups.get("buckets")
        h, d = cfg.num_heads, cfg.h_dim
        self.out_linear = TorchLinear(h * cfg.head_shards * d, d, generator=generator,
                                      device=device)
        self.register_buffer(
            "e2lsh_alpha",
            e2lsh_init(generator, 1 if cfg.share_heads else h, d + cfg.coords_dim,
                       cfg.n_hashes, device=device),
        )

    def _sqrt_w(self, w_rpe):
        cfg = self.cfg
        return rpe_scales(w_rpe, cfg.num_heads, cfg.h_dim, cfg.coords_dim, cfg.num_w_per_dist)

    def forward_post_sort(self, x_normed, coords, codes, invalid, plan, w_rpe, wq, wk, wv,
                          perms=None, record_perms=None):
        """Post-sort path. x_normed: (n, d) normed hidden state; wq/wk/wv:
        (h, d, d) head-major kernels, applied after the sort. On the static
        plan (`plan`) the plan orders the points; with dynamic keys and
        share_heads `e2lsh_alpha` (1, d + cd, n_hashes) hashes [x | coords]
        with head 0's AND codes (`codes` (c, h, n)), and `perms` /
        `record_perms` impose / record the (c, n) sort orders; without
        share_heads `e2lsh_alpha` is (h, d + cd, n_hashes) and the orders are
        (q_src, k_src) pairs of (c, h, n).
        Under bucket sharding (`groups["buckets"]`) the dynamic-key layer
        runs `parallel/bp.py:bucket_sharded_core` over the group. Under
        head / hash sharding (dynamic keys) the caller's `x_normed` carries
        the sum over both groups in its gradient; the kernels and RPE scales
        of this rank's heads enter through `copy_to_group` over hashes, the
        core sums the OR-combine over hashes, and the (n, h_local * d)
        output is all-gathered over heads into `out_linear` (JAX:
        `hept_tpu/models/attention/hept.py:201, 215-216`). Returns (n, d)."""
        cfg = self.cfg
        sqrt_w = self._sqrt_w(w_rpe)
        wq, wk, wv, sqrt_w = (copy_to_group(t, self.hash_group) for t in (wq, wk, wv, sqrt_w))
        if self.bucket_group is not None:
            from ...parallel.bp import bucket_sharded_core

            out = bucket_sharded_core(
                x_normed.t(), coords.t(), wq, wk, wv, sqrt_w, self.e2lsh_alpha, codes, invalid,
                self.bucket_group, block_size=cfg.block_size, impl=cfg.attn_impl,
                transport=cfg.bucket_transport, cap_factor=cfg.bucket_cap_factor,
                unsort_rows=cfg.unsort_rows, src=perms, record_perms=record_perms)
        else:
            out = hept_attention_core_xcols(
                x_normed.t(), coords.t(), wq, wk, wv, sqrt_w, self.e2lsh_alpha, codes, invalid,
                plan, block_size=cfg.block_size, impl=cfg.attn_impl, sort_pack=cfg.sort_pack,
                unsort_pack=cfg.unsort_pack, kernel_bf16=cfg.kernel_bf16,
                kernel_center=cfg.kernel_center, sort_events=cfg.sort_events,
                unsort_rows=cfg.unsort_rows, fold_unsort=cfg.fold_unsort,
                canon=cfg.canon_residual, plan_groups=cfg.transport_groups,
                share_heads=cfg.share_heads,
                shared_sort=cfg.shared_sort, gather_sort=cfg.gather_sort, src=perms,
                record_perms=record_perms, hash_group=self.hash_group,
            )  # (n, h * d) rows
        return self.out_linear(all_gather(out, 1, self.head_group))

    def prep_qkv(self, query, key, value, coords, invalid, w_rpe):
        """The pre-sort path's q_hat, k_hat (h, d + cd, n) and v (h, d, n)
        columns (`prep_qk`): per head, the projection rows and the RPE rows
        sqrt(2 w) * coords; invalid rows zeroed."""
        h, d = self.cfg.num_heads, self.cfg.h_dim
        n = query.shape[0]
        w_cols = self._sqrt_w(w_rpe)[:, :, None] * coords.t()[None]  # (h, cd, n)
        q_hat = torch.cat([query.t().reshape(h, d, n), w_cols], dim=1)
        k_hat = torch.cat([key.t().reshape(h, d, n), w_cols], dim=1)
        v_cols = value.t().reshape(h, d, n)
        if invalid is not None:
            keep = torch.logical_not(invalid)
            q_hat = torch.where(keep, q_hat, 0.0)
            k_hat = torch.where(keep, k_hat, 0.0)
            v_cols = torch.where(keep, v_cols, 0.0)
        return q_hat, k_hat, v_cols

    def forward_dynamic(self, query, key, value, coords, codes, invalid, w_rpe, perms=None,
                        record_perms=None):
        """Pre-sort path. query/key/value: (n, h * d) projections; codes:
        (c, h, n) AND codes. `perms` / `record_perms`: see
        `hept_attention_core_cols`. Returns (n, d)."""
        cfg = self.cfg
        q_hat, k_hat, v_cols = (copy_to_group(t, self.hash_group) for t in
                                self.prep_qkv(query, key, value, coords, invalid, w_rpe))
        out = hept_attention_core_cols(
            q_hat, k_hat, v_cols, self.e2lsh_alpha, codes, invalid,
            block_size=cfg.block_size, impl=cfg.attn_impl, sort_pack=cfg.sort_pack,
            unsort_pack=cfg.unsort_pack, perms=perms, record_perms=record_perms,
            hash_group=self.hash_group,
        )  # (n, h * d) rows
        return self.out_linear(all_gather(out, 1, self.head_group))
