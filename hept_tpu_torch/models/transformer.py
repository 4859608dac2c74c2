"""HEPT transformer backbone (port of `hept_tpu/models/transformer.py` for the
ported profiles and the seven baseline attentions).

Feature-MLP encoder -> N pre-LN attention blocks with residual + FF ->
concat of all layer outputs -> bias-free `W` -> 5-layer tanh/LayerNorm MLP
residual head. The pileup task embeds the PID in the last feature column
before the encoder and ends in a sigmoid classifier. Three ways to bucket the points:
- static plan (hept_acc, hept_fast, hept_turbo): keys are hashed once per
  step from the encoder output and coords, or the coords alone
  (`static_hash`); one plan of `static_rounds` rounds is built, and layer l
  uses rounds [(l * n_hashes + j) % static_rounds for j < n_hashes] (under
  canon_residual round 0 and n_hashes - 1 rounds cycled over the rest);
  under canon_residual the residual stream rides in round 0's sorted order,
  with transport groups in a (AND cell, Morton) order, from the encoder to
  the head (`permute_rows`);
- dynamic keys (the reference-parity `hept`): each layer projects q/k/v
  before the sort and hashes every head on its own, with the per-head AND
  codes of `prepare_event`;
- dynamic keys after the sort (qkv_post_sort): each layer hashes its
  normed state and coords once per OR round for every head (share_heads)
  or per (round, head) through the projections, sorts them, and projects
  per head after the sort.
Padding: replicate (pads copy real rows, integer AND codes) or zero (the
reference's src variant: pads invalid, float `geo_code` codes).
The baselines (`attn_type` performer, flt, reformer, smyrf, sb, pct,
flatformer; `models/attention/`) take the same encoder and head: pre-LN
q/k/v projections of x + pe (a learned or sinusoidal positional embedding
per block, `pe_type`), except pct (a kNN graph on (eta, phi), projected by
w_q alone) and flatformer (four post-norm group layers replace the whole
block, and the head concatenates all four of each block's outputs). They
need no padding plan: invalid coords are zeroed and the pads are masked.
Layers run as a Python loop (the JAX package's `scan_layers` is a compile-
time device with the same math); under `use_ckpt` each block is recomputed
in the backward with the same draws (`HeptTransformer._block`).

The model is defined on ONE event: x (N, in_dim), coords (N, coords_dim),
valid (N,) with N a multiple of block_size; it returns (N, h_dim // 2)
embeddings (tracking) or (N, num_classes) probabilities (pileup). A batch
of events runs one at a time (`make_batched_apply`) or as one flat forward
(`make_flat_batched_apply`: each event prepared on its own, then the batch
index packed into the AND codes so that no bucket crosses two events, or,
with `sort_events`, every event its own sort row of the static plan).

Head / hash tensor parallelism (`parallel/tp.py`): a model built with
`groups` ({"heads": group, "hashes": group}) and the local config
(`num_heads` / `n_hashes` of its shard, `head_shards` / `hash_shards` the
shard counts) runs its attention heads and OR rounds on this rank's
slice; the attention output is all-gathered over heads before
`out_linear`, and the OR-combine's sums are summed over hashes.
Bucket-axis SP (`parallel/bp.py`): a model built with {"buckets": group}
runs each layer's dynamic-key share_heads attention with its bucket grid
split over the group; everything else is computed alike on every rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.buckets import bit_shift, permute_gather_rows
from ..parallel.collectives import broadcast, copy_to_group
from ..core.hashing import e2lsh_init
from ..core.padding import replication_pad_plan
from ..core.regions import geo_code, get_regions, region_codes
from ..ops.bucket_attn import static_bucket_plan, static_hash
from ..ops.bucket_attn_cuda import ATTN_IMPLS
from .attention.flatformer import FlatformerAttention, discretize_coords
from .attention.flt import FLTAttention
from .attention.hept import HeptAttention
from .attention.pct import PCTAttention, knn_graph
from .attention.performer import PerformerAttention
from .attention.reformer import ReformerAttention
from .attention.sb import SBAttention
from .attention.smyrf import SmyrfAttention
from .mlp import FeedForward, OutMLP, TorchLinear, dropout, layer_norm, uniform_

BASELINES = ("performer", "flt", "reformer", "smyrf", "sb", "pct", "flatformer")
# the baselines that draw random rotations / E2LSH directions every forward
LSH_BASELINES = ("reformer", "smyrf", "sb")
# the pileup PID embedding: PIDs 0..6, 10 features each
NUM_PIDS, PID_DIM = 7, 10


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Model hyperparameters, with the JAX TransformerConfig's names.

    The port implements these paths of attn_type "hept", with replicate or
    zero padding (`check_supported`): the static plan (qkv_post_sort +
    share_heads + static_keys "x0" or "coords", with static_and_bins,
    unsort_rows or the head-broadcast unsort, fold_unsort, canon_residual or
    transport_groups); dynamic per-layer keys per
    head with q/k/v projected before the sort (the reference-parity path:
    all four off); and dynamic per-layer keys after the sort
    (qkv_post_sort), shared by the heads (share_heads; the path the
    bucket-axis SP runs) or per head, with q and k sorted apart or by the k
    keys (shared_sort), the sorted copies moved by the sort-carry or by row
    gathers (gather_sort, a no-op on the static plan as in JAX), and
    share_heads' unsort by merged rows (unsort_rows) or per head; per head
    is also JAX's fold_unsort result, so that flag selects nothing more.
    The bf16 modes
    (sort_pack, unsort_pack, kernel_bf16, kernel_center) and the fp8 unsort
    (unsort_pack "fp8") run wherever JAX runs them. Every dynamic-key path
    runs under head and hash sharding in any mix (`parallel/tp.py`), but
    share_heads under head sharding, which JAX's TP step refuses; the static
    plan runs under neither. The bucket-axis SP (`parallel/bp.py`) runs
    share_heads' dynamic keys with either padding. `use_ckpt` recomputes
    each block in the backward, on every attn_type and under every kind of
    sharding. The seven baseline attentions (`BASELINES`)
    read the baseline fields at the end and none of hept's modes.
    `attn_impl` selects the bucket kernels
    (`ops/bucket_attn_cuda.py:cols_routes`), every mode of the JAX package:
    "xla", its einsum forward with autodiff's backward, runs "hybrid"'s K6
    and K7 v1; "slab" and "hybrid_slab" run the contracts of its slab
    kernels (K8/K9) on K6/K7. `sort_ops` and `scan_layers` select TPU
    implementations of the same math and are ignored, and `shared_sort` is
    implied by `share_heads`. Every default is the JAX config's; JAX's mesh
    axis names `head_axis` / `hash_axis` are the shard counts `head_shards`
    / `hash_shards` here, and its `bucket_axis` the model's "buckets" group.
    """

    in_dim: int
    coords_dim: int
    task: str = "tracking"
    num_classes: int = 1  # pileup head width
    attn_type: str = "hept"
    h_dim: int = 24
    num_heads: int = 8
    n_layers: int = 4
    block_size: int = 100
    n_hashes: int = 3
    num_regions: int = 150
    num_w_per_dist: int = 10
    num_and_hashes: int = 2
    dropout: float = 0.1
    padding_mode: str = "zero"
    attn_impl: str = "xla"
    sort_pack: bool = False
    sort_ops: int = 1
    unsort_pack: bool = False
    qkv_post_sort: bool = False
    shared_sort: bool = False
    share_heads: bool = False
    kernel_bf16: bool = False
    kernel_center: bool = False
    static_keys: Any = False
    static_rounds: int = 0
    unsort_rows: bool = False
    gather_sort: bool = False
    fold_unsort: bool = False
    canon_residual: bool = False
    transport_groups: int = 1
    static_and_bins: int = 0
    scan_layers: bool = False
    # the baseline attentions' knobs, with the JAX package's defaults
    pe_type: str = "none"  # none | learned | fixed (| rpe: performer, smyrf, flatformer)
    use_ckpt: bool = False
    nb_features: int = 200  # performer / flt outer features, sb's low-rank features
    nb_features_inner: int = 6  # flt's inner random Fourier features
    bucket_size: int = 100  # reformer / smyrf / sb cluster size, flatformer group size
    allow_duplicate_attention: bool = True  # reformer
    attend_across_buckets: bool = True  # reformer
    knn_k: int = 16  # pct's kNN graph degree
    b_grid: int = 1000  # flatformer's bins per axis
    num_slices_per_axis: int = 30  # flatformer's windows per axis
    # stacked flat batching on the static plan: the flat point axis holds
    # this many equal-size events, each bucket-sorted as its own row
    # (`make_flat_batched_apply` with a model built for B = sort_events)
    sort_events: int = 1
    # head / hash tensor parallelism (`parallel/tp.py`): the number of
    # shards the heads and the OR rounds are split into; the config then
    # holds one shard's num_heads and n_hashes
    head_shards: int = 1
    hash_shards: int = 1
    # bucket-axis sequence parallelism (`parallel/bp.py`): each layer's
    # sorted bucket grid splits over this many ranks, the payload moved by
    # a replicated sort ("replicated") or capped all-to-alls
    # ("distributed", cells of ceil(bucket_cap_factor * n / P^2) points)
    bucket_shards: int = 1
    bucket_transport: str = "replicated"
    bucket_cap_factor: float = 2.0

    def check_supported(self) -> None:
        need = {
            "task in ('tracking', 'pileup') (hept_tpu/models/transformer.py:40; another value "
            "runs JAX's tracking head)": self.task in ("tracking", "pileup"),
            f"attn_type in {('hept',) + BASELINES} (hept_tpu/models/transformer.py:381 raises "
            "NotImplementedError(attn_type))": self.attn_type in ("hept",) + BASELINES,
        }
        tp = self.head_shards > 1 or self.hash_shards > 1
        bucket = self.bucket_shards > 1 or self.bucket_transport != "replicated"
        if self.attn_type != "hept":
            need["head / hash sharding targets HEPT (hept_tpu/parallel/tp.py:125)"] = not tp
            need["bucket sharding targets HEPT (hept_tpu/parallel/bp.py:305)"] = not bucket
            need["sort_events == 1 (stacked batching is the static plan's, "
                 "hept_tpu/models/transformer.py:659)"] = \
                self.sort_events == 1
            self._refuse(need)
            return
        fp8 = self.unsort_pack == "fp8"
        need.update({
            "sort_pack is a bool and unsort_pack a bool or 'fp8' (a sort_pack 'fp8' or another "
            "value must not run as the bf16 transport; JAX documents the e4m3 encoding for the "
            "[num|denom] unsort only, hept_tpu/ops/bucket_attn.py:981-994; ROADMAP.md, queue 1, "
            "'Not queued')":
                isinstance(self.sort_pack, bool)
                and (isinstance(self.unsort_pack, bool) or fp8),
            "unsort_pack 'fp8' not with the merged-row unsorts: unsort_rows after the sort "
            "(hept_tpu/ops/bucket_attn.py:1011) or fold_unsort (:989)":
                not (fp8 and (self.fold_unsort or (self.unsort_rows and self.qkv_post_sort))),
            "padding_mode in ('replicate', 'zero') (hept_tpu/models/transformer.py:51, 821; "
            "another value runs JAX's replicate plan)": self.padding_mode in ("replicate", "zero"),
            "num_and_hashes == 2 (JAX's region_codes reshapes the regions to (2, c * h), "
            "hept_tpu/core/regions.py:106, so its model cannot be built with another value "
            "and there is nothing to hold a port against)": self.num_and_hashes == 2,
            f"attn_impl in {ATTN_IMPLS} (the JAX package's modes, "
            "hept_tpu/ops/bucket_attn.py:971-978)": self.attn_impl in ATTN_IMPLS,
        })
        if self.canon_residual and not self.static_keys:
            # hept_tpu/models/transformer.py:707-708
            raise ValueError("canon_residual requires static_keys")
        if self.static_keys:
            rounds = self.static_rounds or self.n_hashes
            g = self.transport_groups
            if self.canon_residual and rounds != self.n_hashes and (
                    self.n_hashes < 2 or (rounds - 1) % (self.n_hashes - 1)):
                # hept_tpu/models/transformer.py:615-623
                raise ValueError("with canon_residual, static_rounds must be 1 + k*(n_hashes-1)")
            need.update({
                "static plan: no head sharding (share_heads leaves e2lsh_alpha one head wide "
                "and hept_tpu/parallel/tp.py:70-72 shards it over heads: JAX's shard_map "
                "refuses it)": self.head_shards == 1,
                "static plan: no hash sharding (JAX's make_tp_train_step runs it, but each "
                "hash shard keeps the whole replicated static_alpha while its AND codes "
                "shard, hept_tpu/parallel/tp.py:34-78, so a layer's rounds are not the "
                "single-device model's)": self.hash_shards == 1,
                "static_keys in (True, 'x0', 'coords') (hept_tpu/models/transformer.py:638 runs "
                "any other value as 'x0')": self.static_keys in (True, "x0", "coords"),
                "static plan: qkv_post_sort (hept_tpu/models/transformer.py:608-609)":
                    bool(self.qkv_post_sort),
                "static plan: share_heads (hept_tpu/models/transformer.py:608-609)":
                    bool(self.share_heads),
                "static_rounds a multiple of n_hashes (canon_residual: 1 + k * (n_hashes - 1); "
                "hept_tpu/models/transformer.py:615-628)":
                    self.canon_residual or rounds % self.n_hashes == 0,
                "static_and_bins >= 0 (hept_tpu/ops/bucket_attn.py:351 runs a negative value "
                "as AND bins)": self.static_and_bins >= 0,
                "transport_groups >= 1 (hept_tpu/models/transformer.py:652 runs a smaller "
                "value as 1)": g >= 1,
                "transport_groups not with canon_residual (sigma is the groups' own storage "
                "order; hept_tpu/models/transformer.py:653-654)":
                    g == 1 or not self.canon_residual,
                "transport_groups needs unsort_rows (hept_tpu/models/transformer.py:655)":
                    g == 1 or bool(self.unsort_rows),
                "transport_groups divides block_size (hept_tpu/models/transformer.py:656)":
                    self.block_size % g == 0,
            })
        else:
            need.update({
                # JAX reads neither without a plan (hept_tpu/models/transformer.py:600-708)
                "transport_groups == 1 without static_keys (JAX ignores it there; ROADMAP.md, "
                "queue 1, 'Not queued')": self.transport_groups == 1,
                "static_and_bins == 0 without static_keys (JAX ignores it there; ROADMAP.md, "
                "queue 1, 'Not queued')": self.static_and_bins == 0,
            })
            # dynamic keys: the reference-parity path (per-head keys, q/k/v
            # projected before the sort) and the post-sort paths (keys in
            # [x | coords] space, shared by the heads or per head)
            post = bool(self.qkv_post_sort)
            shared = bool(self.share_heads or self.shared_sort)
            need.update({
                "dynamic keys: share_heads needs qkv_post_sort (the pre-sort path hashes each "
                "head, hept_tpu/models/attention/hept.py:153, 249-262)":
                    post or not self.share_heads,
                "pre-sort dynamic keys (qkv_post_sort off): no shared_sort, gather_sort, "
                "fold_unsort, kernel_bf16 or kernel_center (JAX's pre-sort core takes none of "
                "them and runs as if they were off, hept_tpu/models/attention/hept.py:249-262; "
                "ROADMAP.md, queue 1, 'Not queued')":
                    post or not (self.shared_sort or self.gather_sort or self.fold_unsort
                                 or self.kernel_bf16 or self.kernel_center),
                "kernel_center needs a shared q/k bucket grid (share_heads or shared_sort; "
                "hept_tpu/ops/bucket_attn.py:881-883)": not self.kernel_center or shared,
                "fold_unsort folds the heads of one shared grid: it needs share_heads (JAX's "
                "per-head path ignores it, hept_tpu/ops/bucket_attn.py:1156-1160)":
                    not self.fold_unsort or bool(self.share_heads),
                "share_heads: no head sharding (e2lsh_alpha is one head wide and JAX's "
                "make_tp_train_step shards it over heads, hept_tpu/parallel/tp.py:70-72; its "
                "shard_map refuses it: \"ValueError: shard_map applied to the function "
                "'local_loss' was given argument arrays with axis sizes that are not evenly "
                "divisible by the corresponding mesh axis sizes\", on e2lsh_alpha)":
                    not (self.share_heads and self.head_shards > 1),
                "dynamic keys: sort_events == 1 (the dynamic-key core sorts the whole flat "
                "row; hept_tpu/ops/bucket_attn.py:216, hept_attention_core_cols, takes no "
                "sort_events)": self.sort_events == 1,
            })
        if bucket:
            # hept_tpu/models/attention/hept.py:174-179, and what the port
            # refuses besides: JAX's bucket step has no TP, and its bucket
            # core runs f32 whatever the kernel flags say
            need.update({
                "bucket shards: the dynamic-key share_heads path (qkv_post_sort + share_heads, "
                "no static plan; hept_tpu/models/attention/hept.py:174-175)":
                    bool(self.share_heads) and not self.static_keys,
                "bucket shards: f32 transport (no sort_pack / unsort_pack; "
                "hept_tpu/models/attention/hept.py:176-178)":
                    not (self.sort_pack or self.unsort_pack),
                "bucket shards: f32 kernels (no kernel_bf16 / kernel_center: JAX's bucket core "
                "ignores them and runs f32, hept_tpu/parallel/bp.py:152-162)":
                    not (self.kernel_bf16 or self.kernel_center),
                "bucket shards: no gather_sort / fold_unsort (JAX's bucket core, "
                "hept_tpu/parallel/bp.py:49-51, takes neither)":
                    not (self.gather_sort or self.fold_unsort),
                "bucket shards: sort_events == 1 (the bucket SP shards one event; "
                "hept_tpu/models/attention/hept.py:179)":
                    self.sort_events == 1,
                "bucket shards: no head / hash sharding (hept_tpu/parallel/bp.py:261, "
                "make_bucket_train_step, has no TP)": not tp,
                "bucket_transport in ('replicated', 'distributed') (hept_tpu/parallel/bp.py:82)":
                    self.bucket_transport in ("replicated", "distributed"),
            })
        self._refuse(need)

    @staticmethod
    def _refuse(need: dict) -> None:
        missing = [k for k, ok in need.items() if not ok]
        if missing:
            raise NotImplementedError(
                "the port runs the static-plan and the dynamic-key HEPT paths and the seven "
                "baseline attentions only; unsupported: " + ", ".join(missing)
            )


def permute_rows(arr: torch.Tensor, src1: torch.Tensor, inv1: torch.Tensor,
                 n_ev: int) -> torch.Tensor:
    """out[j] = arr[src1[j]] within each of n_ev event rows, differentiable
    (the backward gathers by inv1): the canon_residual / transport-groups
    entry and exit (JAX's `_permute_rows`, `hept_tpu/models/transformer.py:
    223-234`), one row gather (K5 on CUDA tensors). arr (n, d); src1, inv1
    (1, n_ev, n / n_ev)."""
    n, d = arr.shape
    out = permute_gather_rows(arr.reshape(n_ev, n // n_ev, d), src1.reshape(n_ev, -1),
                              inv1.reshape(n_ev, -1))
    return out.reshape(n, d)


def prepare_event(x, coords, valid, regions, block_size: int, groups: dict | None = None,
                  padding_mode: str = "replicate"):
    """Per-event precompute of the AND codes and the padding plan.

    replicate (the reference example's mode): AND codes from quantile
    regions of the event's real points, then trailing-bucket pad slots copy
    real rows by sorted code rank and slots beyond ceil(n/B)*B become inert.
    Under head / hash sharding (`groups`) the pad plan is taken from global
    hash 0 / head 0's codes, broadcast from rank 0 of the heads group and
    then of the hashes group, so that every shard pads alike (JAX:
    `hept_tpu/models/transformer.py:843-846`).

    zero (the reference's src variant, `hept_tpu/models/transformer.py:
    821-826`): the regions rank over the padded length with the pads last,
    the codes are `geo_code`'s floats, every pad is invalid and its coords
    are zeroed; nothing is gathered, so a shard needs nothing of another.

    Returns (x, coords, codes (c, h, N) int32 or float32, invalid (N,) bool).
    """
    if padding_mode == "zero":
        region_eta, region_phi = region_codes(coords, regions, valid_mask=valid)
        codes = geo_code(region_eta, region_phi, regions)
        coords = torch.where(valid[:, None], coords, torch.zeros_like(coords))
        return x, coords, codes, torch.logical_not(valid)
    n_valid = valid.sum()
    region_eta, region_phi = region_codes(coords, regions, valid_mask=valid, n_points=n_valid)
    packed = bit_shift(region_eta.to(torch.int32), region_phi.to(torch.int32))
    c, _, h = regions.shape
    codes = packed.reshape(c, h, -1)
    code00 = codes[0, 0]
    if groups:
        code00 = broadcast(broadcast(code00, groups.get("heads")), groups.get("hashes"))
    code00 = torch.where(valid, code00, torch.iinfo(torch.int32).max)
    sorted_code_idx = torch.argsort(code00, stable=True)
    gather, _, inert = replication_pad_plan(n_valid, x.shape[0], block_size, sorted_code_idx)
    x = torch.where(inert[:, None], torch.zeros_like(x), x[gather])
    coords = torch.where(inert[:, None], torch.zeros_like(coords), coords[gather])
    return x, coords, codes[..., gather], inert


def prepare_baseline(coords, valid, cfg: TransformerConfig):
    """Per-event precompute of the baselines: invalid coords zeroed, no
    padding plan; pct also gets its kNN graph (`knn_graph`, on the coords
    before zeroing). Returns (coords, invalid, edges, edge_mask); the last
    two are None but for pct."""
    edges = edge_mask = None
    if cfg.attn_type == "pct":
        edges, edge_mask = knn_graph(coords, valid, cfg.knn_k)
    coords = torch.where(valid[:, None], coords, torch.zeros_like(coords))
    return coords, torch.logical_not(valid), edges, edge_mask


class PELearned(nn.Module):
    """Learned absolute positional embedding: Linear, LayerNorm, ReLU,
    Linear."""

    def __init__(self, coords_dim: int, h_dim: int, generator=None, device=None):
        super().__init__()
        self.lin0 = TorchLinear(coords_dim, h_dim, generator=generator, device=device)
        self.norm = layer_norm(h_dim, device)
        self.lin1 = TorchLinear(h_dim, h_dim, generator=generator, device=device)

    def forward(self, coords):
        return self.lin1(torch.relu(self.norm(self.lin0(coords))))


class PESinusoidal(nn.Module):
    """Fixed sinusoidal embedding of the binned (eta, phi): per axis, sin /
    cos interleaved at temperature-scaled frequencies, zero-padded to h_dim."""

    def __init__(self, h_dim: int, pos_temperature: float = 10000.0, bins: int = 1000):
        super().__init__()
        self.h_dim, self.pos_temperature, self.bins = h_dim, pos_temperature, bins

    def forward(self, coords):
        dis = discretize_coords(coords[:, :2], self.bins)
        pos_length = (self.h_dim // 4) * 2
        freqs = torch.arange(pos_length, dtype=torch.float32, device=coords.device)
        inv_freq = self.pos_temperature ** (2 * torch.div(freqs, 2, rounding_mode="floor")
                                            / pos_length)

        def enc(t):  # (n,) -> (n, pos_length)
            p = t[:, None] / inv_freq[None, :]
            return torch.stack([torch.sin(p[:, ::2]), torch.cos(p[:, 1::2])],
                               dim=-1).reshape(t.shape[0], -1)

        pe = torch.cat([enc(dis[:, 0]), enc(dis[:, 1])], dim=-1)
        gap = self.h_dim - pe.shape[-1]
        if gap > 0:
            pe = torch.cat([pe, pe.new_zeros((pe.shape[0], gap))], dim=-1)
        return pe


def make_attention(cfg: TransformerConfig, generator=None, device=None,
                   groups: dict | None = None) -> nn.Module:
    """The attention module of `cfg.attn_type` (`groups`: hept's shard
    groups under tensor or bucket-axis parallelism)."""
    common = dict(h_dim=cfg.h_dim, num_heads=cfg.num_heads, generator=generator, device=device)
    t = cfg.attn_type
    if t == "hept":
        return HeptAttention(cfg, generator, device, groups)
    if t == "performer":
        return PerformerAttention(nb_features=cfg.nb_features, num_w_per_dist=cfg.num_w_per_dist,
                                  coords_dim=cfg.coords_dim, pe_type=cfg.pe_type, **common)
    if t == "flt":
        return FLTAttention(nb_features=cfg.nb_features, nb_features_inner=cfg.nb_features_inner,
                            num_w_per_dist=cfg.num_w_per_dist, coords_dim=cfg.coords_dim,
                            **common)
    if t == "reformer":
        return ReformerAttention(bucket_size=cfg.bucket_size, n_hashes=cfg.n_hashes,
                                 allow_duplicate_attention=cfg.allow_duplicate_attention,
                                 attend_across_buckets=cfg.attend_across_buckets, **common)
    if t == "smyrf":
        return SmyrfAttention(bucket_size=cfg.bucket_size, n_hashes=cfg.n_hashes,
                              num_w_per_dist=cfg.num_w_per_dist, coords_dim=cfg.coords_dim,
                              pe_type=cfg.pe_type, **common)
    if t == "sb":
        return SBAttention(bucket_size=cfg.bucket_size, n_hashes=cfg.n_hashes,
                           nb_features=cfg.nb_features, **common)
    if t == "pct":
        return PCTAttention(coords_dim=cfg.coords_dim, **common)
    if t == "flatformer":
        return FlatformerAttention(group_size=cfg.bucket_size, num_w_per_dist=cfg.num_w_per_dist,
                                   b_grid=cfg.b_grid, num_slices_per_axis=cfg.num_slices_per_axis,
                                   pe_type=cfg.pe_type, **common)
    raise NotImplementedError(t)


class AttnBlock(nn.Module):
    """One attention block, in one of three forms:
    - hept and the q/k/v baselines: pre-LN; on hept's static plan the q/k/v
      kernels are applied after the plan's gather inside the attention core,
      with dynamic keys (and for the baselines, on x + pe) they project
      before; then residual, pre-LN FF, residual, each with dropout;
    - pct: the attention takes w_q(norm1(x)) alone;
    - flatformer: four post-norm group layers replace the whole block, which
      returns (x, [their four outputs])."""

    def __init__(self, cfg: TransformerConfig, generator=None, device=None,
                 groups: dict | None = None):
        super().__init__()
        self.cfg = cfg
        self.head_group = (groups or {}).get("heads")
        self.hash_group = (groups or {}).get("hashes")
        h, d = cfg.num_heads, cfg.h_dim
        rpe_in = cfg.num_w_per_dist * (cfg.coords_dim - 1)
        self.w_rpe = nn.Parameter(torch.empty((h * d, rpe_in), device=device))
        uniform_(self.w_rpe, 1.0 / math.sqrt(rpe_in), generator)
        self.pe = None
        if cfg.attn_type != "hept":
            if cfg.pe_type == "learned":
                self.pe = PELearned(cfg.coords_dim, d, generator, device)
            elif cfg.pe_type == "fixed":
                self.pe = PESinusoidal(d)
        if cfg.attn_type == "flatformer":
            self.attn = make_attention(cfg, generator, device)
            return
        self.norm1 = layer_norm(d, device)
        self.w_q = TorchLinear(d, h * d, bias=False, generator=generator, device=device)
        if cfg.attn_type != "pct":
            self.w_k = TorchLinear(d, h * d, bias=False, generator=generator, device=device)
            self.w_v = TorchLinear(d, h * d, bias=False, generator=generator, device=device)
        self.attn = make_attention(cfg, generator, device, groups)
        self.norm2 = layer_norm(d, device)
        self.ff = FeedForward(d, generator, device)

    def _heads(self, lin: TorchLinear) -> torch.Tensor:
        # nn.Linear weight (h*d, d) -> kernel (d, h*d) -> (h, d, d) head-major
        h, d = self.cfg.num_heads, self.cfg.h_dim
        return lin.weight.t().reshape(d, h, d).permute(1, 0, 2)

    def forward(self, x, coords, codes, invalid, plan, generator=None, perms=None,
                record_perms=None, valid=None, edges=None, edge_mask=None, rotations=None):
        """`valid`, `edges`, `edge_mask` and `rotations` are the baselines':
        the real rows, pct's graph, and an override of the LSH baselines'
        random draws (`models/attention/draws.py`); `perms` / `record_perms`
        impose / record hept's dynamic keys' and the LSH baselines' sort
        orders."""
        t = self.cfg.attn_type
        pe = None if self.pe is None else self.pe(coords)
        if t == "flatformer":
            return self.attn(x, coords, coords if pe is None else pe, valid, self.w_rpe)
        if t == "pct":
            aggr = self.attn(self.w_q(self.norm1(x)), coords, valid, edges, edge_mask)
        else:
            xn = self.norm1(x if pe is None else x + pe)
            if t == "hept" and self.cfg.qkv_post_sort:
                # the replicated normed state is sorted and projected on
                # this rank's (round, head) slice: its gradient is summed
                # over the head and the hash shards
                xn = copy_to_group(copy_to_group(xn, self.head_group), self.hash_group)
                aggr = self.attn.forward_post_sort(xn, coords, codes, invalid, plan, self.w_rpe,
                                                   self._heads(self.w_q), self._heads(self.w_k),
                                                   self._heads(self.w_v), perms, record_perms)
            elif t == "hept":
                # the replicated normed state feeds this rank's heads: its
                # gradient is summed over the head shards
                xn = copy_to_group(xn, self.head_group)
                aggr = self.attn.forward_dynamic(self.w_q(xn), self.w_k(xn), self.w_v(xn),
                                                 coords, codes, invalid, self.w_rpe, perms,
                                                 record_perms)
            else:
                aggr = self._baseline(self.w_q(xn), self.w_k(xn), self.w_v(xn), coords, valid,
                                      generator, rotations, perms, record_perms)
        x = x + dropout(aggr, self.cfg.dropout, generator)
        ff = self.ff(self.norm2(x))
        return x + dropout(ff, self.cfg.dropout, generator)

    def _baseline(self, q, k, v, coords, valid, generator, rotations, perms, record_perms):
        t = self.cfg.attn_type
        if t in LSH_BASELINES:
            extra = {"coords": coords, "w_rpe": self.w_rpe} if t == "smyrf" else {}
            return self.attn(q, k, v, valid=valid, rotations=rotations, generator=generator,
                             perms=perms, record_perms=record_perms, **extra)
        return self.attn(q, k, v, coords, valid, self.w_rpe)


class HeptTransformer(nn.Module):
    """Single-event HEPT transformer, on a static bucket plan or with dynamic
    per-layer keys (`cfg.static_keys`), or one of the baseline attentions
    (`cfg.attn_type`).

    `generator` seeds the initial weights and the frozen constants
    (`regions`, `static_alpha` on the static plan, each layer's
    `e2lsh_alpha`; the baselines' projection matrices).
    """

    def __init__(self, cfg: TransformerConfig, generator: torch.Generator | None = None,
                 device=None, groups: dict | None = None):
        super().__init__()
        cfg.check_supported()
        self.cfg = cfg
        self.groups = groups
        self.total_rounds = cfg.static_rounds or cfg.n_hashes
        if cfg.attn_type == "hept":
            self.register_buffer("regions", get_regions(
                generator, cfg.num_regions, cfg.n_hashes, cfg.num_heads, cfg.num_and_hashes,
                device=device))
        in_dim = cfg.in_dim
        if cfg.task == "pileup":
            # flax's nn.Embed default init (default_embed_init):
            # variance_scaling(1.0, "fan_in", "normal", out_axis=0), where
            # fan_in is the embedding width and jax's "normal" is the
            # untruncated normal: N(0, 1 / PID_DIM)
            self.pids_enc = nn.Embedding(NUM_PIDS, PID_DIM, device=device)
            with torch.no_grad():
                nn.init.normal_(self.pids_enc.weight, 0.0, math.sqrt(1.0 / PID_DIM),
                                generator=generator)
            in_dim = cfg.in_dim - 1 + PID_DIM
        self.feat_enc_0 = TorchLinear(in_dim, cfg.h_dim, generator=generator, device=device)
        self.feat_enc_1 = TorchLinear(cfg.h_dim, cfg.h_dim, generator=generator, device=device)
        if cfg.attn_type == "hept" and cfg.static_keys:
            # a second row of directions for static_and_bins' AND bin
            self.register_buffer("static_alpha", e2lsh_init(
                generator, 2 if cfg.static_and_bins else 1, cfg.h_dim + cfg.coords_dim,
                self.total_rounds, device=device))
        self.blocks = nn.ModuleList(
            AttnBlock(cfg, generator, device, groups) for _ in range(cfg.n_layers)
        )
        # flatformer's blocks each give four outputs to the head
        per_block = 4 if cfg.attn_type == "flatformer" else 1
        self.W = TorchLinear(cfg.h_dim * (per_block * cfg.n_layers + 1), cfg.h_dim // 2,
                             bias=False, generator=generator, device=device)
        self.mlp_out = OutMLP(cfg.h_dim // 2, cfg.h_dim // 2, generator=generator,
                              device=device)
        if cfg.task == "pileup":
            self.out_proj = TorchLinear(cfg.h_dim // 2, cfg.num_classes, generator=generator,
                                        device=device)

    @property
    def out_width(self) -> int:
        """Width of the output: the embedding (tracking) or the classes."""
        return self.cfg.num_classes if self.cfg.task == "pileup" else self.cfg.h_dim // 2

    def build_plan(self, h, coords, codes, invalid):
        """The once-per-step plan of `total_rounds` rounds (`static_hash` of
        the encoder output and coords, or of the coords alone; AND codes of
        head 0, cycled over the rounds, or under canon_residual's pinned
        scheme round 0's row and then rows 1.. cycled), the tuple of
        `static_bucket_plan`: 3 arrays, 5 under canon_residual, 7 with
        transport groups."""
        cfg = self.cfg
        nh = cfg.n_hashes
        scale = float(math.sqrt(2.0 * cfg.num_w_per_dist))
        hashed = static_hash(h.t(), coords.t(), self.static_alpha, scale,
                             "coords" if cfg.static_keys == "coords" else "x0",
                             cfg.static_and_bins)
        if cfg.canon_residual and self.total_rounds != nh:
            rows = [0] + [1 + t % (nh - 1) for t in range(self.total_rounds - 1)]
        else:
            rows = [t % nh for t in range(self.total_rounds)]
        codes0 = codes[:, 0][torch.as_tensor(rows, device=codes.device)]
        return static_bucket_plan(hashed, codes0, invalid, coords.t(),
                                  sort_events=cfg.sort_events, sort_pack=cfg.sort_pack,
                                  coords_f32=cfg.kernel_center, canonical=cfg.canon_residual,
                                  group_size=cfg.transport_groups)

    def layer_plan(self, plan, layer: int):
        """Layer `layer`'s n_hashes rounds of the plan: rounds (layer * nh +
        j) % total_rounds, or under canon_residual round 0 and nh - 1 rounds
        cycled over 1..total_rounds - 1 (round 0 stays each layer's
        canonical round)."""
        nh, total = self.cfg.n_hashes, self.total_rounds
        if self.cfg.canon_residual and total != nh:
            rounds = [0] + [1 + (layer * (nh - 1) + j) % (total - 1) for j in range(nh - 1)]
        else:
            rounds = [(layer * nh + j) % total for j in range(nh)]
        idx = torch.as_tensor(rounds, device=plan[0].device)
        return tuple(a[idx] for a in plan)

    def _block(self, block: AttnBlock, h, generator, perms, record_perms, **kw):
        """One block. Under `use_ckpt` with autograd on, the block runs under
        `torch.utils.checkpoint` and is recomputed in the backward (JAX's
        `_remat_block`, the reference's use_ckpt). The checkpoint replays
        only the global RNGs, so both runs draw their dropout masks and LSH
        draws from a generator set to a snapshot of `generator` taken before
        the block, and `generator` is then left where the block left it, as
        a plain forward leaves it. The sort orders the first run records
        are imposed on the recompute, and recorded once."""
        if not (self.cfg.use_ckpt and torch.is_grad_enabled()):
            return block(h, generator=generator, perms=perms, record_perms=record_perms, **kw)
        state = None if generator is None else generator.get_state()
        seen, first = [], []

        def run(h_):
            gen = None
            if state is not None:
                gen = torch.Generator(device=generator.device)
                gen.set_state(state)
            if not first:  # the forward
                out = block(h_, generator=gen, perms=perms, record_perms=seen, **kw)
                first.append(gen)
                return out
            return block(h_, generator=gen, perms=seen[0] if seen else perms, **kw)

        out = checkpoint(run, h, use_reentrant=False)
        if record_perms is not None:
            record_perms.extend(seen)
        if generator is not None:
            generator.set_state(first[0].get_state())
        return out

    def forward(self, x, coords, valid, generator: torch.Generator | None = None,
                plan=None, perms=None, record_perms: list | None = None,
                rotations: list | None = None, prepared=None):
        """`generator` draws the dropout masks (no generator: no dropout)
        and the LSH baselines' random rotations (no generator: a fixed
        draw). Static plan: `plan` overrides the step's bucket plan of
        `total_rounds` rounds, the tuple `build_plan` builds.
        Dynamic keys: `perms` overrides each layer's (q_src, k_src)
        permutations, and `record_perms` (a list) receives them, one pair
        per layer (shared by the heads: one (c, n) src a layer). Reformer /
        smyrf / sb: `rotations` overrides each layer's
        random draws (a list, one entry per layer), and `perms` /
        `record_perms` do the same for their sort orders (reformer's
        bucket order, smyrf's and sb's (q, k) orders). `prepared`: hept's
        (x, coords, codes, invalid) from outside (`make_flat_batched_apply`),
        which skips `prepare_event`."""
        cfg = self.cfg
        if x.shape[0] % (cfg.block_size * cfg.sort_events):
            raise ValueError("N must be a multiple of block_size (times sort_events)")
        codes = edges = edge_mask = None
        if prepared is not None:
            x, coords, codes, invalid = prepared
        elif cfg.attn_type == "hept":
            x, coords, codes, invalid = prepare_event(x, coords, valid, self.regions,
                                                      cfg.block_size, self.groups,
                                                      cfg.padding_mode)
        else:
            coords, invalid, edges, edge_mask = prepare_baseline(coords, valid, cfg)
        if cfg.task == "pileup":
            # after the padding plan: replication pads carry their source
            # row's PID, inert slots PID 0
            pids = torch.clamp(x[:, -1].to(torch.int32), 0, NUM_PIDS - 1)
            x = torch.cat([x[:, :-1], self.pids_enc(pids)], dim=-1)
        h = self.feat_enc_1(torch.relu(self.feat_enc_0(x)))
        static = cfg.attn_type == "hept" and cfg.static_keys
        entry = None
        if static:
            if plan is None:
                plan = self.build_plan(h, coords, codes, invalid)
            if cfg.transport_groups > 1:
                entry, plan = plan[5:7], plan[:5]
            elif cfg.canon_residual:
                entry = plan[0][:1], plan[1][:1]  # global round 0
            if entry is not None:
                # the residual stream and the pad mask ride in round 0's (or
                # sigma's) order from here to the head
                h = permute_rows(h, entry[0], entry[1], cfg.sort_events)
                invalid = torch.gather(invalid.reshape(cfg.sort_events, -1), 1,
                                       entry[0][0]).reshape(-1)
        layers = [h]
        for i, block in enumerate(self.blocks):
            out = self._block(block, h, generator, perms=None if perms is None else perms[i],
                              record_perms=record_perms, coords=coords, codes=codes,
                              invalid=invalid, plan=self.layer_plan(plan, i) if static else None,
                              valid=valid, edges=edges, edge_mask=edge_mask,
                              rotations=None if rotations is None else rotations[i])
            if cfg.attn_type == "flatformer":
                h, inner = out
                layers.extend(inner)
            else:
                h = out
                layers.append(h)
        out = self.W(torch.cat(layers, dim=-1))
        out = out + dropout(self.mlp_out(out), cfg.dropout, generator)
        if cfg.task == "pileup":
            out = torch.sigmoid(self.out_proj(out))
        if entry is not None:
            out = permute_rows(out, entry[1], entry[0], cfg.sort_events)  # back to point order
        return out


def make_batched_apply(model: nn.Module):
    """A batch of events one at a time (the JAX package vmaps the
    single-event model; an eager loop runs the same math), for any
    single-event model taking (x, coords, valid, generator), the GNNs too:
    apply(x (B, N, F), coords (B, N, C), valid (B, N), generator) ->
    (B, N, out). The generator's draws follow event order."""

    def apply(x, coords, valid, generator=None):
        return torch.stack([model(x[i], coords[i], valid[i], generator)
                            for i in range(x.shape[0])])

    return apply


def make_flat_batched_apply(model: HeptTransformer):
    """Flat batching for HEPT (`hept_tpu/models/transformer.py:882-955`):
    each event is prepared on its own (its quantile regions and replication
    pads), then the B events run as ONE forward of B * N points.

    Without `sort_events` the batch index is packed above each AND code
    (`bit_shift`), so buckets never cross events: an event's real rows and
    replication pads fill whole buckets and its inert slots sort to the end
    (the reference example's batched design). With `cfg.sort_events == B`
    (static plan only) each event is its own sort row of the plan and the
    codes stay as they are. Replicate padding only: a zero-mode pad would
    sort to the global end and leave an event's span unaligned to buckets.

    Returns apply(x (B, N, F), coords (B, N, C), valid (B, N), generator) ->
    (B, N, out); one generator draws the flat forward's dropout.
    """
    cfg = model.cfg
    if cfg.attn_type != "hept":
        raise ValueError("flat batching targets the HEPT path")
    if cfg.padding_mode != "replicate":
        raise ValueError("flat batching requires padding_mode='replicate'")

    def apply(x, coords, valid, generator=None):
        b, n = x.shape[:2]
        if cfg.sort_events > 1 and cfg.sort_events != b:
            raise ValueError(f"model built for sort_events={cfg.sort_events}, got B={b}")
        preps = [prepare_event(x[i], coords[i], valid[i], model.regions, cfg.block_size,
                               model.groups) for i in range(b)]
        xp = torch.cat([p[0] for p in preps])
        cp = torch.cat([p[1] for p in preps])
        codes = torch.stack([p[2] for p in preps])  # (B, c, h, n)
        c, h = codes.shape[1:3]
        codes = codes.permute(1, 2, 0, 3).reshape(c * h, b * n)
        if cfg.sort_events == 1:
            batch_idx = torch.arange(b, dtype=torch.int32, device=x.device).repeat_interleave(n)
            codes = bit_shift(codes, batch_idx.expand(c * h, b * n))
        prepared = (xp, cp, codes.reshape(c, h, b * n), torch.cat([p[3] for p in preps]))
        out = model(xp, cp, valid.reshape(b * n), generator, prepared=prepared)
        return out.reshape(b, n, -1)

    return apply
