"""The tasks' losses (port of `hept_tpu/train/losses.py`): InfoNCE for
tracking on the windowed pair layout (`infonce_loss`, the pair kernels K3 /
K4) or on the pair list as packed (`infonce_loss_pairs`, plain indexing and
`ops/segment.py`'s sum, as JAX uses XLA's gather and segment sum there), the triplet
margin loss, and the focal loss for pileup."""

from __future__ import annotations

import torch

from ..ops.pair_ops import (
    anchor_csr,
    anchor_segment_sum,
    pair_gather,
    pair_l2rbf_sim,
    partner_gather,
)
from ..ops.segment import segment_sum

DIST_METRICS = ("l2_rbf", "cosine", "l2_inverse")
SIGMA = 0.75  # the l2_rbf similarity's width


def pair_filter(cluster_ids, pairs, recons, pts, pt_thres: float = 0.9) -> torch.Tensor:
    """Positive-pair eligibility: both ends reconstructable and above the
    pt threshold."""
    p0, p1 = pairs[0].long(), pairs[1].long()
    return (recons[p0] != 0) & (recons[p1] != 0) & (pts[p0] > pt_thres) & (pts[p1] > pt_thres)


def _safe_norm(diff: torch.Tensor) -> torch.Tensor:
    # sqrt(|.|^2 + 1e-12): a finite gradient at zero distance (pad self-pairs)
    return torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)


def similarity(e0: torch.Tensor, e1: torch.Tensor, dist_metric: str) -> torch.Tensor:
    """Per-pair similarity of the rows e0, e1 (E, d)."""
    if dist_metric == "cosine":
        return torch.sum(e0 * e1, dim=-1) / torch.clamp(_safe_norm(e0) * _safe_norm(e1),
                                                        min=1e-8)
    if dist_metric == "l2_rbf":
        return torch.exp(-_safe_norm(e0 - e1) / (2 * SIGMA**2))
    if dist_metric == "l2_inverse":
        return 1.0 / (_safe_norm(e0 - e1) + 1.0)
    raise NotImplementedError(f"dist_metric {dist_metric}: the port has {DIST_METRICS}")


def _loss_per_pair(sim, tau, pair_mask, neg_mask, seg0, gather0) -> torch.Tensor:
    """-log(e / (e + negative mass of the anchor)) per pair, e = exp(sim / tau
    - max); `seg0` sums (E,) values per anchor, `gather0` looks (n,) values
    up per pair."""
    logit = sim / tau
    max_sim = torch.max(torch.where(pair_mask, logit, torch.full_like(logit, -torch.inf)))
    exp_sim = torch.exp(logit - max_sim.detach())
    neg_sum = seg0(torch.where(neg_mask, exp_sim, torch.zeros_like(exp_sim)))
    denominator = gather0(neg_sum)
    return -torch.log(exp_sim / (exp_sim + denominator + 1e-30) + 1e-30)


def infonce_loss(embeddings: torch.Tensor, pairs: torch.Tensor, pair_mask: torch.Tensor,
                 pair_rev: torch.Tensor, pair_weight: torch.Tensor, pair_neg: torch.Tensor,
                 *, tau: float = 0.05, dist_metric: str = "l2_rbf") -> torch.Tensor:
    """Contrastive InfoNCE over windowed supervision pairs.

    Args:
      embeddings: (N, d).
      pairs: (2, E) int32 anchor-sorted windowed pairs (data/batching.py).
      pair_mask: (E,) bool real pairs.
      pair_rev: (E,) reverse-pair index (folds the partner-side backward into
        the anchor-side segment sum).
      pair_weight: (E,) pack-time cluster weights: the per-cluster mean of
        positive-pair losses, averaged over clusters, is one dot product.
      pair_neg: (E,) pack-time negative-pair mask.
      dist_metric: "l2_rbf" (the fused symmetric similarity), "cosine" or
        "l2_inverse" (the anchor rows by K3, the partner rows by
        `partner_gather`, whose backward is K4 too).
    Returns: scalar loss.
    """
    n = embeddings.shape[0]
    p0, p1 = pairs[0], pairs[1]
    # one CSR of the anchor index for all of the step's K4 segment sums
    csr = anchor_csr(p0, n)
    if dist_metric == "l2_rbf":
        sim = pair_l2rbf_sim(embeddings, p0, p1, pair_rev, pair_mask, SIGMA, csr)
    else:
        sim = similarity(pair_gather(embeddings, p0, csr),
                         partner_gather(embeddings, p1, p0, pair_rev, pair_mask, csr),
                         dist_metric)
    loss_per_pair = _loss_per_pair(
        sim, tau, pair_mask, pair_neg, lambda v: anchor_segment_sum(v, p0, n, csr),
        lambda v: pair_gather(v[:, None], p0, csr)[:, 0])
    return torch.sum(loss_per_pair * pair_weight)


def _pos_neg_masks(pairs, pair_mask, cluster_ids, recons, pts, pt_thres):
    """The pair list's masks built in the step: a positive is a real pair of
    one cluster whose ends pass `pair_filter`; every other real pair is a
    negative."""
    p0, p1 = pairs[0].long(), pairs[1].long()
    pos_mask = (cluster_ids[p0] == cluster_ids[p1]) \
        & pair_filter(cluster_ids, pairs, recons, pts, pt_thres) & pair_mask
    return pos_mask, torch.logical_not(pos_mask) & pair_mask


def infonce_loss_pairs(embeddings: torch.Tensor, pairs: torch.Tensor, pair_mask: torch.Tensor,
                       cluster_ids: torch.Tensor, recons: torch.Tensor, pts: torch.Tensor,
                       *, tau: float = 0.05, dist_metric: str = "l2_rbf",
                       pt_thres: float = 0.9) -> torch.Tensor:
    """InfoNCE over the pair list as packed (`windowed_pairs: false`), with
    the masks built in the step (`_pos_neg_masks`): the loss is the mean over
    non-empty clusters of their positive pairs' mean loss. cluster_ids must
    be dense ints in [0, N)."""
    n = embeddings.shape[0]
    p0, p1 = pairs[0].long(), pairs[1].long()
    pos_mask, neg_mask = _pos_neg_masks(pairs, pair_mask, cluster_ids, recons, pts, pt_thres)
    sim = similarity(embeddings[p0], embeddings[p1], dist_metric)
    loss_per_pair = _loss_per_pair(sim, tau, pair_mask, neg_mask,
                                   lambda v: segment_sum(v, p0, n), lambda v: v[p0])
    labels = torch.where(pos_mask, cluster_ids[p0].long(), n - 1)  # pads dumped on a slot
    w = pos_mask.to(embeddings.dtype)
    cluster_sum = segment_sum(loss_per_pair * w, labels, n)
    cluster_cnt = segment_sum(w, labels, n)
    nonempty = cluster_cnt > 0
    cluster_mean = torch.where(nonempty, cluster_sum / torch.clamp(cluster_cnt, min=1),
                               torch.zeros_like(cluster_sum))
    return torch.sum(cluster_mean) / torch.clamp(nonempty.sum(), min=1)


def triplet_margin_loss(embeddings: torch.Tensor, pairs: torch.Tensor, pair_mask: torch.Tensor,
                        cluster_ids: torch.Tensor, recons: torch.Tensor, pts: torch.Tensor,
                        *, margin: float = 0.5, pt_thres: float = 0.9) -> torch.Tensor:
    """Triplet loss: per positive pair max(d - (mean negative distance of
    its anchor) + margin, 0), averaged over the positive pairs."""
    n = embeddings.shape[0]
    p0, p1 = pairs[0].long(), pairs[1].long()
    pos_mask, neg_mask = _pos_neg_masks(pairs, pair_mask, cluster_ids, recons, pts, pt_thres)
    d = _safe_norm(embeddings[p0] - embeddings[p1])
    neg_sum = segment_sum(torch.where(neg_mask, d, torch.zeros_like(d)), p0, n)
    neg_cnt = segment_sum(neg_mask.to(d.dtype), p0, n)
    neg_mean = neg_sum / torch.clamp(neg_cnt, min=1.0)
    per_pair = torch.clamp(d - neg_mean[p0] + margin, min=0.0)
    w = pos_mask.to(d.dtype)
    return torch.sum(per_pair * w) / torch.clamp(torch.sum(w), min=1.0)


def focal_loss(probs: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor | None = None,
               alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Focal binary cross-entropy on probabilities (the model ends in a
    sigmoid): BCE of p clipped to [1e-7, 1 - 1e-7], pt = exp(-BCE), loss
    alpha (1 - pt)^gamma BCE, averaged over the `mask`ed points (at least
    one in the denominator), or over all points without a mask."""
    p = torch.clamp(probs, 1e-7, 1.0 - 1e-7)
    bce = -(targets * torch.log(p) + (1.0 - targets) * torch.log(1.0 - p))
    pt = torch.exp(-bce)
    fl = alpha * (1.0 - pt) ** gamma * bce
    if mask is None:
        return fl.mean()
    fl = torch.where(mask, fl, torch.zeros_like(fl))
    return fl.sum() / torch.clamp(mask.sum(), min=1)
