"""The tasks' losses: InfoNCE for tracking on the windowed pair layout (port
of the windowed path of `hept_tpu/train/losses.py:infonce_loss`) and the
focal loss for pileup (`focal_loss`)."""

from __future__ import annotations

import torch

from ..ops.pair_ops import anchor_csr, anchor_segment_sum, pair_gather, pair_l2rbf_sim


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
    Returns: scalar loss.
    """
    if dist_metric != "l2_rbf":
        raise NotImplementedError(f"dist_metric {dist_metric}: the port has l2_rbf")
    n = embeddings.shape[0]
    p0, p1 = pairs[0], pairs[1]
    # one CSR of the anchor index for the step's three K4 segment sums
    csr = anchor_csr(p0, n)
    # similarity exp(-|e0 - e1| / (2 sigma^2)); the distance is
    # sqrt(|.|^2 + 1e-12), finite-gradient at zero distance (pad self-pairs)
    sim = pair_l2rbf_sim(embeddings, p0, p1, pair_rev, pair_mask, 0.75, csr)
    logit = sim / tau
    max_sim = torch.max(torch.where(pair_mask, logit, torch.full_like(logit, -torch.inf)))
    exp_sim = torch.exp(logit - max_sim.detach())
    # per-anchor negative mass, looked up per pair
    neg_sum = anchor_segment_sum(torch.where(pair_neg, exp_sim, torch.zeros_like(exp_sim)), p0, n,
                                 csr)
    denominator = pair_gather(neg_sum[:, None], p0, csr)[:, 0]
    loss_per_pair = -torch.log(exp_sim / (exp_sim + denominator + 1e-30) + 1e-30)
    return torch.sum(loss_per_pair * pair_weight)


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
