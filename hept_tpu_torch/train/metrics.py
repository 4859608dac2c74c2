"""Task metrics (port of `hept_tpu/train/metrics.py`).

Tracking: kNN-retrieval accuracy / precision / recall at pT thresholds: each
scored point retrieves its K+1 nearest neighbours in the embedding space
(itself first), drops itself, and counts the neighbours of its own cluster.
The distance blocks are tiled over queries (`ops/knn.py`), so a 60k-point
event never holds an N x N matrix.

Pileup: average precision, ROC-AUC and F1 at 0.5 of the classifier's
probabilities (`binary_classification_metrics`), in numpy on the host, with
scikit-learn's definitions (the JAX package calls scikit-learn, which the
port does not need).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.knn import knn_brute_force

THRESHOLDS = (0.0, 0.5, 0.9)


def point_filter(cluster_ids, recons, pts, pt_thres):
    """Points that count: a real track, reconstructable, above the pT cut."""
    return (cluster_ids != 0) & (recons != 0) & (pts > pt_thres)


def _retrieval_scores(embeddings, cluster_ids, valid, k: int, tile: int):
    """Per-point (acc, prec, recall, scorable) before any eval mask.

    Cluster sizes count valid points only; k_i = min(size - 1, k) is a
    point's true-neighbour count, and a point with k_i = 0 is not scored.
    """
    n = embeddings.shape[0]
    cid = cluster_ids.to(torch.int64)
    sizes = torch.zeros(n, dtype=torch.int64, device=cid.device).index_add_(
        0, cid, valid.to(torch.int64))
    k_i = torch.clamp_max(sizes[cid] - 1, k)
    kk = min(k + 1, n)  # events smaller than K+1 retrieve all points
    _, idx = knn_brute_force(embeddings, embeddings, kk, valid=valid, tile=tile)
    nbrs = idx[:, 1:]  # drop self, the nearest
    matches = cid[nbrs] == cid[:, None]  # (n, kk - 1)
    if kk - 1 < k:
        matches = torch.nn.functional.pad(matches, (0, k - (kk - 1)))
    within_k = torch.arange(k, device=cid.device)[None, :] < k_i[:, None]
    m_total = matches.sum(dim=1)
    m_at_k = (matches & within_k).sum(dim=1)
    kf = torch.clamp_min(k_i, 1).to(torch.float32)
    acc = m_at_k.to(torch.float32) / kf
    prec = m_total.to(torch.float32) / float(k)
    recall = m_total.to(torch.float32) / kf
    return acc, prec, recall, (k_i > 0) & valid


def _knn_retrieval_scores(embeddings, cluster_ids, eval_mask, valid, k: int = 19,
                          tile: int = 2048):
    """Per-point scores of one event.

    Args:
      embeddings: (N, d); cluster_ids: (N,) dense ids (0 = noise);
      eval_mask: (N,) points to score; valid: (N,) real (unpadded) points.
    Returns:
      (acc, prec, recall, include): (N,) tensors; `include` marks the
      scored points (eval_mask & k_i > 0 & valid).
    """
    acc, prec, recall, scorable = _retrieval_scores(embeddings, cluster_ids, valid, k, tile)
    return acc, prec, recall, eval_mask & scorable


def _masked_means(scores, include) -> torch.Tensor:
    denom = torch.clamp_min(include.sum(), 1).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=include.device)
    return torch.stack([torch.where(include, s, zero).sum() / denom for s in scores])


def acc_and_pr_at_k(embeddings, cluster_ids, mask, valid=None, k: int = 19,
                    tile: int = 2048) -> tuple[float, float, float]:
    """Mean retrieval accuracy / precision / recall at K over the masked
    points (K = 19: K + 1 = 20 neighbours are retrieved)."""
    if valid is None:
        valid = torch.ones(embeddings.shape[0], dtype=torch.bool, device=embeddings.device)
    acc, prec, recall, include = _knn_retrieval_scores(embeddings, cluster_ids, mask, valid,
                                                       k=k, tile=tile)
    return tuple(float(v) for v in _masked_means((acc, prec, recall), include))


def tracking_metrics_batch(embeddings, cluster_ids, recons, pts, valid, k: int = 19,
                           tile: int = 2048) -> torch.Tensor:
    """Retrieval metrics of a (B, N, .) event batch at every pT threshold.

    The neighbour lists do not depend on the threshold, so each event's kNN
    runs once and the three masks are scored from it (the JAX package runs
    it once per threshold; the numbers are the same).

    Returns (B, 3 thresholds, 3 metrics) float32 on the input's device,
    metrics (accuracy, precision, recall), thresholds (0, 0.5, 0.9).
    """
    out = []
    for b in range(embeddings.shape[0]):
        scores = _retrieval_scores(embeddings[b], cluster_ids[b], valid[b], k, tile)
        rows = []
        for thres in THRESHOLDS:
            include = point_filter(cluster_ids[b], recons[b], pts[b], thres) & scores[3]
            rows.append(_masked_means(scores[:3], include))
        out.append(torch.stack(rows))
    return torch.stack(out)


def _binary_clf_curve(targets: np.ndarray, probs: np.ndarray):
    """False and true positives at each distinct threshold, highest first
    (scikit-learn's `_binary_clf_curve`): scores sorted descending by a
    stable sort, ties grouped at their last position."""
    order = np.argsort(probs, kind="mergesort")[::-1]
    s, t = probs[order], targets[order]
    idx = np.r_[np.where(np.diff(s))[0], t.size - 1]
    tps = np.cumsum(t, dtype=np.float64)[idx]
    return 1 + idx - tps, tps


def _average_precision(targets, probs) -> float:
    """sum_n (R_n - R_{n-1}) P_n over distinct thresholds, no interpolation."""
    fps, tps = _binary_clf_curve(targets, probs)
    ps = tps + fps
    precision = np.zeros_like(tps)
    np.divide(tps, ps, out=precision, where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    precision, recall = np.r_[precision[::-1], 1], np.r_[recall[::-1], 0]
    return float(-np.sum(np.diff(recall) * precision[:-1]))


def _roc_auc(targets, probs) -> float:
    """The trapezoid under the ROC curve through its distinct thresholds
    (collinear points dropped, as `roc_curve` does by default)."""
    fps, tps = _binary_clf_curve(targets, probs)
    if len(fps) > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps = fps[keep], tps[keep]
    fpr, tpr = np.r_[0, fps] / fps[-1], np.r_[0, tps] / tps[-1]
    return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())


def binary_classification_metrics(probs, targets) -> dict:
    """AP ("auc", as the reference configs name it), ROC-AUC ("roc") and F1 of
    the strict prediction probs > 0.5 ("f1") over the given points; the
    targets hold both classes."""
    probs = np.asarray(probs).reshape(-1)
    targets = np.asarray(targets).reshape(-1) == 1
    pred = probs > 0.5
    tp = float(np.sum(pred & targets))
    denom = 2 * tp + float(np.sum(pred & ~targets)) + float(np.sum(~pred & targets))
    return {"auc": _average_precision(targets, probs), "roc": _roc_auc(targets, probs),
            "f1": 2 * tp / denom if denom else 0.0}
