"""Segmented reductions over axis 0 (port of `hept_tpu/ops/segment.py`).

The PCT attention's per-destination softmax and sum, and the GNNs' sums and
means, over an edge list. `segment_sum` takes on each device the call that
gives the same bits on every call: `index_put_(accumulate=True)` on the
card, which sums each segment in sorted-index order (`index_add_` sums with
atomics there), and `index_add` on the CPU (where `index_put_` with
accumulate adds floats with atomics from several threads once the input
holds 32768 elements or more). So a step can be compared with another at
f32 rounding, and a restored checkpoint re-evaluates to the same metrics;
the CPU's and the card's bits may differ, within float32 rounding. Empty
segments give 0 (sum, mean) or -inf (max, floats), as in JAX.
"""

from __future__ import annotations

import torch


def _rows(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """(E,) -> (E, 1, ...) broadcasting over the trailing axes of an ndim array."""
    return t.reshape((-1,) + (1,) * (ndim - 1))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    ids = segment_ids.to(torch.int64)
    if data.is_cuda:
        return out.index_put_((ids,), data, accumulate=True)
    return out.index_add(0, ids, data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean per segment; empty segments yield 0."""
    if weights is None:
        weights = torch.ones(data.shape[0], dtype=data.dtype, device=data.device)
    w = _rows(weights, data.ndim)
    total = segment_sum(data * w, segment_ids, num_segments)
    count = segment_sum(w.expand(data.shape[:1] + (1,) * (data.ndim - 1)), segment_ids,
                        num_segments)
    return total / torch.clamp(count, min=1e-12)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Max per segment; empty segments yield the dtype's lowest value (-inf
    for floats)."""
    low = -torch.inf if data.is_floating_point() else torch.iinfo(data.dtype).min
    out = torch.full((num_segments,) + tuple(data.shape[1:]), low, dtype=data.dtype,
                     device=data.device)
    idx = _rows(segment_ids.to(torch.int64), data.ndim).expand(data.shape)
    return out.scatter_reduce(0, idx, data, "amax", include_self=True)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax within segments over axis 0; `mask` marks valid entries (the
    rest get probability 0). The shift by the segment max is taken without
    its gradient: the softmax does not depend on it."""
    if mask is not None:
        logits = torch.where(_rows(mask, logits.ndim), logits, -torch.inf)
    with torch.no_grad():
        seg_max = segment_max(logits, segment_ids, num_segments)
        seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
    ids = segment_ids.to(torch.int64)
    ex = torch.exp(logits - seg_max[ids])
    if mask is not None:
        ex = torch.where(_rows(mask, ex.ndim), ex, torch.zeros_like(ex))
    denom = segment_sum(ex, ids, num_segments)
    return ex / torch.clamp(denom[ids], min=1e-16)
