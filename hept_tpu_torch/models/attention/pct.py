"""Point Cloud Transformer attention, a graph message-passing baseline (port
of `hept_tpu/models/attention/pct.py`, and of the kNN graph that the JAX
package's `_prepare_event` builds for it).

Per edge j -> i: delta = pos_nn(pos_i - pos_j), alpha = attn_nn(lin_src(x)_i
- lin_dst(x)_j + delta), softmaxed per destination and channel; the
message alpha * (lin(x)_j + delta) is summed per destination
(`ops/segment.py`).
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.knn import knn_brute_force
from ...ops.segment import segment_softmax, segment_sum
from ..mlp import TorchLinear


def knn_graph(coords: torch.Tensor, valid: torch.Tensor, k: int):
    """The k nearest neighbours of each point on (eta, phi), itself dropped,
    then one self loop per point: edges (2, n k + n) as [src j, dst i] and
    the edge mask (both ends real)."""
    n = coords.shape[0]
    _, idx = knn_brute_force(coords[:, :2], coords[:, :2], k + 1, valid=valid)
    ar = torch.arange(n, device=coords.device)
    dst = ar.repeat_interleave(k)
    src = idx[:, 1:].reshape(-1)
    edges = torch.stack([torch.cat([src, ar]), torch.cat([dst, ar])])
    edge_mask = torch.cat([valid[src] & valid[dst], valid])
    return edges, edge_mask


class PCTAttention(nn.Module):
    def __init__(self, h_dim: int, num_heads: int, coords_dim: int, generator=None,
                 device=None):
        super().__init__()
        d, hd = h_dim, h_dim * num_heads
        kw = dict(generator=generator, device=device)
        self.lin = TorchLinear(hd, d, bias=False, **kw)
        self.lin_src = TorchLinear(hd, d, bias=False, **kw)
        self.lin_dst = TorchLinear(hd, d, bias=False, **kw)
        self.pos_nn = TorchLinear(coords_dim, d, **kw)
        self.attn_nn = TorchLinear(d, d, **kw)

    def forward(self, x, coords, valid, edges, edge_mask):
        """x (n, h_dim * num_heads), the block's w_q projection; edges (2, E)
        [src, dst] with self loops, edge_mask (E,). Returns (n, h_dim)."""
        n = x.shape[0]
        src, dst = edges[0], edges[1]
        lin, a_src, a_dst = self.lin(x), self.lin_src(x), self.lin_dst(x)
        delta = self.pos_nn(coords[dst] - coords[src])  # pos_i - pos_j
        alpha = self.attn_nn(a_src[dst] - a_dst[src] + delta)
        mask = edge_mask & valid[src] & valid[dst]
        attn = segment_softmax(alpha, dst, n, mask=mask)
        msg = attn * (lin[src] + delta)
        msg = torch.where(mask[:, None], msg, torch.zeros_like(msg))
        return segment_sum(msg, dst, n)
