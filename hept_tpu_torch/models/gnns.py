"""The GNN baselines: the GNNStack backbone with a gated, GCN, DGCNN or
GravNet convolution (port of `hept_tpu/models/gnns.py`).

Message passing is plain PyTorch over padded static edge arrays: gathers by
edge index, then masked segment sums (`ops/segment.py`), as JAX computes it
with `jax.ops.segment_sum` outside any Pallas kernel. The
gated and GCN convolutions run on a fixed kNN graph of (eta, phi)
(`gnn_graph`, rebuilt every forward as JAX rebuilds it inside the jitted
apply); DGCNN and GravNet build a kNN graph in a learned space in every
layer (`ops/knn.py:knn_brute_force`, k + 1 neighbours, column 0 dropped as
JAX drops it: at near-zero distances the expansion |q|^2 - 2 q.p + |p|^2
can rank a close neighbour before the point itself).

The model is defined on ONE event, x (N, in_dim), coords (N, coords_dim),
valid (N,), and returns (N, out_width): embeddings for tracking,
probabilities for pileup.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..ops.knn import knn_brute_force
from ..ops.segment import segment_mean, segment_sum
from .mlp import OutMLP, TorchLinear, dropout, layer_norm

CONVS = ("gatedgnn", "gcn", "dgcnn", "gravnet")
# the convolutions on the fixed (eta, phi) graph; the others build their own
GRAPH_CONVS = ("gatedgnn", "gcn")
# the pileup PID embedding: PIDs 0..6, 10 features each
NUM_PIDS, PID_DIM = 7, 10
# GravNet's projected message width
PROPAGATE_DIM = 32


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    """GNNStack hyperparameters; `build_model` maps the YAMLs' model_kwargs
    (hidden_dim, num_layers, out_dim, graph_k, k, knn_dim) onto them, with
    the JAX trainer's defaults."""

    in_dim: int
    coords_dim: int
    conv_type: str = "gcn"
    task: str = "tracking"
    num_classes: int = 1  # pileup head width
    h_dim: int = 64
    n_layers: int = 4
    out_dim: int | None = None  # tracking embedding width (default h_dim // 2)
    graph_k: int = 16  # degree of the fixed (eta, phi) graph
    k: int = 8  # learned-space neighbours (dgcnn, gravnet)
    knn_dim: int = 4  # learned-space width (dgcnn, gravnet)

    def __post_init__(self):
        if self.conv_type not in CONVS:
            raise NotImplementedError(f"GNN conv {self.conv_type!r}: the port has {CONVS}")
        if self.task not in ("tracking", "pileup"):
            raise NotImplementedError(f"task {self.task!r}")

    @property
    def w_out(self) -> int:
        """Width of the head's W: h_dim // 2 for pileup (then out_proj),
        out_dim or h_dim // 2 for tracking."""
        if self.task == "pileup":
            return self.h_dim // 2
        return self.out_dim or self.h_dim // 2


def gnn_graph(coords: torch.Tensor, valid: torch.Tensor, k: int):
    """The fixed kNN graph of (eta, phi) and its RBF edge inputs: each
    point's k nearest real points, its first neighbour dropped.

    Returns edges (2, n k) as [src (the neighbour), dst (the point)], int64;
    edge_mask (n k,) (both ends real); edge_weight (n k, 1) = -d^2."""
    n = coords.shape[0]
    with torch.no_grad():
        d2, idx = knn_brute_force(coords[:, :2], coords[:, :2], k + 1, valid=valid)
    dst = torch.arange(n, device=coords.device).repeat_interleave(k)
    src = idx[:, 1:].reshape(-1)
    return torch.stack([src, dst]), valid[src] & valid[dst], -d2[:, 1:].reshape(-1, 1)


def learned_knn(s: torch.Tensor, valid: torch.Tensor, k: int, nbrs: torch.Tensor | None,
                record_nbrs: list | None):
    """Each point's k neighbours in the learned space s (n, knn_dim) and the
    squared distances to them, differentiable in s: the k + 1 nearest, the
    first dropped. `nbrs` (n, k) imposes the neighbours (the distances are
    then computed for them with the same expansion); `record_nbrs` receives
    the ones used."""
    if nbrs is None:
        d2, idx = knn_brute_force(s, s, k + 1, valid=valid)
        d2, idx = d2[:, 1:], idx[:, 1:]
    else:
        idx = nbrs.to(device=s.device, dtype=torch.int64)
        sq = torch.sum(s * s, dim=-1)
        d2 = (sq[:, None] - 2.0 * torch.sum(s[:, None, :] * s[idx], dim=-1)) + sq[idx]
        d2 = torch.where(valid[idx], d2, torch.full_like(d2, torch.inf))
    if record_nbrs is not None:
        record_nbrs.append(idx.detach())
    return d2, idx


def _normal_param(shape, generator, device) -> nn.Parameter:
    """flax's normal(1.0) initialiser: N(0, 1)."""
    p = nn.Parameter(torch.empty(shape, device=device))
    with torch.no_grad():
        p.normal_(0.0, 1.0, generator=generator)
    return p


class GatedConv(nn.Module):
    """Gated message passing with (d_eta, d_phi, d_R) edge geometry and a
    global node; mean aggregation."""

    def __init__(self, f: int, h_dim: int, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        msg = 3 * f + 4  # [x_src, x_dst, x_g, d_eta, d_phi, d_R, log n]
        self.edge_weight_w = _normal_param((1, 1), generator, device)
        self.lin_m2 = TorchLinear(msg, 1, **kw)
        self.lin_m5 = TorchLinear(msg + 2 * f + 1, 1, **kw)
        self.lin_m5_g1 = TorchLinear(f, h_dim, **kw)
        self.lin_m5_g2 = TorchLinear(msg, h_dim, **kw)

    def forward(self, x, coords, valid, edges, edge_mask, **_):
        n, f = x.shape
        src, dst = edges[0], edges[1]
        mask = edge_mask & valid[src] & valid[dst]
        eta_phi = coords[:, :2]
        d_ep = eta_phi[src] - eta_phi[dst]  # x_j - x_i
        # phi wrapped into (-pi, pi] from above only, as the reference does
        phi = d_ep[:, 1]
        phi = torch.where(phi > math.pi,
                          phi - torch.ceil((phi - math.pi) / (2 * math.pi)) * 2 * math.pi, phi)
        d_ep = torch.stack([d_ep[:, 0], phi], dim=1)
        d_r = torch.exp(-torch.sum(d_ep**2, dim=1, keepdim=True)
                        / torch.exp(self.edge_weight_w[0, 0]))

        n_valid = torch.clamp(valid.sum(), min=1)
        x_g = torch.where(valid[:, None], x, torch.zeros_like(x)).sum(0) / n_valid
        log_count = torch.log(n_valid.to(torch.float32))

        e = src.shape[0]
        msg = torch.cat([x[src], x[dst], x_g.expand(e, f), d_ep, d_r,
                         log_count.expand(e, 1)], dim=-1)
        msg = msg * torch.sigmoid(self.lin_m2(msg))
        msg = torch.where(mask[:, None], msg, torch.zeros_like(msg))
        aggr = segment_mean(msg, dst, n, weights=mask.to(x.dtype))

        upd = torch.cat([aggr, x, x_g.expand(n, f), log_count.expand(n, 1)], dim=-1)
        g = torch.sigmoid(self.lin_m5(upd))
        return torch.relu(g * self.lin_m5_g1(x) + (1 - g) * self.lin_m5_g2(aggr))


class GCNConv(nn.Module):
    """GCN with learnable RBF edge weights exp(-d^2 / exp(w)), symmetric
    deg^-1/2 normalisation and self loops of weight 1."""

    def __init__(self, f: int, h_dim: int, generator=None, device=None):
        super().__init__()
        self.edge_weight_w = _normal_param((1, 1), generator, device)
        self.lin = TorchLinear(f, h_dim, bias=False, generator=generator, device=device)
        self.bias = nn.Parameter(torch.zeros(h_dim, device=device))

    def forward(self, x, coords, valid, edges, edge_mask, edge_weight, **_):
        n = x.shape[0]
        src, dst = edges[0], edges[1]
        vf = valid.to(x.dtype)
        mask = (edge_mask & valid[src] & valid[dst]).to(x.dtype)
        ew = torch.exp(edge_weight[:, 0] / torch.exp(self.edge_weight_w[0, 0])) * mask
        h = self.lin(x)
        deg = segment_sum(ew, dst, n) + vf
        dinv = torch.rsqrt(torch.clamp(deg, min=1e-12))
        norm = dinv[src] * ew * dinv[dst]
        out = segment_sum(norm[:, None] * h[src], dst, n)
        out = out + (dinv * dinv * vf)[:, None] * h
        return out + self.bias


class DGCNNConv(nn.Module):
    """DynamicEdgeConv on a kNN graph in a learned projection: the edge MLP
    of [x_i, x_j - x_i] (Linear, LayerNorm, ReLU, twice), mean over the k
    neighbours."""

    def __init__(self, f: int, h_dim: int, k: int = 8, knn_dim: int = 4, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.k = k
        self.lin_s = TorchLinear(f, knn_dim, **kw)
        self.nn0 = TorchLinear(2 * f, h_dim, **kw)
        self.ln0 = layer_norm(h_dim, device)
        self.nn1 = TorchLinear(h_dim, h_dim, **kw)
        self.ln1 = layer_norm(h_dim, device)

    def forward(self, x, coords, valid, nbrs=None, record_nbrs=None, **_):
        n, f = x.shape
        _, idx = learned_knn(self.lin_s(x), valid, self.k, nbrs, record_nbrs)
        xi = x[:, None, :].expand(n, self.k, f)
        msg = torch.cat([xi, x[idx] - xi], dim=-1).reshape(n * self.k, 2 * f)
        h = torch.relu(self.ln0(self.nn0(msg)))
        h = torch.relu(self.ln1(self.nn1(h)))
        return h.reshape(n, self.k, -1).mean(dim=1)


class GravNetConv(nn.Module):
    """GravNet: a kNN graph in a learned space, Gaussian edge weights
    exp(-d^2 exp(w)), mean and max of the weighted projected features."""

    def __init__(self, f: int, h_dim: int, k: int = 8, knn_dim: int = 4, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.k = k
        self.lin_h = TorchLinear(f, PROPAGATE_DIM, **kw)
        self.lin_s = TorchLinear(f, knn_dim, **kw)
        self.edge_weight_w = _normal_param((1,), generator, device)
        self.lin_out1 = TorchLinear(f, h_dim, **kw)
        self.lin_out2 = TorchLinear(2 * PROPAGATE_DIM, h_dim, **kw)

    def forward(self, x, coords, valid, nbrs=None, record_nbrs=None, **_):
        h_l = self.lin_h(x)
        d2, idx = learned_knn(self.lin_s(x), valid, self.k, nbrs, record_nbrs)
        ew = torch.exp(-d2 * torch.exp(self.edge_weight_w[0]))
        feats = h_l[idx] * ew[..., None]  # (n, k, propagate)
        nbr_valid = valid[idx][..., None]
        feats = torch.where(nbr_valid, feats, torch.zeros_like(feats))
        mean_agg = feats.sum(1) / torch.clamp(nbr_valid.sum(1), min=1)
        # amax splits the gradient evenly among ties, as JAX's reduce-max
        max_agg = torch.amax(torch.where(nbr_valid, feats, torch.full_like(feats, -torch.inf)),
                             dim=1)
        max_agg = torch.where(torch.isfinite(max_agg), max_agg, torch.zeros_like(max_agg))
        out = torch.cat([mean_agg, max_agg], dim=-1)
        return self.lin_out1(x) + self.lin_out2(out)


def make_conv(cfg: GNNConfig, generator=None, device=None) -> nn.Module:
    f, h = cfg.h_dim, cfg.h_dim
    if cfg.conv_type == "gatedgnn":
        return GatedConv(f, h, generator, device)
    if cfg.conv_type == "gcn":
        return GCNConv(f, h, generator, device)
    if cfg.conv_type == "dgcnn":
        return DGCNNConv(f, h, cfg.k, cfg.knn_dim, generator, device)
    return GravNetConv(f, h, cfg.k, cfg.knn_dim, generator, device)


class GNNStack(nn.Module):
    """GNN backbone in the transformer's skeleton: (pileup: the PID
    embedding) feature encoder; per layer pre-LN Linear, the conv, a
    residual with dropout, a pre-LN FF and another residual; the concat of
    every layer; bias-free W; the OutMLP residual head; (pileup) the
    sigmoid classifier. Dropout is 0.1, as in JAX's module, drawn from the
    forward's generator (none: no dropout)."""

    def __init__(self, cfg: GNNConfig, generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        h = cfg.h_dim
        in_dim = cfg.in_dim
        if cfg.task == "pileup":
            # flax's nn.Embed default init: N(0, 1 / PID_DIM)
            self.pids_enc = nn.Embedding(NUM_PIDS, PID_DIM, device=device)
            with torch.no_grad():
                nn.init.normal_(self.pids_enc.weight, 0.0, math.sqrt(1.0 / PID_DIM),
                                generator=generator)
            in_dim = cfg.in_dim - 1 + PID_DIM
        self.feat_enc_0 = TorchLinear(in_dim, h, **kw)
        self.feat_enc_1 = TorchLinear(h, h, **kw)
        self.pre_ln = nn.ModuleList(layer_norm(h, device) for _ in range(cfg.n_layers))
        self.pre_ff = nn.ModuleList(TorchLinear(h, h, **kw) for _ in range(cfg.n_layers))
        self.convs = nn.ModuleList(make_conv(cfg, generator, device)
                                   for _ in range(cfg.n_layers))
        self.norm2 = nn.ModuleList(layer_norm(h, device) for _ in range(cfg.n_layers))
        self.ff0 = nn.ModuleList(TorchLinear(h, h, **kw) for _ in range(cfg.n_layers))
        self.ff1 = nn.ModuleList(TorchLinear(h, h, **kw) for _ in range(cfg.n_layers))
        self.W = TorchLinear(h * (cfg.n_layers + 1), cfg.w_out, bias=False, **kw)
        self.mlp_out = OutMLP(cfg.w_out, cfg.w_out, **kw)
        if cfg.task == "pileup":
            self.out_proj = TorchLinear(cfg.w_out, cfg.num_classes, **kw)

    @property
    def out_width(self) -> int:
        return self.cfg.num_classes if self.cfg.task == "pileup" else self.cfg.w_out

    def forward(self, x, coords, valid, generator: torch.Generator | None = None,
                graph=None, nbrs: list | None = None, record_nbrs: list | None = None):
        """`graph` = (edges, edge_mask, edge_weight) overrides the fixed
        graph of gatedgnn / gcn (default: `gnn_graph` of coords); `nbrs`
        (one (n, k) index per layer) imposes dgcnn's / gravnet's learned-
        space neighbours, and `record_nbrs` (a list) receives them."""
        cfg = self.cfg
        kw = {}
        if cfg.conv_type in GRAPH_CONVS:
            edges, edge_mask, edge_weight = graph if graph is not None else \
                gnn_graph(coords, valid, cfg.graph_k)
            kw = dict(edges=edges.to(torch.int64), edge_mask=edge_mask, edge_weight=edge_weight)
        if cfg.task == "pileup":
            pids = torch.clamp(x[:, -1].to(torch.int32), 0, NUM_PIDS - 1)
            x = torch.cat([x[:, :-1], self.pids_enc(pids)], dim=-1)
        h = self.feat_enc_1(torch.relu(self.feat_enc_0(x)))
        layers = [h]
        for i in range(cfg.n_layers):
            pre = self.pre_ff[i](self.pre_ln[i](h))
            aggr = self.convs[i](pre, coords, valid, nbrs=None if nbrs is None else nbrs[i],
                                 record_nbrs=record_nbrs, **kw)
            h = h + dropout(aggr, 0.1, generator)
            ff = self.ff1[i](torch.relu(self.ff0[i](self.norm2[i](h))))
            h = h + dropout(ff, 0.1, generator)
            layers.append(h)
        out = self.W(torch.cat(layers, dim=-1))
        out = out + dropout(self.mlp_out(out), 0.1, generator)
        if cfg.task == "pileup":
            out = torch.sigmoid(self.out_proj(out))
        return out
