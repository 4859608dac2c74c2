"""Plain PyTorch reference of the HEPT tracking transformer, its windowed
InfoNCE loss, Adam and the kNN retrieval metrics.

Written from the published model (Graph-COM/HEPT, arXiv 2402.12535) and the
configuration files beside it, with no kernel, no custom autograd and no
import of the port: every bucket is an explicit (B, B) block of RBF logits,
sorts are `torch.argsort`, unsorts are indexing, and the backward is
autograd's. It computes in float32 with TF32 off. This module is a
library: a configuration's module (`tracking_hept_acc.py`,
`tracking_hept.py`) adds the way its attention buckets the points (`plan`,
`attend`) and exports what the harness calls, `param_spec`,
`train_reference`, `eval_reference` and `PRECISIONS`, through
`TrackingReference`.

Precision: `Precision` rounds the tensors that the configuration states in
a lower precision (the bucket kernels' operands and the transports) and
their cotangents; the reference itself rounds nothing (`EXACT`). The
lower-precision control of `control.py` puts a rounding below the stated
one there (`E4M3`), or turns TF32 on (`TF32`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-6
DENOM_EPS = 1e-20
BIG_KEY = 3.0e38
SIGMA = 0.75
E4M3_MAX = 448.0


class _ScaledE4M3(torch.autograd.Function):
    """Per-tensor scaled e4m3 rounding of the values, and of the cotangents
    in the backward."""

    @staticmethod
    def forward(ctx, x):
        return e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return e4m3(g)


def e4m3(x: torch.Tensor) -> torch.Tensor:
    s = (x.detach().abs().amax() / E4M3_MAX).clamp_min(1e-30)
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _BF16(torch.autograd.Function):
    """bfloat16 rounding of the values and of the cotangents."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(torch.float32)


class Precision:
    """Where the configuration states a lower precision than float32, the
    reference applies `round` (identity for the reference itself), and
    `round_den` to the attention's denominators in the unsort (e4m3 would
    flush them to zero: the port's own fp8 unsort carries them in bf16);
    `tf32` lets float32 products run in TF32."""

    def __init__(self, name: str, rounding=None, den_rounding=None, tf32: bool = False):
        self.name, self.rounding, self.den_rounding, self.tf32 = name, rounding, den_rounding, tf32

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.rounding is None else self.rounding(x)

    def round_den(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.den_rounding is None else self.den_rounding(x)


EXACT = Precision("f32")
E4M3 = Precision("e4m3", _ScaledE4M3.apply, _BF16.apply)
TF32 = Precision("tf32", tf32=True)
# the controls a configuration's file can name (`control`)
PRECISIONS = {"e4m3": E4M3, "tf32": TF32}


def param_spec(cfg: dict) -> list:
    """(name, shape, init) of every parameter and frozen constant, under the
    port's state_dict names. init: ("uniform", bound) as torch's Linear,
    ("ones",), ("zeros",), ("normal",) for the E2LSH directions, ("regions",)
    for the AND-region counts."""
    m = cfg["model_kwargs"]
    d, h, L = m["h_dim"], m["num_heads"], m["n_layers"]
    fin, cd = cfg["in_dim"], cfg["coords_dim"]
    nh = m["n_hashes"]
    rpe_in = m["num_w_per_dist"] * (cd - 1)
    spec = [("regions", (nh, 2, h), ("regions",))]

    def lin(name, i, o, bias=True):
        spec.append((f"{name}.weight", (o, i), ("uniform", 1.0 / math.sqrt(i))))
        if bias:
            spec.append((f"{name}.bias", (o,), ("uniform", 1.0 / math.sqrt(i))))

    def norm(name, w):
        spec.extend([(f"{name}.weight", (w,), ("ones",)), (f"{name}.bias", (w,), ("zeros",))])

    lin("feat_enc_0", fin, d)
    lin("feat_enc_1", d, d)
    if m.get("static_keys"):
        spec.append(("static_alpha", (1, d + cd, m["static_rounds"]), ("normal",)))
    for i in range(L):
        b = f"blocks.{i}"
        spec.append((f"{b}.w_rpe", (h * d, rpe_in), ("uniform", 1.0 / math.sqrt(rpe_in))))
        norm(f"{b}.norm1", d)
        for w in ("w_q", "w_k", "w_v"):
            lin(f"{b}.{w}", d, h * d, bias=False)
        spec.append((f"{b}.attn.e2lsh_alpha", (1 if m.get("share_heads") else h, d + cd, nh),
                     ("normal",)))
        lin(f"{b}.attn.out_linear", h * d, d)
        norm(f"{b}.norm2", d)
        lin(f"{b}.ff.fc1", d, d)
        lin(f"{b}.ff.fc2", d, d)
    lin("W", d * (L + 1), d // 2, bias=False)
    dims = [d // 2] + [256] * 4 + [d // 2]
    for j in range(5):
        lin(f"mlp_out.lins.{j}", dims[j], dims[j + 1])
    for j in range(4):
        norm(f"mlp_out.norms.{j}", 256)
    return spec


def trainable(name: str) -> bool:
    return name not in ("regions", "static_alpha") and not name.endswith("e2lsh_alpha")


def linear(x, W, name):
    return F.linear(x, W[f"{name}.weight"], W.get(f"{name}.bias"))


def layer_norm(x, W, name):
    return F.layer_norm(x, x.shape[-1:], W[f"{name}.weight"], W[f"{name}.bias"], LN_EPS)


def dropout(x, p: float, gen):
    """Inverted dropout: keep where a uniform draw from `gen` is >= p (one
    draw of x's shape per call, in the order the model applies them); no
    generator: identity."""
    if gen is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def region_ids(values, n_valid, num_regions):
    """Rank // ceil(n_valid / R) + 1 per row of R region counts; values (n,)
    with pads at +max so they rank last."""
    ranks = torch.empty_like(values, dtype=torch.int64)
    order = torch.argsort(values, stable=True)
    ranks[order] = torch.arange(values.shape[0], device=values.device)
    size = torch.ceil(n_valid.to(torch.float32) / num_regions)  # (R, 1)
    return torch.floor(ranks.to(torch.float32)[None] / size) + 1.0


def prepare_replicate(x, coords, valid, regions, block_size: int):
    """AND codes from quantile regions of the real points, and replication
    padding: the trailing bucket's empty slots copy real rows in the order
    of their (hash 0, head 0) code; slots past it are inert (zeroed, keyed
    last). Returns (x, coords, codes (c, h, n) int64, inert (n,))."""
    n = x.shape[0]
    c, _, h = regions.shape
    n_valid = valid.sum()
    big = torch.finfo(torch.float32).max
    reg = regions.permute(1, 0, 2).reshape(2, c * h)[..., None]  # (2, c * h, 1)
    eta = region_ids(torch.where(valid, coords[:, 0], big), n_valid, reg[0]).to(torch.int64)
    phi = region_ids(torch.where(valid, coords[:, 1], big), n_valid, reg[1]).to(torch.int64)
    bits = torch.ceil(torch.log2(eta.amax(dim=1, keepdim=True).to(torch.float32) + 1.0))
    codes = ((phi << bits.to(torch.int64)) | eta).reshape(c, h, n)
    code00 = torch.where(valid, codes[0, 0], torch.iinfo(torch.int64).max)
    by_code = torch.argsort(code00, stable=True)
    pos = torch.arange(n, device=x.device)
    padded = (n_valid + block_size - 1) // block_size * block_size
    fill = by_code[torch.clamp(n_valid - block_size + (pos - n_valid), 0, n - 1)]
    inert = pos >= padded
    src = torch.where(pos < n_valid, pos, torch.where(inert, torch.zeros_like(pos), fill))
    x = torch.where(inert[:, None], 0.0, x[src])
    coords = torch.where(inert[:, None], 0.0, coords[src])
    return x, coords, codes[..., src], inert


def rpe_scales(w_rpe, h: int, d: int, cd: int, nw: int):
    """Per-head RPE scales sqrt(2 w), (h, cd): w = sum_k exp(min(sum_d
    W[h, d, r, k], 50)) per distance group; eta and phi share the first."""
    w = w_rpe.reshape(h, d, cd - 1, nw)
    qw = torch.exp(torch.clamp(w.sum(dim=1), max=50.0)).sum(dim=-1)
    return torch.sqrt(2.0 * torch.cat([qw[:, :1], qw], dim=-1))


def _buckets(q, k, v, block_size: int, prec: Precision):
    r, n, dq = q.shape
    nb = n // block_size
    qb = q.reshape(r, nb, block_size, dq)
    kb = k.reshape(r, nb, block_size, dq)
    vb = v.reshape(r, nb, block_size, v.shape[-1])
    logits = (qb @ kb.transpose(-1, -2) - 0.5 * (qb * qb).sum(-1)[..., :, None]
              - 0.5 * (kb * kb).sum(-1)[..., None, :])
    p = torch.exp(torch.clamp(logits, max=0.0))
    den = p.sum(-1) + DENOM_EPS
    num = prec.round(p) @ vb
    return num.reshape(r, n, -1), den.reshape(r, n, 1)


def bucket_attend(q, k, v, block_size: int, prec: Precision):
    """Per bucket of `block_size` consecutive sorted points: p = exp(min(q.k
    - |q|^2/2 - |k|^2/2, 0)), den = sum_j p + 1e-20, num = sum_j p v_j.
    q, k (r, n, d), v (r, n, dv) -> num (r, n, dv), den (r, n, 1). Recomputed
    in the backward (checkpoint), so a layer holds one round's logits."""
    if torch.is_grad_enabled() and q.requires_grad:
        return checkpoint(_buckets, q, k, v, block_size, prec, use_reentrant=False)
    return _buckets(q, k, v, block_size, prec)


def head_split(t, h: int):
    """(n, h * d) -> (h, n, d)."""
    return t.reshape(t.shape[0], h, -1).permute(1, 0, 2)


def forward(W, cfg, attention, x, coords, valid, gen=None, prec: Precision = EXACT):
    """One event's (n, h_dim / 2) embeddings. `attention` has the
    configuration's `plan` and `attend`; `gen` draws dropout."""
    m = cfg["model_kwargs"]
    p = m.get("dropout", 0.1)
    x, coords, codes, inert = prepare_replicate(x, coords, valid, W["regions"], m["block_size"])
    h = linear(torch.relu(linear(x, W, "feat_enc_0")), W, "feat_enc_1")
    plan = attention.plan(W, cfg, h, coords, codes, inert)
    layers = [h]
    for i in range(m["n_layers"]):
        b = f"blocks.{i}"
        xn = torch.where(inert[:, None], 0.0, layer_norm(h, W, f"{b}.norm1"))
        aggr = attention.attend(W, cfg, i, xn, coords, codes, inert, plan, prec)
        h = h + dropout(linear(aggr, W, f"{b}.attn.out_linear"), p, gen)
        ff = linear(torch.relu(linear(layer_norm(h, W, f"{b}.norm2"), W, f"{b}.ff.fc1")), W,
                    f"{b}.ff.fc2")
        h = h + dropout(ff, p, gen)
        layers.append(h)
    out = F.linear(torch.cat(layers, dim=-1), W["W.weight"])
    y = out
    for j in range(4):
        y = torch.tanh(layer_norm(linear(y, W, f"mlp_out.lins.{j}"), W, f"mlp_out.norms.{j}"))
    return out + dropout(linear(y, W, "mlp_out.lins.4"), p, gen)


def infonce_loss(emb, pairs, weight, neg, mask, tau: float):
    """Windowed InfoNCE with the l2_rbf similarity exp(-|e0 - e1| / (2
    sigma^2)): -log(e / (e + negative mass of the anchor)) per pair, e =
    exp(sim / tau - max), weighted by the pack-time cluster weights."""
    p0, p1 = pairs[0].long(), pairs[1].long()
    diff = emb[p0] - emb[p1]
    sim = torch.exp(-torch.sqrt((diff * diff).sum(-1) + 1e-12) / (2 * SIGMA ** 2))
    logit = sim / tau
    mx = torch.where(mask, logit, -torch.inf).max().detach()
    e = torch.exp(logit - mx)
    neg_sum = torch.zeros(emb.shape[0], device=emb.device).index_add(
        0, p0, torch.where(neg, e, 0.0))
    return torch.sum(-torch.log(e / (e + neg_sum[p0] + 1e-30) + 1e-30) * weight)


def knn_metrics(emb, cluster_ids, recons, pts, valid, k: int = 19, tile: int = 2048):
    """kNN retrieval accuracy / precision / recall at pT thresholds (0, 0.5,
    0.9), (3, 3): every real point retrieves its k + 1 nearest real points by
    squared L2 (itself first, dropped), k_i = min(|own cluster| - 1, k);
    acc = matches among the first k_i / k_i, precision = matches / k, recall
    = matches / k_i, averaged over the real points of a real,
    reconstructable track above the threshold with k_i > 0."""
    n = emb.shape[0]
    cid = cluster_ids.long()
    sizes = torch.zeros(n, dtype=torch.int64, device=emb.device).index_add_(0, cid, valid.long())
    k_i = torch.clamp_max(sizes[cid] - 1, k)
    sq = (emb * emb).sum(-1)
    idx = []
    for s in range(0, n, tile):
        q = emb[s:s + tile]
        d2 = (q * q).sum(-1, keepdim=True) - 2.0 * q @ emb.t() + sq[None]
        d2 = torch.where(valid[None], d2, torch.inf)
        idx.append(torch.topk(d2, k + 1, dim=-1, largest=False).indices)
    nbrs = torch.cat(idx)[:, 1:]
    match = cid[nbrs] == cid[:, None]
    within = torch.arange(k, device=emb.device)[None] < k_i[:, None]
    kf = torch.clamp_min(k_i, 1).float()
    scores = ((match & within).sum(1) / kf, match.sum(1) / float(k), match.sum(1) / kf)
    out = []
    for thres in (0.0, 0.5, 0.9):
        inc = (cid != 0) & (recons != 0) & (pts > thres) & (k_i > 0) & valid
        cnt = inc.sum().clamp_min(1).float()
        out.append(torch.stack([torch.where(inc, s, 0.0).sum() / cnt for s in scores]))
    return torch.stack(out)


class _TF32:
    """TF32 on for float32 products inside the block where `on`."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


class TrackingReference:
    """The HEPT tracking model's reference over an attention (`plan`,
    `attend`): what a configuration's module exports."""

    def __init__(self, plan, attend):
        self.plan, self.attend = plan, attend

    @staticmethod
    def param_spec(cfg: dict) -> list:
        return param_spec(cfg)

    def batch_loss(self, W, cfg, b, gen, prec):
        """The mean over the batch's events of their losses, each event's
        forward in turn on one dropout generator (the port's "vmap" batch
        mode), and the (B, n, h_dim / 2) embeddings."""
        if cfg["batch_mode"] != "vmap":
            raise NotImplementedError("reference: batch_mode must be 'vmap'")
        tau = cfg["loss_kwargs"]["tau"]
        losses, embs = [], []
        for i in range(b["x"].shape[0]):
            out = forward(W, cfg, self, b["x"][i], b["coords"][i], b["valid"][i], gen, prec)
            losses.append(infonce_loss(out, b["pairs"][i], b["pair_weight"][i], b["pair_neg"][i],
                                       b["pair_mask"][i], tau))
            embs.append(out)
        return sum(losses) / len(losses), torch.stack(embs), losses

    def train_reference(self, W0: dict, cfg: dict, batches: list, gen_state, device,
                        prec: Precision = EXACT, adam: dict | None = None):
        """Adam steps from the weights W0, step s on batches[s], dropout
        drawn from a device generator set to `gen_state`. `adam` is Adam's
        state to start from ({"m": .., "v": .., "t": steps taken}; none: a
        fresh Adam). Returns (losses, the first step's gradients, the
        trainable parameters after the last step)."""
        lr = cfg["optimizer_kwargs"]["lr"]
        b1, b2, eps = 0.9, 0.999, 1e-8
        W = {k: v.detach().clone() for k, v in W0.items()}
        names = [k for k in W if trainable(k)]
        adam = adam or {"m": {}, "v": {}, "t": 0}
        m = {k: adam["m"].get(k, torch.zeros_like(W[k])).clone() for k in names}
        v = {k: adam["v"].get(k, torch.zeros_like(W[k])).clone() for k in names}
        gen = torch.Generator(device=device)
        gen.set_state(gen_state)
        losses, first = [], None
        with _TF32(prec.tf32):
            for s, batch in enumerate(batches):
                for k in names:
                    W[k].requires_grad_(True)
                loss = self.batch_loss(W, cfg, batch, gen, prec)[0]
                grads = torch.autograd.grad(loss, [W[k] for k in names])
                losses.append(float(loss.detach()))
                with torch.no_grad():
                    if first is None:
                        first = {k: g.clone() for k, g in zip(names, grads)}
                    t = adam["t"] + s + 1
                    for k, g in zip(names, grads):
                        p = W[k].detach()
                        m[k].mul_(b1).add_(g, alpha=1 - b1)
                        v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                        denom = v[k].sqrt() / math.sqrt(1 - b2 ** t) + eps
                        W[k] = p.addcdiv(m[k], denom, value=-lr / (1 - b1 ** t))
        return losses, first, {k: W[k].detach() for k in names}

    def eval_reference(self, W: dict, cfg: dict, batches: list, prec: Precision = EXACT):
        """Per batch of the split: (embeddings (B, n, h_dim / 2), the batch's
        loss, (B, 3, 3) metrics), forward without dropout."""
        out = []
        with _TF32(prec.tf32), torch.no_grad():
            for b in batches:
                loss, emb, _ = self.batch_loss(W, cfg, b, None, prec)
                metrics = torch.stack([
                    knn_metrics(emb[i], b["cluster_ids"][i], b["recons"][i], b["pts"][i],
                                b["valid"][i]) for i in range(emb.shape[0])])
                out.append((emb, float(loss), metrics))
        return out
