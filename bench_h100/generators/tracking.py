"""The `tracking` generator: synthetic tracking events packed into batches
of the configuration's `batch_size`, in plain NumPy.

A frozen copy of the port's generator's law (`hept_tpu_torch/data/
synthetic.py:synthetic_tracking_event`, drawn in bulk here) and of its
packer (`hept_tpu_torch/data/batching.py:pack_events` on the windowed,
reversal-closed pair layout), so that a later change to either does not
move the benchmark's inputs. Supervision pairs come from scipy's cKDTree
(the k nearest within the radius), never from the port's native library.

A traffic file that names this generator gives `batches`, `points`,
`pairs_per_point`, `pair_radius`, `aug_pair_p` and `window_pairs`. The
packed batches are the benchmark's input: the same arrays go to the port
and, through `to_device` (the benchmark's own dtypes), to the reference.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial import cKDTree

# the dtype of each packed field on the device
DTYPES = {"x": torch.float32, "coords": torch.float32, "valid": torch.bool,
          "cluster_ids": torch.int32, "recons": torch.float32, "pts": torch.float32,
          "pairs": torch.int32, "pair_mask": torch.bool, "pair_rev": torch.int32,
          "pair_weight": torch.float32, "pair_neg": torch.bool}


def tracking_event(rng: np.random.Generator, n_points: int, pairs_per_point: int,
                   pair_radius: float, avg_track_size: int = 8, max_track_size: int = 20,
                   noise_frac: float = 0.1, n_feature_dim: int = 10) -> dict:
    """One event: tracks of Poisson(8) hits (2 to 20) around an (eta, phi)
    centre, spread 0.05, whose features are the track's N(0, 1) base plus
    N(0, 0.3); a track of 3 hits or more is reconstructable; pT lognormal
    (0, 0.8) a track; 10 % noise hits (cluster 0) uniform in eta [-4, 4].
    coords = [eta, phi, x[:, :4]]; the points in random order. The port's
    generator's law, drawn in bulk. Returns numpy arrays x (n, 10), coords
    (n, 6), cluster_ids, recons, pts (n,) and pairs (2, e) int32."""
    n_noise = int(n_points * noise_frac)
    n_hits = n_points - n_noise
    sizes = np.clip(rng.poisson(avg_track_size, n_hits // 2 + 1), 2, max_track_size)
    sizes = sizes[: int(np.searchsorted(np.cumsum(sizes), n_hits)) + 1]
    sizes[-1] -= sizes.sum() - n_hits
    if sizes[-1] < 2:
        sizes = sizes[:-1]
    n_noise = n_points - int(sizes.sum())
    t = len(sizes)
    tid = np.repeat(np.arange(t), sizes)
    centre_eta, centre_phi = rng.uniform(-3, 3, t), rng.uniform(-np.pi, np.pi, t)
    pt = rng.lognormal(0.0, 0.8, t)
    base = rng.normal(0, 1, (t, n_feature_dim))
    eta = np.concatenate([centre_eta[tid] + rng.normal(0, 0.05, tid.size),
                          rng.uniform(-4, 4, n_noise)]).astype(np.float32)
    phi = np.concatenate([centre_phi[tid] + rng.normal(0, 0.05, tid.size),
                          rng.uniform(-np.pi, np.pi, n_noise)]).astype(np.float32)
    x = np.concatenate([base[tid] + rng.normal(0, 0.3, (tid.size, n_feature_dim)),
                        rng.normal(0, 1, (n_noise, n_feature_dim))]).astype(np.float32)
    cid = np.concatenate([tid + 1, np.zeros(n_noise, np.int64)]).astype(np.int32)
    recons = np.concatenate([(sizes >= 3)[tid], np.zeros(n_noise, bool)]).astype(np.float32)
    pts = np.concatenate([pt[tid], np.zeros(n_noise)]).astype(np.float32)
    perm = rng.permutation(n_points)
    eta, phi, x, cid, recons, pts = (a[perm] for a in (eta, phi, x, cid, recons, pts))
    coords = np.concatenate([eta[:, None], phi[:, None], x[:, :4]], axis=1)
    return {"x": x, "coords": coords, "cluster_ids": cid, "recons": recons, "pts": pts,
            "pairs": radius_pairs(eta, phi, pair_radius, pairs_per_point)}


def radius_pairs(eta, phi, radius: float, k: int) -> np.ndarray:
    """Up to k nearest neighbours within `radius` in (eta, phi) per point,
    (2, e) int32 with the anchor in row 0."""
    n = len(eta)
    pos = np.stack([eta, phi], axis=1).astype(np.float64)
    kk = min(k + 1, n)
    dist, idx = cKDTree(pos).query(pos, k=kk)
    src = np.repeat(np.arange(n), kk - 1)
    dst = idx[:, 1:].reshape(-1)
    good = dist[:, 1:].reshape(-1) < radius
    return np.stack([src[good], dst[good]]).astype(np.int32)


def bucket_n(n: int, block_size: int, slab: int = 1024) -> int:
    """n rounded up to whole buckets, and for block sizes that are multiples
    of 128 to a bucket count divisible by slab / block_size (the port's
    `slab_friendly_n`)."""
    nb = -(-n // block_size)
    if block_size % 128 == 0 and block_size <= slab:
        g0 = slab // block_size
        nb = -(-nb // g0) * g0
    return nb * block_size


def window_pad_pairs(pairs: np.ndarray, group: int = 128):
    """Anchor-sorted pairs -> aligned `group`-pair windows in which the
    anchors span less than `group`; pads copy the next real pair and are
    masked. Returns (pairs (2, E'), mask (E',))."""
    p0 = pairs[0]
    e = p0.shape[0]
    starts, i = [], 0
    while i < e:
        starts.append(i)
        i = min(i + group, int(np.searchsorted(p0, p0[i] + group, side="left")))
    starts.append(e)
    sa = np.asarray(starts, np.int64)
    n_runs = sa.shape[0] - 1
    offs = np.tile(np.arange(group, dtype=np.int64), n_runs)
    base = np.repeat(sa[:-1], group)
    lens = np.repeat(sa[1:] - sa[:-1], group)
    ends = np.repeat(np.minimum(sa[1:], e - 1), group)
    mask = offs < lens
    return pairs[:, np.where(mask, base + offs, ends)], mask


def symmetrize_pairs(pairs: np.ndarray, n: int) -> np.ndarray:
    """The pair list closed under reversal, deduplicated, anchor-sorted."""
    both = np.concatenate([pairs, pairs[::-1]], axis=1)
    key = np.unique(both[0].astype(np.int64) * n + both[1])
    return np.stack([key // n, key % n]).astype(pairs.dtype)


def pair_rev_index(pairs: np.ndarray, pmask: np.ndarray, n: int) -> np.ndarray:
    """Position of each real pair's reverse among the windowed slots;
    identity for pads."""
    rev = np.arange(pairs.shape[1], dtype=np.int32)
    real = np.flatnonzero(pmask)
    key = pairs[0, real].astype(np.int64) * n + pairs[1, real]
    rkey = pairs[1, real].astype(np.int64) * n + pairs[0, real]
    pos = np.empty(rkey.size, np.int64)
    pos[np.argsort(rkey, kind="stable")] = np.arange(rkey.size)
    # the symmetrised layout keeps the real slots in key order
    opos = pos if (key[1:] > key[:-1]).all() else np.argsort(key, kind="stable")[pos]
    if not (key[opos] == rkey).all():
        raise ValueError("pair list not closed under reversal")
    rev[real] = real[opos].astype(np.int32)
    return rev


def pair_cluster_weights(pairs, pmask, cluster_ids, recons, pts, pt_thres: float = 0.9):
    """Per-pair weight 1 / |cluster| / #clusters on the positive pairs (the
    loss's mean of per-cluster means as one dot product) and the negative
    mask (~positive & real)."""
    p0, p1 = pairs[0], pairs[1]
    pos = (pmask & (cluster_ids[p0] == cluster_ids[p1]) & (recons[p0] != 0)
           & (recons[p1] != 0) & (pts[p0] > pt_thres) & (pts[p1] > pt_thres))
    w = np.zeros(pairs.shape[1], np.float32)
    if pos.any():
        labels = cluster_ids[p0[pos]].astype(np.int64)
        cnt = np.bincount(labels)
        w[pos] = 1.0 / (cnt[labels] * (cnt > 0).sum())
    return w, np.logical_not(pos) & pmask


def event_pairs(ev: dict, aug_pair_p: float, aug_rng: np.random.Generator | None,
                window: int):
    """One event's windowed pairs, their mask and reverse index. Training
    appends int(E * p / 2) random pairs in both directions before the
    symmetrisation."""
    ni = ev["x"].shape[0]
    pairs = ev["pairs"]
    if aug_pair_p > 0.0 and aug_rng is not None:
        n_aug = int(pairs.shape[1] * aug_pair_p / 2)
        if n_aug:
            rnd = aug_rng.integers(0, ni, (2, n_aug))
            pairs = np.concatenate([pairs, np.concatenate([rnd, rnd[::-1]], 1).astype(pairs.dtype)],
                                   axis=1)
    pairs, pmask = window_pad_pairs(symmetrize_pairs(pairs, ni), window)
    return pairs, pmask, pair_rev_index(pairs, pmask, ni)


def pack_batch(evs: list, n: int, aug_pair_p: float, aug_rng: np.random.Generator | None,
               window: int = 128) -> dict:
    """Events as one batch of B = len(evs), n rows each (n >= every event's
    points): x, coords, valid, cluster_ids, recons, pts, and the windowed
    pairs with pair_mask, pair_rev, pair_weight, pair_neg, padded to the
    batch's most pairs (pads point at row n - 1, masked, reverse index the
    identity)."""
    b = len(evs)
    if n < max(ev["x"].shape[0] for ev in evs):
        raise ValueError(f"n={n} below an event's points")
    processed = [event_pairs(ev, aug_pair_p, aug_rng, window) for ev in evs]
    e = -(-max(max(p.shape[1] for p, _, _ in processed), window) // window) * window
    out = {"x": np.zeros((b, n, evs[0]["x"].shape[1]), np.float32),
           "coords": np.zeros((b, n, evs[0]["coords"].shape[1]), np.float32),
           "valid": np.zeros((b, n), bool),
           "cluster_ids": np.zeros((b, n), np.int32), "recons": np.zeros((b, n), np.float32),
           "pts": np.zeros((b, n), np.float32),
           # C order, as the port packs: its pair kernels take contiguous indices
           "pairs": np.full((b, 2, e), n - 1, np.int32), "pair_mask": np.zeros((b, e), bool),
           "pair_rev": np.tile(np.arange(e, dtype=np.int32), (b, 1)),
           "pair_weight": np.zeros((b, e), np.float32), "pair_neg": np.zeros((b, e), bool)}
    for i, (ev, (pairs, pmask, rev)) in enumerate(zip(evs, processed)):
        ni, ei = ev["x"].shape[0], pairs.shape[1]
        out["valid"][i, :ni] = True
        for name in ("x", "coords", "cluster_ids", "recons", "pts"):
            out[name][i, :ni] = ev[name]
        out["pairs"][i, :, :ei] = pairs
        out["pair_mask"][i, :ei] = pmask
        out["pair_rev"][i, :ei] = rev
        w, neg = pair_cluster_weights(pairs, pmask, ev["cluster_ids"], ev["recons"], ev["pts"])
        out["pair_weight"][i, :ei] = w
        out["pair_neg"][i, :ei] = neg
    return out


def make_batches(cfg: dict, traffic: dict, seeds: dict) -> list:
    """The traffic's `batches` packed batches of the configuration's
    `batch_size` events, from the seed's event and augmentation draws."""
    rng = np.random.default_rng(seeds["events"])
    aug = np.random.default_rng(seeds["aug"]) if traffic["aug_pair_p"] > 0 else None
    n = bucket_n(traffic["points"], cfg["model_kwargs"]["block_size"])
    out = []
    for _ in range(traffic["batches"]):
        evs = [tracking_event(rng, traffic["points"], traffic["pairs_per_point"],
                              traffic["pair_radius"]) for _ in range(cfg["batch_size"])]
        out.append(pack_batch(evs, n, traffic["aug_pair_p"], aug, traffic["window_pairs"]))
    return out


def to_device(batch: dict, device) -> dict:
    """A packed batch as device tensors of the benchmark's own dtypes."""
    return {k: torch.as_tensor(v).to(device=device, dtype=DTYPES[k]) for k, v in batch.items()}


def half_batch(loss_fn):
    """A fault: the loss over the pairs whose anchor lies in the first half
    of the rows, the cluster weights renormalised over them."""
    def half(out, batch):
        b = dict(batch)
        keep = b["pairs"][:, 0] < out.shape[1] // 2
        w = torch.where(keep, b["pair_weight"], 0.0)
        b["pair_weight"] = w / w.sum(dim=1, keepdim=True)
        b["pair_neg"] = b["pair_neg"] & keep
        return loss_fn(out, b)
    return half
