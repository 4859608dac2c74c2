"""Host-side dense batching: ragged events -> fixed-shape numpy arrays.

Own copy of `hept_tpu/data/batching.py` (numpy only): events are packed into
a dense (B, N, ...) layout with validity masks, and the tracking supervision
pairs take the windowed, reversal-closed InfoNCE layout that the pair
kernels (ops/pair_ops.py) and the folded loss backward rely on:
anchor-sorted, partitioned into 128-pair windows, with a reverse-pair index
and pack-time cluster weights / negative masks.

With `cache=True` (the training loader's setting, as in the JAX package)
the augmentation-independent part of an event's pairs (symmetrise, window,
reverse index) is built once and kept on the Event; each call then appends
only the fresh augmentation draw as its own windowed block. The pair set,
masks, weights and reversal closure equal a full re-pack's; only the window
grouping (in-window summation order) differs.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class Event:
    """One point cloud with supervision (host-side, numpy).

    Attributes:
      x: (n, F) features; coords: (n, C) with eta/phi first.
      cluster_ids: (n,) dense ids in [0, n); 0 = noise (tracking).
      recons: (n,) reconstructability flags; pts: (n,) transverse momenta.
      pairs: (2, e) supervision point pairs (tracking).
      y: (n,) binary labels (pileup); is_neu: (n,) neutral-particle mask.
    """

    x: np.ndarray
    coords: np.ndarray
    cluster_ids: np.ndarray | None = None
    recons: np.ndarray | None = None
    pts: np.ndarray | None = None
    pairs: np.ndarray | None = None
    y: np.ndarray | None = None
    is_neu: np.ndarray | None = None
    # window size -> processed base pairs (see _process_event_pairs)
    pair_cache: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def n(self) -> int:
        return self.x.shape[0]


def slab_friendly_n(n: int, block_size: int, slab: int = 1024) -> int:
    """Round n up to a bucket count divisible by slab/block_size (the bucket
    grid the JAX package sizes its events with, so both packages run the
    same n). No-op when block_size is not a multiple of 128."""
    nb = -(-n // block_size)
    if block_size % 128 == 0 and block_size <= slab:
        g0 = slab // block_size
        nb = -(-nb // g0) * g0
    return nb * block_size


def _ceil_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def window_pad_pairs(pairs: np.ndarray, group: int = 128) -> tuple[np.ndarray, np.ndarray]:
    """Repartition anchor-sorted pairs into aligned `group`-pair windows such
    that within every window, max(anchor) - min(anchor) < group.

    Pads inserted to break windows copy the NEXT real pair (keeping the
    anchor column sorted) and are masked.

    Args: pairs (2, E) anchor-sorted. Returns (padded_pairs (2, E'), mask
    (E',)) with E' a multiple of `group`.
    """
    p0 = pairs[0]
    e = p0.shape[0]
    if e == 0:
        return pairs.reshape(2, 0), np.zeros((0,), bool)
    # greedy run construction: a run starting at i extends to
    # min(i + group, first j with p0[j] >= p0[i] + group)
    starts = []
    i = 0
    while i < e:
        starts.append(i)
        lim = int(np.searchsorted(p0, p0[i] + group, side="left"))
        i = min(i + group, lim)
    starts.append(e)
    sa = np.asarray(starts, np.int64)
    n_runs = sa.shape[0] - 1
    # slot j of run r reads pairs[:, s_r + j] while real (j < len_r), else
    # the run's END pair (the next real pair; the final run pads with its
    # own last pair), so the anchor order stays sorted
    offs = np.tile(np.arange(group, dtype=np.int64), n_runs)
    base = np.repeat(sa[:-1], group)
    lens = np.repeat(sa[1:] - sa[:-1], group)
    ends = np.repeat(np.minimum(sa[1:], e - 1), group)
    mask = offs < lens
    src = np.where(mask, base + offs, ends)
    return pairs[:, src], mask


def _symmetrize_pairs(pairs: np.ndarray, n: int) -> np.ndarray:
    """Close the pair list under reversal and dedupe; returns pairs in
    canonical (anchor, partner) lexicographic order (anchor-sorted)."""
    both = np.concatenate([pairs, pairs[::-1]], axis=1)
    key = np.unique(both[0].astype(np.int64) * n + both[1])
    out = np.empty((2, key.shape[0]), dtype=pairs.dtype)
    np.floor_divide(key, n, out=out[0], casting="unsafe")
    np.remainder(key, n, out=out[1], casting="unsafe")
    return out


def _pair_rev_index(pairs: np.ndarray, pmask: np.ndarray, n: int) -> np.ndarray:
    """Position of each REAL pair's reverse among the real (unmasked) slots
    of the padded windowed layout; identity for pads. Requires the real pair
    set to be reversal-closed and duplicate-free (`_symmetrize_pairs`)."""
    e = pairs.shape[1]
    rev = np.arange(e, dtype=np.int32)
    real = np.flatnonzero(pmask)
    if real.size == 0:
        return rev
    key = pairs[0, real].astype(np.int64) * n + pairs[1, real]
    rkey = pairs[1, real].astype(np.int64) * n + pairs[0, real]
    if key.size > 1 and (key[1:] > key[:-1]).all():
        order = None  # canonical packing: real slots already key-sorted
    else:
        order = np.argsort(key, kind="stable")
    # rank of rkey[i] among the rkeys == its position in sorted(key) when the
    # two sets are equal (reversal closure); the equality check below still
    # catches a pair list that is not closed
    order_r = np.argsort(rkey, kind="stable")
    pos = np.empty(rkey.size, np.int64)
    pos[order_r] = np.arange(rkey.size)
    opos = pos if order is None else order[pos]
    target = real[opos]
    if not (key[opos] == rkey).all():
        raise ValueError("pair list not closed under reversal")
    rev[real] = target.astype(np.int32)
    return rev


def _pair_cluster_weights(pairs, pmask, cluster_ids, recons, pts, pt_thres: float = 0.9):
    """Per-pair weight w_e = pos_e / |cluster(e)| / #nonempty-clusters (the
    loss's cluster mean-of-means as one dot product) and the negative-pair
    mask (~pos & real). Both depend only on batch data."""
    p0, p1 = pairs[0], pairs[1]
    pos = (
        pmask
        & (cluster_ids[p0] == cluster_ids[p1])
        & (recons[p0] != 0)
        & (recons[p1] != 0)
        & (pts[p0] > pt_thres)
        & (pts[p1] > pt_thres)
    )
    w = np.zeros(pairs.shape[1], np.float32)
    neg = np.logical_not(pos) & pmask
    if not pos.any():
        return w, neg
    labels = cluster_ids[p0[pos]].astype(np.int64)
    cnt = np.bincount(labels)
    n_clusters = (cnt > 0).sum()
    w[pos] = 1.0 / (cnt[labels] * n_clusters)
    return w, neg


def _process_event_pairs(ev: Event, aug_pair_p: float,
                         aug_rng: np.random.Generator | None, window: int,
                         cache: bool = False):
    """One event's supervision pairs -> (pairs, mask, rev, has_cluster).

    `rev` is the reverse-pair index (None outside the windowed+cluster path).
    Train-time augmentation appends int(E * p / 2) random pairs in both
    directions, drawn from `aug_rng` (the same draws with or without
    `cache`).
    """
    pairs = ev.pairs
    ni = ev.n
    has_cluster = ev.cluster_ids is not None and ev.recons is not None \
        and ev.pts is not None
    rnd = None
    if aug_pair_p > 0.0 and aug_rng is not None:
        n_aug = int(pairs.shape[1] * aug_pair_p / 2)
        if n_aug:
            rnd = aug_rng.integers(0, ni, (2, n_aug))

    def with_aug(p):
        if rnd is None:
            return p
        return np.concatenate([p, np.concatenate([rnd, rnd[::-1]], axis=1).astype(p.dtype)],
                              axis=1)

    if not (window and has_cluster):
        pairs = with_aug(pairs)
        order = np.argsort(pairs[0], kind="stable")
        pairs = pairs[:, order]
        pmask = None
        if window:
            pairs, pmask = window_pad_pairs(pairs, window)
        return pairs, pmask, None, has_cluster
    if not cache:
        pairs, pmask = window_pad_pairs(_symmetrize_pairs(with_aug(pairs), ni), window)
        return pairs, pmask, _pair_rev_index(pairs, pmask, ni), True
    if window not in ev.pair_cache:
        base = _symmetrize_pairs(ev.pairs, ni)
        bpairs, bmask = window_pad_pairs(base, window)
        ev.pair_cache[window] = (base[0].astype(np.int64) * ni + base[1], bpairs, bmask,
                                 _pair_rev_index(bpairs, bmask, ni))
    bkeys, bpairs, bmask, brev = ev.pair_cache[window]
    if rnd is None:
        return bpairs, bmask, brev, True
    akey = np.unique(np.concatenate([rnd[0].astype(np.int64) * ni + rnd[1],
                                     rnd[1].astype(np.int64) * ni + rnd[0]]))
    if bkeys.size:
        # drop draws already in the (reversal-closed) base set: the rest stays
        # closed under reversal
        ins = np.minimum(np.searchsorted(bkeys, akey), bkeys.size - 1)
        akey = akey[bkeys[ins] != akey]
    if akey.size == 0:
        return bpairs, bmask, brev, True
    apairs = np.empty((2, akey.size), dtype=ev.pairs.dtype)
    np.floor_divide(akey, ni, out=apairs[0], casting="unsafe")
    np.remainder(akey, ni, out=apairs[1], casting="unsafe")
    apairs, amask = window_pad_pairs(apairs, window)
    arev = _pair_rev_index(apairs, amask, ni) + bpairs.shape[1]
    return (np.concatenate([bpairs, apairs], axis=1), np.concatenate([bmask, amask]),
            np.concatenate([brev, arev.astype(brev.dtype)]), True)


def pack_events(
    events: Sequence[Event],
    block_size: int,
    n_max: int | None = None,
    aug_pair_p: float = 0.0,
    aug_rng: np.random.Generator | None = None,
    window_pairs: int = 0,
    cache: bool = False,
) -> dict:
    """Pack events into dense arrays.

    Returns dict of numpy arrays with leading batch dim B:
      x (B, N, F), coords (B, N, C), valid (B, N) bool, and when present:
      cluster_ids/recons/pts/y (B, N), is_neu (B, N) bool, pairs (B, 2, E) int32, pair_mask (B, E)
      bool, and on the windowed path pair_rev/pair_weight/pair_neg (B, E).
      N is a multiple of block_size.
    `cache=True` keeps each event's processed base pairs on the Event and
    appends fresh augmentation as its own windowed block.
    """
    b = len(events)
    n_req = max(ev.n for ev in events)
    n = _ceil_to(n_max or n_req, block_size)
    if n < n_req:
        raise ValueError(f"n_max={n_max} smaller than largest event ({n_req})")

    f = events[0].x.shape[1]
    c = events[0].coords.shape[1]
    out = {
        "x": np.zeros((b, n, f), np.float32),
        "coords": np.zeros((b, n, c), np.float32),
        "valid": np.zeros((b, n), bool),
    }
    has_pairs = events[0].pairs is not None
    if has_pairs:
        processed = [
            _process_event_pairs(ev, aug_pair_p, aug_rng, window_pairs, cache)
            for ev in events
        ]
        e_req = max(p.shape[1] for p, _, _, _ in processed)
        if window_pairs:
            e_req = _ceil_to(max(e_req, window_pairs), window_pairs)
        e = e_req
        # pad pairs point at the LAST row so the anchor order stays sorted
        # across the padding tail too (masked either way)
        out["pairs"] = np.full((b, 2, e), n - 1, np.int32)
        out["pair_mask"] = np.zeros((b, e), bool)
    dtypes = {"cluster_ids": np.int32, "recons": np.float32, "pts": np.float32,
              "y": np.float32, "is_neu": bool}
    for name, dt in dtypes.items():
        if getattr(events[0], name) is not None:
            out[name] = np.zeros((b, n), dt)

    for i, ev in enumerate(events):
        ni = ev.n
        out["x"][i, :ni] = ev.x
        out["coords"][i, :ni] = ev.coords
        out["valid"][i, :ni] = True
        for name in dtypes:
            val = getattr(ev, name)
            if val is not None:
                out[name][i, :ni] = val
        if has_pairs:
            pairs, pmask, rev, has_cluster = processed[i]
            ei = pairs.shape[1]
            out["pairs"][i, :, :ei] = pairs
            out["pair_mask"][i, :ei] = pmask if pmask is not None else True
            if window_pairs and has_cluster:
                if "pair_rev" not in out:
                    out["pair_rev"] = np.tile(np.arange(e, dtype=np.int32), (b, 1))
                    out["pair_weight"] = np.zeros((b, e), np.float32)
                    out["pair_neg"] = np.zeros((b, e), bool)
                out["pair_rev"][i, :ei] = rev
                w_i, neg_i = _pair_cluster_weights(
                    pairs, pmask, ev.cluster_ids, ev.recons, ev.pts
                )
                out["pair_weight"][i, :ei] = w_i
                out["pair_neg"][i, :ei] = neg_i
    return out
