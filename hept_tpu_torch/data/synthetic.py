"""Synthetic tracking and pileup events (own copy of
`hept_tpu/data/synthetic.py`).

Tracks are clusters of hits around an (eta, phi) centre whose features
correlate with the track, so contrastive embedding learning is possible.
coords = [eta, phi, x[:, :4]] -> coords_dim = 6.

Supervision pairs follow the JAX package's rule: the native grid-hash
library (`native/`, built with g++ at first use) wherever it builds, else
scipy's cKDTree, which returns a different pair set (kNN-capped); the backend
is logged once (`pairs_backend`). The two generators draw the same points
from the same seed, so on one host the whole set is the JAX package's.
"""

from __future__ import annotations

import logging

import numpy as np
from scipy.spatial import cKDTree

from .. import native
from .batching import Event

_BACKEND_LOGGED = False


def synthetic_tracking_event(
    rng: np.random.Generator,
    n_points: int = 1000,
    avg_track_size: int = 8,
    max_track_size: int = 20,
    noise_frac: float = 0.1,
    n_feature_dim: int = 10,
    pairs_per_point: int = 32,
    pair_radius: float = 0.5,
) -> Event:
    """Generate one tracking event; cluster sizes are capped at
    max_track_size."""
    n_noise = int(n_points * noise_frac)
    n_hits = n_points - n_noise
    sizes = []
    while sum(sizes) < n_hits:
        sizes.append(int(np.clip(rng.poisson(avg_track_size), 2, max_track_size)))
    sizes[-1] -= sum(sizes) - n_hits
    if sizes[-1] < 2:
        sizes.pop()
        n_noise = n_points - sum(sizes)

    etas, phis, cids, pts_l, recons_l, feats = [], [], [], [], [], []
    for tid, size in enumerate(sizes, start=1):
        center = rng.uniform(-3, 3), rng.uniform(-np.pi, np.pi)
        pt = float(rng.lognormal(0.0, 0.8))
        recon = 1.0 if size >= 3 else 0.0
        spread = 0.05
        etas.append(center[0] + rng.normal(0, spread, size))
        phis.append(center[1] + rng.normal(0, spread, size))
        cids.append(np.full(size, tid))
        pts_l.append(np.full(size, pt))
        recons_l.append(np.full(size, recon))
        base = rng.normal(0, 1, n_feature_dim)
        feats.append(base[None, :] + rng.normal(0, 0.3, (size, n_feature_dim)))
    # noise points: cluster id 0
    etas.append(rng.uniform(-4, 4, n_noise))
    phis.append(rng.uniform(-np.pi, np.pi, n_noise))
    cids.append(np.zeros(n_noise))
    pts_l.append(np.zeros(n_noise))
    recons_l.append(np.zeros(n_noise))
    feats.append(rng.normal(0, 1, (n_noise, n_feature_dim)))

    eta = np.concatenate(etas).astype(np.float32)
    phi = np.concatenate(phis).astype(np.float32)
    cid = np.concatenate(cids).astype(np.int32)
    pts = np.concatenate(pts_l).astype(np.float32)
    recons = np.concatenate(recons_l).astype(np.float32)
    x = np.concatenate(feats).astype(np.float32)

    perm = rng.permutation(n_points)
    eta, phi, cid, pts, recons, x = (
        eta[perm], phi[perm], cid[perm], pts[perm], recons[perm], x[perm]
    )
    coords = np.concatenate([eta[:, None], phi[:, None], x[:, :4]], axis=1)
    pairs = radius_pairs(eta, phi, pair_radius, pairs_per_point)
    return Event(
        x=x, coords=coords.astype(np.float32), cluster_ids=cid,
        recons=recons, pts=pts, pairs=pairs,
    )


def pairs_backend() -> str:
    """The backend `radius_pairs` uses on this host: "native-grid-hash" where
    the native library builds, else "cKDTree-knn-capped" (the JAX package's
    names)."""
    return "native-grid-hash" if native.native_available() else "cKDTree-knn-capped"


def radius_pairs(eta, phi, radius, k):
    """Supervision pairs: up to k neighbours within `radius` per point,
    (2, E) int32 with the anchor in row 0 (the role of the reference's
    radius-graph pairs, src/datasets/tracking.py:204-209). The native
    grid-hash library returns every in-radius pair up to the k nearest;
    without it, cKDTree's k nearest that lie within the radius (JAX:
    `hept_tpu/data/synthetic.py:96-131`)."""
    global _BACKEND_LOGGED
    backend = pairs_backend()
    if not _BACKEND_LOGGED:
        logging.getLogger(__name__).info("synthetic supervision pairs backend: %s", backend)
        _BACKEND_LOGGED = True
    if backend == "native-grid-hash":
        return native.radius_pairs(np.asarray(eta, np.float32), np.asarray(phi, np.float32),
                                   radius, k).astype(np.int32)
    n = len(eta)
    pos = np.stack([eta, phi], axis=1).astype(np.float64)
    tree = cKDTree(pos)
    # query k+1 nearest (self included), keep those within radius
    kk = min(k + 1, n)
    dist, idx = tree.query(pos, k=kk)
    if kk == 1:
        dist, idx = dist[:, None], idx[:, None]
    src = np.repeat(np.arange(n), kk - 1)
    dst = idx[:, 1:].reshape(-1)
    good = dist[:, 1:].reshape(-1) < radius
    src, dst = src[good], dst[good]
    if len(src) == 0:
        return np.zeros((2, 0), np.int32)
    return np.stack([src, dst]).astype(np.int32)


def synthetic_pileup_event(
    rng: np.random.Generator,
    n_points: int = 1000,
    n_feature_dim: int = 8,
    neutral_frac: float = 0.3,
) -> Event:
    """One pileup event: per-point binary labels that follow a latent density
    field over (eta, phi), the PID integer in the last feature column, and
    evaluation on neutral high-pT points (`is_neu`). The same draws, in the
    same order, as the JAX package's generator, so one seed gives the same
    event in both. coords = [eta, phi, x[:, :2]] -> coords_dim = 4."""
    eta = rng.uniform(-4, 4, n_points).astype(np.float32)
    phi = rng.uniform(-np.pi, np.pi, n_points).astype(np.float32)
    centers = rng.uniform(-3, 3, (8, 2))
    pos = np.stack([eta, phi], axis=1)
    score = sum(
        np.exp(-np.linalg.norm(pos - c[None], axis=1) ** 2 / 0.5) for c in centers
    )
    y = (score + rng.normal(0, 0.2, n_points) > np.median(score)).astype(np.float32)
    pt = rng.lognormal(0, 0.8, n_points).astype(np.float32)
    charge_neutral = rng.uniform(size=n_points) < neutral_frac
    is_neu = charge_neutral & (pt > 0.9)
    pid = rng.integers(0, 7, n_points)
    feats = rng.normal(0, 1, (n_points, n_feature_dim - 1)).astype(np.float32)
    feats[:, 0] += y * 1.0  # the label shows in one feature: the task is learnable
    x = np.concatenate([feats, pid[:, None].astype(np.float32)], axis=1)
    coords = np.concatenate([pos, x[:, :2]], axis=1)
    return Event(x=x, coords=coords.astype(np.float32), y=y, is_neu=is_neu)
