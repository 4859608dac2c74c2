"""Synthetic tracking and pileup datasets with the reference's 80/10/10
split (own copy of `hept_tpu/data/datasets.py`), and the dispatch of the
reference's processed archives to `loaders.py`."""

from __future__ import annotations

import dataclasses

import numpy as np

from .batching import pack_events
from .synthetic import synthetic_pileup_event, synthetic_tracking_event


@dataclasses.dataclass
class SplitDataset:
    train: list
    valid: list
    test: list
    in_dim: int
    coords_dim: int

    def iter_batches(self, split: str, batch_size: int, block_size: int,
                     n_max: int | None = None,
                     shuffle_rng: np.random.Generator | None = None,
                     aug_pair_p: float = 0.0, window_pairs: int = 0,
                     drop_last: bool | None = None):
        """Yield packed batches. A trailing partial batch is dropped when
        `drop_last` (None: when training, i.e. `shuffle_rng` is set, which
        keeps the batch divisible over data-parallel ranks); eval keeps it.
        Training draws the pair augmentation from `shuffle_rng`. Events keep
        their processed base pairs between calls (`cache`)."""
        if drop_last is None:
            drop_last = shuffle_rng is not None
        events = getattr(self, split)
        order = np.arange(len(events))
        if shuffle_rng is not None:
            shuffle_rng.shuffle(order)
        for i in range(0, len(order), batch_size):
            chunk = order[i : i + batch_size]
            if len(chunk) < batch_size and drop_last:
                break
            yield pack_events(
                [events[j] for j in chunk], block_size, n_max=n_max,
                aug_pair_p=aug_pair_p if shuffle_rng is not None else 0.0,
                aug_rng=shuffle_rng, window_pairs=window_pairs, cache=True,
            )


def _split(events: list) -> SplitDataset:
    n_tr = int(len(events) * 0.8)
    n_va = max(1, int(len(events) * 0.1))
    return SplitDataset(
        train=events[:n_tr],
        valid=events[n_tr : n_tr + n_va],
        test=events[n_tr + n_va :] or events[-1:],
        in_dim=events[0].x.shape[1],
        coords_dim=events[0].coords.shape[1],
    )


def make_synthetic_tracking(n_events: int = 20, n_points: int = 1000,
                            seed: int = 0, **kwargs) -> SplitDataset:
    rng = np.random.default_rng(seed)
    sizes = rng.integers(int(n_points * 0.8), n_points + 1, n_events)
    return _split([synthetic_tracking_event(rng, n_points=int(s), **kwargs) for s in sizes])


def make_synthetic_pileup(n_events: int = 20, n_points: int = 1000,
                          seed: int = 0, **kwargs) -> SplitDataset:
    rng = np.random.default_rng(seed)
    sizes = rng.integers(int(n_points * 0.8), n_points + 1, n_events)
    return _split([synthetic_pileup_event(rng, n_points=int(s), **kwargs) for s in sizes])


def get_dataset(name: str, seed: int = 0, **kwargs) -> SplitDataset:
    """`synthetic-tracking-<n>[k]` datasets, e.g. synthetic-tracking-60k, and
    `synthetic-pileup` (events of up to 1000 points; as in the JAX package,
    the name takes no size); the reference's processed `tracking-*` and
    `pileup` archives (`loaders.load_reference_dataset`, keyword
    `data_dir`)."""
    if name.startswith("synthetic-pileup"):
        return make_synthetic_pileup(seed=seed, **kwargs)
    if name.startswith("tracking-") or name == "pileup":
        from .loaders import load_reference_dataset

        return load_reference_dataset(name, **kwargs)
    if not name.startswith("synthetic-tracking"):
        raise NotImplementedError(name)
    tail = name.rsplit("-", 1)[-1]
    n_points = int(tail.replace("k", "000")) if tail[-1] in "k0123456789" \
        and tail[0].isdigit() else 1000
    return make_synthetic_tracking(n_points=n_points, seed=seed, **kwargs)
