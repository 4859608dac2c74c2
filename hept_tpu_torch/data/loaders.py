"""Loader of the reference's processed datasets (port of
`hept_tpu/data/loaders.py`).

The reference ships PyG `InMemoryDataset` archives, `<name>/processed/
data.pt`: a collated `Data`, its slices and, for pileup, the split
(`src/datasets/tracking.py:85`, `pileup.py:34`). Reading one normally needs
torch_geometric. Here the archive is unpickled by an unpickler of the
port's own (`_RefUnpickler`, passed to `torch.load` as its pickle module):
every class of a `torch_geometric` module is read as a plain attribute bag,
`RefData`, so no PyG install and no stub module in `sys.modules` is needed.
`save_reference_dataset` writes the same layout (PyG's collate of graphs
given as arrays) for tests and smoke runs.
The events then get the reference's per-sample transforms:

- TrackingTransform (tracking.py:26-35): x <- [x, layer / 10],
  coords = [pos, x[:, :4]];
- PileupTransform (pileup.py:22-27): coords = [pos, x[:, :2]].
"""

from __future__ import annotations

import pickle
import types
from pathlib import Path

import numpy as np

from .batching import Event
from .datasets import SplitDataset


class RefData:
    """What a pickled PyG object (`Data`, its storages) is read as: its
    pickled state as attributes."""

    def __init__(self, *args, **kwargs):
        self.__dict__.update(kwargs)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:  # a nested mapping
            try:
                self.__dict__.update(dict(state))
            except (TypeError, ValueError):
                self.__dict__["_state"] = state


class _RefUnpickler(pickle.Unpickler):
    """Reads any class of a torch_geometric module as `RefData`."""

    def find_class(self, module, name):
        if module == "torch_geometric" or module.startswith("torch_geometric."):
            return RefData
        return super().find_class(module, name)


class _RefPickler(pickle._Pickler):
    """Writes `RefData` under the class name PyG's archives use,
    torch_geometric.data.Data."""

    def save_global(self, obj, name=None):
        if obj is RefData:
            self.write(pickle.GLOBAL + b"torch_geometric.data\nData\n")
            self.memoize(obj)
            return
        super().save_global(obj, name)


# `torch.load` / `torch.save`'s pickle module: the standard one with the
# (un)pickler above
_PICKLE = types.SimpleNamespace(**{k: getattr(pickle, k) for k in dir(pickle)
                                   if not k.startswith("__")})
_PICKLE.Unpickler = _RefUnpickler
_PICKLE.Pickler = _RefPickler
_PICKLE.__name__ = "pickle"


def collate_graphs(graphs: list, index_keys: tuple) -> tuple:
    """PyG's collate of graphs given as dicts of arrays: (RefData, slices).
    Node attributes concatenate along dim 0; the `index_keys` attributes
    along dim 1, each graph's values offset by its first node
    (Data.__inc__)."""
    import torch

    data, slices = RefData(), {}
    for k in graphs[0]:
        parts, bounds, off, node_off = [], [0], 0, 0
        for g in graphs:
            t = torch.as_tensor(np.asarray(g[k]))
            if k in index_keys:
                t = t + node_off
            parts.append(t)
            off += t.shape[1] if k in index_keys else t.shape[0]
            bounds.append(off)
            node_off += int(np.asarray(g["x"]).shape[0])
        setattr(data, k, torch.cat(parts, dim=1 if k in index_keys else 0))
        slices[k] = torch.tensor(bounds, dtype=torch.long)
    return data, slices


def save_reference_dataset(graphs: list, name: str, data_dir: str, index_keys: tuple,
                           idx_split: dict | None = None) -> Path:
    """Write `<data_dir>/<name>/processed/data.pt` in the reference's layout
    (the inverse of `load_reference_dataset`, for tests and smoke runs):
    the collated graphs, their slices and the optional split, the collated
    object pickled as torch_geometric.data.Data. Returns the path."""
    import torch

    path = Path(data_dir) / name / "processed" / "data.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = collate_graphs(graphs, index_keys)
    if idx_split is not None:
        payload += (idx_split,)
    torch.save(payload, path, pickle_module=_PICKLE)
    return path


def _get(obj, key):
    val = getattr(obj, key, None)
    if val is None and hasattr(obj, "_store"):
        store = obj._store
        val = store.get(key) if isinstance(store, dict) else getattr(store, key, None)
    return val


def _slice(tensor, slices, i):
    return tensor[int(slices[i]):int(slices[i + 1])]


def _tracking_split(evtids: np.ndarray) -> tuple[list, list, list]:
    """The reference's split: events sorted by evtid, 80/10/10 with n_train
    rounded down to a multiple of 10 (tracking.py get_new_idx_split:38-51)."""
    order = np.argsort(evtids, kind="stable")
    n = len(order)
    n_tr = int(n * 0.8)
    n_tr -= n_tr % 10
    n_va = int(n * 0.1)
    return list(order[:n_tr]), list(order[n_tr:n_tr + n_va]), list(order[n_tr + n_va:])


def _dense_ids(pid: np.ndarray) -> np.ndarray:
    """Dense particle ids with noise (pid 0) kept at 0."""
    _, dense = np.unique(pid, return_inverse=True)
    if (pid == 0).any():
        zero = dense[pid == 0][0]
        swap = dense.copy()
        swap[dense == zero] = 0
        swap[dense == 0] = zero
        dense = swap
    return dense


def _tracking_event(data, slices, i: int) -> Event:
    x = _slice(_get(data, "x"), slices["x"], i).numpy().astype(np.float32)
    pos = _slice(_get(data, "pos"), slices["pos"], i).numpy().astype(np.float32)
    layer = _slice(_get(data, "layer"), slices["layer"], i).numpy()
    x = np.concatenate([x, layer.reshape(-1, 1).astype(np.float32) / 10.0], axis=1)
    coords = np.concatenate([pos, x[:, :4]], axis=1)
    pid = _slice(_get(data, "particle_id"), slices["particle_id"], i).numpy()
    recons = _slice(_get(data, "reconstructable"), slices["reconstructable"], i).numpy()
    pt = _slice(_get(data, "pt"), slices["pt"], i).numpy()
    key = "point_pairs_index" if "point_pairs_index" in slices else "point_pairs_index_rad"
    # index attributes collate along dim 1, each graph's values offset by
    # its first node (PyG's Data.__inc__): take them back to the event
    pairs = _get(data, key)[:, int(slices[key][i]):int(slices[key][i + 1])].numpy()
    pairs = pairs.astype(np.int64) - int(slices["x"][i])
    if (pairs < 0).any() or (pairs >= x.shape[0]).any():
        raise ValueError(f"event {i}: pair indices out of range after de-offset (min "
                         f"{pairs.min()}, max {pairs.max()}, n {x.shape[0]})")
    return Event(x=x, coords=coords.astype(np.float32),
                 cluster_ids=_dense_ids(pid).astype(np.int32),
                 recons=recons.astype(np.float32), pts=pt.astype(np.float32),
                 pairs=pairs.astype(np.int32))


def _pileup_event(data, slices, i: int) -> Event:
    x = _slice(_get(data, "x"), slices["x"], i).numpy().astype(np.float32)
    pos = _slice(_get(data, "pos"), slices["pos"], i).numpy().astype(np.float32)
    y = _slice(_get(data, "y"), slices["y"], i).numpy().astype(np.float32)
    is_neu = _slice(_get(data, "is_neu"), slices["is_neu"], i).numpy()
    return Event(x=x, coords=np.concatenate([pos, x[:, :2]], axis=1).astype(np.float32),
                 y=y.reshape(-1), is_neu=is_neu.reshape(-1).astype(bool))


def load_reference_dataset(name: str, data_dir: str = "data/") -> SplitDataset:
    """Load `<data_dir>/<name>/processed/data.pt` (the reference's layout).

    The archive is (collated Data, slices[, idx_split]). PyG's collate
    concatenates node attributes along dim 0 and index attributes
    (`point_pairs_index_rad`, ...) along dim 1 with each graph's node
    offset added, so the pairs are taken back by `slices["x"][i]`.

    Splits: tracking re-derives the reference's evtid-sorted 80/10/10 split
    (`_tracking_split`); pileup takes the stored idx_split where there is
    one; else 80/10/10 in stored order.
    """
    import torch

    path = Path(data_dir) / name / "processed" / "data.pt"
    if not path.exists():
        raise FileNotFoundError(f"{path} not found: place the reference-processed dataset "
                                "there, or use a synthetic-* dataset")
    payload = torch.load(path, map_location="cpu", weights_only=False, pickle_module=_PICKLE)
    data, slices = payload[0], payload[1]
    idx_split = payload[2] if len(payload) > 2 else None
    n_events = len(slices["x"]) - 1
    tracking = "tracking" in name
    make = _tracking_event if tracking else _pileup_event
    events = [make(data, slices, i) for i in range(n_events)]
    evtid = _get(data, "evtid")
    if tracking and evtid is not None and "evtid" in slices:
        tr, va, te = _tracking_split(np.asarray(evtid).reshape(-1))
    elif idx_split is not None and all(k in idx_split for k in ("train", "valid", "test")):
        tr, va, te = ([int(j) for j in np.asarray(idx_split[k]).reshape(-1)]
                      for k in ("train", "valid", "test"))
    else:
        n_tr, n_va = int(n_events * 0.8), int(n_events * 0.1)
        tr, va, te = (list(range(n_tr)), list(range(n_tr, n_tr + n_va)),
                      list(range(n_tr + n_va, n_events)))
    return SplitDataset(train=[events[j] for j in tr], valid=[events[j] for j in va],
                        test=[events[j] for j in te], in_dim=events[0].x.shape[1],
                        coords_dim=events[0].coords.shape[1])
