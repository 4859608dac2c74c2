"""The port's reference-data loader (`data/loaders.py`) and offline builders
(`data/builders/`) against the JAX package's.

Loaders: archives fabricated in the reference's collated layout by
`loaders.save_reference_dataset` from `tests/test_loaders.py`'s graphs
(node attributes concatenated along dim 0, index attributes along dim 1
offset by each graph's first node), the collated object pickled as
`torch_geometric.data.Data`, the class PyG's archives name: JAX's loader
reads it through its stub module, the port's through its own unpickler
(no PyG here). Events, pairs and splits bit for bit. Builders:
`tests/test_builder.py`'s toy raw TrackML frames and raw Delphes-like
columns, events bit for bit.
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hept_tpu_torch.data import loaders  # noqa: E402
from hept_tpu_torch.data.datasets import get_dataset  # noqa: E402

EVENT_FIELDS = ("x", "coords", "cluster_ids", "recons", "pts", "pairs", "y", "is_neu")


def _tracking_graphs():
    from test_loaders import _tracking_graph

    rng = np.random.default_rng(0)
    sizes = [40, 56, 32, 48, 36, 44, 52, 40, 60, 36, 50, 42]
    evtids = [29005, 3, 17, 29001, 8, 21, 5, 12, 28999, 7, 40, 1]
    return [_tracking_graph(rng, n, e) for n, e in zip(sizes, evtids)]


def _pileup_graphs():
    rng = np.random.default_rng(1)
    graphs = []
    for n in [30, 44, 38, 26, 50]:
        pids = rng.integers(0, 7, n).astype(np.float32)
        x = np.concatenate([rng.standard_normal((n, 7)).astype(np.float32), pids[:, None]], 1)
        graphs.append(dict(x=x, pos=rng.standard_normal((n, 2)).astype(np.float32),
                           y=rng.integers(0, 2, n).astype(np.int64),
                           is_neu=rng.random(n) < 0.4,
                           edge_index=np.stack([rng.integers(0, n, 2 * n),
                                                rng.integers(0, n, 2 * n)]).astype(np.int64)))
    return graphs


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """tracking-6k (evtid split; stored split ignored), pileup (stored
    split) and pileup-nosplit (80/10/10 in stored order)."""
    root = tmp_path_factory.mktemp("ref_data")
    loaders.save_reference_dataset(
        _tracking_graphs(), "tracking-6k", root, ("point_pairs_index_rad", "knn_edge_index_k60"),
        {"train": np.arange(8), "valid": np.array([8]), "test": np.arange(9, 12)})
    pu = _pileup_graphs()
    loaders.save_reference_dataset(pu, "pileup", root, ("edge_index",),
                                   {"train": np.array([0, 1, 2]), "valid": np.array([3]),
                                    "test": np.array([4])})
    loaders.save_reference_dataset(pu, "pileup-nosplit", root, ("edge_index",))
    return root


def _same_dataset(got, want):
    assert (got.in_dim, got.coords_dim) == (want.in_dim, want.coords_dim)
    for split in ("train", "valid", "test"):
        g, w = getattr(got, split), getattr(want, split)
        assert len(g) == len(w), split
        for eg, ew in zip(g, w):
            for f in EVENT_FIELDS:
                a, b = getattr(eg, f), getattr(ew, f)
                assert (a is None) == (b is None), f
                if a is not None:
                    assert a.dtype == b.dtype, f
                    np.testing.assert_array_equal(a, b, err_msg=f"{split} {f}")


@pytest.mark.parametrize("name", ["tracking-6k", "pileup", "pileup-nosplit"])
def test_loader_matches_jax(archives, name):
    """Every event (features with the reference's transforms, de-offset
    pairs, dense particle ids with noise at 0, labels) and the split, bit
    for bit against JAX's `load_reference_dataset`."""
    from hept_tpu.data.loaders import load_reference_dataset as jax_load

    _same_dataset(loaders.load_reference_dataset(name, data_dir=str(archives)),
                  jax_load(name, data_dir=str(archives)))


def test_tracking_split_matches_jax():
    from hept_tpu.data.loaders import _tracking_split as jax_split

    rng = np.random.default_rng(3)
    for n in (10, 12, 37, 100):
        evtids = rng.integers(0, 50, n)
        assert [list(map(int, s)) for s in loaders._tracking_split(evtids)] == \
            [list(map(int, s)) for s in jax_split(evtids)]


@pytest.mark.parametrize("name", ["tracking-6k", "pileup"])
def test_get_dataset_dispatch(archives, name):
    """`get_dataset` hands the reference names to the loader, as JAX's."""
    from hept_tpu.data.datasets import get_dataset as jax_get

    _same_dataset(get_dataset(name, data_dir=str(archives)),
                  jax_get(name, data_dir=str(archives)))


def test_loader_reads_its_own_class(archives):
    """The port unpickles PyG's classes into its own `RefData`, never into
    the JAX package's stub class, and leaves sys.modules as it was."""
    import hept_tpu.data.loaders as jl

    jl._install_pyg_stubs()  # JAX's stub module present in this process
    before = {k: v for k, v in sys.modules.items() if k.startswith("torch_geometric")}
    payload = torch.load(archives / "pileup" / "processed" / "data.pt", weights_only=False,
                         pickle_module=loaders._PICKLE)
    assert type(payload[0]) is loaders.RefData
    loaders.load_reference_dataset("pileup", data_dir=str(archives))
    after = {k: v for k, v in sys.modules.items() if k.startswith("torch_geometric")}
    assert after.keys() == before.keys() and all(after[k] is before[k] for k in before)


def test_loader_missing_archive(tmp_path):
    with pytest.raises(FileNotFoundError):
        loaders.load_reference_dataset("tracking-60k", data_dir=str(tmp_path))


def _same_event(a, b):
    for f in EVENT_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("n_sectors,edges", [(1, True), (4, False)])
def test_point_cloud_builder_matches_jax(n_sectors, edges):
    """`PointCloudBuilder.build_event` on the toy raw frames: each sector's
    event (features, coords, dense ids, reconstructability, pt, true
    edges) bit for bit against JAX's."""
    from test_builder import _toy_raw

    from hept_tpu.data.builders.trackml import PointCloudBuilder as JaxBuilder
    from hept_tpu_torch.data.builders import PointCloudBuilder

    hits, particles, truth, cells, detector = _toy_raw(n_hits=120, seed=1)
    kw = dict(detector=detector, n_sectors=n_sectors, add_true_edges=edges)
    got = PointCloudBuilder(**kw).build_event(hits, particles, truth, cells)
    want = JaxBuilder(**kw).build_event(hits, particles, truth, cells)
    assert len(got) == len(want) == n_sectors
    for a, b in zip(got, want):
        _same_event(a, b)


def test_builder_helpers_match_jax():
    """get_truth_edges and preprocess_detector's tables, and the build
    without a detector table, as JAX's."""
    from test_builder import _toy_raw

    from hept_tpu.data.builders import trackml as jt
    from hept_tpu_torch.data.builders import trackml as pt

    pids = np.random.default_rng(2).integers(0, 6, 50)
    np.testing.assert_array_equal(pt.get_truth_edges(pids), jt.get_truth_edges(pids))
    hits, particles, truth, cells, detector = _toy_raw()
    got, want = pt.preprocess_detector(detector), jt.preprocess_detector(detector)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    _same_event(pt.PointCloudBuilder().build_event(hits, particles, truth, cells)[0],
                jt.PointCloudBuilder().build_event(hits, particles, truth, cells)[0])


def test_pileup_builder_matches_jax():
    """remap_pid and build_one_pileup_event on raw Delphes-like columns
    (the same generator state on both sides): bit for bit."""
    from hept_tpu.data.builders import pileup as jp
    from hept_tpu_torch.data.builders import pileup as pp

    rng = np.random.default_rng(4)
    n = 64
    pid = rng.choice([211, -211, 22, 130, 310, 2112, -2112, 3122, 3322, 11], n)
    charge = np.where(np.isin(np.abs(pid), [211, 11]), np.sign(pid), 0)
    np.testing.assert_array_equal(pp.remap_pid(pid, charge), jp.remap_pid(pid, charge))
    cols = {k: rng.normal(size=n) for k in ("Eta", "Phi", "Px", "Py", "E", "Rapidity")}
    cols.update(PT=rng.uniform(0, 3, n), PID=pid, Charge=charge, IsPU=rng.integers(0, 2, n))
    _same_event(pp.build_one_pileup_event(cols, np.random.default_rng(7)),
                jp.build_one_pileup_event(cols, np.random.default_rng(7)))


def test_pileup_builder_needs_uproot(tmp_path):
    """Without uproot the ROOT reader raises ImportError, naming it."""
    if _has("uproot"):
        pytest.skip("uproot is installed")
    from hept_tpu_torch.data.builders.pileup import build_pileup_events

    with pytest.raises(ImportError, match="uproot"):
        build_pileup_events(str(tmp_path / "none.root"))


def _has(mod: str) -> bool:
    import importlib.util

    return importlib.util.find_spec(mod) is not None
