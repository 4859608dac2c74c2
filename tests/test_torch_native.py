"""The port's native host kernels (`hept_tpu_torch/native/`, its own copy of
the C++ source, built with g++ into `hept_tpu_torch/_build/`) against the
JAX package's (`hept_tpu.native`), bit for bit, and the synthetic tracking
set, which now builds its pairs with the same backend as JAX's (the native
grid hash where g++ builds it), equal to JAX's whole: points, labels and
pairs."""

import logging

import numpy as np
import pytest

from hept_tpu import native as jax_native
from hept_tpu.data.datasets import make_synthetic_tracking as jax_tracking
from hept_tpu_torch import native
from hept_tpu_torch.data import synthetic
from hept_tpu_torch.data.datasets import make_synthetic_tracking


@pytest.fixture(scope="module", autouse=True)
def require_native():
    if not (native.native_available() and jax_native.native_available()):
        pytest.skip("no C++ toolchain available")


@pytest.mark.parametrize("radius,max_k", [(0.5, 300), (0.3, 5), (1.0, 1)])
def test_radius_pairs_bits(radius, max_k):
    rng = np.random.default_rng(0)
    eta = rng.uniform(-3, 3, 300).astype(np.float32)
    phi = rng.uniform(-3, 3, 300).astype(np.float32)
    got = native.radius_pairs(eta, phi, radius, max_k)
    want = jax_native.radius_pairs(eta, phi, radius, max_k)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert np.bincount(got[0], minlength=300).max() <= max_k


def test_pack_dense_bits():
    rng = np.random.default_rng(2)
    events = [rng.normal(size=(n, 3)).astype(np.float32) for n in (5, 2, 6)]
    got, got_valid = native.pack_dense(events, n_max=6)
    want, want_valid = jax_native.pack_dense(events, n_max=6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_valid, want_valid)
    assert got_valid.sum(1).tolist() == [5, 2, 6]


@pytest.mark.parametrize("k", [6, 60])
def test_knn_small_bits(k):
    """k past n: the +inf / -1 tail too."""
    x = np.random.default_rng(3).normal(size=(50, 4)).astype(np.float32)
    got_d, got_i = native.knn_small(x, k)
    want_d, want_i = jax_native.knn_small(x, k)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_i, want_i)


def test_synthetic_tracking_set_is_jaxs(caplog):
    """make_synthetic_tracking: every event of every split equal to JAX's,
    the pairs included; the backend is logged once, by its JAX name."""
    synthetic._BACKEND_LOGGED = False
    with caplog.at_level(logging.INFO, logger=synthetic.__name__):
        got = make_synthetic_tracking(n_events=4, n_points=1500, seed=3, avg_track_size=8,
                                      pairs_per_point=16)
    assert [r.getMessage() for r in caplog.records] == [
        "synthetic supervision pairs backend: native-grid-hash"]
    want = jax_tracking(n_events=4, n_points=1500, seed=3, avg_track_size=8,
                        pairs_per_point=16)
    for split in ("train", "valid", "test"):
        a, b = getattr(got, split), getattr(want, split)
        assert len(a) == len(b)
        for ea, eb in zip(a, b):
            for name in ("x", "coords", "cluster_ids", "recons", "pts", "pairs"):
                np.testing.assert_array_equal(getattr(ea, name), getattr(eb, name),
                                              err_msg=f"{split} {name}")
    assert synthetic.pairs_backend() == "native-grid-hash"


def test_backends_pack_alike(monkeypatch):
    """At the 60k demo's pair settings (16 pairs a point, radius 0.5) the
    grid-hash and the cKDTree backends find the same pair set, and
    `pack_events` orders it alike: the packed batches are equal, array for
    array (so accuracies measured on either pair set hold for both)."""
    from hept_tpu_torch.data.batching import pack_events

    batches = []
    for backend in ("native-grid-hash", "cKDTree-knn-capped"):
        monkeypatch.setattr(synthetic, "pairs_backend", lambda b=backend: b)
        ev = synthetic.synthetic_tracking_event(np.random.default_rng(3), n_points=6000,
                                                avg_track_size=8, pairs_per_point=16)
        batches.append(pack_events([ev], block_size=100, window_pairs=128, aug_pair_p=0.2,
                                   aug_rng=np.random.default_rng(1)))
    a, b = batches
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
