"""hept_tpu_torch.data against hept_tpu.data: the packed arrays of identical
events are equal exactly. The generators draw the same points from the same
seed; pairs are compared here through `pack_events`, and whole, with the
backend both packages pick, in `test_torch_native.py`."""

import numpy as np
import pytest

pytest.importorskip("torch")

from hept_tpu.data import batching as jb  # noqa: E402
from hept_tpu.data.synthetic import synthetic_tracking_event as jax_synthetic  # noqa: E402
from hept_tpu_torch.data import batching as tb  # noqa: E402
from hept_tpu_torch.data.datasets import get_dataset  # noqa: E402
from hept_tpu_torch.data.synthetic import radius_pairs, synthetic_tracking_event  # noqa: E402


def _events(n_events=2, n_points=700):
    rng = np.random.default_rng(11)
    return [synthetic_tracking_event(rng, n_points=n_points - 37 * i, pairs_per_point=12)
            for i in range(n_events)]


def _as_jax_event(ev):
    return jb.Event(x=ev.x, coords=ev.coords, cluster_ids=ev.cluster_ids, recons=ev.recons,
                    pts=ev.pts, pairs=ev.pairs)


def test_generator_draws_match_jax():
    a = synthetic_tracking_event(np.random.default_rng(3), n_points=500)
    b = jax_synthetic(np.random.default_rng(3), n_points=500)
    for name in ("x", "coords", "cluster_ids", "recons", "pts"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert a.pairs.dtype == np.int32 and a.pairs.shape[0] == 2


@pytest.mark.parametrize("window,aug", [(128, 0.0), (128, 0.2), (0, 0.2)])
def test_pack_events_matches_jax(window, aug):
    evs = _events()
    got = tb.pack_events(evs, block_size=64, n_max=tb.slab_friendly_n(700, 64),
                         aug_pair_p=aug, aug_rng=np.random.default_rng(9),
                         window_pairs=window)
    want = jb.pack_events([_as_jax_event(e) for e in evs], block_size=64,
                          n_max=jb.slab_friendly_n(700, 64), aug_pair_p=aug,
                          aug_rng=np.random.default_rng(9), window_pairs=window)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cached_pack_matches_jax_over_epochs():
    """The training loader's cached packing (base block once per event, a
    fresh augmentation block per call) equals JAX's cache=True packing, call
    after call from the same rng stream."""
    evs = _events()
    jevs = [_as_jax_event(e) for e in evs]
    rng_t, rng_j = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(2):
        got = tb.pack_events(evs, block_size=64, aug_pair_p=0.2, aug_rng=rng_t,
                             window_pairs=128, cache=True)
        want = jb.pack_events(jevs, block_size=64, aug_pair_p=0.2, aug_rng=rng_j,
                              window_pairs=128, cache=True)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert all(128 in e.pair_cache for e in evs)


def test_windowed_layout_invariants():
    """Anchor-sorted, aligned 128-pair windows spanning < 128 rows, a
    reversal-closed real pair set, pads masked."""
    b = tb.pack_events(_events(1), block_size=64, window_pairs=128)
    p, m, rev = b["pairs"][0], b["pair_mask"][0], b["pair_rev"][0]
    assert p.shape[1] % 128 == 0
    assert (np.diff(p[0]) >= 0).all()
    w = p[0].reshape(-1, 128)
    real = m.reshape(-1, 128)
    span = np.where(real, w, w[:, :1]).max(1) - np.where(real, w, w[:, :1]).min(1)
    assert (span < 128).all()
    np.testing.assert_array_equal(p[0, rev[m]], p[1, m])
    np.testing.assert_array_equal(p[1, rev[m]], p[0, m])
    assert not (b["pair_neg"][0] & ~m).any()
    assert b["pair_weight"][0][~m].sum() == 0


def test_slab_friendly_n():
    for n, bs in ((60000, 512), (6000, 512), (1000, 100), (300, 16)):
        assert tb.slab_friendly_n(n, bs) == jb.slab_friendly_n(n, bs)
    assert tb.slab_friendly_n(60000, 512) == 60416


def test_radius_pairs_and_dataset(tmp_path):
    eta = np.asarray([0.0, 0.1, 0.2, 3.0], np.float32)
    phi = np.zeros(4, np.float32)
    pairs = radius_pairs(eta, phi, 0.15, 2)
    assert {tuple(x) for x in pairs.T} == {(0, 1), (1, 0), (1, 2), (2, 1)}
    ds = get_dataset("synthetic-tracking-300", seed=0, n_events=5)
    assert len(ds.train) == 4 and ds.in_dim == 10 and ds.coords_dim == 6
    assert max(ev.n for ev in ds.train) <= 300
    # reference names go to the reference-archive loader (data/loaders.py);
    # other names are refused
    with pytest.raises(FileNotFoundError):
        get_dataset("tracking-60k", data_dir=str(tmp_path))
    with pytest.raises(NotImplementedError):
        get_dataset("no-such-dataset")
