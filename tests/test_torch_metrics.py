"""The port's kNN and tracking retrieval metrics against the JAX package's,
on the same embeddings (numpy, from a seed).

Cases: clustered Gaussian embeddings, a noise cluster 0, invalid pad rows,
an event smaller than K+1, and query tiles that do not divide n. Invalid
rows sit at +inf distance, where the two top-k routines order ties
differently; per-point scores are therefore compared on valid points (pad
rows are never scored), and kNN indices only at finite distances.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from hept_tpu.ops import knn as jknn  # noqa: E402
from hept_tpu.train import metrics as jm  # noqa: E402
from hept_tpu_torch.ops.knn import knn_brute_force  # noqa: E402
from hept_tpu_torch.train import metrics as tm  # noqa: E402


def _event(seed, n, n_pad, n_clusters, d=6, noise=0.2):
    """n real points in Gaussian clusters (ids 1..C, a `noise` share in the
    noise cluster 0, scattered), then n_pad invalid rows."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * 3.0
    cid = rng.integers(1, n_clusters + 1, n)
    cid[rng.random(n) < noise] = 0
    emb = np.where(cid[:, None] > 0, centers[np.maximum(cid, 1) - 1], 0.0)
    emb = emb + rng.normal(size=(n, d)) * np.where(cid[:, None] > 0, 0.6, 3.0)
    recons = (rng.random(n) < 0.9).astype(np.float32)
    pts = rng.uniform(0.0, 2.0, n).astype(np.float32)
    pad = lambda a, v: np.concatenate([a, np.full((n_pad,) + a.shape[1:], v, a.dtype)])  # noqa
    emb = pad(emb.astype(np.float32), 0.0)
    emb[n:] = rng.normal(size=(n_pad, d)).astype(np.float32)
    valid = np.arange(n + n_pad) < n
    return (emb, pad(cid.astype(np.int32), 0), pad(recons, 0.0), pad(pts, 0.0), valid)


CASES = {
    "clusters_pads_ragged_tiles": dict(seed=0, n=300, n_pad=37, n_clusters=30, tile=64),
    "no_pads_one_tile": dict(seed=1, n=256, n_pad=0, n_clusters=12, tile=2048),
    "smaller_than_k_plus_1": dict(seed=2, n=12, n_pad=3, n_clusters=3, tile=4),
}


@pytest.mark.parametrize("k,tile", [(8, 64), (20, 1024), (5, 7)])
def test_knn_matches_jax(k, tile):
    emb, _, _, _, valid = _event(3, 300, 20, 25)
    q = np.random.default_rng(4).normal(size=(133, emb.shape[1])).astype(np.float32) * 3
    jd, ji = jknn.knn_brute_force(jnp.asarray(q), jnp.asarray(emb), k, valid=jnp.asarray(valid),
                                  tile=tile)
    d, i = knn_brute_force(torch.from_numpy(q), torch.from_numpy(emb), k,
                           valid=torch.from_numpy(valid), tile=tile)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5)
    # self-queries: every point's nearest is itself; invalid columns never
    # appear while k valid points exist
    d, i = knn_brute_force(torch.from_numpy(emb), torch.from_numpy(emb), k,
                           valid=torch.from_numpy(valid), tile=tile)
    np.testing.assert_array_equal(i[:300, 0].numpy(), np.arange(300))
    assert valid[i.numpy()].all() and np.isfinite(d.numpy()).all()


@pytest.mark.parametrize("case", list(CASES))
def test_retrieval_scores_match_jax(case):
    c = dict(CASES[case])
    tile = c.pop("tile")
    emb, cid, rec, pts, valid = _event(**c)
    mask = np.asarray(jm.point_filter(cid, rec, pts, 0.5)) & valid
    k = 19
    jout = jm._knn_retrieval_scores(jnp.asarray(emb), jnp.asarray(cid), jnp.asarray(mask),
                                    jnp.asarray(valid), k=k, tile=tile)
    tout = tm._knn_retrieval_scores(torch.from_numpy(emb), torch.from_numpy(cid),
                                    torch.from_numpy(mask), torch.from_numpy(valid), k=k,
                                    tile=tile)
    for name, a, b in zip(("acc", "prec", "recall"), tout[:3], jout[:3]):
        np.testing.assert_allclose(a.numpy()[valid], np.asarray(b)[valid], rtol=0, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    assert tout[3].any()

    ja = jm.acc_and_pr_at_k(jnp.asarray(emb), jnp.asarray(cid), jnp.asarray(mask),
                            jnp.asarray(valid), k=k, tile=tile)
    ta = tm.acc_and_pr_at_k(torch.from_numpy(emb), torch.from_numpy(cid), torch.from_numpy(mask),
                            torch.from_numpy(valid), k=k, tile=tile)
    np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-6)


@pytest.mark.parametrize("tile", [64, 2048])
def test_tracking_metrics_batch_matches_jax(tile):
    """A (2, N) batch: two events of different real sizes packed to one N."""
    evs = [_event(5, 300, 40, 28), _event(6, 260, 80, 20)]
    b = [np.stack(a) for a in zip(*evs)]
    want = np.asarray(jm.tracking_metrics_batch(*(jnp.asarray(a) for a in b), tile=tile))
    got = tm.tracking_metrics_batch(*(torch.from_numpy(a) for a in b), tile=tile)
    assert got.shape == (2, 3, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert ((want > 0) & (want <= 1)).all()
