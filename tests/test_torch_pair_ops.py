"""Plain K3/K4 (hept_tpu_torch.ops.pair_ops) against the JAX package's
windowed Pallas kernels in interpret mode, the differentiable pair ops, and
the windowed InfoNCE loss against JAX's (value and gradient, 1e-5)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from hept_tpu.ops.pair_ops import _gather_tpu, _scatter_add_tpu  # noqa: E402
from hept_tpu.train.losses import infonce_loss as jax_infonce  # noqa: E402
from hept_tpu_torch.data.batching import pack_events  # noqa: E402
from hept_tpu_torch.data.synthetic import synthetic_tracking_event  # noqa: E402
from hept_tpu_torch.ops.pair_ops import (  # noqa: E402
    CSR_BUILDS,
    anchor_csr,
    anchor_segment_sum,
    gather_rows_plain,
    pair_gather,
    pair_l2rbf_sim,
    segment_sum_plain,
)
from hept_tpu_torch.train.losses import infonce_loss  # noqa: E402


def _batch(n_points=600, seed=7):
    ev = synthetic_tracking_event(np.random.default_rng(seed), n_points=n_points,
                                  pairs_per_point=6)
    return pack_events([ev], block_size=64, window_pairs=128)


def _two_block_batch(n_points=600, seed=7):
    """The training loader's cached layout: the base block's windows, then
    the augmentation draw's, each anchor-sorted, their concatenation not."""
    ev = synthetic_tracking_event(np.random.default_rng(seed), n_points=n_points,
                                  pairs_per_point=6)
    return pack_events([ev], block_size=64, window_pairs=128, aug_pair_p=0.3,
                       aug_rng=np.random.default_rng(seed + 1), cache=True)


def _anchor_index(layout):
    """(idx, n) for a layout, with anchors that have no pairs."""
    if layout in ("random", "random_wide"):
        rng = np.random.default_rng(4)
        n = 500 if layout == "random" else 70000  # 16- and 32-bit sort keys
        idx = rng.integers(0, n, 3000 if layout == "random" else 200000)
        idx[(idx % 7) == 3] = 0  # every 7th anchor from 3 on gets no pairs
        return idx.astype(np.int32), n
    b = _batch() if layout == "sorted" else _two_block_batch()
    return b["pairs"][0, 0], b["x"].shape[1]


@pytest.mark.parametrize("layout", ["sorted", "two_block", "random", "random_wide"])
def test_anchor_csr_matches_numpy(layout):
    """order is numpy's stable argsort as int32; rowptr numpy's searchsorted
    of 0..n (an anchor without pairs has an empty row)."""
    idx, n = _anchor_index(layout)
    if layout == "two_block":
        assert (np.diff(idx) < 0).any()  # the concatenation is not sorted
    counts = np.bincount(idx, minlength=n)
    assert (counts == 0).any()
    before = CSR_BUILDS["anchor_csr"]
    order, rowptr = anchor_csr(torch.tensor(idx), n)
    assert CSR_BUILDS["anchor_csr"] == before + 1
    assert order.dtype == torch.int32 and rowptr.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), np.argsort(idx, kind="stable"))
    np.testing.assert_array_equal(rowptr.numpy(),
                                  np.searchsorted(np.sort(idx), np.arange(n + 1)))
    np.testing.assert_array_equal(np.diff(rowptr.numpy()), counts)


def test_plain_k3_k4_match_tpu_windowed_kernels():
    """Gather is exact; the segment sum matches to 1e-6 (sums in another
    order)."""
    b = _batch()
    idx = b["pairs"][0, 0]
    n = b["x"].shape[1]
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(n, 12)).astype(np.float32)
    vals = rng.normal(size=(idx.shape[0], 12)).astype(np.float32) * b["pair_mask"][0][:, None]
    # one jax.jit: eager dispatch from the test thread can deadlock with
    # interpret mode's callbacks
    with pltpu.force_tpu_interpret_mode():
        jg, js = jax.jit(lambda e, v, i: (_gather_tpu(e.T, i), _scatter_add_tpu(v.T, i, n)))(
            emb, vals, idx)
    jg, js = np.asarray(jg).T, np.asarray(js).T
    tidx = torch.tensor(idx)
    np.testing.assert_array_equal(gather_rows_plain(torch.tensor(emb), tidx).numpy(), jg)
    np.testing.assert_allclose(segment_sum_plain(torch.tensor(vals), tidx, n).numpy(), js,
                               rtol=1e-6, atol=1e-6)


def test_pair_gather_and_segment_sum_backward():
    """pair_gather's backward is the segment sum and vice versa (exact
    adjoints: <gather(x), y> == <x, segsum(y)>)."""
    b = _batch(300)
    idx = torch.tensor(b["pairs"][0, 0])
    n = b["x"].shape[1]
    rng = np.random.default_rng(1)
    emb = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32, requires_grad=True)
    y = torch.tensor(rng.normal(size=(idx.shape[0], 3)), dtype=torch.float32)
    torch.sum(pair_gather(emb, idx) * y).backward()
    np.testing.assert_allclose(emb.grad.numpy(), segment_sum_plain(y, idx, n).numpy(),
                               rtol=1e-6)
    v = torch.tensor(rng.normal(size=idx.shape[0]), dtype=torch.float32, requires_grad=True)
    gz = torch.tensor(rng.normal(size=n), dtype=torch.float32)
    torch.sum(anchor_segment_sum(v, idx, n) * gz).backward()
    np.testing.assert_allclose(v.grad.numpy(), gz[idx.long()].numpy(), rtol=1e-6)


def test_infonce_matches_jax():
    """Loss value and embedding gradient against JAX's windowed InfoNCE, 1e-5.
    On the CPU JAX computes pair_l2rbf_sim's backward unfolded (a p0-side and
    a p1-side segment sum); the port folds the p1 side into the anchor side
    through the reverse-pair index. The two agree because the packed real
    pair set is reversal-closed."""
    b = _batch()
    n = b["x"].shape[1]
    emb = np.random.default_rng(3).normal(size=(n, 12)).astype(np.float32) * 0.5
    keys = ("pairs", "pair_mask", "pair_rev", "pair_weight", "pair_neg")
    jb = {k: jnp.asarray(b[k][0]) for k in keys + ("cluster_ids", "recons", "pts")}

    def jloss(e):
        return jax_infonce(e, jb["pairs"], jb["pair_mask"], jb["cluster_ids"], jb["recons"],
                           jb["pts"], tau=0.05, dist_metric="l2_rbf", windowed_pairs=True,
                           pair_rev=jb["pair_rev"], pair_weight=jb["pair_weight"],
                           pair_neg=jb["pair_neg"])

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(emb))
    te = torch.tensor(emb, requires_grad=True)
    tb = {k: torch.tensor(b[k][0]) for k in keys}
    tl = infonce_loss(te, tb["pairs"], tb["pair_mask"], tb["pair_rev"], tb["pair_weight"],
                      tb["pair_neg"], tau=0.05)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jg)).max())


def test_infonce_two_block_layout_matches_jax():
    """The training loader's two-block layout, loss and gradient against
    JAX's windowed InfoNCE (1e-5), with one CSR of the anchor index built
    per loss call and handed to its three segment sums."""
    b = _two_block_batch()
    n = b["x"].shape[1]
    assert (np.diff(b["pairs"][0, 0]) < 0).any()
    emb = np.random.default_rng(5).normal(size=(n, 12)).astype(np.float32) * 0.5
    keys = ("pairs", "pair_mask", "pair_rev", "pair_weight", "pair_neg")
    jb = {k: jnp.asarray(b[k][0]) for k in keys + ("cluster_ids", "recons", "pts")}

    def jloss(e):
        return jax_infonce(e, jb["pairs"], jb["pair_mask"], jb["cluster_ids"], jb["recons"],
                           jb["pts"], tau=0.05, dist_metric="l2_rbf", windowed_pairs=True,
                           pair_rev=jb["pair_rev"], pair_weight=jb["pair_weight"],
                           pair_neg=jb["pair_neg"])

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(emb))
    te = torch.tensor(emb, requires_grad=True)
    tb = {k: torch.tensor(b[k][0]) for k in keys}
    before = CSR_BUILDS["anchor_csr"]
    tl = infonce_loss(te, tb["pairs"], tb["pair_mask"], tb["pair_rev"], tb["pair_weight"],
                      tb["pair_neg"], tau=0.05)
    tl.backward()
    assert CSR_BUILDS["anchor_csr"] == before + 1
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jg)).max())


def test_pair_sim_safe_norm_at_zero_distance():
    """Pad self-pairs have zero distance: sqrt(|.|^2 + 1e-12) keeps the
    gradient finite (the loss's safe_norm)."""
    emb = torch.zeros((4, 3), requires_grad=True)
    p = torch.tensor([0, 1, 3, 3], dtype=torch.int32)
    mask = torch.tensor([True, True, True, False])
    sim = pair_l2rbf_sim(emb, p, p, torch.arange(4, dtype=torch.int32), mask)
    sim.sum().backward()
    assert torch.isfinite(emb.grad).all()
    np.testing.assert_allclose(sim.detach().numpy(), np.exp(-1e-6 / (2 * 0.75**2)), rtol=1e-6)
