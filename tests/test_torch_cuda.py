"""The CUDA kernels (K1-K7, K10, K12) against their plain versions, on the card
(K1/K2, K6 and K7 on both routes, tensor cores and scalar; K10 on both of
its routes, tiled and first cut).

Marked `cuda`: each test skips (inside the fixture, never at import) when no
CUDA device is present, which is the case on CPU-only hosts. On a GPU
machine, where JAX (and so tests/conftest.py) is absent:
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hept_tpu_torch.ops import bucket_attn_cuda as ba  # noqa: E402
from hept_tpu_torch.ops import pair_ops as po  # noqa: E402
from hept_tpu_torch.ops import row_gather as rg  # noqa: E402
from hept_tpu_torch.ops import sort as srt  # noqa: E402
from hept_tpu_torch.ops.bucket_attn import (  # noqa: E402
    bucket_rbf_attention_cols,
    hept_attention_core,
)
from hept_tpu_torch.ops.dispatch import plain_reference  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, dtype, r=3, d=7, dv=5, nb=6, bs=64, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    n = nb * bs

    def rn(*s):
        return torch.randn(s, generator=g, device=dev)

    sq, sk = (rn(r, d, n) * 0.5).to(dtype), (rn(r, d, n) * 0.5).to(dtype)
    return sq, sk, rn(r, dv, n).to(dtype), rn(r, 1, n), rn(r, dv, n), bs


@pytest.mark.parametrize("dtype,d,dv,nb,bs", [
    (torch.float32, 7, 5, 6, 64), (torch.bfloat16, 7, 5, 6, 64),  # scalar / tensor cores
    (torch.bfloat16, 30, 24, 6, 64), (torch.bfloat16, 30, 24, 3, 512),  # tensor cores
    (torch.bfloat16, 30, 24, 5, 48),  # tensor cores, one 16-query tile per warp in K1
    (torch.bfloat16, 30, 24, 4, 40), (torch.float32, 30, 24, 3, 512),  # scalar
])
def test_k1_k2_match_plain(dev, dtype, d, dv, nb, bs):
    """Both routes at the toy widths and the main path's (30, 24): denom
    1e-5 x scale; f32 1e-5 x scale; bf16 5e-3 x scale forward (pt rounding
    flips), 1e-2 x scale backward (bf16 outputs)."""
    sq, sk, sv, gden, gso, bs = _inputs(dev, dtype, d=d, dv=dv, nb=nb, bs=bs)
    f32 = dtype == torch.float32
    den_k, so_k = ba.bucket_attn_fwd_cuda(sq, sk, sv, bs)
    den_p, so_p = ba.bucket_attn_fwd_plain(sq, sk, sv, bs)
    torch.testing.assert_close(den_k, den_p, rtol=1e-5, atol=1e-5 * den_p.abs().max().item())
    tol = 1e-5 if f32 else 5e-3
    torch.testing.assert_close(so_k, so_p, rtol=tol, atol=tol * so_p.abs().max().item())
    tol = 1e-5 if f32 else 1e-2
    for a, b in zip(ba.bucket_attn_bwd_cuda(sq, sk, sv, gden, gso, bs),
                    ba.bucket_attn_bwd_plain(sq, sk, sv, gden, gso, bs)):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                   atol=tol * b.float().abs().max().item())


def _rpe_inputs(dev, common, r=4, nb=3, bs=512, seed=5):
    """The main path's regime at (d, dv) = (30, 24), bf16: 24 projection rows
    O(0.3) and 6 RPE rows with O(0.5) local spread around a per-bucket common
    mode shared by q and k; values and cotangents."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = nb * bs

    def rn(*s):
        return torch.randn(s, generator=g, device=dev)

    shared = rn(r, 6, nb, 1) * common

    def qk():
        rpe = (shared + rn(r, 6, nb, bs) * 0.5).reshape(r, 6, n)
        return torch.cat([rn(r, 24, n) * 0.3, rpe], 1).to(torch.bfloat16).contiguous()

    return qk(), qk(), rn(r, 24, n).to(torch.bfloat16), rn(r, 1, n), rn(r, 24, n)


@pytest.mark.parametrize("bs,kernel", [(64, "K2"), (512, "K2"), (100, "K7 v2")])
def test_k2_is_gradient_of_bf16_forward_at_common_mode_40(dev, bs, kernel):
    """The bf16-gradient contract on the card: K2 and K7 v2 (tensor cores;
    K7 on buckets of 100 padded to 112) against f32 autograd of plain K1 at
    the same bf16 values, with a per-bucket common mode of 40 in the RPE
    rows, 2e-2 x scale (as chip_smoke.py phase 2)."""
    sq, sk, sv, gden, gso = _rpe_inputs(dev, 40.0, nb=1536 // bs, bs=bs)
    ins = [t.float().requires_grad_(True) for t in (sq, sk, sv)]
    den, so = ba.bucket_attn_fwd_plain(*ins, bs)
    ref = torch.autograd.grad((den * gden).sum() + (so * gso).sum(), ins)
    counter = "bucket_attn_bwd_tc" if kernel == "K2" else "cols_bwd_tc"
    before = ba.LAUNCHES[counter]
    if kernel == "K2":
        got = ba.bucket_attn_bwd_cuda(sq, sk, sv, gden, gso, bs)
    else:
        got = ba.cols_bwd_cuda(sq, sk, sv, gden, gso, bs, True)
    assert ba.LAUNCHES[counter] == before + 1
    for a, b, nm in zip(got, ref, ("dq", "dk", "dv")):
        torch.testing.assert_close(a.float(), b, rtol=2e-2, atol=2e-2 * b.abs().max().item(),
                                   msg=nm)


@pytest.mark.parametrize("dtype,bs", [(torch.bfloat16, 512), (torch.bfloat16, 64),
                                      (torch.float32, 512)])
def test_k1_k2_same_bits_on_repeated_calls(dev, dtype, bs):
    """No atomics on either route: every call gives the same bits."""
    sq, sk, sv, gden, gso, bs = _inputs(dev, dtype, d=30, dv=24, nb=1536 // bs, bs=bs)
    fwd = ba.bucket_attn_fwd_cuda(sq, sk, sv, bs)
    bwd = ba.bucket_attn_bwd_cuda(sq, sk, sv, gden, gso, bs)
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(fwd, ba.bucket_attn_fwd_cuda(sq, sk, sv, bs)))
        assert all(torch.equal(a, b)
                   for a, b in zip(bwd, ba.bucket_attn_bwd_cuda(sq, sk, sv, gden, gso, bs)))


@pytest.mark.parametrize("dtype,bs,route", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 512, "tc"), (torch.bfloat16, 48, "tc"),
    (torch.float32, 64, "scalar"), (torch.float32, 512, "scalar"),
    (torch.bfloat16, 40, "scalar"), (torch.bfloat16, 100, "scalar"),
])
def test_k1_k2_routes(dev, dtype, bs, route):
    """bf16 at a block size that is a multiple of 16 launches the
    tensor-core kernels; f32, and bf16 at any other block size, the scalar
    ones. Each launch counts once, on its own route's counters only."""
    assert ba.bucket_attn_route(dtype, bs) == route
    sq, sk, sv, gden, gso, bs = _inputs(dev, dtype, d=30, dv=24, nb=2, bs=bs)
    before = dict(ba.LAUNCHES)
    ba.bucket_attn_fwd_cuda(sq, sk, sv, bs)
    ba.bucket_attn_bwd_cuda(sq, sk, sv, gden, gso, bs)
    suffix = "_tc" if route == "tc" else ""
    after = {k: v - before[k] for k, v in ba.LAUNCHES.items() if v != before[k]}
    assert after == {f"bucket_attn_fwd{suffix}": 1, f"bucket_attn_bwd{suffix}": 1}


@pytest.mark.parametrize("dtype,hilo", [(torch.float32, False), (torch.bfloat16, False),
                                        (torch.bfloat16, True)])
@pytest.mark.parametrize("nb,bs", [(6, 100), (7, 100), (5, 64), (3, 300), (5, 36), (7, 64),
                                   (5, 50)])
@pytest.mark.parametrize("d", [30, 28])
def test_k6_matches_plain(dev, dtype, hilo, nb, bs, d):
    """K6 in its three modes at the tracking (d = 30) and pileup (28)
    widths, each on the route `cols_fwd_route` gives it:
    bf16 on the tensor cores (buckets padded to 16 points, odd buckets
    starting 8 bytes off a 16-byte boundary), f32 on 2 x 4 register tiles
    up to 100 points and the first-cut kernel at 300; a ragged last CTA (7
    buckets: f32 CTAs of 2), and both on the first-cut kernel at bs 50 (no
    multiple of 4): f32 1e-5 x scale; bf16 5e-3 x scale (pt rounding
    flips)."""
    sq, sk, sv, _, _, _ = _inputs(dev, dtype, d=d, dv=24, nb=nb, bs=bs)
    counter = "cols_fwd_tc" if ba.cols_fwd_route(dtype, bs) == "tc" else "cols_fwd"
    before = dict(ba.LAUNCHES)
    den_k, so_k = ba.cols_fwd_cuda(sq, sk, sv, bs, hilo)
    after = {k: v - before[k] for k, v in ba.LAUNCHES.items() if v != before[k]}
    assert after == {counter: 1}
    den_p, so_p = ba.cols_fwd_plain(sq, sk, sv, bs, hilo)
    torch.testing.assert_close(den_k, den_p, rtol=1e-5, atol=1e-5 * den_p.abs().max().item())
    tol = 1e-5 if dtype == torch.float32 else 5e-3
    torch.testing.assert_close(so_k, so_p, rtol=tol, atol=tol * so_p.abs().max().item())


@pytest.mark.parametrize("dtype,hilo", [(torch.float32, False), (torch.bfloat16, False),
                                        (torch.bfloat16, True)])
def test_k6_same_bits_on_repeated_calls(dev, dtype, hilo):
    """No atomics on either K6 route (tensor cores for bf16, FP32 FMAs for
    f32): every call gives the same bits, a ragged 7-bucket count too."""
    sq, sk, sv, _, _, bs = _inputs(dev, dtype, d=30, dv=24, nb=7, bs=100, seed=6)
    first = ba.cols_fwd_cuda(sq, sk, sv, bs, hilo)
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(first, ba.cols_fwd_cuda(sq, sk, sv, bs, hilo)))


def test_k6_tc_at_common_mode_40(dev):
    """K6 on the tensor cores (bf16, exact bias) against the f32 plain
    forward of the same bf16 values, with a per-bucket common mode of 40 in
    the RPE rows: the biases enter in f32, so the logits keep their O(1)
    part; 2e-2 x scale (pt rounded to bf16 for the value product)."""
    sq, sk, sv, _, _ = _rpe_inputs(dev, 40.0, nb=15, bs=100)
    assert ba.cols_fwd_route(sq.dtype, 100) == "tc"
    before = ba.LAUNCHES["cols_fwd_tc"]
    got = ba.cols_fwd_cuda(sq, sk, sv, 100)
    assert ba.LAUNCHES["cols_fwd_tc"] == before + 1
    ref = ba.cols_fwd_plain(sq.float(), sk.float(), sv.float(), 100)
    for a, b, nm in zip(got, ref, ("denom", "so")):
        torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-2 * b.abs().max().item(), msg=nm)


@pytest.mark.parametrize("dtype,v2", [(torch.float32, False), (torch.bfloat16, False),
                                      (torch.bfloat16, True)])
@pytest.mark.parametrize("nb,bs", [(6, 100), (7, 100), (3, 300), (5, 36), (5, 50)])
@pytest.mark.parametrize("d", [30, 28])
def test_k7_matches_plain(dev, dtype, v2, nb, bs, d):
    """K7 v1 (f32, and bf16 upcast) and v2 (bf16) at the tracking (d = 30)
    and pileup (28) widths, each on the route
    `cols_bwd_route` gives it: v2 on the tensor cores at bs 100 (odd buckets
    start 8 bytes off a 16-byte boundary; 7 buckets end at n), 36 and 300,
    on FP32 FMAs at bs 50 (no multiple of 4); v1 one pass per bucket up to
    100 points and two halves at 300. f32 1e-5 x scale, bf16 outputs 1e-2 x
    scale (one bf16 ulp)."""
    sq, sk, sv, gden, gso, _ = _inputs(dev, dtype, d=d, dv=24, nb=nb, bs=bs)
    counter = "cols_bwd_tc" if ba.cols_bwd_route(dtype, bs, v2) == "tc" else "cols_bwd"
    before = dict(ba.LAUNCHES)
    got = ba.cols_bwd_cuda(sq, sk, sv, gden, gso, bs, v2)
    after = {k: v - before[k] for k, v in ba.LAUNCHES.items() if v != before[k]}
    assert after == {counter: 1}
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for a, b in zip(got, ba.cols_bwd_plain(sq, sk, sv, gden, gso, bs, v2)):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                   atol=tol * b.float().abs().max().item())


@pytest.mark.parametrize("dtype,v2", [(torch.float32, False), (torch.bfloat16, True),
                                      (torch.bfloat16, False)])
def test_k7_same_bits_on_repeated_calls(dev, dtype, v2):
    """No atomics on either K7 route (tensor cores for bf16 v2, FP32 FMAs
    for v1): every call gives the same bits, a ragged 7-bucket count too."""
    sq, sk, sv, gden, gso, bs = _inputs(dev, dtype, d=30, dv=24, nb=7, bs=100, seed=6)
    first = ba.cols_bwd_cuda(sq, sk, sv, gden, gso, bs, v2)
    for _ in range(3):
        assert all(torch.equal(a, b)
                   for a, b in zip(first, ba.cols_bwd_cuda(sq, sk, sv, gden, gso, bs, v2)))


@pytest.mark.parametrize("mode,dtype,want", [
    ("pallas", torch.float32, ("cols_fwd", "cols_bwd")),  # both on FP32 FMAs
    ("pallas", torch.bfloat16, ("cols_fwd_tc", "cols_bwd")),  # K6 hilo on the tensor cores
    ("hybrid2", torch.bfloat16, ("cols_fwd_tc", "cols_bwd_tc")),  # K6, K7 v2: tensor cores
    ("slab2", torch.bfloat16, ("cols_fwd_tc", "cols_bwd_tc")),  # bs 100: no flat slab
    ("slab", torch.bfloat16, ("cols_fwd_tc", "cols_bwd")),  # K8 / K9 as K6 hilo / K7 v1
    ("hybrid_slab", torch.float32, ("cols_fwd", "cols_bwd")),
])
def test_modes_route_through_k6_k7(dev, mode, dtype, want):
    sq, sk, sv, _, _, bs = _inputs(dev, dtype, d=30, dv=24, nb=6, bs=100, seed=2)
    ins = [t.clone().requires_grad_(True) for t in (sq, sk, sv)]
    before = dict(ba.LAUNCHES)
    den, so = bucket_rbf_attention_cols(*ins, bs, mode)
    (so / den).sum().backward()
    after = {k: v - before[k] for k, v in ba.LAUNCHES.items()}
    assert after == {"bucket_attn_fwd_tc": 0, "bucket_attn_bwd_tc": 0, "bucket_attn_fwd": 0,
                     "bucket_attn_bwd": 0, "cols_fwd_tc": 0, "cols_fwd": 0, "cols_bwd_tc": 0,
                     "cols_bwd": 0, "rows_fwd": 0, "rows_bwd": 0, want[0]: 1, want[1]: 1}
    with plain_reference():
        refs = [t.clone().requires_grad_(True) for t in (sq, sk, sv)]
        den2, so2 = bucket_rbf_attention_cols(*refs, bs, mode)
        (so2 / den2).sum().backward()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(ins, refs):
        torch.testing.assert_close(a.grad.float(), b.grad.float(), rtol=tol,
                                   atol=tol * b.grad.float().abs().max().item())


@pytest.mark.parametrize("nb,bs,want", [
    (6, 64, ("bucket_attn_fwd_tc", "bucket_attn_bwd_tc")),  # slab2 with a flat slab: K1 / K2
    (6, 100, ("cols_fwd_tc", "cols_bwd_tc")),  # slab2 at bs 100: K6 and K7 v2
])
def test_autograd_routes_through_kernels(dev, nb, bs, want):
    """bf16 autograd through `bucket_rbf_attention_cols` (slab2) launches
    one forward and one backward, both on the tensor cores, and none under
    `plain_reference()`."""
    sq, sk, sv, _, _, bs = _inputs(dev, torch.bfloat16, nb=nb, bs=bs, seed=1)
    ins = [t.clone().requires_grad_(True) for t in (sq, sk, sv)]
    before = dict(ba.LAUNCHES)
    den, so = bucket_rbf_attention_cols(*ins, bs)
    (so / den).sum().backward()
    after = {k: v - before[k] for k, v in ba.LAUNCHES.items() if v != before[k]}
    assert after == {want[0]: 1, want[1]: 1}
    with plain_reference():
        refs = [t.clone().requires_grad_(True) for t in (sq, sk, sv)]
        den2, so2 = bucket_rbf_attention_cols(*refs, bs)
        (so2 / den2).sum().backward()
    assert {k: v - before[k] for k, v in ba.LAUNCHES.items() if v != before[k]} == after
    for a, b in zip(ins, refs):
        torch.testing.assert_close(a.grad.float(), b.grad.float(), rtol=2e-2,
                                   atol=2e-2 * b.grad.float().abs().max().item())


def _anchor_index(layout, n, e, rng):
    """Sorted anchors; two sorted blocks concatenated (the training loader's
    cached layout: base, then augmentation); a random index. Every 7th anchor
    from 3 on has no pairs."""
    raw = rng.integers(0, n, e)
    raw[(raw % 7) == 3] += 1
    if layout == "sorted":
        raw = np.sort(raw)
    elif layout == "two_block":
        cut = e * 4 // 5
        raw = np.concatenate([np.sort(raw[:cut]), np.sort(raw[cut:])])
    return raw.astype(np.int32)


@pytest.mark.parametrize("d", [1, 7, 12])
@pytest.mark.parametrize("layout", ["sorted", "two_block", "random"])
def test_k3_k4_match_plain(dev, layout, d):
    """K3 exactly and K4 with and without a given CSR (index_add_ sums in
    another order), anchors without pairs summing to zero; K4 gives the same
    bits on every call."""
    rng = np.random.default_rng(0)
    n, e = 1000, 20000
    idx = torch.tensor(_anchor_index(layout, n, e, rng), device=dev)
    emb = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32, device=dev)
    vals = torch.tensor(rng.normal(size=(e, d)), dtype=torch.float32, device=dev)
    torch.testing.assert_close(po.gather_rows_cuda(emb, idx), po.gather_rows_plain(emb, idx),
                               rtol=0, atol=0)
    ref = po.segment_sum_plain(vals, idx, n)
    csr = po.anchor_csr(idx, n)
    before = po.CSR_BUILDS["anchor_csr"]
    got = po.segment_sum_cuda(vals, idx, n, csr)
    assert po.CSR_BUILDS["anchor_csr"] == before
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    # the CSR on the card is numpy's stable argsort and searchsorted
    cpu = idx.cpu().numpy()
    np.testing.assert_array_equal(csr[0].cpu().numpy(), np.argsort(cpu, kind="stable"))
    np.testing.assert_array_equal(csr[1].cpu().numpy(),
                                  np.searchsorted(np.sort(cpu), np.arange(n + 1)))
    assert (got[3::7] == 0).all()
    own = po.segment_sum_cuda(vals, idx, n)
    assert po.CSR_BUILDS["anchor_csr"] == before + 1
    # deterministic: the same bits on every call, with or without a given CSR
    assert torch.equal(own, got) and torch.equal(po.segment_sum_cuda(vals, idx, n, csr), got)


@pytest.mark.parametrize("base", ["aligned", "emb at +4 bytes", "idx at +4 bytes"])
@pytest.mark.parametrize("d", [1, 2, 3, 7, 12, 24])
def test_k3_exact_at_each_width_and_alignment(dev, d, base):
    """K3 copies rows bit for bit on each vector path (float4 / float2 /
    scalar rows, d = 1's four pairs a thread), with emb or idx 4 bytes into
    a larger buffer, E not a multiple of 4, and NaN rows where the index is
    outside [0, n); a d = 1 launch counts on its own counter too."""
    rng = np.random.default_rng(d)
    n, e = 777, 10001
    raw = rng.integers(0, n, e).astype(np.int32)
    raw[::13], raw[5::17], raw[7::19] = n, -1, 2**31 - 1
    flat_emb = torch.tensor(rng.normal(size=n * d + 1), dtype=torch.float32, device=dev)
    flat_idx = torch.tensor(np.concatenate([[0], raw]).astype(np.int32), device=dev)
    emb = (flat_emb[1:] if base == "emb at +4 bytes" else flat_emb[:-1]).view(n, d)
    idx = flat_idx[1:] if base == "idx at +4 bytes" else flat_idx[1:].clone()
    assert (emb.data_ptr() % 16 != 0) == (base == "emb at +4 bytes")
    assert (idx.data_ptr() % 16 != 0) == (base == "idx at +4 bytes")
    before = dict(po.LAUNCHES)
    got = po.gather_rows_cuda(emb, idx)
    assert po.LAUNCHES["pair_gather"] == before["pair_gather"] + 1
    assert po.LAUNCHES["pair_gather_d1"] == before["pair_gather_d1"] + (d == 1)
    ok = (idx >= 0) & (idx < n)
    want = po.gather_rows_plain(emb, idx.clamp(0, n - 1))
    assert torch.equal(got[ok].view(torch.int32), want[ok].view(torch.int32))
    assert torch.isnan(got[~ok]).all() and int((~ok).sum()) > 0
    assert torch.equal(po.gather_rows_cuda(emb, idx).view(torch.int32), got.view(torch.int32))


def test_k4_csr_built_once_per_loss(dev):
    """infonce_loss builds one CSR of its anchor index and its three K4 calls
    (forward negative sums, the gather's and the similarity's backward) use
    it; the loss and gradient match plain_reference()."""
    from hept_tpu_torch.data.batching import pack_events
    from hept_tpu_torch.data.synthetic import synthetic_tracking_event
    from hept_tpu_torch.train.losses import infonce_loss

    ev = synthetic_tracking_event(np.random.default_rng(7), n_points=2000, pairs_per_point=6)
    b = pack_events([ev], block_size=64, window_pairs=128, aug_pair_p=0.3,
                    aug_rng=np.random.default_rng(8), cache=True)
    keys = ("pairs", "pair_mask", "pair_rev", "pair_weight", "pair_neg")
    tb = [torch.tensor(b[k][0], device=dev) for k in keys]
    emb0 = torch.tensor(np.random.default_rng(9).normal(size=(b["x"].shape[1], 12)) * 0.5,
                        dtype=torch.float32, device=dev)
    emb = emb0.clone().requires_grad_(True)
    csr0, k40 = po.CSR_BUILDS["anchor_csr"], po.LAUNCHES["pair_segment_sum"]
    loss = infonce_loss(emb, *tb, tau=0.05)
    loss.backward()
    assert po.CSR_BUILDS["anchor_csr"] == csr0 + 1
    assert po.LAUNCHES["pair_segment_sum"] == k40 + 3
    ref = emb0.clone().requires_grad_(True)
    with plain_reference():
        loss_p = infonce_loss(ref, *tb, tau=0.05)
        loss_p.backward()
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(emb.grad, ref.grad, rtol=1e-5,
                               atol=1e-5 * ref.grad.abs().max().item())


def test_wrappers_reject_bad_inputs(dev):
    sq, sk, sv, gden, gso, bs = _inputs(dev, torch.bfloat16)
    with pytest.raises(ValueError):
        ba.bucket_attn_fwd_cuda(sq, sk, sv.float(), bs)
    with pytest.raises(ValueError):
        ba.bucket_attn_fwd_cuda(sq[:, :6].contiguous(), sk[:, :6].contiguous(), sv, bs)
    # the tensor-core route stages with 16-byte loads: a contiguous view that
    # starts 2 bytes into its storage is refused, not read misaligned
    off = torch.empty(sq.numel() + 1, dtype=sq.dtype, device=dev)[1:].view(sq.shape)
    off.copy_(sq)
    with pytest.raises(ValueError):
        ba.bucket_attn_fwd_cuda(off, sk, sv, bs)
    with pytest.raises(ValueError):  # K6's tensor-core route likewise
        ba.cols_fwd_cuda(off, sk, sv, bs)
    with pytest.raises(ValueError):
        ba.bucket_attn_bwd_cuda(sq, sk, sv, gso, gden, bs)  # cotangents swapped
    with pytest.raises(ValueError):
        po.gather_rows_cuda(torch.zeros(4, 2, device=dev), torch.zeros(3, device=dev).long())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int32])
@pytest.mark.parametrize("S,R,n,w", [(2, 2, 1000, 200), (1, 2, 999, 200), (3, 6, 257, 7),
                                     (2, 2, 64, 300), (3, 3, 1000, 25), (8, 24, 1001, 30),
                                     (8, 24, 1001, 24), (2, 4, 999, 13), (1, 2, 64, 3075)])
def test_k5_matches_plain_bit_for_bit(dev, dtype, S, R, n, w):
    """Rows of 16-byte multiples (200, 24 f32 / bf16: direct 16-byte copies)
    and the staged widths: 100 and 120 B f32 (the parity unsort's W = 25, the
    core's d = 30), 50 and 26 B bf16 (W = 25, 13), 4- and 2-byte rows (7
    elements); broadcast sources (S = 8, R = 24), ragged n and row counts
    that are no multiple of a tile, a row wider than the TPU's 128 words,
    and one wider than the stage (3075 f32)."""
    g = torch.Generator(device=dev).manual_seed(0)
    src = torch.randint(-2**15, 2**15, (S, n, w), generator=g, device=dev,
                        dtype=torch.int32)
    src = src.to(torch.int16).view(torch.bfloat16) if dtype == torch.bfloat16 \
        else src.view(dtype)
    idx = torch.stack([torch.randperm(n, generator=g, device=dev) for _ in range(R)])
    before = rg.LAUNCHES["row_gather"]
    got = rg.row_gather_cuda(src, idx)
    assert rg.LAUNCHES["row_gather"] == before + 1
    want = rg.row_gather_plain(src, idx)
    bits = torch.int16 if src.element_size() == 2 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("dtype,w", [(torch.float32, 24), (torch.float32, 25),
                                     (torch.bfloat16, 200), (torch.bfloat16, 25)])
def test_k5_offset_source_and_out_of_range_index(dev, dtype, w):
    """A source whose base is only 4-byte (f32) or 2-byte (bf16) aligned, so
    even 16-byte multiples go through the stage; indices outside [0, n)
    write zero rows."""
    g = torch.Generator(device=dev).manual_seed(3)
    s_, r_, n = 2, 4, 777
    flat = torch.randint(-2**15, 2**15, (s_ * n * w + 1,), generator=g, device=dev,
                         dtype=torch.int32)
    flat = flat.to(torch.int16).view(torch.bfloat16) if dtype == torch.bfloat16 \
        else flat.view(dtype)
    src = flat[1:].view(s_, n, w)
    assert src.data_ptr() % 16 != 0
    idx = torch.stack([torch.randperm(n, generator=g, device=dev) for _ in range(r_)])
    idx[1, 5], idx[2, 0], idx[3, -1] = -1, n, 2**40
    got = rg.row_gather_cuda(src, idx)
    bits = torch.int16 if src.element_size() == 2 else torch.int32
    ok = (idx >= 0) & (idx < n)
    want = rg.row_gather_plain(src, torch.where(ok, idx, torch.zeros_like(idx)))
    want[~ok] = 0
    assert torch.equal(got.view(bits), want.view(bits))


def test_k5_runs_the_unsort_and_its_backward(dev):
    from hept_tpu_torch.core.buckets import permute_gather_rows

    g = torch.Generator(device=dev).manual_seed(1)
    rows = torch.randn((2, 500, 200), generator=g, device=dev, requires_grad=True)
    idx = torch.stack([torch.randperm(500, generator=g, device=dev) for _ in range(2)])
    inv = torch.argsort(idx, dim=-1)
    ct = torch.randn((2, 500, 200), generator=g, device=dev)
    before = rg.LAUNCHES["row_gather"]
    for pack in (False, True):
        out = permute_gather_rows(rows, idx, inv, pack=pack)
        (grad,) = torch.autograd.grad(out, rows, ct)
        with plain_reference():
            out_p = permute_gather_rows(rows, idx, inv, pack=pack)
            (grad_p,) = torch.autograd.grad(out_p, rows, ct)
        assert torch.equal(out, out_p) and torch.equal(grad, grad_p)
    assert rg.LAUNCHES["row_gather"] == before + 4


def test_k5_rejects_what_it_does_not_take(dev):
    src = torch.zeros((2, 10, 8), device=dev)
    idx = torch.zeros((2, 10), dtype=torch.int64, device=dev)
    bad = [
        (src.double(), idx),  # 8-byte elements
        (src.to(torch.uint8), idx),  # 1-byte elements
        (src.transpose(1, 2), idx[:, :8]),  # not contiguous
        (src.cpu(), idx.cpu()),  # not on the card
        (src, idx.int()),  # int32 index
        (src, idx.cpu()),  # index elsewhere
        (src, idx[:, :9]),  # n mismatch
        (src[:, :, :].repeat(3, 1, 1)[:3], idx),  # S = 3 does not divide R = 2
        (src[0], idx),  # not (S, n, W)
    ]
    for s_, i_ in bad:
        with pytest.raises(ValueError):
            rg.row_gather_cuda(s_, i_)


@pytest.mark.parametrize("d,dv,g,bs", [(30, 24, 12, 100), (30, 24, 7, 100), (30, 24, 5, 12),
                                       (7, 5, 9, 8), (30, 24, 3, 300)])
def test_k10_matches_plain(dev, d, dv, g, bs):
    """K10 forward and backward, f32: two buckets of 100 per CTA and a ragged
    last CTA (7 buckets), 21 buckets of 12 per CTA, buckets of 8 (JAX's
    unpadded case), a bucket wider than a CTA (300); 1e-5 x scale forward,
    1e-4 x scale backward (f32 sums in other orders)."""
    gen = torch.Generator(device=dev).manual_seed(3)

    def rn(*s):
        return torch.randn(s, generator=gen, device=dev)

    sq, sk = rn(g, bs, d) * 0.5, rn(g, bs, d) * 0.5
    sv, gden, gso = rn(g, bs, dv), rn(g, bs, 1), rn(g, bs, dv)
    before = dict(ba.LAUNCHES)
    got = ba.rows_fwd_cuda(sq, sk, sv)
    for a, b in zip(got, ba.rows_fwd_plain(sq, sk, sv)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * b.abs().max().item())
    for a, b in zip(ba.rows_bwd_cuda(sq, sk, sv, gden, gso),
                    ba.rows_bwd_plain(sq, sk, sv, gden, gso)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item())
    assert ba.LAUNCHES["rows_fwd"] == before["rows_fwd"] + 1
    assert ba.LAUNCHES["rows_bwd"] == before["rows_bwd"] + 1
    with pytest.raises(ValueError):
        ba.rows_fwd_cuda(sq.to(torch.bfloat16), sk.to(torch.bfloat16), sv.to(torch.bfloat16))


@pytest.mark.parametrize("d,dv,g,bs,offset", [
    (30, 24, 12, 100, 0),  # the parity core's buckets: both tiled
    (30, 24, 7, 100, 0),  # a ragged last CTA of the tiled forward
    (30, 24, 7, 100, 1),  # operands 4 bytes into their buffers: no vector copies
    (30, 24, 6, 50, 0),  # bs % 4 != 0: forward first cut, backward tiled
    (30, 24, 3, 300, 0),  # above 100: both first cut
    (7, 5, 9, 8, 0),  # JAX's bs 8 case: both tiled, scalar rows
    (7, 5, 5, 100, 1),
])
def test_k10_routes_match_plain(dev, d, dv, g, bs, offset):
    """K10 on each route (`rows_fwd_route`, `rows_bwd_route`) against its
    plain version (1e-5 x scale forward, 1e-4 x scale backward), the same
    bits on 4 calls, one launch a call each way; on the tiled forward route
    the bits of K6 f32 on the transposed operands, (1, d, g * bs) columns
    (the tiled backward adds the norm biases after the dot, K7 v1 before)."""
    gen = torch.Generator(device=dev).manual_seed(5)

    def rn(*s, scale=1.0):
        flat = torch.randn(int(np.prod(s)) + offset, generator=gen, device=dev) * scale
        return flat[offset:].view(s)

    sq, sk = rn(g, bs, d, scale=0.5), rn(g, bs, d, scale=0.5)
    sv, gden, gso = rn(g, bs, dv), rn(g, bs, 1), rn(g, bs, dv)
    before = dict(ba.LAUNCHES)
    fwd = ba.rows_fwd_cuda(sq, sk, sv)
    bwd = ba.rows_bwd_cuda(sq, sk, sv, gden, gso)
    assert ba.LAUNCHES["rows_fwd"] == before["rows_fwd"] + 1
    assert ba.LAUNCHES["rows_bwd"] == before["rows_bwd"] + 1
    for a, b in zip(fwd, ba.rows_fwd_plain(sq, sk, sv)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * b.abs().max().item())
    for a, b in zip(bwd, ba.rows_bwd_plain(sq, sk, sv, gden, gso)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item())
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(fwd, ba.rows_fwd_cuda(sq, sk, sv)))
        assert all(torch.equal(a, b)
                   for a, b in zip(bwd, ba.rows_bwd_cuda(sq, sk, sv, gden, gso)))
    if ba.rows_fwd_route(bs) == "tiled":
        cols = [t.reshape(g * bs, -1).t().contiguous()[None] for t in (sq, sk, sv)]
        want = ba.cols_fwd_cuda(*cols, bs)
        assert all(torch.equal(a, w[0].t().reshape(a.shape)) for a, w in zip(fwd, want))


def test_core_runs_k10_and_k5(dev):
    """`hept_attention_core` forward and backward: one K10 forward, one K10
    backward and eight K5 gathers (q, k, v sorts and the unsort, each way);
    against the same run under `plain_reference()` on its permutations."""
    gen = torch.Generator(device=dev).manual_seed(4)
    h, n, d, dv, c, bs = 8, 2000, 30, 24, 3, 100

    def rn(*s):
        return torch.randn(s, generator=gen, device=dev)

    ins = [rn(h, n, d).requires_grad_(True), rn(h, n, d).requires_grad_(True),
           rn(h, n, dv).requires_grad_(True)]
    alpha, codes = rn(h, d, c), torch.randint(0, 4, (c, h, n), generator=gen, device=dev)
    w = rn(h, n, dv)
    before = {**ba.LAUNCHES, **rg.LAUNCHES}
    perms = []
    out = hept_attention_core(*ins, alpha, codes, block_size=bs, impl="pallas",
                              record_perms=perms)
    grads = torch.autograd.grad((out * w).sum(), ins)
    after = {k: v - before[k] for k, v in {**ba.LAUNCHES, **rg.LAUNCHES}.items()}
    assert after == {"bucket_attn_fwd_tc": 0, "bucket_attn_bwd_tc": 0, "bucket_attn_fwd": 0,
                     "bucket_attn_bwd": 0, "cols_fwd_tc": 0, "cols_fwd": 0, "cols_bwd_tc": 0,
                     "cols_bwd": 0, "rows_fwd": 1, "rows_bwd": 1, "row_gather": 8}
    with plain_reference():
        out_p = hept_attention_core(*ins, alpha, codes, block_size=bs, impl="pallas",
                                    perms=perms[0])
        grads_p = torch.autograd.grad((out_p * w).sum(), ins)
    torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-5 * out_p.abs().max().item())
    for a, b in zip(grads, grads_p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item())


def _k12_keys(dev, rows, n, seed=5):
    """Normal keys with a +BIG tail and interior ties (-0.0 and +0.0 among
    them)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    keys = torch.randn((rows, n), generator=gen, device=dev)
    keys[:, -min(n, 30):] = 3.0e38
    keys[:, :40] = torch.round(keys[:, :40] * 10) / 10
    keys[:, :4] = torch.tensor([-0.0, 0.0, -0.0, 0.0], device=dev)[:min(n, 4)]
    return keys


def _k12_payloads(dev, rows, n, ops, seed=6, tie=None):
    """ops - 1 random uint32 payloads as int32 bit patterns, then the
    tie-break (the row-position iota unless given)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    pays = [torch.randint(-2**31, 2**31 - 1, (rows, n), generator=gen, device=dev,
                          dtype=torch.int32) for _ in range(ops - 1)]
    if tie is None:
        tie = torch.arange(n, device=dev, dtype=torch.int32).expand(rows, n).contiguous()
    return pays + [tie]


def _k12_exact(keys, pays):
    """One launch on the route `sort_route` picks, bit-equal to plain K12."""
    route = srt.sort_route(*keys.shape, len(pays))
    before = dict(srt.LAUNCHES)
    got = srt.bitonic_sort_rows_cuda(keys, pays)
    assert {k: v - before[k] for k, v in srt.LAUNCHES.items()} == {
        k: int(k == f"sort_{route}") for k in srt.LAUNCHES}
    want = srt.bitonic_sort_rows_plain(keys, pays)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return got


@pytest.mark.parametrize("rows,n,ops", [
    (2, 384, 4), (3, 512, 2), (24, 60000, 16), (1, 1, 1), (5, 4097, 3),  # the first shapes
    (2, 2, 2), (2, 513, 2), (2, 8192, 3), (2, 8193, 3),  # one CTA a row, then a cluster
    (2, 16384, 2), (2, 16385, 2), (2, 32769, 2),  # clusters of 2, 4, 8; the move 1, 2, 4
    (2, 65536, 3), (2, 65537, 3),  # the cluster route's last n, the bitonic route's first
    (1, 3000, 1), (1, 3000, 32),  # fewest and most payloads
])
def test_k12_matches_plain_bit_for_bit(dev, rows, n, ops):
    """Every route and every shape edge of the cluster route (CTA slice,
    cluster size, the move's slice), a +BIG tail and interior ties (-0.0 and
    +0.0 among them), uint32 payloads as int32 bit patterns; exactly one
    launch, counted on the route `sort_route` picks."""
    assert srt.sort_route(rows, n, ops) == ("cluster" if n <= 65536 else "bitonic")
    _k12_exact(_k12_keys(dev, rows, n), _k12_payloads(dev, rows, n, ops))


@pytest.mark.parametrize("n", [700, 20000, 65537])
@pytest.mark.parametrize("kind", ["equal", "big", "specials", "tie"])
def test_k12_hard_keys(dev, kind, n):
    """All keys equal; all +3e38; +-inf, denormals, +-0.0, the extreme
    finite values and many ties; a tie-break that is not the iota (random,
    with repeats, so that the position decides too): bit-equal on both
    routes."""
    rows = 3
    gen = torch.Generator(device=dev).manual_seed(7)
    tie = None
    if kind == "equal":
        keys = torch.full((rows, n), 1.5, device=dev)
    elif kind == "big":
        keys = torch.full((rows, n), 3.0e38, device=dev)
    elif kind == "specials":
        pool = torch.tensor([float("inf"), float("-inf"), 1e-45, -1e-45, 1e-40, -1e-40, 0.0, -0.0,
                             3.4028235e38, -3.4028235e38, 1.0, -1.0], device=dev)
        keys = pool[torch.randint(0, len(pool), (rows, n), generator=gen, device=dev)]
    else:
        keys = torch.round(torch.randn((rows, n), generator=gen, device=dev) * 4) / 4
        tie = torch.randint(-50, 50, (rows, n), generator=gen, device=dev, dtype=torch.int32)
    _k12_exact(keys, _k12_payloads(dev, rows, n, 3, tie=tie))


@pytest.mark.parametrize("n", [60000, 70000])
def test_k12_same_bits_on_repeated_calls(dev, n):
    keys, pays = _k12_keys(dev, 4, n), _k12_payloads(dev, 4, n, 5)
    first = _k12_exact(keys, pays)
    for _ in range(3):
        for a, b in zip(srt.bitonic_sort_rows_cuda(keys, pays), first):
            assert torch.equal(a, b)


def test_k12_rejects_what_it_does_not_take(dev):
    keys = torch.zeros((2, 10), device=dev)
    tie = torch.zeros((2, 10), dtype=torch.int32, device=dev)
    bad = [
        (keys.double(), [tie]),  # f64 keys
        (keys, [tie.float()]),  # tie-break not int32
        (keys, [tie.long(), tie]),  # 8-byte payload
        (keys, [tie[:, :9].contiguous()]),  # shape mismatch
        (keys, [tie.t().contiguous().t()]),  # not contiguous
        (keys.cpu(), [tie.cpu()]),  # not on the card
        (keys, []),  # no tie-break
        (keys, [tie] * 33),  # too many payloads
        (torch.zeros((65536, 1), device=dev),
         [torch.zeros((65536, 1), dtype=torch.int32, device=dev)]),  # too many rows
    ]
    for k_, p_ in bad:
        with pytest.raises(ValueError):
            srt.bitonic_sort_rows_cuda(k_, p_)


def test_segment_sum_same_bits_on_the_card(dev):
    """ops/segment.py's segment sum on the card (index_put_ accumulating in
    sorted-index order: the GNNs' and pct's message sums) gives the same bits
    on repeated calls, equals index_add_ to f32 rounding, and its gradient
    is the gather of the cotangent."""
    from hept_tpu_torch.ops.segment import segment_sum

    g = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(0, 5000, (200000,), generator=g, device=dev)
    vals = torch.randn((200000, 24), generator=g, device=dev, requires_grad=True)
    first = segment_sum(vals, ids, 5000)
    for _ in range(3):
        assert torch.equal(segment_sum(vals, ids, 5000), first)
    ref = torch.zeros((5000, 24), device=dev).index_add_(0, ids, vals.detach())
    torch.testing.assert_close(first.detach(), ref, rtol=0, atol=1e-5 * ref.abs().max().item())
    cot = torch.randn((5000, 24), generator=g, device=dev)
    (first * cot).sum().backward()
    assert torch.equal(vals.grad, cot[ids])


def test_collectives_autograd_on_cuda(dev, tmp_path):
    """The collectives' forward and gradients on CUDA tensors, two ranks
    sharing the card in a gloo group (`test_torch_parallel.py`)."""
    from test_torch_parallel import check_collectives

    check_collectives(tmp_path, "cuda")


def test_dp_world1_nccl_step_is_the_plain_step(dev):
    """A one-rank NCCL group: the DP train step (gradients through the
    group's all-reduce) equals the plain step bit for bit, three steps of
    a small hept_acc-like model (static plan, bf16 kernels K1 / K2)."""
    import copy
    import datetime
    import socket

    import torch.distributed as dist

    from hept_tpu_torch.data.batching import pack_events
    from hept_tpu_torch.data.synthetic import synthetic_tracking_event
    from hept_tpu_torch.parallel.mesh import make_mesh
    from hept_tpu_torch.train import trainer
    from hept_tpu_torch.train.config import ExperimentConfig

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        group = make_mesh(1, ("data",), device="cuda").group("data")
        ev = synthetic_tracking_event(np.random.default_rng(1), n_points=1000,
                                      pairs_per_point=8)
        batch = trainer.batch_to_device(pack_events([ev], block_size=128, window_pairs=128),
                                        dev)
        cfg = ExperimentConfig(device="cuda", model_kwargs=dict(
            h_dim=24, num_heads=8, n_layers=2, block_size=128, n_hashes=2, static_rounds=4,
            qkv_post_sort=True, shared_sort=True, share_heads=True, static_keys="x0",
            unsort_rows=True, sort_pack=True, unsort_pack=True, kernel_bf16=True,
            kernel_center=True), optimizer_kwargs=dict(lr=1e-2), attn_impl="slab2")
        m0 = trainer.build_model(cfg, 10, 6, torch.Generator(device=dev).manual_seed(0), dev)
        m1 = copy.deepcopy(m0)
        opts = [trainer.make_optimizer(m.parameters(), lr=1e-2) for m in (m0, m1)]
        gens = [torch.Generator(device=dev).manual_seed(1) for _ in range(2)]
        loss_fn = trainer.make_loss_fn(cfg)
        for _ in range(3):
            a = trainer.train_step(m0, opts[0], loss_fn, batch, gens[0])
            b = trainer.train_step(m1, opts[1], loss_fn, batch, gens[1], data_group=group)
            assert torch.equal(a["loss"], b["loss"]) and torch.equal(a["grad_norm"],
                                                                      b["grad_norm"])
            for (k, p), q in zip(m0.state_dict().items(), m1.state_dict().values()):
                assert torch.equal(p, q), k
    finally:
        dist.destroy_process_group()
