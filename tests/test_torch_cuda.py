"""K1-K4 CUDA kernels against their plain versions, on the card.

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
from hept_tpu_torch.ops.bucket_attn import bucket_rbf_attention_cols  # noqa: E402
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_k2_match_plain(dev, dtype):
    """f32: 1e-5 x scale; bf16: 5e-3 x scale forward (pt rounding flips),
    1e-2 x scale backward (bf16 outputs)."""
    sq, sk, sv, gden, gso, bs = _inputs(dev, dtype)
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


def test_autograd_routes_through_kernels(dev):
    sq, sk, sv, _, _, bs = _inputs(dev, torch.bfloat16, seed=1)
    ins = [t.clone().requires_grad_(True) for t in (sq, sk, sv)]
    before = dict(ba.LAUNCHES)
    den, so = bucket_rbf_attention_cols(*ins, bs)
    (so / den).sum().backward()
    assert ba.LAUNCHES["bucket_attn_fwd"] == before["bucket_attn_fwd"] + 1
    assert ba.LAUNCHES["bucket_attn_bwd"] == before["bucket_attn_bwd"] + 1
    with plain_reference():
        refs = [t.clone().requires_grad_(True) for t in (sq, sk, sv)]
        den2, so2 = bucket_rbf_attention_cols(*refs, bs)
        (so2 / den2).sum().backward()
    assert ba.LAUNCHES["bucket_attn_fwd"] == before["bucket_attn_fwd"] + 1
    for a, b in zip(ins, refs):
        torch.testing.assert_close(a.grad.float(), b.grad.float(), rtol=2e-2,
                                   atol=2e-2 * b.grad.float().abs().max().item())


@pytest.mark.parametrize("sort", [True, False])
def test_k3_k4_match_plain(dev, sort):
    """Sorted anchors, and an unsorted index (the cached layout's base and
    augmentation blocks are each sorted, not their concatenation)."""
    rng = np.random.default_rng(0)
    n, e, d = 1000, 20000, 12
    raw = rng.integers(0, n, e)
    idx = torch.tensor((np.sort(raw) if sort else raw).astype(np.int32), device=dev)
    emb = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32, device=dev)
    vals = torch.tensor(rng.normal(size=(e, d)), dtype=torch.float32, device=dev)
    torch.testing.assert_close(po.gather_rows_cuda(emb, idx), po.gather_rows_plain(emb, idx),
                               rtol=0, atol=0)
    ref = po.segment_sum_plain(vals, idx, n)
    torch.testing.assert_close(po.segment_sum_cuda(vals, idx, n), ref, rtol=1e-5, atol=1e-5)
    # deterministic: the same bits on every call
    assert torch.equal(po.segment_sum_cuda(vals, idx, n), po.segment_sum_cuda(vals, idx, n))


def test_wrappers_reject_bad_inputs(dev):
    sq, sk, sv, _, _, bs = _inputs(dev, torch.bfloat16)
    with pytest.raises(ValueError):
        ba.bucket_attn_fwd_cuda(sq, sk, sv.float(), bs)
    with pytest.raises(ValueError):
        ba.bucket_attn_fwd_cuda(sq[:, :6].contiguous(), sk[:, :6].contiguous(), sv, bs)
    with pytest.raises(ValueError):
        po.gather_rows_cuda(torch.zeros(4, 2, device=dev), torch.zeros(3, device=dev).long())
