"""The bf16 modes on dynamic keys in the port against the JAX package:
sort_pack / unsort_pack on the reference-parity path (q_hat / k_hat / v
carried through bf16, f32 kernels), and sort_pack + unsort_pack +
kernel_bf16 (+ kernel_center where q and k ride one sorted copy) on the
post-sort paths, with `attn_impl: hybrid2` (K6's exact-bias bf16 forward,
K7 v2), JAX running its TPU kernels in interpret mode; the port on JAX's
recorded sort orders (`torch_dynamic_keys.py`). The output and every
parameter gradient are held to 2e-2 of scale, as `test_torch_model.py`'s
hept_fast test holds them, each gradient's scale floored at 2e-2 of the
largest one's, and the whole gradient to 1e-3 relative L2 (`compare_model`'s
`whole_grad`). Measured here: the whole within 1.3e-4; unfloored, the q / k
projection and RPE weights' small gradients reach 3e-2 to 7e-2 of their
own scale (one bf16 rounding flipped between sums of other orders; the
dynamic keys move the RPE columns through bf16 uncentred on the parity and
per-head paths), where the static plan's hept_fast modes stay within 2e-2.

The bf16-gradient contract (ROADMAP.md's North star) at the model level:
the gradient of a dynamic bf16 model is the AD gradient of that same bf16
forward, at the same bf16 operands, to 2e-2 of each gradient's scale (the
kernel-level check's level, `test_torch_cols_kernels.py::
test_plain_k7_v2_is_gradient_of_bf16_forward_at_scale`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hept_tpu_torch.ops.bucket_attn as ba  # noqa: E402
from hept_tpu_torch.models.transformer import HeptTransformer, TransformerConfig  # noqa: E402
from hept_tpu_torch.ops.bucket_attn import hept_attention_core_xcols  # noqa: E402
from hept_tpu_torch.ops.bucket_attn_cuda import cols_fwd_plain  # noqa: E402
from torch_dynamic_keys import (  # noqa: E402
    BASE,
    BF16,
    POST,
    check_bf16_grads,
    SHARE_HEADS,
    SHARED_SORT,
    close,
    compare_model,
    event,
    t,
)

REP = dict(padding_mode="replicate")
PACK = dict(sort_pack=True, unsort_pack=True)


def test_parity_pack_matches_jax(monkeypatch):
    """The parity path with sort_pack and unsort_pack and f32 kernels (JAX
    on its einsum path, K6 / K7 v1's math)."""
    compare_model(monkeypatch, dict(PACK, **REP), 2e-2, 2e-2, whole_grad=True)


@pytest.mark.parametrize("path", [POST, SHARED_SORT, SHARE_HEADS],
                         ids=["per_head", "shared_sort", "share_heads"])
def test_post_sort_bf16_matches_jax(monkeypatch, path):
    """The post-sort paths with bf16 transport and kernels (hybrid2), and
    kernel_center where q and k share a sorted copy (shared_sort,
    share_heads: hept_fast's modes on dynamic keys)."""
    kw = dict(path, **BF16, **REP)
    if path is POST:
        kw["kernel_center"] = False
    compare_model(monkeypatch, kw, 2e-2, 2e-2, jax_impl="hybrid2", port_impl="hybrid2",
                  kernels="hybrid2", whole_grad=True)


def _grads(model, x, coords, valid, w):
    model.zero_grad()
    out = model(x, coords, valid)
    torch.sum(out * w).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def test_bf16_gradient_is_ad_gradient_of_bf16_forward(monkeypatch):
    """The share_heads model with hept_fast's modes (hybrid2: K6 bf16, K7
    v2's plain versions) against the same model whose bucket attention
    keeps K6's forward values but takes autograd's gradient of the f32
    forward at the same bf16 operands: the whole gradient to 1e-2 relative
    L2 (the card's bf16 steps' level) and every parameter gradient to 5e-2
    of its scale floored at 2e-2 of the largest gradient's scale (as
    `compare_model` floors it). K7 v2 rounds g_so to bf16 by design, so its
    dq differs from autograd's at the kernel check's 2e-2 level, and a q
    projection weight's gradient sums those differences over the event:
    measured 2.8e-2 of the floored scale for blocks.0.w_q here."""
    batch = event()
    x, coords, valid = (t(batch[k][0]) for k in ("x", "coords", "valid"))
    cfg = TransformerConfig(in_dim=10, coords_dim=6, attn_impl="hybrid2",
                            **dict(BASE, **SHARE_HEADS, **BF16, **REP))
    model = HeptTransformer(cfg, torch.Generator().manual_seed(0))
    w = torch.as_tensor(np.random.default_rng(2).normal(size=(x.shape[0], 4)),
                        dtype=torch.float32)
    perms = []
    with torch.no_grad():
        model(x, coords, valid, record_perms=perms)
    kernel = _grads(model, x, coords, valid, w)
    calls = []
    kernels = ba.bucket_rbf_attention_cols

    def ad_backward(sq, sk, sv, block_size, mode):
        # the kernels' forward values, autograd's gradient of the f32
        # forward at the same bf16 operands
        calls.append(sq.dtype)
        with torch.no_grad():
            den_k, so_k = kernels(sq, sk, sv, block_size, mode)
        den, so = cols_fwd_plain(sq.float(), sk.float(), sv.float(), block_size)
        return den + (den_k - den).detach(), so + (so_k - so).detach()

    monkeypatch.setattr(ba, "bucket_rbf_attention_cols", ad_backward)
    ad = _grads(model, x, coords, valid, w)
    assert calls == [torch.bfloat16] * BASE["n_layers"]
    check_bf16_grads(kernel, ad, 5e-2, 1e-2)


def test_kernel_center_needs_a_shared_copy():
    """kernel_center subtracts one per-bucket mean from q's and k's RPE
    columns, which is exact only where both ride one sorted copy: refused
    on per-head keys without shared_sort, by the config and by the core
    (JAX asserts it, `hept_tpu/ops/bucket_attn.py:881-883`)."""
    with pytest.raises(NotImplementedError, match="shared q/k bucket grid"):
        TransformerConfig(in_dim=10, coords_dim=6,
                          **dict(BASE, **POST, kernel_center=True)).check_supported()
    rng = np.random.default_rng(0)
    h, dm, c, n = 2, 8, 2, 64
    args = [t(rng.normal(size=s).astype(np.float32)) for s in
            ((dm, n), (3, n), (h, dm, dm), (h, dm, dm), (h, dm, dm), (h, 3), (h, dm + 3, c))]
    codes = torch.zeros((c, h, n), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared q/k bucket grid"):
        hept_attention_core_xcols(*args, codes, None, None, block_size=16, share_heads=False,
                                  kernel_center=True)
