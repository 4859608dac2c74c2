"""`gather_sort` and `fold_unsort` on the port's dynamic-key post-sort
paths.

gather_sort moves the sorted copies of [x | coords] as broadcast-source row
gathers (kernel K5 on the card) instead of the sort-carry's column gathers,
and its backward is a row gather by the inverse. The port lays the gathered
rows out as columns before projecting, so on each path (per-head keys,
shared_sort, share_heads) it must give its sort-carry's bits: the output and
every parameter gradient of a whole model, f32 and under sort_pack.
fold_unsort (share_heads) runs as the head-broadcast carry, whose exact row
gathers give JAX's fold_unsort result: the model with the flag gives the
bits of the model without it. Against the
JAX package (its `gather_sort` / `fold_unsort` through
`hept_attention_core_xcols`, f32 `attn_impl: "xla"`, on JAX's recorded
orders): core output 1e-5 and input gradients 1e-4 of scale, as in
`test_torch_parity_model.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hept_tpu.ops.bucket_attn as jba  # noqa: E402
from hept_tpu_torch.models.transformer import HeptTransformer, TransformerConfig  # noqa: E402
from hept_tpu_torch.ops import row_gather  # noqa: E402
from hept_tpu_torch.ops.bucket_attn import hept_attention_core_xcols  # noqa: E402
from torch_dynamic_keys import (  # noqa: E402
    BASE,
    BS,
    POST,
    SHARE_HEADS,
    SHARED_SORT,
    close,
    event,
    record_jax_sorts,
    t,
)

PATHS = {"per_head": POST, "shared_sort": SHARED_SORT, "share_heads": SHARE_HEADS}


def model_step(kw: dict, impl: str = "pallas"):
    """A 2-layer model on a padded event (dropout on, a fixed generator):
    its output and the gradients of sum(out * w)."""
    batch = event()
    x, coords, valid = (t(batch[k][0]) for k in ("x", "coords", "valid"))
    cfg = TransformerConfig(in_dim=10, coords_dim=6, attn_impl=impl, dropout=0.1,
                            padding_mode="replicate", **dict(BASE, **kw))
    model = HeptTransformer(cfg, torch.Generator().manual_seed(0))
    out = model(x, coords, valid, torch.Generator().manual_seed(1))
    w = torch.as_tensor(np.random.default_rng(2).normal(size=tuple(out.shape)),
                        dtype=torch.float32)
    torch.sum(out * w).backward()
    return out.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "sort_pack"])
@pytest.mark.parametrize("path", list(PATHS))
def test_gather_sort_gives_sort_carry_bits(monkeypatch, path, bf16):
    """gather_sort against the sort-carry on the same model, weights and
    draws: the output and every parameter gradient bit for bit; under
    sort_pack with bf16 kernels (K6 / K7 v2's plain versions, hybrid2) too.
    gather_sort moves [x | coords] by row gathers, two a layer forward (one
    with shared_sort / share_heads) besides the unsort's."""
    calls = []
    gather = row_gather.row_gather

    def counting(src, idx):
        calls.append(tuple(src.shape))
        return gather(src, idx)

    monkeypatch.setattr(row_gather, "row_gather", counting)
    import hept_tpu_torch.core.buckets as buckets

    monkeypatch.setattr(buckets, "row_gather", counting)
    kw = dict(PATHS[path])
    impl = "pallas"
    if bf16:
        kw.update(sort_pack=True, unsort_pack=True, kernel_bf16=True,
                  kernel_center=path != "per_head")
        impl = "hybrid2"
    out_s, grads_s = model_step(kw, impl)
    n_carry = len(calls)
    out_g, grads_g = model_step(dict(kw, gather_sort=True), impl)
    assert torch.equal(out_s, out_g)
    for name, g in grads_s.items():
        assert torch.equal(g, grads_g[name]), name
    d_xc = BASE["h_dim"] + 6
    copies = [s for s in calls[n_carry:] if s[-1] == d_xc]
    per_layer = 2 if path == "per_head" else 1
    # a broadcast-source gather (S = 1) forward and its cotangent's gather
    # backward, per copy and layer
    assert sum(s[0] == 1 for s in copies) == per_layer * BASE["n_layers"]
    assert len(copies) == 2 * per_layer * BASE["n_layers"]
    assert not any(s[-1] == d_xc for s in calls[:n_carry])


def core_inputs(seed, share, h=2, dm=8, d=8, cd=3, c=2, n=8 * BS):
    """A core's operands with 20 invalid rows (ties at +BIG): one-head
    alpha and head-0 codes under share_heads, per-head otherwise."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(dm, n)).astype(np.float32)
    coords = rng.normal(size=(cd, n)).astype(np.float32)
    wq, wk, wv = (rng.normal(size=(h, dm, d)).astype(np.float32) * 0.2 for _ in range(3))
    sqrt_w = np.abs(rng.normal(size=(h, cd)).astype(np.float32)) + 0.5
    alpha = rng.normal(size=(1 if share else h, (dm if share else d) + cd, c)).astype(np.float32)
    codes = rng.integers(0, 4, size=(c, 1 if share else h, n))
    codes = np.broadcast_to(codes, (c, h, n)).astype(np.int32)
    invalid = np.zeros(n, bool)
    invalid[-20:] = True
    cot = rng.normal(size=(n, h * d)).astype(np.float32)
    return [x, coords, wq, wk, wv, sqrt_w], alpha, codes, invalid, cot


def check_core(monkeypatch, kw, seed=7):
    """The port's core against JAX's on JAX's recorded orders."""
    share = kw.get("share_heads", False)
    diff, alpha, codes, invalid, cot = core_inputs(seed, share)
    h, d, n = diff[2].shape[0], diff[2].shape[2], diff[0].shape[1]
    rows = kw.get("unsort_rows", False)
    wj = cot if rows else cot.T.reshape(h, d, n)
    with record_jax_sorts(monkeypatch) as rec:
        def loss(*a):
            out = jba.hept_attention_core_xcols(
                *a, jnp.asarray(alpha), jnp.asarray(codes), jnp.asarray(invalid), None,
                block_size=BS, impl="xla", **kw)
            return jnp.sum(out * wj), out

        (_, jout), jgrads = jax.block_until_ready(jax.jit(jax.value_and_grad(
            loss, argnums=tuple(range(6)), has_aux=True))(*map(jnp.asarray, diff)))
        jax.effects_barrier()
    c = alpha.shape[-1]
    if share:
        (src,) = rec
        src = t(src, torch.int64).reshape(c, n)
    else:
        perms = [t(a, torch.int64).reshape(c, h, n) for a in rec]
        src = (perms[0], perms[0]) if kw.get("shared_sort") else tuple(perms)
    pkw = {k: v for k, v in kw.items() if k not in ("share_heads", "fold_unsort")}
    ins = [t(a).requires_grad_(True) for a in diff]
    out = hept_attention_core_xcols(*ins, t(alpha), t(codes), t(invalid), None, block_size=BS,
                                    impl="pallas", share_heads=share, src=src, **pkw)
    jrows = np.asarray(jout) if rows else np.asarray(jout).reshape(h * d, n).T
    close(out, jrows, 1e-5, "output")
    torch.sum(out * t(cot)).backward()
    for x, g, nm in zip(ins, jgrads, ("x", "coords", "wq", "wk", "wv", "sqrt_w")):
        close(x.grad, g, 1e-4, nm)


@pytest.mark.parametrize("path", list(PATHS))
def test_gather_sort_core_matches_jax(monkeypatch, path):
    """JAX's gather_sort (its `_argsort_keys` and row gathers, the
    projections contracting the rows) against the port's, on each dynamic
    post-sort path; per-head also with unsort_rows (the q-side inverse
    reused by the unsort)."""
    kw = {k: v for k, v in PATHS[path].items() if k != "qkv_post_sort"}
    check_core(monkeypatch, dict(kw, gather_sort=True, unsort_rows=path == "per_head"))


@pytest.mark.parametrize("unsort_pack", [False, True], ids=["f32", "unsort_pack"])
def test_fold_unsort_core_matches_jax(monkeypatch, unsort_pack):
    """JAX's fold_unsort (share_heads: every head's [num | denom] unsorted in
    one merged-row gather a round, each element rounded once under
    unsort_pack) against the port's head-broadcast carry, which takes no
    flag for it."""
    check_core(monkeypatch, dict(shared_sort=True, share_heads=True, fold_unsort=True,
                                 unsort_pack=unsort_pack))


@pytest.mark.parametrize("unsort_pack", [False, True], ids=["f32", "unsort_pack"])
def test_fold_unsort_gives_head_carry_bits(unsort_pack):
    """The port's model with fold_unsort against the one without: the
    output and every parameter gradient bit for bit (the flag is accepted
    and runs the head-broadcast carry)."""
    kw = dict(SHARE_HEADS, unsort_pack=unsort_pack)
    out_h, grads_h = model_step(kw)
    out_f, grads_f = model_step(dict(kw, fold_unsort=True))
    assert torch.equal(out_h, out_f)
    for name, g in grads_h.items():
        assert torch.equal(g, grads_f[name]), name
