"""Dynamic keys after the sort without share_heads (qkv_post_sort, per-head
keys composed through the projections; with and without shared_sort) in
the port against the JAX package's `hept_attention_core_xcols` and model
(`attn_impl: "xla"`, f32), and the refusals that remain on the HEPT path.

JAX sorts unstably and the port stably: on inputs with ties (invalid rows,
replication pads) the port runs on JAX's recorded sort orders
(`torch_dynamic_keys.py`); tie-free, its own keys must give JAX's orders.
Tolerances are `test_torch_parity_model.py`'s: core output 1e-5 and input
gradients 1e-4 of scale; model output 1e-4 and parameter gradients 1e-3 of
scale.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hept_tpu.ops.bucket_attn as jba  # noqa: E402
from hept_tpu_torch.models.transformer import TransformerConfig  # noqa: E402
from hept_tpu_torch.ops.bucket_attn import hept_attention_core_xcols, post_sort_keys  # noqa: E402
from torch_dynamic_keys import (  # noqa: E402
    BASE,
    BS,
    POST,
    SHARE_HEADS,
    SHARED_SORT,
    STATIC,
    close,
    compare_model,
    record_jax_sorts,
    t,
)


def core_inputs(seed, ties, h=2, dm=8, d=8, cd=3, c=2, n=8 * BS):
    """The per-head core's operands; with ties the last 20 rows are
    invalid (all key to +BIG)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(dm, n)).astype(np.float32)
    coords = rng.normal(size=(cd, n)).astype(np.float32)
    wq, wk, wv = (rng.normal(size=(h, dm, d)).astype(np.float32) * 0.2 for _ in range(3))
    sqrt_w = np.abs(rng.normal(size=(h, cd)).astype(np.float32)) + 0.5
    alpha = rng.normal(size=(h, d + cd, c)).astype(np.float32)
    codes = rng.integers(0, 4, size=(c, h, n)).astype(np.int32)
    invalid = np.zeros(n, bool)
    if ties:
        invalid[-20:] = True
    cot = rng.normal(size=(n, h * d)).astype(np.float32)
    return [x, coords, wq, wk, wv, sqrt_w], alpha, codes, invalid, cot


def jax_core(monkeypatch, diff, alpha, codes, invalid, cot, **kw):
    """JAX's xcols core, value and gradients of sum(out * cot) in one
    waited jit, its sort orders recorded. Returns (rows (n, h * d),
    gradients, recorded orders)."""
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
    jrows = np.asarray(jout) if rows else np.asarray(jout).reshape(h * d, n).T
    return jrows, jgrads, list(rec)


MODES = {"per_head": {}, "shared_sort": dict(shared_sort=True),
         "per_head_unsort_rows": dict(unsort_rows=True)}


@pytest.mark.parametrize("ties", [False, True], ids=["tie_free", "invalid_rows"])
@pytest.mark.parametrize("mode", list(MODES))
def test_core_matches_jax(monkeypatch, mode, ties):
    """The per-head post-sort core against JAX's, on JAX's (q_src, k_src):
    output to 1e-5 and the gradients of x, coords, wq, wk, wv and sqrt_w to
    1e-4 of scale. Tie-free, the port's own keys order the points as JAX's
    do up to keys that differ by f32 rounding alone (1e-6 of their scale:
    the two compose the hash through the projections in other orders), and
    the port's recorded orders are its keys' stable argsort."""
    kw = MODES[mode]
    diff, alpha, codes, invalid, cot = core_inputs(5 + ties, ties)
    h, n = diff[2].shape[0], diff[0].shape[1]
    jrows, jgrads, rec = jax_core(monkeypatch, diff, alpha, codes, invalid, cot, **kw)
    shared = kw.get("shared_sort", False)
    assert len(rec) == (1 if shared else 2)
    perms = [t(a, torch.int64).reshape(2, h, n) for a in rec]
    want = (perms[0], perms[0]) if shared else tuple(perms)
    ins = [t(a).requires_grad_(True) for a in diff]
    seen = []
    if not ties:
        hept_attention_core_xcols(*(t(a) for a in diff), t(alpha), t(codes), t(invalid), None,
                                  block_size=BS, impl="pallas", share_heads=False,
                                  record_perms=seen, **kw)
        keys = post_sort_keys(t(diff[0]), t(diff[1]), t(diff[2]), t(diff[3]), t(diff[5]),
                              t(alpha), t(codes), t(invalid))
        for got, w, key in zip(seen[0], want, (keys[1], keys[1]) if shared else keys):
            np.testing.assert_array_equal(got.numpy(), torch.argsort(key, stable=True).numpy())
            ordered = torch.gather(key, -1, w)
            np.testing.assert_allclose(ordered.numpy(), torch.gather(key, -1, got).numpy(),
                                       rtol=0, atol=1e-6 * float(key.abs().max()))
    out = hept_attention_core_xcols(*ins, t(alpha), t(codes), t(invalid), None, block_size=BS,
                                    impl="pallas", share_heads=False, src=want, **kw)
    close(out, jrows, 1e-5, "output")
    torch.sum(out * t(cot)).backward()
    for x, g, nm in zip(ins, jgrads, ("x", "coords", "wq", "wk", "wv", "sqrt_w")):
        close(x.grad, g, 1e-4, nm)


@pytest.mark.parametrize("path", [POST, SHARED_SORT], ids=["per_head", "shared_sort"])
def test_model_matches_jax(monkeypatch, path):
    """The whole post-sort model without share_heads (2 layers, replication
    pads, each layer's e2lsh_alpha h wide and carried by
    `from_jax_variables`), the port on JAX's recorded orders: output to 1e-4
    and every parameter gradient to 1e-3 of scale."""
    model, _, _ = compare_model(monkeypatch, dict(path, padding_mode="replicate"), 1e-4, 1e-3)
    assert tuple(model.blocks[1].attn.e2lsh_alpha.shape) == (2, 8 + 6, 2)


def test_model_tie_free_takes_jax_orders(monkeypatch):
    """On an event without pads the port's own per-head keys give JAX's
    model output (no orders imposed)."""
    from hept_tpu.models import HeptTransformer as JaxHept
    from hept_tpu.models import TransformerConfig as JaxConfig
    from hept_tpu_torch.models.transformer import HeptTransformer
    from hept_tpu_torch.utils.convert import from_jax_variables
    from torch_dynamic_keys import event

    batch = event(384)
    x, coords, valid = batch["x"][0], batch["coords"][0], batch["valid"][0]
    assert valid.all()
    kw = dict(BASE, **POST, padding_mode="replicate")
    jmodel = JaxHept(JaxConfig(in_dim=10, coords_dim=6, attn_impl="xla", **kw))
    variables = jax.block_until_ready(jax.jit(jmodel.init)(jax.random.PRNGKey(3), x, coords,
                                                           valid))
    jout = jax.block_until_ready(jax.jit(jmodel.apply)(variables, x, coords, valid))
    model = HeptTransformer(TransformerConfig(in_dim=10, coords_dim=6, attn_impl="pallas", **kw),
                            torch.Generator().manual_seed(0))
    model.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        out = model(t(x), t(coords), t(valid))
    close(out, jout, 1e-4)


@pytest.mark.parametrize("bad,reason", [
    (dict(num_and_hashes=3), "regions.py:106"),
    (dict(STATIC, canon_residual=True, transport_groups=2), "sigma is the groups' own"),
    (dict(STATIC, unsort_rows=False, transport_groups=2), "transport_groups needs unsort_rows"),
    (dict(STATIC, transport_groups=3), "transport_groups divides block_size"),
    (dict(STATIC, static_keys="morton"), "static_keys in"),
    (dict(transport_groups=2), "without static_keys"),
    (dict(STATIC, unsort_pack="fp8"), "bucket_attn.py:1011"),
    (dict(STATIC, sort_pack="fp8"), "Not queued"),
    (dict(POST, kernel_center=True), "shared q/k bucket grid"),
    (dict(POST, fold_unsort=True), "needs share_heads"),
    (dict(SHARE_HEADS, fold_unsort=True, unsort_pack="fp8"), ":989"),
    (dict(kernel_bf16=True), "Not queued"),
    (dict(SHARE_HEADS, head_shards=2), "not evenly divisible by the corresponding mesh axis"),
    (dict(static_and_bins=4), "without static_keys"),
], ids=["num_and_hashes_3", "canon_with_groups", "groups_without_unsort_rows",
        "groups_not_dividing_block_size", "static_keys_unknown", "groups_without_plan",
        "fp8_unsort_rows", "fp8_sort_pack", "kernel_center_per_head", "fold_unsort_per_head",
        "fold_unsort_fp8", "pre_sort_kernel_bf16", "share_heads_head_tp",
        "and_bins_without_plan"])
def test_refusals_name_their_reason(bad, reason):
    """What stays refused on the HEPT path names its reason: JAX's own
    asserts against the static-plan family's combinations (canon with
    groups, groups without unsort_rows or dividing no bucket, fp8 with the
    merged-row unsorts), JAX's own error (share_heads under head TP: its
    shard_map cannot split the one-head e2lsh_alpha), or what JAX ignores
    or leaves undocumented (groups and AND bins without a plan, a sort_pack
    "fp8": ROADMAP.md, queue 1, 'Not queued')."""
    with pytest.raises(NotImplementedError, match=reason):
        TransformerConfig(in_dim=10, coords_dim=6, **dict(BASE, **bad)).check_supported()


@pytest.mark.parametrize("mode", [
    dict(POST, head_shards=2),
    dict(SHARE_HEADS, use_ckpt=True, bucket_shards=2),
    dict(SHARE_HEADS, padding_mode="zero", bucket_shards=2),
], ids=["post_sort_head_tp", "use_ckpt_bucket_sp", "zero_padding_bucket_sp"])
def test_formerly_refused_modes_are_accepted(mode):
    """Three modes this test file once held refused now pass
    `check_supported`; they are held against JAX's sharded steps in
    `test_torch_tp_post_sort.py` and `test_torch_bucket_padding.py`."""
    TransformerConfig(in_dim=10, coords_dim=6, **dict(BASE, **mode)).check_supported()


def test_dynamic_key_modes_are_supported():
    """The dynamic-key family this port runs passes `check_supported`."""
    bf16 = dict(sort_pack=True, unsort_pack=True, kernel_bf16=True)
    for kw in (dict(padding_mode="zero"), dict(sort_pack=True, unsort_pack=True),
               dict(POST, gather_sort=True, **bf16), dict(SHARED_SORT, kernel_center=True, **bf16),
               dict(SHARE_HEADS, fold_unsort=True, gather_sort=True, kernel_center=True, **bf16),
               dict(STATIC, gather_sort=True, padding_mode="zero"), dict(use_ckpt=True)):
        TransformerConfig(in_dim=10, coords_dim=6, **dict(BASE, **kw)).check_supported()
