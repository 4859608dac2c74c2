"""`attn_impl: "xla"`, the JAX package's default, in the port.

Off a TPU, JAX runs the einsum forward (`bucket_rbf_attention_cols_xla`)
and autodiff's backward for every `attn_impl`; `hybrid`'s forward is that
einsum too. The port runs `xla` on `hybrid`'s kernels: K6 with exact f32
bias terms and K7 v1, the f32-upcast backward, which is the gradient of
that forward (`ops/bucket_attn_cuda.py:cols_routes`). On the CPU they are
their plain versions.

The model a bare `TransformerConfig(in_dim, coords_dim, <widths>)` builds
(zero padding, `xla`) is held against JAX's model at its own defaults,
unpatched, on an event whose length is not a multiple of the block: f32 at
the parity tolerances of `test_torch_parity_model.py` (output 1e-4, every
parameter gradient 1e-3 of its scale). With the bf16 modes, JAX's autodiff
backward of its bf16 einsum rounds the cotangents to bf16 where K7 v1 keeps
them f32, so the yardstick is JAX's own gap: its `hybrid` (K7 v1 in Pallas
interpret mode) against its `xla`. The port's `xla` may be no further from
JAX's `xla` than 1.5 times that gap. JAX's parameters come from
`jax.eval_shape(init)` filled from numpy; the port runs on JAX's recorded
sort orders (`torch_dynamic_keys.py`: pads key to +BIG, where JAX's
unstable sort and the port's stable one part ties), and each JAX
computation is one waited `jax.jit`.
"""

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hept_tpu.models import HeptTransformer as JaxHept  # noqa: E402
from hept_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from hept_tpu_torch.models.transformer import HeptTransformer, TransformerConfig  # noqa: E402
from hept_tpu_torch.ops.bucket_attn_cuda import (  # noqa: E402
    ATTN_IMPLS,
    bucket_rbf_attention_cols,
    cols_routes,
)
from hept_tpu_torch.utils.convert import from_jax_variables  # noqa: E402
from torch_dynamic_keys import (  # noqa: E402
    BASE,
    SHARE_HEADS,
    STATIC,
    close,
    event,
    jit0,
    layer_perms,
    record_jax_sorts,
    t,
    tpu_kernels,
)

# hept_fast's kernel modes on the dynamic share_heads keys (kernel_center
# needs q and k on one sorted copy)
BF16_KW = dict(SHARE_HEADS, sort_pack=True, kernel_bf16=True, kernel_center=True)
N_POINTS = 378  # 6 zero pads at block 16


def _variables(jmodel, x, coords, valid, seed=0) -> dict:
    """JAX's variables as its init builds their tree, filled from numpy:
    kernels and w_rpe U(+-1/sqrt(fan_in)), biases U(+-0.1), LayerNorm
    scales 1 + N(0, 0.1), frozen E2LSH directions N(0, 1), the region
    counts as `hept_tpu/core/regions.py:get_regions` builds them (uniform
    in [2, 2 sqrt(num_regions) - 2], rescaled to a product of num_regions,
    rounded to thirds)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "regions":  # (c, 2, h)
            c, a, h = shape
            lb, ub = 2.0, 2.0 * jmodel.cfg.num_regions ** (1.0 / a) - 2.0
            flat = rng.uniform(lb, ub, size=(h * c, a))
            flat *= (jmodel.cfg.num_regions / flat.prod(axis=1, keepdims=True)) ** (1.0 / a)
            val = (np.round(flat * 3.0) / 3.0).reshape(h, c, a).transpose(1, 2, 0)
        elif name in ("kernel", "w_rpe"):
            bound = 1.0 / np.sqrt(shape[0] if name == "kernel" else shape[1])
            val = rng.uniform(-bound, bound, size=shape)
        elif name == "bias":
            val = rng.uniform(-0.1, 0.1, size=shape)
        elif name == "scale":
            val = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            val = rng.normal(size=shape)
        return jnp.asarray(val, leaf.dtype)

    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, coords, valid)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_grads(jmodel, variables, x, coords, valid, w_out, kernels=None):
    """JAX's output and parameter gradients of sum(out * w_out), one waited
    jit, with the float-key sort orders recorded; `kernels`: JAX's bucket
    attention through its TPU kernels of that mode, in interpret mode."""
    with pytest.MonkeyPatch.context() as mp, record_jax_sorts(mp) as rec:
        with tpu_kernels(mp, kernels) if kernels else contextlib.nullcontext():
            def jloss(params, x_, coords_, valid_):
                out = jmodel.apply({"params": params, "constants": variables["constants"]},
                                   x_, coords_, valid_)
                return jnp.sum(out * w_out), out

            (_, out), grads = jit0(jax.value_and_grad(jloss, has_aux=True),
                                   variables["params"], x, coords, valid)
            jax.effects_barrier()
    grads = from_jax_variables({"params": grads, "constants": variables["constants"]})
    n_params = len(jax.tree_util.tree_leaves(variables["params"]))
    return np.asarray(out), grads, list(rec), n_params


def _run(kw: dict, jax_kernels=None):
    """JAX's model at its defaults but `kw` (and the widths), its output and
    gradients, and the port's model from TransformerConfig(...) at the
    port's defaults with the same `kw`, on JAX's sort orders: returns
    (JAX's output, JAX's gradients, the port's output, the port's
    gradients), and, with `jax_kernels`, JAX's output and gradients
    through those kernels."""
    batch = event(N_POINTS)
    x, coords, valid = batch["x"][0], batch["coords"][0], batch["valid"][0]
    assert not valid.all()
    jmodel = JaxHept(JaxConfig(in_dim=10, coords_dim=6, **BASE, **kw))
    variables = _variables(jmodel, x, coords, valid)
    w_out = np.random.default_rng(2).normal(size=(x.shape[0], 4)).astype(np.float32)
    jout, jgrads, rec, n_params = _jax_grads(jmodel, variables, x, coords, valid, w_out)
    cfg = TransformerConfig(in_dim=10, coords_dim=6, **BASE, **kw)
    assert (cfg.padding_mode, cfg.attn_impl) == ("zero", "xla")
    model = HeptTransformer(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(from_jax_variables(variables))
    perms = layer_perms(rec, kw, BASE["n_hashes"], BASE["num_heads"], x.shape[0])
    out = model(t(x), t(coords), t(valid), perms=perms)
    torch.sum(out * t(w_out)).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert len(grads) == n_params
    other = None
    if jax_kernels:
        hybrid = JaxHept(dataclasses.replace(jmodel.cfg, attn_impl=jax_kernels))
        hout, hgrads, hrec, _ = _jax_grads(hybrid, variables, x, coords, valid, w_out,
                                           jax_kernels)
        assert all(np.array_equal(a, b) for a, b in zip(rec, hrec))
        other = (hout, {k: hgrads[k] for k in grads})
    return jout, {k: jgrads[k] for k in grads}, out, grads, other


def _rel_l2(got: dict, want: dict) -> float:
    diff2 = sum(float((got[k].double() - want[k].double()).pow(2).sum()) for k in want)
    norm2 = sum(float(want[k].double().pow(2).sum()) for k in want)
    return float(np.sqrt(diff2 / norm2))


def test_default_model_matches_jax_default_model():
    """f32, JAX's einsum + autodiff against the port's plain K6 / K7 v1: the
    output to 1e-4 of its scale and every parameter gradient to 1e-3 of its
    scale."""
    jout, jgrads, out, grads, _ = _run({})
    close(out, jout, 1e-4, "output")
    for name, g in grads.items():
        close(g, jgrads[name], 1e-3, name)


def test_bf16_modes_within_jax_hybrid_gap():
    """sort_pack + kernel_bf16 + kernel_center on the dynamic share_heads
    keys. JAX's `hybrid` gives its `xla` forward (the same einsum) and K7
    v1's gradient; the port's `xla` gradient may be no further from JAX's
    `xla` than 1.5 times JAX's hybrid-vs-xla gap (whole-gradient relative
    L2), and its output within 2e-2 of scale of JAX's (the bf16 level of
    `test_torch_dynamic_bf16.py`). Measured here: the gap 1.06e-3, the
    port 1.07e-3 from JAX's `xla` and 7.4e-5 from its `hybrid`; the output
    within 3.1e-4 of scale."""
    jout, jgrads, out, grads, (hout, hgrads) = _run(BF16_KW, jax_kernels="hybrid")
    np.testing.assert_array_equal(hout, jout)
    close(out, jout, 2e-2, "output")
    gap = _rel_l2(hgrads, jgrads)
    assert gap > 0
    port_gap = _rel_l2(grads, jgrads)
    assert port_gap <= 1.5 * gap, (port_gap, gap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,bs", [(60, 10), (6000, 100), (1536, 16), (5120, 512)])
def test_xla_routes_as_hybrid(dtype, n, bs):
    """`xla` takes `hybrid`'s kernels at every shape (K6 with exact bias,
    K7 v1; never K1 / K2), and on the CPU gives its bits: forward and the
    gradients of sum(so / den) + sum(log den)."""
    assert cols_routes("xla", n, bs, dtype) == cols_routes("hybrid", n, bs, dtype) \
        == ("K6", "K7 v1")
    if n > 2000:
        return
    rng = np.random.default_rng(n)
    arrays = [rng.normal(size=(2, d, n)).astype(np.float32) for d in (7, 7, 5)]
    res = {}
    for mode in ("xla", "hybrid"):
        ins = [t(a).to(dtype).requires_grad_(True) for a in arrays]
        den, so = bucket_rbf_attention_cols(*ins, bs, mode)
        (torch.sum(so / den) + torch.sum(torch.log(den))).backward()
        res[mode] = [den, so] + [a.grad for a in ins]
    for a, b in zip(res["xla"], res["hybrid"]):
        assert torch.equal(a, b)


PATHS = {
    "parity": {},
    "replicate": dict(padding_mode="replicate"),
    "post_sort": dict(qkv_post_sort=True),
    "share_heads_bf16": BF16_KW,
    "static": dict(STATIC, padding_mode="replicate"),
    "static_fp8": dict(SHARE_HEADS, static_keys="x0", unsort_pack="fp8"),
    "head_tp": dict(head_shards=2, use_ckpt=True),
    "hash_tp_share": dict(SHARE_HEADS, hash_shards=2),
    "bucket_sp": dict(SHARE_HEADS, bucket_shards=2, bucket_transport="distributed"),
    "share_heads_head_tp": dict(SHARE_HEADS, head_shards=2),  # refused for both
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_check_supported_takes_xla_where_it_takes_hybrid(path):
    """`check_supported` accepts `xla` on every path that accepts `hybrid`
    (and refuses it where it refuses `hybrid`, with the same reasons)."""
    out = {}
    for mode in ("xla", "hybrid"):
        cfg = TransformerConfig(in_dim=10, coords_dim=6, **dict(BASE, **PATHS[path]),
                                attn_impl=mode)
        try:
            cfg.check_supported()
            out[mode] = None
        except NotImplementedError as e:
            out[mode] = str(e)
    assert out["xla"] == out["hybrid"]
    assert (out["xla"] is None) == (path != "share_heads_head_tp")
    assert "xla" in ATTN_IMPLS
