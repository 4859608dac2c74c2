"""Helpers of the tests that hold the port's dynamic-key modes against the
JAX package (`test_torch_zero_padding.py`, `test_torch_post_sort.py`,
`test_torch_gather_sort.py`, `test_torch_dynamic_bf16.py`,
`test_torch_ckpt.py`).

JAX sorts unstably and the port stably. Invalid rows all key to +BIG and
replication pads copy their source row's key, so where such ties straddle a
bucket boundary the two may bucket a row apart. The model comparisons
therefore run the port on JAX's own sort orders, recorded from its key
sorts with `jax.debug.callback` (`record_jax_sorts`), or on JAX's static
plan; tie-free, the port's own keys must give JAX's orders. Every JAX
computation is one waited `jax.jit` (the interpret-mode kernels' callback
thread dispatches work of its own, and eager dispatch beside it can
deadlock).
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

import hept_tpu.ops.bucket_attn as jba
from hept_tpu.models import HeptTransformer as JaxHept
from hept_tpu.models import TransformerConfig as JaxConfig
from hept_tpu_torch.data.batching import pack_events
from hept_tpu_torch.data.synthetic import synthetic_tracking_event
from hept_tpu_torch.models.transformer import HeptTransformer, TransformerConfig
from hept_tpu_torch.utils.convert import from_jax_variables

BS = 16
BASE = dict(h_dim=8, num_heads=2, n_layers=2, block_size=BS, n_hashes=2, num_regions=16,
            num_w_per_dist=10)
POST = dict(qkv_post_sort=True)
SHARED_SORT = dict(qkv_post_sort=True, shared_sort=True)
SHARE_HEADS = dict(qkv_post_sort=True, shared_sort=True, share_heads=True)
STATIC = dict(SHARE_HEADS, static_keys="x0", unsort_rows=True)
# the hept_fast / hept_acc bf16 modes
BF16 = dict(sort_pack=True, unsort_pack=True, kernel_bf16=True, kernel_center=True)


def t(a, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype)


def close(got, want, tol, name=""):
    """|got - want| <= tol * (|want| + max|want|)."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=name)


def event(n_points: int = 378, seed: int = 5, block_size: int = BS) -> dict:
    """One synthetic event packed to a multiple of `block_size`: at BS, 378
    points leave 6 pads, 384 none."""
    ev = synthetic_tracking_event(np.random.default_rng(seed), n_points=n_points,
                                  pairs_per_point=8)
    return pack_events([ev], block_size=block_size, window_pairs=128)


class Record(list):
    """The recorded sort orders, and `plans`: the static plans."""

    def __init__(self):
        super().__init__()
        self.plans = []


@contextlib.contextmanager
def record_jax_sorts(monkeypatch):
    """Record, in call order, the source permutation of every float-key
    sort of JAX's two dynamic-key cores: the sort-carries
    (`grouped_sort_carry`, one entry per key group) and gather_sort's
    argsorts (`_argsort_keys`); and each static plan the model builds
    (`static_bucket_plan`'s tuple, in `.plans`). The unsorts
    sort integer keys and are skipped. Yields the list; entries are numpy
    arrays."""
    rec = Record()
    sort, argsort, plan = jba.grouped_sort_carry, jba._argsort_keys, jba.static_bucket_plan

    def keep(*arrays):
        jax.debug.callback(lambda *a: rec.extend(np.asarray(x) for x in a), *arrays,
                           ordered=True)

    def recording_sort(keys, payloads, **kw):
        outs, srcs = sort(keys, payloads, **kw)
        if jnp.issubdtype(keys[0].dtype, jnp.floating):
            keep(*srcs)
        return outs, srcs

    def recording_argsort(keys2):
        src, inv = argsort(keys2)
        keep(src)
        return src, inv

    def recording_plan(*args, **kw):
        out = plan(*args, **kw)
        jax.debug.callback(lambda *a: rec.plans.append([np.asarray(x) for x in a]), *out,
                           ordered=True)
        return out

    monkeypatch.setattr(jba, "grouped_sort_carry", recording_sort)
    monkeypatch.setattr(jba, "_argsort_keys", recording_argsort)
    monkeypatch.setattr(jba, "static_bucket_plan", recording_plan)
    for core in (jba.hept_attention_core_xcols, jba.hept_attention_core_cols):
        core.clear_cache()
    try:
        yield rec
    finally:
        for core in (jba.hept_attention_core_xcols, jba.hept_attention_core_cols):
            core.clear_cache()


def plan_tensors(plan) -> tuple:
    """A recorded JAX plan as the port's: int64 permutations, float32
    coords."""
    return tuple(t(a, torch.int64) if np.issubdtype(np.asarray(a).dtype, np.integer)
                 else torch.as_tensor(np.array(a, np.float32)) for a in plan)


def check_plan(got, want) -> None:
    """The port's plan equals JAX's recorded one: every array exactly."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, plan_tensors(want))):
        assert torch.equal(g.to(w.dtype), w), f"plan array {i} differs"


def layer_perms(rec: list, kw: dict, c: int, h: int, n: int) -> list:
    """The recorded sorts as the port's per-layer `perms`: a (c, n) src a
    layer under share_heads, else (q_src, k_src) pairs of (c, h, n) (one
    recorded sort a layer under shared_sort, serving both)."""
    arrays = [t(a, torch.int64) for a in rec]
    if kw.get("share_heads"):
        return [a.reshape(c, n) for a in arrays]
    arrays = [a.reshape(c, h, n) for a in arrays]
    if kw.get("shared_sort") and kw.get("qkv_post_sort"):
        return [(a, a) for a in arrays]
    return [(q, k) for q, k in zip(arrays[::2], arrays[1::2])]


def tpu_kernels(monkeypatch, mode: str):
    """Route JAX's bucket attention through its TPU kernels of attn_impl
    `mode` (interpret mode), as on the TPU (`test_torch_model.py`)."""
    from hept_tpu.ops.bucket_attn_pallas import bucket_rbf_attention_cols_pallas

    einsum = jba.bucket_rbf_attention_cols_xla
    inside = []

    def kernels(sq, sk, sv, block_size, precision=None):
        if inside:  # the hybrid modes' einsum forward calls back in here
            return einsum(sq, sk, sv, block_size, precision=precision)
        inside.append(True)
        try:
            return bucket_rbf_attention_cols_pallas(sq, sk, sv, block_size=block_size,
                                                    hybrid=mode)
        finally:
            inside.pop()

    monkeypatch.setattr(jba, "bucket_rbf_attention_cols_xla", kernels)
    return pltpu.force_tpu_interpret_mode()


def jit0(fn, *args):
    """fn(*args) as one jitted call compiled at XLA's optimisation level 0,
    waited for: a reference compiled once and run once spends most of its
    time in the compile (`test_torch_baselines.py:_jit_run`)."""
    compiled = jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    return jax.block_until_ready(compiled(*args))


def compare_model(monkeypatch, kw: dict, fwd_tol: float, grad_tol: float, *,
                  jax_impl: str = "xla", port_impl: str = "pallas", kernels: str | None = None,
                  n_points: int = 378, port_kw: dict | None = None, whole_grad: bool = False,
                  own_plan: bool = False, base: dict | None = None, fwd_flips: int = 0,
                  whole_tol: float = 1e-3, quick: bool = False):
    """JAX's model and the port's (`kw` over BASE), JAX's weights and
    constants carried over: output to `fwd_tol` and every parameter gradient
    of sum(out * w) to `grad_tol` of its scale, the port on JAX's sort orders
    (or its static plan). `kernels`: JAX runs its TPU kernels of that mode
    in interpret mode. `port_kw`: config fields of the port's model only.
    `whole_grad` (the bf16 modes): the whole gradient is held to 1e-3
    relative L2 over all parameters, as the card's bf16 checks hold it,
    and each tensor to `grad_tol` of its scale floored at 2e-2 of the
    largest gradient's scale (`chip_smoke.py:compare_first_step` floors its
    f32 check alike): a bf16 rounding that flips between two f32 sums of
    other orders moves gradient elements by the same absolute amount in
    every tensor, and at init the q / k projection weights' gradients are
    100-400 times smaller than the largest. `own_plan`: the port builds its
    own static plan, which must equal JAX's (`check_plan`). `base`: the
    widths instead of BASE. `fwd_flips` (an e4m3 transport of raw values):
    at most this many output elements may miss `fwd_tol`, each within 5 x
    `fwd_tol` of scale: f32 noise between the two packages can move a value
    across an e4m3 rounding boundary, and one e4m3 step is 6-12 % of the
    value moved. `whole_tol`: `whole_grad`'s relative L2 (default 1e-3).
    `quick`: JAX's init and step compile at optimisation level 0 (`jit0`).
    Returns (port model, its output, JAX's output)."""
    assert "padding_mode" in kw  # each test names the padding it holds
    base = BASE if base is None else base
    batch = event(n_points, block_size=base["block_size"])
    x, coords, valid = batch["x"][0], batch["coords"][0], batch["valid"][0]
    jcfg = JaxConfig(in_dim=10, coords_dim=6, attn_impl=jax_impl, **base, **kw)
    jmodel = JaxHept(jcfg)
    w_out = np.random.default_rng(2).normal(size=(x.shape[0], 4)).astype(np.float32)
    ctx = tpu_kernels(monkeypatch, kernels) if kernels else contextlib.nullcontext()
    with record_jax_sorts(monkeypatch) as rec, ctx:
        run = jit0 if quick else (lambda f, *a: jax.block_until_ready(jax.jit(f)(*a)))
        variables = run(jmodel.init, jax.random.PRNGKey(1), x, coords, valid)
        jax.effects_barrier()
        rec.clear()  # the sorts of init's forward
        rec.plans.clear()

        def jloss(params, x_, coords_, valid_):
            out = jmodel.apply({"params": params, "constants": variables["constants"]},
                               x_, coords_, valid_)
            return jnp.sum(out * w_out), out

        (_, jout), jgrads = run(jax.value_and_grad(jloss, has_aux=True), variables["params"], x,
                                coords, valid)
        jax.effects_barrier()
    cfg = TransformerConfig(in_dim=10, coords_dim=6, attn_impl=port_impl,
                            **dict(base, **kw, **(port_kw or {})))
    model = HeptTransformer(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(from_jax_variables(variables))
    fwd, built = {}, []
    if kw.get("static_keys") and own_plan:
        build = model.build_plan
        model.build_plan = lambda *a: built.append(build(*a)) or built[-1]
    elif kw.get("static_keys"):
        (plan,) = rec.plans
        fwd["plan"] = plan_tensors(plan)
    else:
        one = kw.get("qkv_post_sort") and (kw.get("shared_sort") or kw.get("share_heads"))
        assert len(rec) == base["n_layers"] * (1 if one else 2)
        fwd["perms"] = layer_perms(rec, kw, kw.get("n_hashes", base["n_hashes"]),
                                   base["num_heads"], x.shape[0])
    out = model(t(x), t(coords), t(valid), **fwd)
    if built:
        check_plan(built[0], rec.plans[0])
    if fwd_flips:
        d = (out.detach() - t(jout)).abs() / float(np.abs(jout).max())
        assert int((d > fwd_tol).sum()) <= fwd_flips and float(d.max()) <= 5 * fwd_tol, \
            (int((d > fwd_tol).sum()), float(d.max()))
    else:
        close(out, jout, fwd_tol, "output")
    torch.sum(out * t(w_out)).backward()
    ref = from_jax_variables({"params": jgrads, "constants": variables["constants"]})
    if not whole_grad:
        for name, p in model.named_parameters():
            close(p.grad, ref[name], grad_tol, name)
        return model, out, np.asarray(jout)
    check_bf16_grads({n: p.grad for n, p in model.named_parameters()}, ref, grad_tol, whole_tol)
    return model, out, np.asarray(jout)


def check_bf16_grads(got: dict, want: dict, tol: float, whole_tol: float) -> None:
    """Gradients of a bf16 model: each tensor to `tol` of its scale floored
    at 2e-2 of the largest tensor's scale, the whole to `whole_tol`
    relative L2 over all tensors (`compare_model`'s `whole_grad`)."""
    want = {name: want[name] for name in got}
    floor = 2e-2 * max(float(w.abs().max()) for w in want.values())
    diff2 = norm2 = 0.0
    for name, w in want.items():
        d = (got[name] - w).double()
        bound = tol * max(float(w.abs().max()), floor)
        assert float(d.abs().max()) <= bound, (name, float(d.abs().max()), bound)
        diff2, norm2 = diff2 + float(d.pow(2).sum()), norm2 + float(w.double().pow(2).sum())
    assert np.sqrt(diff2 / norm2) <= whole_tol, np.sqrt(diff2 / norm2)
