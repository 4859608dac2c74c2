"""The static-plan family against the JAX package: `static_hash`'s "coords"
variant and AND bins, the canonical and the grouped (transport groups)
plans, the four plan branches of `hept_attention_core_xcols` (head-broadcast
unsort, fold_unsort, canon, groups), the fp8 unsort, and the model with
canon_residual, transport_groups (with static_rounds, sort_events,
use_ckpt), `static_keys: "coords"` and `static_and_bins`.

Sizes are those of JAX's own tests of these modes (n 600, bs 50, 2 hashes,
20 regions). Tolerances: the plans' integers and the fp8 rounding exact (NaN
on overflow included); f32 outputs 1e-4 of scale and gradients 1e-3 of
scale; the bf16 transport (sort_pack / unsort_pack) and the fp8 unsort at
the port's bf16 tolerances (`test_torch_dynamic_bf16.py`'s: the model's
output 2e-2 of scale, and `torch_dynamic_keys.compare_model`'s
`whole_grad`: each gradient 2e-2 of its scale floored at 2e-2 of the
largest, the whole 1e-3 relative L2; the core's output 1e-3 of scale). JAX runs its
einsum kernels (`attn_impl: "xla"`), the port K6 / K7's plain versions;
every JAX computation is one waited `jax.jit`. The port builds its own plans
from the same inputs, and the model tests assert that their integers equal
JAX's: the events are tie-free in every sort key (no replication pads, no
two points of one (AND cell, Morton) code).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hept_tpu.ops.bucket_attn as jba
from hept_tpu.core.buckets import _cols_to_u32, _u32_to_cols, grouped_sort_carry
from hept_tpu.models import HeptTransformer as JaxHept
from hept_tpu.models import TransformerConfig as JaxConfig
from hept_tpu.models import make_flat_batched_apply as jax_flat
from hept_tpu_torch.core.buckets import _transport, e4m3_round, permute_gather_rows
from hept_tpu_torch.data.batching import pack_events
from hept_tpu_torch.data.synthetic import synthetic_tracking_event
from hept_tpu_torch.models.transformer import (
    HeptTransformer,
    TransformerConfig,
    make_flat_batched_apply,
)
from hept_tpu_torch.ops.bucket_attn import (
    hept_attention_core_xcols,
    morton_order,
    static_bucket_plan,
    static_hash,
)
from hept_tpu_torch.utils.convert import from_jax_variables
from torch_dynamic_keys import (
    SHARE_HEADS,
    check_plan,
    close,
    compare_model,
    jit0,
    plan_tensors,
    record_jax_sorts,
    t,
)

BS = 50
N = 600
FAMILY = dict(h_dim=8, num_heads=2, n_layers=2, block_size=BS, n_hashes=2, num_regions=20,
              num_w_per_dist=10)
STATIC = dict(SHARE_HEADS, static_keys="x0", padding_mode="replicate")
PACK = dict(sort_pack=True, unsort_pack=True)


# -- static_hash ------------------------------------------------------------

@pytest.mark.parametrize("variant,and_bins", [("x0", 0), ("coords", 0), ("x0", 4),
                                              ("coords", 8)])
def test_static_hash_matches_jax(variant, and_bins):
    """Both variants, with and without the AND bin, to 1e-5 of scale."""
    rng = np.random.default_rng(1)
    x0 = rng.normal(size=(8, N)).astype(np.float32)
    coords = rng.normal(size=(6, N)).astype(np.float32)
    alpha = rng.normal(size=(2 if and_bins else 1, 14, 3)).astype(np.float32)
    want = jax.block_until_ready(jax.jit(
        lambda a, b, c: jba.static_hash(a, b, c, 4.47, variant, and_bins=and_bins))(
        x0, coords, alpha))
    got = static_hash(t(x0), t(coords), t(alpha), 4.47, variant, and_bins)
    close(got, want, 1e-5)


# -- the plans ----------------------------------------------------------------

def _plan_inputs(seed=0, n_ev=1):
    """Hashes and codes whose keys do not tie within an event row (two
    float32 keys hash + code * span can coincide; JAX's order among them is
    unspecified), and the coords of synthetic events."""
    rng = np.random.default_rng(seed)
    n = n_ev * N
    while True:
        hashed = rng.normal(size=(3, n)).astype(np.float32)
        codes = rng.integers(0, 5, size=(3, n)).astype(np.float32)
        key = hashed + codes * (hashed.max(1, keepdims=True) - hashed.min(1, keepdims=True))
        key = key.reshape(3, n_ev, N)
        if all(np.unique(k).size == N for k in key.reshape(-1, N)):
            break
    ev = [synthetic_tracking_event(np.random.default_rng(seed + i), n_points=N)
          for i in range(n_ev)]
    coords = np.concatenate([e.coords for e in ev]).T.copy()  # (6, n): eta, phi first
    return hashed, codes, coords


def _jax_plan(hashed, codes, invalid, coords, **kw):
    fn = jax.jit(lambda a, b, c, d: jba.static_bucket_plan(a, b, c, d, **kw))
    return [np.asarray(a) for a in jax.block_until_ready(fn(hashed, codes, invalid, coords))]


def _assert_tie_free(codes, coords, n_ev):
    """No two points of an event share (round 0's AND cell, Morton code):
    sigma's order among such ties is unspecified in JAX."""
    cell = t(codes[0]).reshape(n_ev, -1)
    src0, _ = morton_order(cell, t(coords[0]).reshape(n_ev, -1), t(coords[1]).reshape(n_ev, -1))
    # ties are adjacent in sigma: two neighbours with equal cell and Morton
    from hept_tpu_torch.ops.bucket_attn import _quantise_rank

    qe = _quantise_rank(t(coords[0]).reshape(n_ev, -1), 10)
    qp = _quantise_rank(t(coords[1]).reshape(n_ev, -1), 10)
    key = torch.stack([torch.gather(a, 1, src0) for a in (cell, qe.float(), qp.float())])
    assert not ((key[:, :, 1:] == key[:, :, :-1]).all(dim=0)).any(), "sigma ties"


@pytest.mark.parametrize("n_ev", [1, 2])
def test_canonical_plan_exact(n_ev):
    """canonical=True: (src, inv, scoords, f, finv) equal to JAX's."""
    hashed, codes, coords = _plan_inputs(2, n_ev)
    want = _jax_plan(hashed, codes, None, coords, sort_events=n_ev, canonical=True)
    got = static_bucket_plan(t(hashed), t(codes), None, t(coords), sort_events=n_ev,
                             canonical=True)
    check_plan(got, want)
    assert torch.equal(got[3][0], torch.arange(N).expand(n_ev, N))  # f[0] = identity


@pytest.mark.parametrize("g,n_ev,pack", [(2, 1, False), (4, 1, True), (2, 2, False)],
                         ids=["g2", "g4_pack", "g2_events2"])
def test_grouped_plan_exact(g, n_ev, pack):
    """group_size > 1: the 7-tuple (expanded and group permutations, sigma-
    ordered sorted coords, sigma's entry maps) equal to JAX's, on tie-free
    events."""
    hashed, codes, coords = _plan_inputs(3, n_ev)
    _assert_tie_free(codes, coords, n_ev)
    want = _jax_plan(hashed, codes, None, coords, sort_events=n_ev, group_size=g,
                     sort_pack=pack)
    got = static_bucket_plan(t(hashed), t(codes), None, t(coords), sort_events=n_ev,
                             group_size=g, sort_pack=pack)
    check_plan(got, want)


def test_grouped_plan_padding_valid_rows():
    """Invalid rows go last in sigma and groups of only invalid rows tie at
    +BIG, where JAX's order is unspecified: sigma's valid slots and the
    group permutations' slots of groups with a valid member equal JAX's."""
    hashed, codes, coords = _plan_inputs(4)
    n_valid = 557
    invalid = np.arange(N) >= n_valid
    coords[:, invalid] = 0.0
    g = 2
    want = _jax_plan(hashed, codes, invalid, coords, group_size=g)
    got = static_bucket_plan(t(hashed), t(codes), t(invalid), t(coords), group_size=g)
    np.testing.assert_array_equal(got[5][0, 0, :n_valid].numpy(), want[5][0, 0, :n_valid])
    live = -(-n_valid // g)  # groups holding a valid point sort first
    np.testing.assert_array_equal(got[3][:, 0, :live].numpy(), want[3][:, 0, :live])


# -- the core's plan branches -------------------------------------------------

def _core_inputs(seed=7):
    rng = np.random.default_rng(seed)
    h, d_model, cd, c = 2, 8, 6, 2
    x = rng.normal(size=(d_model, N)).astype(np.float32)
    coords = rng.normal(size=(cd, N)).astype(np.float32)
    wq, wk, wv = (rng.normal(size=(h, d_model, d_model)).astype(np.float32) * 0.3
                  for _ in range(3))
    sqrt_w = (np.abs(rng.normal(size=(h, cd))) + 0.5).astype(np.float32)
    alpha = rng.normal(size=(1, d_model + cd, c)).astype(np.float32)
    codes = np.broadcast_to(rng.integers(0, 4, size=(c, 1, N)), (c, h, N)).astype(np.float32)
    hashed = rng.normal(size=(c, N)).astype(np.float32)
    return [x, coords, wq, wk, wv, sqrt_w, alpha, codes], hashed


CORE_CASES = {
    "head_broadcast": dict(),
    "rows": dict(unsort_rows=True),
    "fold_unsort": dict(fold_unsort=True),
    "canon": dict(canon=True),
    "canon_rows": dict(canon=True, unsort_rows=True),
    "groups": dict(unsort_rows=True, plan_groups=2),
    "fp8": dict(unsort_pack="fp8"),
    "canon_fp8": dict(canon=True, unsort_pack="fp8"),
    "canon_pack": dict(canon=True, unsort_pack=True, sort_pack=True),
}


@pytest.mark.parametrize("case", list(CORE_CASES))
def test_core_plan_branch_matches_jax(case):
    """`hept_attention_core_xcols` on JAX's plan (the canonical or grouped
    one where the case needs it): output and the gradients of sum(out * w)
    for x, coords, the projections and sqrt_w; f32 at 1e-4 / 1e-3 of scale,
    the fp8 and bf16 transports at 1e-3 / 2e-2."""
    kw = CORE_CASES[case]
    arrs, hashed = _core_inputs()
    codes0 = arrs[7][:, 0]
    pkw = dict(canonical=kw.get("canon", False), group_size=kw.get("plan_groups", 1),
               sort_pack=kw.get("sort_pack", False))
    plan = _jax_plan(hashed, codes0, None, arrs[1], **pkw)
    w_out = np.random.default_rng(3).normal(size=(N, 16)).astype(np.float32)

    def jloss(*a):
        out = jba.hept_attention_core_xcols(*a, None, tuple(jnp.asarray(p) for p in plan),
                                            block_size=BS, impl="xla", share_heads=True, **kw)
        if out.ndim == 3:  # (h, dv, n) columns without unsort_rows
            out = out.reshape(-1, N).T
        return jnp.sum(out * w_out), out

    (_, jout), jgrads = jax.block_until_ready(jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4, 5), has_aux=True))(*arrs))
    ins = [t(a).requires_grad_(i < 6) for i, a in enumerate(arrs)]
    out = hept_attention_core_xcols(*ins, None, plan_tensors(plan), block_size=BS,
                                    impl="pallas", share_heads=True, **kw)
    torch.sum(out * t(w_out)).backward()
    bf16 = kw.get("unsort_pack") or kw.get("sort_pack")
    close(out, jout, 1e-3 if bf16 else 1e-4, "output")
    for x, g, nm in zip(ins, jgrads, ("x", "coords", "wq", "wk", "wv", "sqrt_w")):
        if nm == "coords":  # the plan carries the coords: no gradient reaches them
            assert x.grad is None or not x.grad.any()
            continue
        want = np.asarray(g)
        if bf16:
            tol = 2e-2 * max(np.abs(want).max(), 2e-2 * max(np.abs(np.asarray(j)).max()
                                                              for j in jgrads))
            assert float((x.grad - t(want)).abs().max()) <= tol, nm
        else:
            close(x.grad, want, 1e-3, nm)


def test_canon_core_equals_static_core_after_reordering():
    """canon is a storage reordering: with packing off the canonical core's
    output, taken back to point order, is the plain plan's (JAX's claim,
    `tests/test_canon_residual.py`), to f32 reassociation."""
    arrs, hashed = _core_inputs(9)
    ta = [t(a) for a in arrs]
    plan = static_bucket_plan(t(hashed), ta[7][:, 0], None, ta[1], canonical=True)
    src0 = plan[0][0, 0]
    plain = hept_attention_core_xcols(*ta, None, plan[:3], block_size=BS, impl="pallas",
                                      share_heads=True, unsort_rows=True)
    canon = hept_attention_core_xcols(ta[0][:, src0], *ta[1:], None, plan, block_size=BS,
                                      impl="pallas", share_heads=True, canon=True,
                                      unsort_rows=True)
    close(canon[plan[1][0, 0]], plain.numpy(), 1e-6)


# -- the fp8 transport ----------------------------------------------------------

def _fp8_values():
    rng = np.random.default_rng(11)
    v = rng.normal(size=(2, 3, 5, 64)).astype(np.float32) * 100.0
    special = np.asarray([463.9, 464.0, 464.1, 465.0, 480.0, 500.0, 448.0, 1e6, np.inf,
                          -np.inf, -464.5, -470.0, np.nan, 1e-30, 2.0 ** -9, 2.0 ** -10,
                          3e-3, -0.0, 0.0, 1e-20], np.float32)
    v[0, 0, 0, :special.size] = special
    v[1, 2, 4, :special.size] = special  # the denominator column: bf16
    return v


def test_fp8_transport_bits_match_jax():
    """The e4m3 numerators / bf16 denominator rounding, bit for bit against
    JAX's `_cols_to_u32` / `_u32_to_cols` round trip, NaN past 464 and at
    +-inf (torch's own cast saturates)."""
    cols = _fp8_values()  # (c, h, d, n) columns, the last column the denominator
    want = np.asarray(jax.jit(lambda a: _u32_to_cols(*_cols_to_u32(a, "fp8"), "fp8"))(cols))
    got = _transport(t(cols).transpose(2, 3), "fp8").float().transpose(2, 3).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.uint32), want[ok].view(np.uint32))
    assert np.isnan(want[0, 0, 0, 2:6]).all() and np.isnan(want[0, 0, 0, 8:12]).all()
    assert want[0, 0, 0, 1] == 448.0
    # torch's plain cast saturates where JAX gives NaN; e4m3_round restores it
    raw = t(np.asarray([500.0, np.inf], np.float32)).to(torch.float8_e4m3fn).float()
    assert torch.equal(raw, torch.tensor([448.0, 448.0]))
    assert e4m3_round(t(np.asarray([500.0, np.inf], np.float32))).isnan().all()


def test_fp8_cotangent_rounding_matches_jax():
    """The fp8 unsort's VJP rounds the cotangent alike (JAX:
    `tests/test_core.py:242-270`): the gradient of a permuted fp8 row
    gather, bit for bit."""
    rng = np.random.default_rng(12)
    rows = rng.normal(size=(3, 64, 5)).astype(np.float32)  # (c*h, n, dv + 1)
    ct = _fp8_values()[0].reshape(-1, 5, 64)[:3].transpose(0, 2, 1).copy()
    perm = np.stack([rng.permutation(64) for _ in range(3)])
    keys = jnp.asarray(perm.reshape(3, 1, 64).astype(np.float32))

    def f(r):
        (out,), _ = grouped_sort_carry([keys], [jnp.swapaxes(r, -1, -2)[:, None]], pack="fp8")
        return jnp.sum(out[:, 0] * jnp.swapaxes(jnp.asarray(ct), -1, -2))

    want = np.asarray(jax.jit(jax.grad(f))(rows))
    src = torch.as_tensor(np.argsort(perm, axis=1, kind="stable"))
    inv = torch.argsort(src, dim=1)
    x = t(rows).requires_grad_()
    out = permute_gather_rows(x, src, inv, pack="fp8")
    torch.sum(out * t(ct)).backward()
    got = x.grad.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok], want[ok])


# -- the model ------------------------------------------------------------------

MODEL_CASES = {
    "canon": (dict(STATIC, canon_residual=True), 1e-4, 1e-3, False),
    "canon_rounds3_rows": (dict(STATIC, canon_residual=True, static_rounds=3,
                                unsort_rows=True), 1e-4, 1e-3, False),
    "coords_canon_bins4_pack": (dict(STATIC, static_keys="coords", canon_residual=True,
                                     static_and_bins=4, **PACK), 2e-2, 2e-2, True),
    "x0_bins4_fold_unsort": (dict(STATIC, static_and_bins=4, fold_unsort=True), 1e-4, 1e-3,
                             False),
    "groups_rounds4_ckpt": (dict(STATIC, unsort_rows=True, transport_groups=2, static_rounds=4,
                                 use_ckpt=True), 1e-4, 1e-3, False),
    "plan_fp8": (dict(STATIC, unsort_pack="fp8"), 2e-2, 2e-2, True),
    "share_heads_fp8": (dict(SHARE_HEADS, unsort_pack="fp8", padding_mode="replicate"), 2e-2,
                        2e-2, True),
    "per_head_fp8": (dict(qkv_post_sort=True, unsort_pack="fp8", padding_mode="replicate"),
                     2e-2, 2e-2, True),
    # raw e4m3 numerators and cotangents (no ratio): a rounding step is 6-12 %
    "pre_sort_fp8": (dict(unsort_pack="fp8", padding_mode="replicate"), 2e-2, 2e-1, True),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_matches_jax(monkeypatch, case):
    """JAX's model and the port's on carried weights and constants (the
    2-row `static_alpha` of the AND bins too): outputs and every parameter
    gradient within the case's tolerances. Ungrouped, the port's own plan
    equals JAX's; the synthetic tracks' hits share (cell, Morton) codes, so
    the grouped cases run on JAX's plan (`test_grouped_plan_exact` holds
    the grouped plan itself on tie-free points), and on dynamic keys (the
    fp8 cases without a plan) on JAX's recorded sort orders. The pre-sort
    fp8 core moves raw numerators and their cotangents as e4m3, where f32
    noise between the packages flips roundings of 6-12 %: its output holds
    at 2e-2 of scale but for 2 elements (`fwd_flips`), its gradient at 1e-2
    relative L2 (the card's bf16 gate) and 2e-1 per tensor."""
    kw, fwd_tol, grad_tol, whole = MODEL_CASES[case]
    compare_model(monkeypatch, kw, fwd_tol, grad_tol, n_points=N, base=FAMILY,
                  own_plan=not kw.get("transport_groups"), whole_grad=whole,
                  fwd_flips=2 if case == "pre_sort_fp8" else 0,
                  whole_tol=1e-2 if case == "pre_sort_fp8" else 1e-3, quick=True)


@pytest.mark.parametrize("kw", [dict(transport_groups=2, unsort_rows=True),
                                dict(canon_residual=True)], ids=["groups", "canon"])
def test_stacked_events_match_jax(monkeypatch, kw):
    """Two events as stacked rows of one plan (`sort_events` 2,
    `make_flat_batched_apply`): the output matches at 1e-4 of scale; canon
    on the port's own plan, equal to JAX's, the groups on JAX's (sigma ties
    between a track's hits: `test_model_matches_jax`)."""
    evs = [synthetic_tracking_event(np.random.default_rng(20 + i), n_points=N,
                                    pairs_per_point=8) for i in range(2)]
    batch = pack_events(evs, block_size=BS, window_pairs=128)
    x, coords, valid = batch["x"], batch["coords"], batch["valid"]
    assert valid.all()
    cfg = dict(FAMILY, **STATIC, **kw, sort_events=2)
    jmodel = JaxHept(JaxConfig(in_dim=10, coords_dim=6, attn_impl="xla", **cfg))
    with record_jax_sorts(monkeypatch) as rec:
        variables = jit0(jmodel.init, jax.random.PRNGKey(4), x[0], coords[0], valid[0])
        jax.effects_barrier()
        rec.plans.clear()
        jout = jit0(jax_flat(jmodel), variables, x, coords, valid)
        jax.effects_barrier()
    model = HeptTransformer(TransformerConfig(in_dim=10, coords_dim=6, attn_impl="pallas",
                                              **cfg), torch.Generator().manual_seed(0))
    model.load_state_dict(from_jax_variables(variables))
    built, build = [], model.build_plan
    model.build_plan = lambda *a: built.append(build(*a)) or built[-1]
    grouped = kw.get("transport_groups", 1) > 1
    if grouped:
        model.build_plan = lambda *a: plan_tensors(rec.plans[0])
    with torch.no_grad():
        out = make_flat_batched_apply(model)(t(x), t(coords), t(valid))
    if not grouped:
        check_plan(built[0], rec.plans[0])
    close(out, jout, 1e-4)


def test_ckpt_gives_the_plain_bits():
    """use_ckpt on the grouped and the canonical plan: the same output and
    gradients, bit for bit, as without it."""
    batch = pack_events([synthetic_tracking_event(np.random.default_rng(6), n_points=N)],
                        block_size=BS, window_pairs=128)
    x, coords, valid = (t(batch[k][0]) for k in ("x", "coords", "valid"))
    for kw in (dict(transport_groups=2, unsort_rows=True), dict(canon_residual=True)):
        cfg = TransformerConfig(in_dim=10, coords_dim=6, attn_impl="pallas",
                                **dict(FAMILY, **STATIC, **kw))
        runs = []
        for ckpt in (False, True):
            model = HeptTransformer(dataclasses.replace(cfg, use_ckpt=ckpt),
                                    torch.Generator().manual_seed(0))
            out = model(x, coords, valid, torch.Generator().manual_seed(1))
            out.square().sum().backward()
            runs.append((out.detach(), [p.grad for p in model.parameters()]))
        assert torch.equal(runs[0][0], runs[1][0])
        assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_twins_give_the_same_forward_bits():
    """A plan without unsort_rows, with it, and with fold_unsort give the
    same output bits; canon gives the plain plan's with packing off (up to
    f32 reassociation of the projections: 1e-6 of scale)."""
    batch = pack_events([synthetic_tracking_event(np.random.default_rng(8), n_points=N)],
                        block_size=BS, window_pairs=128)
    x, coords, valid = (t(batch[k][0]) for k in ("x", "coords", "valid"))
    outs = {}
    for name, kw in (("broadcast", {}), ("rows", dict(unsort_rows=True)),
                     ("fold", dict(fold_unsort=True)), ("canon", dict(canon_residual=True))):
        cfg = TransformerConfig(in_dim=10, coords_dim=6, attn_impl="pallas",
                                **dict(FAMILY, **STATIC, **kw))
        with torch.no_grad():
            outs[name] = HeptTransformer(cfg, torch.Generator().manual_seed(0))(x, coords, valid)
    assert torch.equal(outs["broadcast"], outs["rows"])
    assert torch.equal(outs["broadcast"], outs["fold"])
    close(outs["canon"], outs["rows"].numpy(), 1e-6)


# -- check_supported --------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(STATIC), dict(STATIC, fold_unsort=True), dict(STATIC, canon_residual=True),
    dict(STATIC, canon_residual=True, static_rounds=5), dict(STATIC, static_keys="coords"),
    dict(STATIC, static_and_bins=4), dict(STATIC, unsort_rows=True, transport_groups=2),
    dict(STATIC, unsort_pack="fp8"), dict(STATIC, canon_residual=True, unsort_pack="fp8"),
    dict(SHARE_HEADS, unsort_pack="fp8"), dict(qkv_post_sort=True, unsort_pack="fp8"),
    dict(unsort_pack="fp8"), dict(unsort_pack="fp8", unsort_rows=True),
], ids=["plan_head_broadcast", "plan_fold_unsort", "canon", "canon_rounds5", "coords",
        "and_bins", "groups", "plan_fp8", "canon_fp8", "share_heads_fp8", "per_head_fp8",
        "pre_sort_fp8", "pre_sort_fp8_unsort_rows"])
def test_static_family_is_supported(kw):
    """What JAX runs of the family passes `check_supported` (the pre-sort
    core ignores unsort_rows and runs fp8 on its raw [num | denom])."""
    TransformerConfig(in_dim=10, coords_dim=6,
                      **{**FAMILY, "padding_mode": "replicate", **kw}).check_supported()


@pytest.mark.parametrize("bad,exc,reason", [
    (dict(canon_residual=True), ValueError, "requires static_keys"),
    (dict(STATIC, canon_residual=True, static_rounds=4, n_hashes=3), ValueError,
     "1 \\+ k\\*\\(n_hashes-1\\)"),
    (dict(STATIC, canon_residual=True, static_rounds=3, n_hashes=1), ValueError,
     "1 \\+ k\\*\\(n_hashes-1\\)"),
], ids=["canon_without_plan", "canon_rounds", "canon_one_hash"])
def test_canon_value_errors(bad, exc, reason):
    """JAX's ValueErrors of canon_residual (`hept_tpu/models/transformer.py:
    615-623, 707-708`)."""
    with pytest.raises(exc, match=reason):
        TransformerConfig(in_dim=10, coords_dim=6,
                          **{**FAMILY, "padding_mode": "replicate", **bad}).check_supported()
