"""The port's ALSH transforms (`core/alsh.py`), reference-checkpoint
converter (`utils/convert.py:convert_reference_hept`) and quickstart
(`scripts/hept_example.py`) against the JAX package's.

ALSH: each transform on the same inputs, the random families on JAX's own
draws (the anchors, rotations and directions JAX draws from its key) and
on a torch generator. Converter: a reference-layout state dict fabricated
from a port model's weights (the reference's names, torch's layouts), read
by both converters; the port's model forward against JAX's on a tie-free
event (einsum path) to 1e-4 of scale. Example: `--device cpu` at a small
size."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hept_tpu.core import alsh as ja  # noqa: E402
from hept_tpu_torch.core import alsh as ta  # noqa: E402


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol * max(float(np.abs(np.asarray(want)).max()), 1e-12))


@pytest.mark.parametrize("fn", ["l2lsh_k", "l2lsh_q", "h2lsh_k", "h2lsh_q", "hadamard_transform"])
def test_alsh_transforms_match_jax(fn):
    v = np.random.default_rng(0).normal(size=(10, 8)).astype(np.float32)
    _close(getattr(ta, fn)(_t(v)), getattr(ja, fn)(jnp.asarray(v)))


@pytest.mark.parametrize("fn", ["xbox", "xbox_max"])
def test_xbox_transforms_match_jax(fn):
    rng = np.random.default_rng(1)
    q, k = (rng.normal(size=(2, 12, 5)).astype(np.float32) for _ in range(2))
    for got, want in zip(getattr(ta, fn)(_t(q), _t(k)), getattr(ja, fn)(jnp.asarray(q),
                                                                          jnp.asarray(k))):
        _close(got, want)


def test_random_families_on_jax_draws():
    """Voronoi, cross-polytope and QLSH on the draws JAX makes from its key:
    the same buckets and projections."""
    rng = np.random.default_rng(2)
    v = rng.normal(size=(3, 20, 6)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    anchors = jax.random.normal(key, (3, 4, 6))
    np.testing.assert_array_equal(ta.voronoi_lsh(_t(v), 3, 4, anchors=_t(anchors)).numpy(),
                                  np.asarray(ja.voronoi_lsh(key, jnp.asarray(v), 3, 4)))
    rot = jax.random.normal(key, (2, 6, 6))
    np.testing.assert_array_equal(ta.cross_polytope_lsh(_t(v), 2, rotations=_t(rot)).numpy(),
                                  np.asarray(ja.cross_polytope_lsh(key, jnp.asarray(v), 2)))
    q, k = rng.normal(size=(4, 5)).astype(np.float32), rng.normal(size=(16, 5)).astype(np.float32)
    a = jax.random.normal(key, (5, 3), jnp.float32)
    got = ta.qlsh_project(_t(q), _t(k), 3, 0.5, directions=_t(a))
    want = ja.qlsh_project(key, jnp.asarray(q), jnp.asarray(k), 3, 0.5)
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_random_families_on_a_generator():
    """Drawn from a torch generator: shapes, ranges, the same draws for the
    same seed, and identical points hashing alike."""
    v = torch.randn(20, 6, generator=torch.Generator().manual_seed(0))

    def gen():
        return torch.Generator().manual_seed(3)

    b = ta.voronoi_lsh(v, 3, 4, generator=gen())
    assert b.shape == (3, 20) and int(b.max()) < 4
    assert torch.equal(b, ta.voronoi_lsh(v, 3, 4, generator=gen()))
    c = ta.cross_polytope_lsh(v, 2, generator=gen())
    assert c.shape == (2, 20) and int(c.max()) < 12
    same = ta.voronoi_lsh(torch.cat([v[:1], v[:1]]), 2, 4, generator=gen())
    assert torch.equal(same[:, 0], same[:, 1])
    qp, kb = ta.qlsh_project(v[:4], v, 3, 0.5, generator=gen())
    assert qp.shape == (4, 3) and kb.shape == (4, 20, 3)
    assert (kb[torch.arange(4), torch.arange(4)] == 0).all()


def test_sort_and_inversions_match_jax():
    rng = np.random.default_rng(3)
    keys = rng.normal(size=(3, 9)).astype(np.float32)
    vals = rng.integers(0, 100, (3, 9))
    for got, want in zip(ta.sort_key_val(_t(keys), _t(vals)),
                         ja.sort_key_val(jnp.asarray(keys), jnp.asarray(vals))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x, y = rng.normal(size=30), rng.normal(size=30)
    assert int(ta.inversion_number(_t(x), _t(y))) == \
        int(ja.inversion_number(jnp.asarray(x), jnp.asarray(y)))


# the port's state-dict names -> the reference's (the inverse of the
# converter's renames)
_TO_REFERENCE = (
    (r"^feat_enc_0\.", "feat_encoder.0."),
    (r"^feat_enc_1\.", "feat_encoder.2."),
    (r"^blocks\.(\d+)\.ff\.fc1\.", r"attns.\1.ff.0."),
    (r"^blocks\.(\d+)\.ff\.fc2\.", r"attns.\1.ff.2."),
    (r"^blocks\.(\d+)\.w_rpe$", r"attns.\1.w_rpe.weight"),
    (r"^blocks\.(\d+)\.attn\.e2lsh_alpha$", r"attns.\1.attn.e2lsh.alpha"),
    (r"^blocks\.(\d+)\.", r"attns.\1."),
)


def test_convert_reference_hept_matches_jax():
    """A reference-layout state dict (the port model's weights under the
    reference's names) through both converters: the port's gives back the
    model's own state dict exactly, and its forward equals JAX's on JAX's
    conversion of the same dict (1e-4 of scale; einsum path, tie-free
    event, 2 layers)."""
    import re

    from hept_tpu.models import HeptTransformer as JaxHept
    from hept_tpu.models import TransformerConfig as JaxConfig
    from hept_tpu.utils.convert import convert_reference_hept as jax_convert
    from hept_tpu_torch.data.batching import pack_events
    from hept_tpu_torch.data.synthetic import synthetic_tracking_event
    from hept_tpu_torch.models.transformer import HeptTransformer, TransformerConfig
    from hept_tpu_torch.utils.convert import convert_reference_hept

    kw = dict(in_dim=10, coords_dim=6, h_dim=8, num_heads=2, n_layers=2, block_size=16,
              n_hashes=2, num_regions=16, num_w_per_dist=10, padding_mode="replicate")
    model = HeptTransformer(TransformerConfig(attn_impl="pallas", **kw),
                            torch.Generator().manual_seed(3))
    own = model.state_dict()
    ref = {}
    for name, v in own.items():
        for pat, rep in _TO_REFERENCE:
            name, hits = re.subn(pat, rep, name)
            if hits:
                break
        ref[name] = v.clone()
    # a checkpoint may hold layers the model does not: both converters skip them
    ref["attns.9.norm1.weight"] = torch.ones(8)
    got = convert_reference_hept(ref, n_layers=2)
    assert got.keys() == own.keys()
    for k in own:
        assert torch.equal(got[k], own[k]), k

    ev = synthetic_tracking_event(np.random.default_rng(5), n_points=384, pairs_per_point=8)
    batch = pack_events([ev], block_size=16, window_pairs=128)
    x, coords, valid = batch["x"][0], batch["coords"][0], batch["valid"][0]
    assert valid.all()
    variables = jax_convert({k: v.numpy() for k, v in ref.items()}, n_layers=2)
    jmodel = JaxHept(JaxConfig(attn_impl="xla", **kw))
    jout = jax.block_until_ready(jax.jit(jmodel.apply)(variables, x, coords, valid))
    model.load_state_dict(got)
    with torch.no_grad():
        out = model(_t(x), _t(coords), _t(valid))
    _close(out.numpy(), jout, 1e-4)


def test_load_reference_checkpoint(tmp_path):
    """A `.pt` holding {"state_dict": ...} loads as the converted dict."""
    from hept_tpu_torch.utils.convert import convert_reference_hept, load_reference_checkpoint

    sd = {"feat_encoder.0.weight": torch.randn(4, 3), "attns.0.w_rpe.weight": torch.randn(2, 5),
          "attns.1.attn.e2lsh.alpha": torch.randn(2, 7, 2)}
    torch.save({"state_dict": sd}, tmp_path / "ckpt.pt")
    got = load_reference_checkpoint(str(tmp_path / "ckpt.pt"))
    want = convert_reference_hept(sd)
    assert got.keys() == want.keys() == {"feat_enc_0.weight", "blocks.0.w_rpe",
                                         "blocks.1.attn.e2lsh_alpha"}
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_hept_example_runs_on_cpu(capsys):
    """The quickstart with `--device cpu` at a small size: finite losses,
    retrieval metrics in [0, 1], a timing line."""
    from hept_tpu_torch.scripts import hept_example

    res = hept_example.main(["--device", "cpu", "--points", "200", "--epochs", "1",
                             "--events", "2"])
    assert len(res["losses"]) == 1 and np.isfinite(res["losses"]).all()
    assert all(0.0 <= res[k] <= 1.0 for k in ("accuracy", "precision", "recall"))
    assert "inference:" in capsys.readouterr().out
