"""The port's defaults are the JAX package's.

For every public class and function that a module of both packages defines
under the same module path and name, each keyword that both signatures (or
dataclass fields) have takes the same default in both, and a keyword that
JAX lets a call leave out the port lets it leave out too. The values are
read through `dataclasses.fields` and `inspect.signature`, not the source.
Left out of the comparison, with the reason: the renamed parallel fields
(`RENAMED`), and the one signature that is split in two (`SPLIT`).
"""

import dataclasses
import importlib
import inspect
import pkgutil

import pytest

pytest.importorskip("torch")

import hept_tpu  # noqa: E402
import hept_tpu_torch  # noqa: E402

# JAX's TransformerConfig names the mesh axes its TP / bucket SP steps
# shard over; the port's config holds the shard counts, and its model takes
# the process groups (`HeptTransformer(groups=)`). Both defaults mean one
# device.
RENAMED = {
    "head_axis": ("head_shards", None, 1),
    "hash_axis": ("hash_shards", None, 1),
    "bucket_axis": ("groups['buckets']", None, None),
}
# fields of JAX's configs that no port config has: the renamed ones, a field
# no JAX transformer reads, and the TPU compile work-arounds of JAX's eval
JAX_ONLY_FIELDS = {
    "models.transformer.TransformerConfig": set(RENAMED) | {"out_dim"},
    "train.config.ExperimentConfig": {"eval_chunk", "eval_shape_check", "eval_shape_check_tol",
                                      "eval_split_programs"},
}
# JAX's infonce_loss takes (cluster_ids, recons, pts) and, under
# windowed_pairs, the optional pair_rev / pair_weight / pair_neg; the port
# splits it into infonce_loss (windowed: those three positional) and
# infonce_loss_pairs (the pair list)
SPLIT = {("train.losses", "infonce_loss"): {"pair_rev", "pair_weight", "pair_neg"}}
REQUIRED = object()


def _modules(pkg) -> dict:
    """{path relative to the package: module name} of every module."""
    out = {"": pkg.__name__}
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        out[m.name[len(pkg.__name__) + 1:]] = m.name
    return out


def _defaults(obj) -> dict | None:
    """{keyword: default or REQUIRED} of a dataclass's fields or a
    callable's signature; None if it has no signature."""
    if isinstance(obj, type) and dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            if f.default is not dataclasses.MISSING:
                out[f.name] = f.default
            elif f.default_factory is not dataclasses.MISSING:
                out[f.name] = f.default_factory()
            else:
                out[f.name] = REQUIRED
        return out
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    return {k: REQUIRED if p.default is inspect.Parameter.empty else p.default
            for k, p in sig.parameters.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}


def _shared() -> list:
    """(relative module path, name, JAX object, port object) of every public
    callable with a signature defined in the same-named module of both
    packages."""
    jmods, tmods = _modules(hept_tpu), _modules(hept_tpu_torch)
    out = []
    for rel in sorted(set(jmods) & set(tmods)):
        jm, tm = importlib.import_module(jmods[rel]), importlib.import_module(tmods[rel])
        for name in sorted(set(vars(jm)) & set(vars(tm))):
            a, b = getattr(jm, name), getattr(tm, name)
            if (not name.startswith("_") and callable(a) and callable(b)
                    and getattr(a, "__module__", None) == jm.__name__
                    and getattr(b, "__module__", None) == tm.__name__
                    and _defaults(a) is not None and _defaults(b) is not None):
                out.append((rel, name, a, b))
    return out


SHARED = _shared()


def test_shared_surface_is_found():
    """The comparison reaches the configs and the cores whose defaults once
    differed (attn_impl, padding_mode, impl, share_heads)."""
    found = {f"{rel}.{name}" for rel, name, _, _ in SHARED}
    assert {"models.transformer.TransformerConfig", "train.config.ExperimentConfig",
            "ops.bucket_attn.hept_attention_core", "ops.bucket_attn.hept_attention_core_cols",
            "ops.bucket_attn.hept_attention_core_xcols", "parallel.sp.head_sharded_attention",
            "models.gnns.DGCNNConv", "train.losses.infonce_loss"} <= found
    assert len(SHARED) > 100


@pytest.mark.parametrize("rel,name,jax_obj,port_obj", SHARED,
                         ids=[f"{rel}.{name}" for rel, name, _, _ in SHARED])
def test_shared_defaults_equal(rel, name, jax_obj, port_obj):
    want, got = _defaults(jax_obj), _defaults(port_obj)
    split = SPLIT.get((rel, name), set())
    bad = {}
    for key in sorted(set(want) & set(got) - split):
        if want[key] is REQUIRED:
            continue  # the port may default what JAX requires
        if got[key] is REQUIRED or type(got[key]) is not type(want[key]) \
                or got[key] != want[key]:
            bad[key] = (want[key], "required" if got[key] is REQUIRED else got[key])
    assert not bad, f"{rel}.{name}: (JAX, port) defaults {bad}"


@pytest.mark.parametrize("cls", sorted(JAX_ONLY_FIELDS))
def test_only_listed_fields_are_jax_only(cls):
    """Each config's JAX-only fields are the listed ones, and every renamed
    field's counterpart means one device by default, as JAX's None does."""
    rel, name = cls.rsplit(".", 1)
    jax_obj = getattr(importlib.import_module(f"hept_tpu.{rel}"), name)
    port_obj = getattr(importlib.import_module(f"hept_tpu_torch.{rel}"), name)
    want, got = _defaults(jax_obj), _defaults(port_obj)
    assert set(want) - set(got) == JAX_ONLY_FIELDS[cls]
    for jax_name, (port_name, jax_default, port_default) in RENAMED.items():
        if jax_name in want:
            assert want[jax_name] == jax_default
            if port_name in got:
                assert got[port_name] == port_default


def test_default_model_is_jax_default_model():
    """The defaults that differed until this check: the model a bare
    TransformerConfig(in_dim, coords_dim) builds pads with zeros and runs
    `xla`, as JAX's does, and ExperimentConfig() runs `pallas`."""
    from hept_tpu.models.transformer import TransformerConfig as JaxConfig
    from hept_tpu.train.config import ExperimentConfig as JaxExperimentConfig
    from hept_tpu_torch.models.transformer import TransformerConfig
    from hept_tpu_torch.train.config import ExperimentConfig

    cfg, jcfg = TransformerConfig(10, 6), JaxConfig(10, 6)
    assert (cfg.padding_mode, cfg.attn_impl) == (jcfg.padding_mode, jcfg.attn_impl) \
        == ("zero", "xla")
    cfg.check_supported()
    got = ExperimentConfig().model_config(10, 6)
    want = JaxExperimentConfig().model_config(10, 6)
    assert (got.padding_mode, got.attn_impl) == (want.padding_mode, want.attn_impl) \
        == ("replicate", "pallas")
