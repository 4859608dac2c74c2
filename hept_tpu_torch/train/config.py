"""Experiment config with the reference's YAML key surface (port of
`hept_tpu/train/config.py`; its own dataclass, since the JAX one builds the
flax model's config). PyYAML is imported only by `load_config`."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

from ..models.gnns import GNNConfig
from ..models.transformer import TransformerConfig

CONFIG_ROOT = Path(__file__).resolve().parent.parent / "configs"
CONFIG_DIR = CONFIG_ROOT / "tracking"


@dataclasses.dataclass
class ExperimentConfig:
    task: str = "tracking"
    seed: int = 42
    note: str = ""

    model_name: str = "trans_hept"
    model_kwargs: dict = dataclasses.field(default_factory=dict)

    loss_name: str = "infonce"
    loss_kwargs: dict = dataclasses.field(default_factory=dict)

    optimizer_name: str = "adam"
    optimizer_kwargs: dict = dataclasses.field(default_factory=dict)
    num_epochs: int = 10
    batch_size: int = 1

    lr_scheduler_name: Optional[str] = None
    lr_scheduler_kwargs: dict = dataclasses.field(default_factory=dict)
    # the metric the "impatient" plateau watches: "loss" (the train loss) or
    # a valid metric's name; None means "loss"
    lr_scheduler_metric: Optional[str] = None

    data_dir: str = "data/"
    dataset_name: str = "synthetic-tracking-1k"
    main_metric: str = "accuracy@0.9"
    mode: str = "max"

    # a run dir of an earlier run to go on from (its ckpt/), or None
    resume: Optional[str] = None
    # evaluate the test split (of the initial or resumed weights) and stop
    only_eval: bool = False
    # log the parameter count and one forward's FLOPs, return them and stop
    only_flops: bool = False
    # declared by the JAX package's config and read by neither trainer:
    # accepted and ignored (checkpoints are written at each new best)
    ckpt_every: int = 0
    # time-stamped run dirs (scalars.jsonl, ckpt/) go under this directory
    log_dir: str = "runs/"

    # "cuda" (default) | "cpu"
    device: Optional[str] = None
    attn_impl: str = "pallas"
    padding_mode: str = "replicate"
    # train-time random supervision-pair augmentation fraction
    pair_aug_p: float = 0.2
    # tracking: pack pairs in the 128-window layout and run the InfoNCE loss
    # on the pair kernels; False packs the pair list as it is and builds the
    # positive / negative masks in the step
    windowed_pairs: bool = True

    # multi-process training (`parallel/`), the JAX package's names and
    # defaults: the number of ranks (None: the world size of the process
    # group, 1 without one); heads and OR rounds sharded over this many
    # ranks each (tensor parallelism, HEPT dynamic keys, batch_mode vmap);
    # the ranks left over take slices of the event batch (data parallelism)
    n_devices: Optional[int] = None
    shard_heads: int = 1
    shard_hashes: int = 1
    # "vmap": the events of a batch one forward each; "flat": one forward of
    # the concatenated batch with the batch index in the AND codes (HEPT
    # only: `models/transformer.py:make_flat_batched_apply`)
    batch_mode: str = "vmap"

    def __post_init__(self):
        if self.batch_mode not in ("vmap", "flat"):
            raise ValueError(f"batch_mode {self.batch_mode!r}: 'vmap' or 'flat'")

    def model_config(self, in_dim: int, coords_dim: int) -> TransformerConfig:
        kw = dict(self.model_kwargs)
        if self.model_name.startswith("trans_"):
            kw.setdefault("attn_type", self.model_name.split("_", 1)[1])
        return TransformerConfig(in_dim=in_dim, coords_dim=coords_dim, task=self.task,
                                 attn_impl=self.attn_impl, padding_mode=self.padding_mode, **kw)


    def gnn_config(self, in_dim: int, coords_dim: int) -> GNNConfig:
        """The GNNStack of `gnn_<conv>`: model_kwargs hidden_dim (64),
        num_layers (4), out_dim, graph_k (16), k (8), knn_dim (4), the JAX
        trainer's keys and defaults; other keys are not read."""
        kw = self.model_kwargs
        return GNNConfig(in_dim=in_dim, coords_dim=coords_dim,
                         conv_type=self.model_name.split("_", 1)[1], task=self.task,
                         h_dim=kw.get("hidden_dim", 64), n_layers=kw.get("num_layers", 4),
                         out_dim=kw.get("out_dim"), graph_k=kw.get("graph_k", 16),
                         k=kw.get("k", 8), knn_dim=kw.get("knn_dim", 4))


def load_config(path: str | Path, **overrides) -> ExperimentConfig:
    """Load a YAML config (reference key surface) into ExperimentConfig."""
    import yaml

    raw = yaml.safe_load(Path(path).read_text()) or {}
    raw.update(overrides)
    known = {f.name for f in dataclasses.fields(ExperimentConfig)}
    unknown = set(raw) - known
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    return ExperimentConfig(**raw)


def profile_config(profile: str, task: str = "tracking", **overrides) -> ExperimentConfig:
    """The shipped profile `configs/<task>/<task>_trans_<profile>.yaml` with
    `overrides`: tracking hept, hept_acc, hept_fast, hept_turbo, hept_max;
    pileup hept, hept_fast; for both tasks the seven baseline attentions
    (`models/transformer.py:BASELINES`: performer, flt, reformer, smyrf,
    sb, pct, flatformer). The GNN baselines' YAMLs,
    `configs/<task>/<task>_gnn_<conv>.yaml`, load with `load_config`
    (`gnn_config`)."""
    return load_config(CONFIG_ROOT / task / f"{task}_trans_{profile}.yaml", **overrides)


def gnn_config_path(conv: str, task: str = "tracking") -> Path:
    """The shipped YAML of a GNN baseline (`models/gnns.py:CONVS`)."""
    return CONFIG_ROOT / task / f"{task}_gnn_{conv}.yaml"
