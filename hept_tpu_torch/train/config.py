"""Experiment config with the reference's YAML key surface (port of
`hept_tpu/train/config.py`; its own dataclass, since the JAX one builds the
flax model's config). PyYAML is imported only by `load_config`."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

from ..models.transformer import TransformerConfig

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs" / "tracking"

# the hept_acc profile's model block (configs/tracking/tracking_trans_hept_acc.yaml)
HEPT_ACC_MODEL = dict(
    block_size=512, n_hashes=2, num_regions=150, num_heads=8, h_dim=24, n_layers=4,
    num_w_per_dist=10, sort_pack=True, sort_ops=8, qkv_post_sort=True, unsort_pack=True,
    shared_sort=True, share_heads=True, kernel_bf16=True, kernel_center=True,
    static_keys="x0", static_rounds=8, unsort_rows=True, scan_layers=True,
)


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

    data_dir: str = "data/"
    dataset_name: str = "synthetic-tracking-1k"
    main_metric: str = "accuracy@0.9"
    mode: str = "max"

    # a run dir of an earlier run to go on from (its ckpt/), or None
    resume: Optional[str] = None
    # evaluate the test split (of the initial or resumed weights) and stop
    only_eval: bool = False
    # time-stamped run dirs (scalars.jsonl, ckpt/) go under this directory
    log_dir: str = "runs/"

    # "cuda" (default) | "cpu"
    device: Optional[str] = None
    attn_impl: str = "slab2"
    padding_mode: str = "replicate"
    # train-time random supervision-pair augmentation fraction
    pair_aug_p: float = 0.2
    # pack pairs in the 128-window layout for the pair kernels; the port's
    # loss has only this path, so False is refused
    windowed_pairs: bool = True

    def model_config(self, in_dim: int, coords_dim: int) -> TransformerConfig:
        kw = dict(self.model_kwargs)
        if self.model_name.startswith("trans_"):
            kw.setdefault("attn_type", self.model_name.split("_", 1)[1])
        return TransformerConfig(in_dim=in_dim, coords_dim=coords_dim, task=self.task,
                                 attn_impl=self.attn_impl, padding_mode=self.padding_mode, **kw)


def hept_acc_config(**overrides) -> ExperimentConfig:
    """The hept_acc profile as a dataclass (the YAML's values, no PyYAML)."""
    cfg = ExperimentConfig(
        seed=42, note="k60_rad256_hept_acc", model_kwargs=dict(HEPT_ACC_MODEL),
        loss_kwargs=dict(dist_metric="l2_rbf", tau=0.05), num_epochs=2000,
        optimizer_kwargs=dict(lr=1.0e-2), lr_scheduler_name="step",
        lr_scheduler_kwargs=dict(gamma=0.5, step_size=500),
        dataset_name="synthetic-tracking-6k",
    )
    return dataclasses.replace(cfg, **overrides)


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
