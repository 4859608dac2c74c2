"""CLI: `python -m hept_tpu_torch.tracking_trainer -m hept_acc
[--dataset synthetic-tracking-60k] [--epochs 1] [--device cpu]`.

`-m` selects `configs/tracking/tracking_trans_<model>.yaml` (needs PyYAML);
the run is on the GPU unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse

from .train.config import CONFIG_DIR, load_config
from .train.trainer import run_training


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model", default="hept_acc")
    ap.add_argument("-c", "--config", default=None)
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    args = ap.parse_args(argv)

    path = args.config or CONFIG_DIR / f"tracking_trans_{args.model}.yaml"
    overrides = {"task": "tracking"}
    if args.dataset:
        overrides["dataset_name"] = args.dataset
    if args.epochs is not None:
        overrides["num_epochs"] = args.epochs
    if args.device:
        overrides["device"] = args.device
    result = run_training(load_config(path, **overrides))
    print("train losses:", result["train_loss"])


if __name__ == "__main__":
    main()
