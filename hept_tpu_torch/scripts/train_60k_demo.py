"""Train the hept_acc profile on synthetic tracking-60k to a retrieval
metric: the port of the `nh2r8bs512cv2r` arm of `scripts/train_60k_demo.py`
(the recipe behind the JAX package's acc@0.9 seed spread).

    python -m hept_tpu_torch.scripts.train_60k_demo [lr seed n_events epochs]
        [--device cuda|cpu] [--log-dir runs/train60k]

Defaults: lr 1e-2, seed 42, 10 events of up to 60000 points (8 train,
1 valid, 1 test; dataset seed 0), 25 epochs, step schedule (500, 0.5),
batch size 1. Ends with one `RESULT ...` line in the JAX script's format.
"""

from __future__ import annotations

import argparse

from ..data.datasets import make_synthetic_tracking
from ..train.config import HEPT_ACC_MODEL, ExperimentConfig
from ..train.trainer import run_one_seed
from ..utils.device import resolve_device

VARIANT = "nh2r8bs512cv2r"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("lr", nargs="?", type=float, default=1e-2)
    ap.add_argument("seed", nargs="?", type=int, default=42)
    ap.add_argument("n_events", nargs="?", type=int, default=10)
    ap.add_argument("epochs", nargs="?", type=int, default=25)
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    ap.add_argument("--log-dir", default="runs/train60k")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # fail before building the dataset

    ds = make_synthetic_tracking(n_events=args.n_events, n_points=60_000, seed=0,
                                 avg_track_size=8, pairs_per_point=16)
    cfg = ExperimentConfig(
        task="tracking", seed=args.seed, model_kwargs=dict(HEPT_ACC_MODEL),
        optimizer_kwargs={"lr": args.lr}, lr_scheduler_name="step",
        lr_scheduler_kwargs={"step_size": 500, "gamma": 0.5}, num_epochs=args.epochs,
        batch_size=1, main_metric="accuracy@0.9", mode="max", log_dir=args.log_dir,
        attn_impl="slab2", device=args.device,
    )
    res = run_one_seed(cfg, dataset=ds)
    print(f"RESULT tracking-60k [{VARIANT} lr={args.lr:g} seed={args.seed} "
          f"n={args.n_events}x{args.epochs}ep]: "
          f"acc@0.9={res['accuracy@0.9']:.4f} "
          f"recall@0.9={res['recall@0.9']:.4f} "
          f"prec@0.9={res.get('precision@0.9', float('nan')):.4f} "
          f"loss={res['loss']:.4f}", flush=True)
    return res


if __name__ == "__main__":
    main()
