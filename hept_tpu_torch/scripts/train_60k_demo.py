"""Train a HEPT profile on synthetic tracking-60k to a retrieval metric: the
port of `scripts/train_60k_demo.py` (the recipe behind the JAX package's
acc@0.9 seed spreads), for the profiles the port runs.

    python -m hept_tpu_torch.scripts.train_60k_demo [lr seed n_events epochs]
        [--profile hept_acc|hept_max|hept_fast|hept_turbo|hept|performer|flt|reformer|
                   smyrf|sb|pct|flatformer] [--device cuda|cpu]
        [--log-dir runs/train60k] [--block-size N]

Defaults: the hept_acc profile, lr 1e-2, seed 42, 10 events of up to 60000
points (8 train, 1 valid, 1 test; dataset seed 0), 25 epochs, step schedule
(500, 0.5), batch size 1. Ends with one `RESULT ...` line in the JAX
script's format, tagged with the JAX demo's name for the profile's
composition. `--block-size` (baselines only: their buckets are
`bucket_size`, so block_size sets the packing alone) packs the events to a
multiple of N instead of 100: reformer needs n % (2 bucket_size) == 0 and
flatformer n % group_size == 0, 200 at their widths, as in JAX, and this
dataset's largest event packs to 58300 points at 100.
"""

from __future__ import annotations

import argparse

from ..data.datasets import make_synthetic_tracking
from ..models.transformer import BASELINES
from ..train.config import ExperimentConfig, profile_config
from ..train.trainer import run_one_seed
from ..utils.device import resolve_device

# the JAX demo's arm of each profile's composition (BASELINE.md); the parity
# profile has no JAX arm of its own (its nearest, r2known, is another stack),
# nor do the baseline attentions (tagged "baseline_<name>")
VARIANTS = {"hept_acc": "nh2r8bs512cv2r", "hept_max": "r12bs512cv2r", "hept_fast": "nh2r8cv2r",
            "hept_turbo": "nh1r4cv2r", "hept": "parity",
            **{b: f"baseline_{b}" for b in BASELINES}}


def demo_config(profile: str, lr: float, seed: int, epochs: int, log_dir: str,
                device=None) -> ExperimentConfig:
    return profile_config(
        profile, seed=seed, note=profile, optimizer_kwargs={"lr": lr},
        lr_scheduler_name="step", lr_scheduler_kwargs={"step_size": 500, "gamma": 0.5},
        num_epochs=epochs, log_dir=log_dir, device=device,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("lr", nargs="?", type=float, default=1e-2)
    ap.add_argument("seed", nargs="?", type=int, default=42)
    ap.add_argument("n_events", nargs="?", type=int, default=10)
    ap.add_argument("epochs", nargs="?", type=int, default=25)
    ap.add_argument("--profile", default="hept_acc", choices=sorted(VARIANTS))
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    ap.add_argument("--log-dir", default="runs/train60k")
    ap.add_argument("--block-size", type=int, default=None,
                    help="baselines: pack to a multiple of this (default 100)")
    args = ap.parse_args(argv)
    if args.block_size and args.profile not in BASELINES:
        ap.error("--block-size is the bucket size of a HEPT profile; it takes a baseline")
    resolve_device(args.device)  # fail before building the dataset

    ds = make_synthetic_tracking(n_events=args.n_events, n_points=60_000, seed=0,
                                 avg_track_size=8, pairs_per_point=16)
    cfg = demo_config(args.profile, args.lr, args.seed, args.epochs, args.log_dir, args.device)
    if args.block_size:
        cfg.model_kwargs["block_size"] = args.block_size
    res = run_one_seed(cfg, dataset=ds)
    bs = f" bs={args.block_size}" if args.block_size else ""
    print(f"RESULT tracking-60k [{VARIANTS[args.profile]}{bs} lr={args.lr:g} seed={args.seed} "
          f"n={args.n_events}x{args.epochs}ep]: "
          f"acc@0.9={res['accuracy@0.9']:.4f} "
          f"recall@0.9={res['recall@0.9']:.4f} "
          f"prec@0.9={res.get('precision@0.9', float('nan')):.4f} "
          f"loss={res['loss']:.4f}", flush=True)
    return res


if __name__ == "__main__":
    main()
