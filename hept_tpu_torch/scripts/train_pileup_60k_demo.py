"""Train a HEPT pileup profile on synthetic 60k-point pileup events to AP /
ROC-AUC / F1: the port of `scripts/train_pileup_60k_demo.py` (focal loss,
the "impatient" plateau schedule, per-batch AP / ROC / F1 on the neutral
points).

    python -m hept_tpu_torch.scripts.train_pileup_60k_demo [seed]
        [--profile hept_fast|hept|performer|flt|reformer|smyrf|sb|pct|flatformer]
        [--n-events 10] [--epochs 25] [--lr 1e-3]
        [--device cuda|cpu] [--log-dir runs/pileup60k]

Defaults: the hept_fast pileup profile, seed 42, 10 events of up to 60000
points (8 train, 1 valid, 1 test; dataset seed 0), 25 epochs at lr 1e-3,
the profile's plateau (factor 0.5, patience 20, on the train loss), batch
size 1. Ends with one `RESULT ...` line in the JAX script's format, tagged
with the JAX demo's arm for the profile's math.
"""

from __future__ import annotations

import argparse

from ..data.datasets import make_synthetic_pileup
from ..models.transformer import BASELINES
from ..train.config import ExperimentConfig, profile_config
from ..train.trainer import run_one_seed
from ..utils.device import resolve_device

# the JAX demo's arm of each profile's math ("headline" is hept_fast's, since
# its row-gather unsort is exact); the parity profile and the baseline
# attentions have no JAX arm
VARIANTS = {"hept_fast": "headline", "hept": "parity", **{b: f"baseline_{b}" for b in BASELINES}}


def demo_config(profile: str, lr: float, seed: int, epochs: int, log_dir: str,
                device=None) -> ExperimentConfig:
    return profile_config(profile, task="pileup", seed=seed, note=f"pileup_{profile}",
                          optimizer_kwargs={"lr": lr}, num_epochs=epochs, log_dir=log_dir,
                          device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("seed", nargs="?", type=int, default=42)
    ap.add_argument("--profile", default="hept_fast", choices=sorted(VARIANTS))
    ap.add_argument("--n-events", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    ap.add_argument("--log-dir", default="runs/pileup60k")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # fail before building the dataset

    ds = make_synthetic_pileup(n_events=args.n_events, n_points=60_000, seed=0)
    cfg = demo_config(args.profile, args.lr, args.seed, args.epochs, args.log_dir, args.device)
    res = run_one_seed(cfg, dataset=ds)
    print(f"RESULT pileup-60k [{VARIANTS[args.profile]} seed={args.seed} "
          f"n={args.n_events}x{args.epochs}ep]: "
          + " ".join(f"{k}={v:.4f}" for k, v in sorted(res.items())), flush=True)
    return res


if __name__ == "__main__":
    main()
