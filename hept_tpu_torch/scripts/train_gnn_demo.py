"""Train a GNN baseline from its YAML on synthetic tracking events to a
retrieval metric: the port's half of a GNN accuracy comparison
(`scripts/gnn_convergence_jax.py` runs the JAX package's half on the same
events).

    python -m hept_tpu_torch.scripts.train_gnn_demo [conv seed n_events epochs]
        [--points 6000] [--device cuda|cpu] [--log-dir runs/gnn]

Defaults: `configs/tracking/tracking_gnn_gcn.yaml` (loaded as the CLI's
`-c` loads it: its widths, lr 1e-3 and step schedule), seed 42, 10 events
of up to 6000 points (the YAML's synthetic-tracking-6k generator; 8 train,
1 valid, 1 test; dataset seed 0 for every model seed), 15 epochs, batch
size 1. Ends with one `RESULT ...` line.
"""

from __future__ import annotations

import argparse

from ..data.datasets import make_synthetic_tracking
from ..models.gnns import CONVS
from ..train.config import gnn_config_path, load_config
from ..train.trainer import run_one_seed
from ..utils.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("conv", nargs="?", default="gcn", choices=CONVS)
    ap.add_argument("seed", nargs="?", type=int, default=42)
    ap.add_argument("n_events", nargs="?", type=int, default=10)
    ap.add_argument("epochs", nargs="?", type=int, default=15)
    ap.add_argument("--points", type=int, default=6000)
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    ap.add_argument("--log-dir", default="runs/gnn")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # fail before building the dataset

    ds = make_synthetic_tracking(n_events=args.n_events, n_points=args.points, seed=0)
    cfg = load_config(gnn_config_path(args.conv), seed=args.seed, num_epochs=args.epochs,
                      log_dir=args.log_dir, device=args.device)
    res = run_one_seed(cfg, dataset=ds)
    print(f"RESULT tracking-{args.points} [gnn_{args.conv} torch seed={args.seed} "
          f"n={args.n_events}x{args.epochs}ep]: acc@0.9={res['accuracy@0.9']:.4f} "
          f"recall@0.9={res['recall@0.9']:.4f} prec@0.9={res['precision@0.9']:.4f} "
          f"loss={res['loss']:.4f}", flush=True)
    return res


if __name__ == "__main__":
    main()
