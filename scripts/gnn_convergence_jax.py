"""The JAX package's half of a GNN accuracy comparison: `run_one_seed` of a
tracking GNN YAML on the CPU, on the events that
`python -m hept_tpu_torch.scripts.train_gnn_demo` trains the port on (10
synthetic 6000-point events, dataset seed 0; 15 epochs; seeds 42, 0, 1).

    python scripts/gnn_convergence_jax.py [--convs gcn gravnet] [--seeds 42 0 1]
        [--n-events 10] [--epochs 15] [--points 6000] [--log-dir runs/gnn_jax]

Prints one `RESULT ...` line a run and, per conv, the mean and sample s.d.
of test acc@0.9 over the seeds.
"""

import argparse
import statistics
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from hept_tpu.data.datasets import make_synthetic_tracking  # noqa: E402
from hept_tpu.train.config import load_config  # noqa: E402
from hept_tpu.train.trainer import run_one_seed  # noqa: E402

CONFIGS = Path(__file__).resolve().parent.parent / "hept_tpu" / "configs" / "tracking"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--convs", nargs="+", default=["gcn", "gravnet"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[42, 0, 1])
    ap.add_argument("--n-events", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--points", type=int, default=6000)
    ap.add_argument("--log-dir", default="runs/gnn_jax")
    args = ap.parse_args(argv)
    ds = make_synthetic_tracking(n_events=args.n_events, n_points=args.points, seed=0)
    for conv in args.convs:
        accs = []
        for seed in args.seeds:
            cfg = load_config(CONFIGS / f"tracking_gnn_{conv}.yaml", seed=seed,
                              num_epochs=args.epochs, log_dir=args.log_dir, device="cpu")
            res = run_one_seed(cfg, dataset=ds)
            accs.append(res["accuracy@0.9"])
            print(f"RESULT tracking-{args.points} [gnn_{conv} jax-cpu seed={seed} "
                  f"n={args.n_events}x{args.epochs}ep]: acc@0.9={res['accuracy@0.9']:.4f} "
                  f"recall@0.9={res['recall@0.9']:.4f} prec@0.9={res['precision@0.9']:.4f} "
                  f"loss={res['loss']:.4f}", flush=True)
        sd = statistics.stdev(accs) if len(accs) > 1 else 0.0
        print(f"SUMMARY gnn_{conv} jax-cpu acc@0.9 mean={statistics.mean(accs):.4f} "
              f"sd={sd:.4f} over seeds {args.seeds}", flush=True)


if __name__ == "__main__":
    main()
