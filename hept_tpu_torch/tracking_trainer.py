"""CLI: `python -m hept_tpu_torch.tracking_trainer -m hept_acc
[--dataset synthetic-tracking-60k] [--epochs 1] [--device cpu]
[--log-dir runs/] [--resume RUN_DIR] [--only-eval] [--batch-size B]
[--batch-mode vmap|flat] [--n-devices N] [--shard-heads H]
[--shard-hashes C]`.

`-m` selects `configs/tracking/tracking_trans_<model>.yaml` (needs PyYAML):
a HEPT profile or one of the seven baseline attentions (performer, flt,
reformer, smyrf, sb, pct, flatformer). `-c` takes any YAML instead, e.g.
the four GNN baselines' `configs/tracking/tracking_gnn_<conv>.yaml` (conv
gatedgnn, gcn, dgcnn, gravnet), as in the JAX package, whose `-m` also
names only the `*_trans_*` files.
The run trains with best-by-valid selection (`train/trainer.py:
run_one_seed`) and prints the best checkpoint's test metrics. `--resume`
goes on from an earlier run dir's latest checkpoint; `--only-eval` only
evaluates the test split (of the resumed weights, with `--resume`). The run
is on the GPU unless `--device cpu` is given. `pileup_trainer.py` is the
same CLI for the pileup task.

Several GPUs: launch under `torchrun`, one process a GPU, e.g.
`torchrun --nproc-per-node 2 -m hept_tpu_torch.tracking_trainer -m hept
--batch-size 2` (data parallelism, an event a rank) or with
`--shard-heads 2` (the heads of each event over two ranks; the parity
`hept` profile). `--n-devices` defaults to the world size; the process
group is NCCL on the GPU and gloo with `--device cpu`, and only rank 0
prints and writes the run dir.
"""

from __future__ import annotations

import argparse

import torch.distributed as dist

from .train.config import CONFIG_ROOT, load_config
from .train.trainer import run_one_seed


def main(argv=None, task: str = "tracking", default_model: str = "hept_acc"):
    ap = argparse.ArgumentParser(prog=f"python -m hept_tpu_torch.{task}_trainer")
    ap.add_argument("-m", "--model", default=default_model)
    ap.add_argument("-c", "--config", default=None)
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--resume", default=None, help="run dir to go on from")
    ap.add_argument("--only-eval", action="store_true")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--batch-mode", default=None, help="vmap (default) | flat")
    ap.add_argument("--n-devices", type=int, default=None,
                    help="ranks (default: the world size under torchrun, else 1)")
    ap.add_argument("--shard-heads", type=int, default=None)
    ap.add_argument("--shard-hashes", type=int, default=None)
    args = ap.parse_args(argv)

    path = args.config or CONFIG_ROOT / task / f"{task}_trans_{args.model}.yaml"
    overrides = {"task": task}
    for key, val in (("dataset_name", args.dataset), ("num_epochs", args.epochs),
                     ("device", args.device), ("log_dir", args.log_dir),
                     ("resume", args.resume), ("batch_size", args.batch_size),
                     ("batch_mode", args.batch_mode), ("n_devices", args.n_devices),
                     ("shard_heads", args.shard_heads), ("shard_hashes", args.shard_hashes)):
        if val is not None:
            overrides[key] = val
    if args.only_eval:
        overrides["only_eval"] = True
    res = run_one_seed(load_config(path, **overrides))
    if not dist.is_initialized() or dist.get_rank() == 0:
        print("best test:", " ".join(f"{k}={v:.4f}" for k, v in res.items()))
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
