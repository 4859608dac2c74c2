"""CLI: `python -m hept_tpu_torch.pileup_trainer -m hept
[--dataset synthetic-pileup] [--epochs 1] [--device cpu] [-c config.yaml]
[--log-dir runs/] [--resume RUN_DIR] [--only-eval]`.

The pileup counterpart of `tracking_trainer` (the JAX package's
`pileup_trainer`): `-m` selects `configs/pileup/pileup_trans_<model>.yaml`
(hept, the reference-parity profile, hept_fast, or one of the seven
baseline attentions: performer, flt, reformer, smyrf, sb, pct,
flatformer); `-c configs/pileup/pileup_gnn_<conv>.yaml` runs a GNN
baseline (gatedgnn, gcn, dgcnn, gravnet). The run trains the focal
loss with best-by-valid AP and prints the best checkpoint's test AP ("auc"),
ROC-AUC, F1 and loss. The run is on the GPU unless `--device cpu` is given.
`--batch-size`, `--batch-mode`, `--n-devices`, `--shard-heads`,
`--shard-hashes` and `torchrun` work as in `tracking_trainer`.
"""

from __future__ import annotations

from . import tracking_trainer


def main(argv=None):
    tracking_trainer.main(argv, task="pileup", default_model="hept")


if __name__ == "__main__":
    main()
