"""Minimal HEPT quickstart (the port's counterpart of
`examples/hept_example.py`, the reference's `example/` flow): train a small
HEPT transformer on synthetic tracking events, evaluate its retrieval
metrics on a held-out event, and time one inference pass.

    python -m hept_tpu_torch.scripts.hept_example [--points 6000] [--epochs 5]
        [--events 8] [--device cuda|cpu]

The model is the JAX example's: the default configuration (4 layers, 8
heads, h_dim 24, 100-point buckets, 3 OR hashes, dynamic per-head keys, f32)
with its bucket kernels K6 / K7 v1 (`attn_impl: pallas`), Adam at lr 1e-3,
no dropout, one event a step. It runs on the card unless `--device cpu`
asks for the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..data.batching import pack_events
from ..data.synthetic import synthetic_tracking_event
from ..train import trainer
from ..train.config import ExperimentConfig
from ..train.metrics import acc_and_pr_at_k, point_filter
from ..utils.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--points", type=int, default=6000)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--events", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    events = [synthetic_tracking_event(rng, n_points=args.points) for _ in range(args.events)]
    batches = [trainer.batch_to_device(pack_events([ev], block_size=100, window_pairs=128),
                                       device) for ev in events]
    cfg = ExperimentConfig(attn_impl="pallas", device=str(device))
    model = trainer.build_model(cfg, events[0].x.shape[1], events[0].coords.shape[1],
                                torch.Generator(device=device).manual_seed(0), device)
    opt = trainer.make_optimizer(model.parameters(), lr=1e-3)
    loss_fn = trainer.make_loss_fn(cfg)
    losses = []
    for epoch in range(args.epochs):
        ep = [float(trainer.train_step(model, opt, loss_fn, b)["loss"]) for b in batches[:-1]]
        losses.append(float(np.mean(ep)))
        print(f"epoch {epoch}: loss {losses[-1]:.4f}")

    # eval on the held-out event
    test = batches[-1]
    x, coords, valid = test["x"][0], test["coords"][0], test["valid"][0]
    with torch.no_grad():
        out = model(x, coords, valid)
    mask = point_filter(test["cluster_ids"][0], test["recons"][0], test["pts"][0], 0.9) & valid
    acc, prec, rec = acc_and_pr_at_k(out, test["cluster_ids"][0], mask, valid=valid)
    print(f"test accuracy@0.9={acc:.4f} precision={prec:.4f} recall={rec:.4f}")

    # inference timing (example.ipynb cells 9-10)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    with torch.no_grad():
        model(x, coords, valid)
        sync()
        t0 = time.perf_counter()
        for _ in range(10):
            model(x, coords, valid)
        sync()
    ms = (time.perf_counter() - t0) / 10 * 1e3
    print(f"inference: {ms:.2f} ms / event on {device}")
    return {"losses": losses, "accuracy": acc, "precision": prec, "recall": rec,
            "inference_ms": ms}


if __name__ == "__main__":
    main()
