"""Train a HEPT profile on synthetic tracking-60k to a retrieval metric: the
port of `scripts/train_60k_demo.py` (the recipe behind the JAX package's
acc@0.9 seed spreads), for the profiles and the JAX demo's arms the port runs.

    python -m hept_tpu_torch.scripts.train_60k_demo [lr seed n_events epochs]
        [--profile hept_acc|hept_max|hept_fast|hept_turbo|hept|performer|flt|reformer|
                   smyrf|sb|pct|flatformer | --arm full|static|fullb4|coordsb4|r9canon|
                   nh2r8bs512cv2rg2|nh2r8bs512cv2rg4|...] [--device cuda|cpu]
        [--log-dir runs/train60k] [--block-size N]

Defaults: the hept_acc profile, lr 1e-2, seed 42, 10 events of up to 60000
points (8 train, 1 valid, 1 test; dataset seed 0), 25 epochs, step schedule
(500, 0.5), batch size 1. `--arm` runs an arm of the JAX demo by its name
(`ARMS`): its model kwargs over the JAX demo's base kwargs (bs 100, 3
hashes, 8 heads, h_dim 24, 4 layers, share_heads, sort_pack, unsort_pack,
kernel_bf16, `attn_impl` "hybrid" unless the arm names another), flat
batches of one event, as the JAX demo builds them. Ends with one `RESULT ...`
line in the JAX script's format, tagged with the JAX demo's name for the
profile's composition or the arm, and the synthetic pairs' backend
(`data/synthetic.py:pairs_backend`). `--block-size` (baselines only: their
buckets are `bucket_size`, so block_size sets the packing alone) packs the
events to a multiple of N instead of 100: reformer needs n % (2
bucket_size) == 0 and flatformer n % group_size == 0, 200 at their widths,
as in JAX, and this dataset's largest event packs to 58300 points at 100.
"""

from __future__ import annotations

import argparse

from ..data.datasets import make_synthetic_tracking
from ..data.synthetic import pairs_backend
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


# the JAX demo's base model kwargs (`scripts/train_60k_demo.py:318-330`;
# sort_ops and scan_layers select TPU implementations, read and ignored)
ARM_BASE = dict(block_size=100, n_hashes=3, num_regions=150, num_heads=8, h_dim=24, n_layers=4,
                num_w_per_dist=10, sort_pack=True, sort_ops=8, qkv_post_sort=True,
                scan_layers=True, unsort_pack=True, shared_sort=True, share_heads=True,
                kernel_bf16=True)
# the JAX demo's arms that the port runs, by their names there ("_attn_impl"
# the config's attn_impl, default "hybrid")
ARMS = {
    "full": dict(static_keys="x0", canon_residual=True),
    "static": dict(static_keys="x0"),
    "coords": dict(static_keys="coords", canon_residual=True),
    "fullb4": dict(static_keys="x0", canon_residual=True, static_and_bins=4),
    "fullb8": dict(static_keys="x0", canon_residual=True, static_and_bins=8),
    "coordsb4": dict(static_keys="coords", canon_residual=True, static_and_bins=4),
    "r6": dict(static_keys="x0", static_rounds=6),
    "r6b4": dict(static_keys="x0", static_rounds=6, static_and_bins=4),
    "r9canon": dict(static_keys="x0", canon_residual=True, static_rounds=9),
    "r9canonb4": dict(static_keys="x0", canon_residual=True, static_rounds=9, static_and_bins=4),
    "fullc": dict(static_keys="x0", canon_residual=True, kernel_center=True),
    "fullr": dict(static_keys="x0", canon_residual=True, unsort_rows=True),
    "r12bs128cv2rg2": dict(static_keys="x0", static_rounds=12, block_size=128,
                           kernel_center=True, unsort_rows=True, transport_groups=2,
                           _attn_impl="slab2"),
    "r12bs128cv2rg4": dict(static_keys="x0", static_rounds=12, block_size=128,
                           kernel_center=True, unsort_rows=True, transport_groups=4,
                           _attn_impl="slab2"),
    "nh2r8bs128cv2rg4": dict(static_keys="x0", static_rounds=8, n_hashes=2, block_size=128,
                             kernel_center=True, unsort_rows=True, transport_groups=4,
                             _attn_impl="slab2"),
    "nh2r8bs512cv2rg2": dict(static_keys="x0", static_rounds=8, n_hashes=2, block_size=512,
                             kernel_center=True, unsort_rows=True, transport_groups=2,
                             _attn_impl="slab2"),
    "nh2r8bs512cv2rg4": dict(static_keys="x0", static_rounds=8, n_hashes=2, block_size=512,
                             kernel_center=True, unsort_rows=True, transport_groups=4,
                             _attn_impl="slab2"),
}


def arm_config(arm: str, lr: float, seed: int, epochs: int, log_dir: str,
               device=None) -> ExperimentConfig:
    """The JAX demo's ExperimentConfig of `arm` (`scripts/train_60k_demo.py:
    313-355`)."""
    kw = dict(ARMS[arm])
    attn_impl = kw.pop("_attn_impl", "hybrid")
    return ExperimentConfig(
        task="tracking", seed=seed, note=arm, model_kwargs={**ARM_BASE, **kw},
        optimizer_kwargs={"lr": lr, "clip_norm": 0.0}, lr_scheduler_name="step",
        lr_scheduler_kwargs={"step_size": 500, "gamma": 0.5}, num_epochs=epochs, batch_size=1,
        batch_mode="flat", n_devices=1, main_metric="accuracy@0.9", mode="max",
        log_dir=log_dir, attn_impl=attn_impl, device=device)


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
    ap.add_argument("--arm", default=None, choices=sorted(ARMS),
                    help="an arm of the JAX demo, by its name (instead of --profile)")
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    ap.add_argument("--log-dir", default="runs/train60k")
    ap.add_argument("--block-size", type=int, default=None,
                    help="baselines: pack to a multiple of this (default 100)")
    args = ap.parse_args(argv)
    if args.block_size and (args.arm or args.profile not in BASELINES):
        ap.error("--block-size is the bucket size of a HEPT profile; it takes a baseline")
    resolve_device(args.device)  # fail before building the dataset

    ds = make_synthetic_tracking(n_events=args.n_events, n_points=60_000, seed=0,
                                 avg_track_size=8, pairs_per_point=16)
    if args.arm:
        cfg = arm_config(args.arm, args.lr, args.seed, args.epochs, args.log_dir, args.device)
    else:
        cfg = demo_config(args.profile, args.lr, args.seed, args.epochs, args.log_dir,
                          args.device)
    if args.block_size:
        cfg.model_kwargs["block_size"] = args.block_size
    res = run_one_seed(cfg, dataset=ds)
    bs = f" bs={args.block_size}" if args.block_size else ""
    tag = args.arm or VARIANTS[args.profile]
    print(f"RESULT tracking-60k [{tag}{bs} lr={args.lr:g} seed={args.seed} "
          f"n={args.n_events}x{args.epochs}ep pairs={pairs_backend()}]: "
          f"acc@0.9={res['accuracy@0.9']:.4f} "
          f"recall@0.9={res['recall@0.9']:.4f} "
          f"prec@0.9={res.get('precision@0.9', float('nan')):.4f} "
          f"loss={res['loss']:.4f}", flush=True)
    return res


if __name__ == "__main__":
    main()
