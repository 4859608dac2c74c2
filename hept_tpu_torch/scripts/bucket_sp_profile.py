"""Where a bucket-SP train step's device time goes, per transport: the
share_heads model (the parity YAML + qkv_post_sort, shared_sort,
share_heads; f32) on one synthetic event, its `make_bucket_train_step` at
world 1 over NCCL, two warm-up steps, then `--steps` steps under
torch.profiler; prints each transport's wall and busy ms a step and its
top device kernels.

    python -m hept_tpu_torch.scripts.bucket_sp_profile [--points 60000]
        [--steps 2] [--top 12]

Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import datetime
import socket

import numpy as np
import torch
import torch.distributed as dist

from ..data.batching import pack_events
from ..data.synthetic import synthetic_tracking_event
from ..ops import cuda_lib
from ..parallel.bp import TRANSPORTS, make_bucket_model, make_bucket_train_step
from ..parallel.mesh import make_mesh
from ..train import trainer
from ..train.config import profile_config
from ..utils.profiling import profile_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--points", type=int, default=60000)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    cuda_lib.build()
    ev = synthetic_tracking_event(np.random.default_rng(0), n_points=args.points,
                                  avg_track_size=8, pairs_per_point=16)
    batch_np = pack_events([ev], block_size=100, window_pairs=128)
    cfg = profile_config("hept", device="cuda", num_epochs=1)
    cfg.model_kwargs.update(qkv_post_sort=True, shared_sort=True, share_heads=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                           world_size=1, timeout=datetime.timedelta(seconds=120))
    res = {}
    try:
        mesh = make_mesh(1, ("data", "buckets"), (1, 1), device="cuda")
        tcfg = cfg.model_config(batch_np["x"].shape[2], batch_np["coords"].shape[2])
        batch = trainer.batch_to_device(batch_np, "cuda")
        for transport in TRANSPORTS:
            model = make_bucket_model(tcfg, mesh, torch.Generator("cuda").manual_seed(0),
                                      "cuda", transport=transport)
            opt = trainer.make_optimizer(model.parameters(), lr=1e-3)
            step = make_bucket_train_step(model, opt, trainer.make_loss_fn(cfg), mesh, seed=1)
            for _ in range(2):
                step(batch)
            torch.cuda.synchronize()
            wall, kernel_us, _ = profile_device(lambda: step(batch), args.steps)
            busy = sum(kernel_us.values()) / 1e3
            res[transport] = {"wall_ms": wall, "busy_ms": busy}
            print(f"{transport}: wall {wall:.2f} ms a step, device busy {busy:.2f} ms", flush=True)
            for name, us in sorted(kernel_us.items(), key=lambda kv: -kv[1])[:args.top]:
                print(f"  {us / 1e3:8.3f} ms  {name[:140]}")
            del model, opt, step
    finally:
        dist.destroy_process_group()
    print(torch.cuda.get_device_name(0))
    return res


if __name__ == "__main__":
    main()
