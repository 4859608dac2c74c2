"""Where a full-width training step spends its time on the GPU.

    python -m hept_tpu_torch.utils.profiling [--task tracking|pileup]
        [--profile hept_acc] [--points 60000] [--steps 3] [--out torch_step_profile]
        [--model-kwargs '{"qkv_post_sort": true}']

Builds the step chip_smoke.py drives (one synthetic event of the task:
tracking with 16 pairs per point, or pileup; the profile's model at full
width, dropout on; `--model-kwargs` over the profile's model kwargs),
warms up two steps,
times `--steps` steps without the profiler, then records `--steps` steps
with torch.profiler. Prints the step's wall time (both ways), the device's
busy and idle shares (kernel time over the profiled wall time), the
device time of the port's own kernels, of PyTorch's sort kernels (kernels
named "sort", among the rest) and of everything else, and writes
the top operators by device time to `<out>.txt` and the summary to
`<out>.json`.
"""

from __future__ import annotations

import argparse
import json
import re
import time
from pathlib import Path

import numpy as np
import torch

from ..data.batching import pack_events, slab_friendly_n
from ..data.synthetic import synthetic_pileup_event, synthetic_tracking_event
from ..train.config import profile_config
from ..train.trainer import batch_to_device, build_model, make_loss_fn, train_step
from ..train.optim import make_optimizer
from .device import resolve_device

# kernels of csrc/*.cu (all in an anonymous namespace) as the profiler names them
PORT_KERNELS = {"tc_fwd_kernel": "K1", "tc_bwd_kernel": "K2", "fwd_kernel": "K1",
                "bwd_kernel": "K2", "gather_kernel": "K3", "gather1_kernel": "K3",
                "segment_sum_kernel": "K4", "row_gather_kernel": "K5",
                "row_gather_staged_kernel": "K5", "cols_fwd_kernel": "K6",
                "tc_cols_fwd_kernel": "K6", "cols_fwd_tiled_kernel": "K6",
                "cols_bwd_kernel": "K7", "tc_cols_bwd_kernel": "K7",
                "cols_bwd_tiled_kernel": "K7"}
_PORT_KERNEL_RE = re.compile(r"anonymous namespace\)::(" + "|".join(PORT_KERNELS)
                             + r")\b(?:<([^>]*)>)?")
# the column kernels that K10 instantiates on the row layout: there their
# last template argument (ROWS) is true
_ROW_LAYOUT_KERNELS = ("cols_fwd_kernel", "cols_bwd_kernel", "cols_fwd_tiled_kernel",
                       "cols_bwd_tiled_kernel")


def port_kernel(name: str) -> str | None:
    """The TPU kernel (K1-K10) that a device kernel of csrc/ stands for, by
    the profiler's name; None for any other kernel."""
    m = _PORT_KERNEL_RE.search(name)
    if m is None:
        return None
    if m.group(1) in _ROW_LAYOUT_KERNELS and (m.group(2) or "").split(",")[-1].strip() == "true":
        return "K10"
    return PORT_KERNELS[m.group(1)]


def profile_device(fn, calls: int) -> tuple[float, dict, object]:
    """`calls` calls of `fn` under torch.profiler: the wall ms a call (ending
    in a synchronise), the device time of each kernel by name, in us a call,
    and the profiler. Only device kernels count: user annotations (e.g. the optimizer's
    step range) span kernels that are counted on their own."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    kernel_us: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
            kernel_us[evt.name] = kernel_us.get(evt.name, 0.0) + evt.time_range.elapsed_us() / calls
    return wall_ms, kernel_us, prof


def topk_ms(kernel_us: dict) -> float:
    """Device ms of `torch.topk`'s selection kernels (PyTorch names them
    sbtopk / mbtopk: gatherTopK, radixFindKthValues, the blockwise k
    counts); the sort of a sorted top-k is among the "sort" kernels."""
    keys = ("topk", "radixfindkth", "kcounts")
    return sum(us for name, us in kernel_us.items()
               if any(k in name.lower() for k in keys)) / 1e3


def port_kernels_ms(kernel_us: dict) -> dict:
    """Device ms of the port's own kernels (K1-K10), by TPU kernel."""
    ours: dict[str, float] = {}
    for name, us in kernel_us.items():
        kid = port_kernel(name)
        if kid:
            ours[kid] = ours.get(kid, 0.0) + us / 1e3
    return ours


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="tracking", choices=("tracking", "pileup"))
    ap.add_argument("--profile", default="hept_acc",
                    help="tracking: hept, hept_acc, hept_fast, hept_turbo, hept_max; "
                         "pileup: hept, hept_fast; both tasks: the seven baselines "
                         "(performer, flt, reformer, smyrf, sb, pct, flatformer)")
    ap.add_argument("--points", type=int, default=60000)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="torch_step_profile")
    ap.add_argument("--model-kwargs", default="{}",
                    help='JSON over the profile\'s model_kwargs, e.g. \'{"qkv_post_sort": true}\'')
    args = ap.parse_args(argv)
    device = resolve_device("cuda")

    cfg = profile_config(args.profile, task=args.task, device="cuda")
    cfg.model_kwargs.update(json.loads(args.model_kwargs))
    bs = cfg.model_kwargs.get("block_size", 100)
    rng = np.random.default_rng(args.seed)
    if args.task == "pileup":
        ev = synthetic_pileup_event(rng, n_points=args.points)
    else:
        ev = synthetic_tracking_event(rng, n_points=args.points, pairs_per_point=16)
    batch = batch_to_device(pack_events([ev], bs, n_max=slab_friendly_n(args.points, bs),
                                        window_pairs=128 if args.task == "tracking" else 0),
                            device)
    model = build_model(cfg, ev.x.shape[1], ev.coords.shape[1],
                        torch.Generator(device=device).manual_seed(args.seed), device)
    opt = make_optimizer(model.parameters(), lr=cfg.optimizer_kwargs["lr"])
    loss_fn = make_loss_fn(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    for _ in range(2):
        train_step(model, opt, loss_fn, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        train_step(model, opt, loss_fn, batch, gen)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    wall_ms, kernel_us, prof = profile_device(
        lambda: train_step(model, opt, loss_fn, batch, gen), args.steps)
    busy_ms = sum(kernel_us.values()) / 1e3
    ours = port_kernels_ms(kernel_us)
    # torch.sort / argsort's radix-sort passes
    sort_ms = sum(us for name, us in kernel_us.items()
                  if port_kernel(name) is None and "sort" in name.lower()) / 1e3
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:25]
    summary = {
        "task": args.task,
        "profile": args.profile,
        "model_kwargs": cfg.model_kwargs,
        "device": torch.cuda.get_device_name(0),
        "peak_memory_gib": peak_gib,
        "step_wall_ms_unprofiled": plain_wall_ms,
        "step_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "port_kernels_ms": ours,
        "other_kernels_ms": busy_ms - sum(ours.values()),
        "sort_kernels_ms": sort_ms,
        "top_kernels_ms": [(name[:120], us / 1e3) for name, us in top],
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.with_suffix(".json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    out.with_suffix(".txt").write_text(
        prof.key_averages().table(sort_by="device_time_total", row_limit=40))
    return summary


if __name__ == "__main__":
    main()
