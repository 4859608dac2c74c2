"""The port's benchmark: one run of one cell.

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the cell's CUDA devices.
Prints diagnostics on standard error, ending in each compared number beside
its limit, and as the last line of standard output one JSON object:
correct, attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), device, with --trace 1 breakdown, and
checks (the compared numbers and their limits). Exits non-zero, printing no
result, without enough CUDA devices, or if JAX, flax or the JAX package was
loaded. The port's nvcc libraries are built and kept in
hept_tpu_torch/_build/ inside the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # caches of the program inside the checkout, at fixed paths
    build = CHECKOUT / "hept_tpu_torch" / "_build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from bench_h100 import harness

    need = next(w["chips"] for w in harness.benchmark_spec()["workloads"]
                if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print("device: " + harness.nvidia_smi(), file=sys.stderr, flush=True)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["checks"] = checks  # the compared numbers come last
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
