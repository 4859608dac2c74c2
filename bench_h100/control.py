"""The readings that the limits of `correct` are set from (not run by the
benchmark's own runs).

    python3 bench_h100/control.py --workload <name> --seeds 1,2,3 --what <what>
        [--seconds 30] [--out readings.jsonl]

<what>:
  program       the harness's own run per seed: the numbers that sound runs
                of the port give (the lower readings);
  control       the same run, and in it the plain reference in the port's
                place computed in the precision below the configuration's
                stated one (`control` in its file: e4m3 below bf16, TF32
                below f32 with TF32 off), against the reference: on the
                set-up steps from the seed and on the late window step from
                the program's snapshot (training), on the split (eval);
  fault:<f>     the harness's run with a fault planted in the timed path
                (`harness.run_cell`'s `fault`: half_batch, half_split,
                altered; frozen reads 1 by construction).
One JSON line per seed: the workload, seed, what, and each number (the
control's under "control").
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from bench_h100 import harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            fault = args.what.split(":", 1)[1] if args.what.startswith("fault:") else None
            res = harness.run_cell(args.workload, seed, args.seconds, False, fault=fault,
                                   control=args.what == "control")
            checks = {k: v["value"] for k, v in res["checks"].items()}
            checks["correct"] = res["correct"]
            if "control" in res:
                checks["control"] = res["control"]
            line = json.dumps({"workload": args.workload, "seed": seed, "what": args.what,
                               "seconds": time.perf_counter() - t0, **checks})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
