"""Spawn the port's rank processes for the CPU tests: TASK of
`torch_parallel_workers.py` (torch only, never JAX) on WORLD processes in a
gloo group that meets through a file in the test's directory. Every spawn
has a join timeout that kills the ranks and fails the test; a rank's output
is in `<dir>/log_<rank>.txt`."""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_parallel_workers.py"
JOIN_TIMEOUT_S = 120


def spawn(task: str, world: int, d: Path, inputs: dict) -> list:
    """Run `task` on `world` worker ranks; their outputs by rank."""
    d.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, d / "inputs.pt")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    logs = [open(d / f"log_{r}.txt", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), task, str(r), str(world), str(d)],
                             stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=d)
             for r in range(world)]
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{task}: a rank did not finish within {JOIN_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = "\n".join(f"rank {r}: " + (d / f"log_{r}.txt").read_text()[-2000:] for r in bad)
        pytest.fail(f"{task}: ranks {bad} failed\n{tails}")
    return [torch.load(d / f"out_{r}.pt", weights_only=False) for r in range(world)]
