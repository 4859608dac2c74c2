"""Run logging: time-stamped stdout and JSONL scalars, plus TensorBoard when
`torch.utils.tensorboard` is importable (own copy of
`hept_tpu/utils/logging.py`)."""

from __future__ import annotations

import json
import time
from pathlib import Path


def log(*args):
    print(f"[{time.strftime('%H:%M:%S')}]", *args, flush=True)


class ScalarLogger:
    """Appends one JSON record per `write` to `<run_dir>/scalars.jsonl`."""

    def __init__(self, run_dir: str | Path):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.run_dir / "scalars.jsonl", "a")
        self._tb = None
        try:  # optional TensorBoard writer
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(str(self.run_dir / "tb"))
        except ImportError:
            pass

    def write(self, step: int, scalars: dict, prefix: str = ""):
        rec = {"step": step, **{f"{prefix}{k}": _f(v) for k, v in scalars.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                if isinstance(_f(v), float):
                    self._tb.add_scalar(f"{prefix}{k}", _f(v), step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def _f(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v
