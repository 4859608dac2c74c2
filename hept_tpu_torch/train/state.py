"""Checkpoints with `torch.save` (port of `hept_tpu/train/state.py:
CheckpointManager`).

A checkpoint is one dict: the model's and the optimizer's state dicts, the
LR scheduler's, the epoch and step, the dropout generator's state and the
data shuffle generator's state (what a resumed run needs to go on where it
stopped). Each save writes `<dir>/step_<step>.pt` synchronously (to a
temporary name, then renamed) and keeps the `max_to_keep` highest steps.
The trainer saves on a new best only, so the latest checkpoint is the best.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import torch


class CheckpointManager:
    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step}.pt"

    def steps(self) -> list[int]:
        return sorted(int(p.stem.split("_", 1)[1]) for p in self.directory.glob("step_*.pt"))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict, metrics: dict | None = None) -> Path:
        fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=self.directory)
        os.close(fd)
        torch.save({**state, "metrics": dict(metrics or {})}, tmp)
        path = self._path(step)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            self._path(old).unlink()
        return path

    def restore(self, step: int | None = None) -> dict:
        """The checkpoint of `step` (default: the latest), tensors on the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)
