"""Scalar metrics logging (jsonl + optional TensorBoard).

A copy of ``skix/utils/metric_logger.py`` (host code).

Capability parity with the reference's logging tier (SURVEY.md §5.5:
stdlib logging + TensorBoard in the SAM3 trainer, results-as-files
CSV/txt reports). The primary sink is an append-only ``metrics.jsonl``
(machine-readable, dependency-free); a TensorBoard writer attaches when
the package is importable.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional


class MetricLogger:
    def __init__(self, log_dir: str | Path, tensorboard: bool = False):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._file = open(self.log_dir / "metrics.jsonl", "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(str(self.log_dir))
            except Exception:  # pragma: no cover - no tensorboard
                self._tb = None

    def log(self, step: int, **scalars: float) -> None:
        row = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in scalars.items()}}
        self._file.write(json.dumps(row) + "\n")
        self._file.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_metrics(log_dir: str | Path):
    """Load metrics.jsonl rows as a list of dicts."""
    p = Path(log_dir) / "metrics.jsonl"
    if not p.exists():
        return []
    return [json.loads(ln) for ln in p.read_text().splitlines() if ln]
