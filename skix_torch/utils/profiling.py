"""Per-stage wall-clock timing (the port's copy of ``skix.utils.profiling``).

Device work is asynchronous: a span that times CUDA work must end with
``torch.cuda.synchronize()`` (or a host read of its result) inside it.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from pathlib import Path

log = logging.getLogger(__name__)


class StageTimer:
    """Accumulates named wall-clock spans; JSON-serializable report."""

    def __init__(self):
        self.spans: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        """Time the block; ``sync`` ends it with ``torch.cuda.synchronize()``
        so that the span holds the device work it enqueued."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                import torch

                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.spans[name] = self.spans.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict:
        return {
            name: {"total_s": round(total, 4),
                   "count": self.counts[name],
                   "mean_ms": round(total / self.counts[name] * 1e3, 3)}
            for name, total in sorted(self.spans.items(),
                                      key=lambda kv: -kv[1])
        }

    def save(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(self.report(), indent=2))

    def log_report(self) -> None:
        for name, row in self.report().items():
            log.info("timing %-30s total %8.3fs  n=%-5d mean %8.3f ms",
                     name, row["total_s"], row["count"], row["mean_ms"])
