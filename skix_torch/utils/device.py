"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(name: str | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. There is no silent CPU path: asking for CUDA on a machine
    without it raises."""
    dev = torch.device(name or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
