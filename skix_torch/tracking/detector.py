"""Text prompt embedding of the detector's smoke mode.

Port of ``embed_text_prompt`` from ``skix/tracking/detector.py`` (numpy, so
copied as it is). The compact ``DetrDetector`` comes with its own slice.
"""

from __future__ import annotations

import hashlib

import numpy as np


def embed_text_prompt(text: str, dim: int = 64) -> np.ndarray:
    """Deterministic hash-based concept embedding ``(dim,)`` float32, unit
    norm: the slot a CLIP text tower fills once its weights are in the
    repository. Distinct strings get near-orthogonal vectors."""
    h = hashlib.sha256(text.lower().strip().encode()).digest()
    rng = np.random.default_rng(int.from_bytes(h[:8], "little"))
    v = rng.normal(size=(dim,)).astype(np.float32)
    return v / (np.linalg.norm(v) + 1e-9)
