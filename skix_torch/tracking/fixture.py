"""The trained tracker fixtures of the repository, read into the port.

``tests/fixtures/tracker_tiny.npz`` (112 px) and ``tracker_tiny224.npz``
(224 px) each hold a trained ``Sam3Detector.tiny`` and a trained
``MaskMemoryTracker`` (48 features over 2 heads: head dim 24, 3 memory
slots), written by ``scripts/make_tracker_fixture.py``: one npz whose keys
are the flax paths under ``det/`` and ``trk/``, float32 leaves stored as
float16. The detector's image size follows from its position table (one
entry a 14 px patch). The text prompt is the hash embedding of a word,
tiled to ``PROMPT_LEN`` tokens, as the script prompts it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from skix_torch.convert import flax_to_state_dict, load_flat_npz, load_into

TRACKER = dict(features=48, num_heads=2, mem_slots=3)
PROMPT_LEN = 4


def fixture_variables(path: str | Path) -> tuple[dict, dict]:
    """``(det, trk)``: the flat ``"params/a/b/kernel"`` float32 arrays of
    the fixture's two models."""
    det, trk = {}, {}
    for key, arr in load_flat_npz(path).items():
        part, rest = key.split("/", 1)
        {"det": det, "trk": trk}[part][rest] = (
            arr.astype(np.float32) if arr.dtype == np.float16 else arr)
    return det, trk


def load_tracker_fixture(path: str | Path, device="cuda"):
    """``(detector, tracker)``: the fixture's ``Sam3Detector.tiny`` and
    ``MaskMemoryTracker`` with its weights, in eval mode on ``device``."""
    from skix_torch.tracking.memory_tracker import MaskMemoryTracker
    from skix_torch.tracking.sam3_detector import Sam3Detector

    det_vars, trk_vars = fixture_variables(path)
    grid = det_vars["params/backbone/pos_embed"].shape[1]
    detector = Sam3Detector.tiny(img_size=14 * grid)
    tracker = MaskMemoryTracker(**TRACKER)
    load_into(detector, flax_to_state_dict(det_vars))
    load_into(tracker, flax_to_state_dict(trk_vars))
    return detector.to(device).eval(), tracker.to(device).eval()


def fixture_prompt(text: str = "person", d_model: int = 64, device="cuda"):
    """The fixture's prompt tokens ``(PROMPT_LEN, d_model)``: the hash
    embedding of ``text`` tiled."""
    from skix_torch.tracking.detector import embed_text_prompt

    return torch.as_tensor(np.tile(embed_text_prompt(text, d_model)[None],
                                   (PROMPT_LEN, 1)), device=device)
