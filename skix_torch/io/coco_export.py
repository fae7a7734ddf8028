"""COCO-format detection results export (evaluator interop).

A copy of ``skix/io/coco_export.py`` (numpy on the host).

Capability parity with the reference's result writers
(``sam3/eval/coco_writer.py`` / ``ytvis_coco_wrapper.py``): converts
detector outputs into the standard COCO results JSON — ``image_id``,
``category_id``, ``bbox`` (xywh pixels), ``score``, and optional
``segmentation`` as uncompressed column-major RLE (the pycocotools
``{"size": [H, W], "counts": [...]}`` dict form, valid input to any COCO
toolchain). Pure numpy host-side tail; no pycocotools dependency.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

import numpy as np


def mask_to_rle(mask: np.ndarray) -> dict:
    """Binary (H, W) mask → COCO uncompressed RLE (column-major runs,
    first count is the number of leading zeros). Vectorized — a
    per-pixel Python loop takes ~0.5 s per megapixel mask."""
    m = np.asarray(mask).astype(bool)
    H, W = m.shape
    flat = m.T.reshape(-1)  # column-major (Fortran) order
    if flat.size == 0:
        return {"size": [int(H), int(W)], "counts": [0]}
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.r_[0, change, flat.size]
    counts = np.diff(bounds).tolist()
    if flat[0]:
        counts = [0] + counts  # RLE starts with a zero-run by convention
    return {"size": [int(H), int(W)], "counts": counts}


def rle_to_mask(rle: dict) -> np.ndarray:
    """Inverse of :func:`mask_to_rle` (vectorized)."""
    H, W = rle["size"]
    counts = np.asarray(rle["counts"], np.int64)
    ends = np.cumsum(counts)
    starts = np.r_[0, ends[:-1]]
    flat = np.zeros(H * W, bool)
    for s, e in zip(starts[1::2], ends[1::2]):  # runs of ones only
        flat[s:e] = True
    return flat.reshape(W, H).T


def detections_to_coco(
    boxes_xyxy: np.ndarray,        # (N, 4) pixels
    scores: np.ndarray,            # (N,)
    image_id: int,
    category_id: int = 1,
    masks: np.ndarray | None = None,   # (N, H, W) bool
    valid: np.ndarray | None = None,   # (N,) bool
    score_threshold: float = 0.0,
) -> list[dict]:
    """One image's detections → COCO results entries."""
    boxes_xyxy = np.asarray(boxes_xyxy).reshape(-1, 4)
    scores = np.asarray(scores).reshape(-1)
    keep = scores > score_threshold
    if valid is not None:
        keep &= np.asarray(valid).reshape(-1).astype(bool)
    out = []
    for i in np.where(keep)[0]:
        x1, y1, x2, y2 = [float(v) for v in boxes_xyxy[i]]
        entry = {
            "image_id": int(image_id),
            "category_id": int(category_id),
            "bbox": [x1, y1, x2 - x1, y2 - y1],
            "score": float(scores[i]),
        }
        if masks is not None:
            entry["segmentation"] = mask_to_rle(np.asarray(masks[i]))
        out.append(entry)
    return out


def write_coco_results(path: str | Path,
                       results: Sequence[dict]) -> None:
    """Atomic JSON write of a COCO results list."""
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "w") as f:
        json.dump(list(results), f)
    tmp.replace(path)
