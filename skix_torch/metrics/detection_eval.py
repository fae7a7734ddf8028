"""COCO-style detection AP@IoU: a copy of ``average_precision`` from
``skix/metrics/detection_eval.py`` (numpy only), so the port's training
stage evaluates without importing skix."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(
        a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(
        b[:, 3] - b[:, 1], 0, None)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-9)


def average_precision(pred_boxes: Sequence[np.ndarray],
                      pred_scores: Sequence[np.ndarray],
                      gt_boxes: Sequence[np.ndarray],
                      iou_threshold: float = 0.5) -> float:
    """AP for one class over a list of images (xyxy boxes).

    Greedy score-ordered matching per image; 101-point interpolated AP
    (COCO convention)."""
    records = []  # (score, is_tp)
    n_gt = 0
    for pb, ps, gb in zip(pred_boxes, pred_scores, gt_boxes):
        pb = np.asarray(pb).reshape(-1, 4)
        ps = np.asarray(ps).reshape(-1)
        gb = np.asarray(gb).reshape(-1, 4)
        n_gt += len(gb)
        order = np.argsort(-ps)
        taken = np.zeros(len(gb), bool)
        iou = _iou_matrix(pb, gb) if len(pb) and len(gb) else None
        for i in order:
            tp = False
            if iou is not None and len(gb):
                cand = np.where(~taken & (iou[i] >= iou_threshold))[0]
                if len(cand):
                    j = cand[np.argmax(iou[i][cand])]
                    taken[j] = True
                    tp = True
            records.append((ps[i], tp))
    if n_gt == 0:
        return float("nan")
    if not records:
        return 0.0
    records.sort(key=lambda r: -r[0])
    tps = np.cumsum([r[1] for r in records])
    fps = np.cumsum([not r[1] for r in records])
    recall = tps / n_gt
    precision = tps / np.maximum(tps + fps, 1)
    # 101-point interpolation
    ap = 0.0
    for r in np.linspace(0, 1, 101):
        p = precision[recall >= r]
        ap += (p.max() if len(p) else 0.0) / 101
    return float(ap)
