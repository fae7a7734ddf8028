"""Non-maximum suppression in plain torch ops.

Port of ``box_iou`` and ``nms`` from ``skix/ops/nms.py``: a dense IoU
matrix of the score-sorted boxes, then the greedy sweep over them. The
sweep reads the IoU matrix once on the host (N is the detector's query
count, a few hundred at most) and returns the keep mask on the boxes'
device, aligned with the input order.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-9


def box_iou(a, b):
    """Pairwise IoU of ``a (..., N, 4)`` vs ``b (..., M, 4)`` xyxy boxes →
    (..., N, M); leading axes are a batch (skix vmaps the 2-D form)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (torch.clamp(a[..., 2] - a[..., 0], min=0)
              * torch.clamp(a[..., 3] - a[..., 1], min=0))
    area_b = (torch.clamp(b[..., 2] - b[..., 0], min=0)
              * torch.clamp(b[..., 3] - b[..., 1], min=0))
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / (union + _EPS)


def nms(boxes, scores, iou_threshold: float = 0.5,
        score_threshold: float = -math.inf):
    """Greedy NMS: ``boxes (N, 4)`` xyxy, ``scores (N,)`` → ``keep (N,)``
    bool aligned with the input order. Boxes are visited in descending
    score order (a stable sort, as ``jnp.argsort``); a kept box suppresses
    every later box whose IoU with it exceeds ``iou_threshold``."""
    order = torch.argsort(-scores, stable=True)
    iou = box_iou(boxes[order], boxes[order]).cpu()
    valid = (scores[order] > score_threshold).cpu()
    N = boxes.shape[0]
    alive = torch.ones(N, dtype=torch.bool)
    keep_sorted = torch.zeros(N, dtype=torch.bool)
    for i in range(N):
        if alive[i] and valid[i]:
            keep_sorted[i] = True
            suppress = iou[i] > iou_threshold
            suppress[i] = False
            alive &= ~suppress
    keep = torch.zeros(N, dtype=torch.bool)
    keep[order.cpu()] = keep_sorted
    return keep.to(boxes.device)
