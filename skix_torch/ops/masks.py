"""Mask utilities: boxes of masks and pairwise mask IoU.

Port of ``masks_to_boxes`` and ``mask_iou`` from ``skix/ops/masks.py``.
``fill_holes_in_mask_scores`` (off on the front path, ``fill_holes=False``)
comes with ``connected_components`` in a later slice.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def masks_to_boxes(masks):
    """``(N, H, W)`` bool masks → ``(N, 4)`` float32 xyxy boxes
    (x2/y2 = last index + 1; an empty mask gives zeros)."""
    masks = masks.to(torch.bool)
    N, H, W = masks.shape
    rows = masks.any(dim=2)
    cols = masks.any(dim=1)
    yidx = torch.arange(H, device=masks.device)
    xidx = torch.arange(W, device=masks.device)
    y1 = torch.where(rows, yidx, H).amin(dim=1)
    y2 = torch.where(rows, yidx + 1, 0).amax(dim=1)
    x1 = torch.where(cols, xidx, W).amin(dim=1)
    x2 = torch.where(cols, xidx + 1, 0).amax(dim=1)
    box = torch.stack([x1, y1, x2, y2], dim=-1).to(torch.float32)
    return torch.where(rows.any(dim=1)[:, None], box, torch.zeros_like(box))


def mask_iou(a, b):
    """Pairwise IoU of ``a (N, H, W)`` vs ``b (M, H, W)`` bool masks →
    ``(N, M)`` float32."""
    a = a.to(torch.bool).reshape(a.shape[0], -1)
    b = b.to(torch.bool).reshape(b.shape[0], -1)
    inter = a.to(torch.float32) @ b.to(torch.float32).T
    area_a = a.sum(dim=1)[:, None]
    area_b = b.sum(dim=1)[None, :]
    return inter / (area_a + area_b - inter + _EPS)
