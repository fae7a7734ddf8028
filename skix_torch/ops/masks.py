"""Mask utilities: boxes of masks, pairwise mask IoU, and the filling of
small holes and removal of small sprinkles in mask logits.

Port of ``skix/ops/masks.py``. skix ``vmap``s the hole filling over masks;
here it takes a batch of masks along leading axes.
"""

from __future__ import annotations

import torch

from skix_torch.ops.connected_components import connected_components

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


def _component_areas(mask):
    """Per-pixel area of the 4-connected component each pixel of the bool
    masks ``(..., H, W)`` belongs to (0 outside the masks), int32."""
    labels = connected_components(mask)
    H, W = labels.shape[-2:]
    flat = labels.reshape(-1, H * W).to(torch.int64)
    safe = flat.clamp(min=0)
    fg = (flat >= 0).to(torch.int32)
    hist = torch.zeros_like(fg).scatter_add_(1, safe, fg)
    return torch.where(flat >= 0, hist.gather(1, safe),
                       torch.zeros_like(fg)).reshape(labels.shape)


def fill_holes_in_mask_scores(mask, max_area: int, fill_holes: bool = True,
                              remove_sprinkles: bool = True):
    """Fill small background holes (→ +0.1) and remove small foreground
    sprinkles (→ −0.1) in float mask-logit maps ``(..., H, W)``, each map
    on its own. Sprinkles are removed below ``min(max_area, foreground area
    // 2)`` of their map, so a tiny object is never wiped (skix's rule)."""
    if max_area <= 0:
        return mask
    if fill_holes:
        bg = mask <= 0
        small_bg = bg & (_component_areas(bg) <= max_area)
        mask = torch.where(small_bg, torch.full_like(mask, 0.1), mask)
    if remove_sprinkles:
        fg = mask > 0
        thresh = torch.clamp(fg.sum(dim=(-2, -1), dtype=torch.int32) // 2,
                             max=max_area)
        small_fg = fg & (_component_areas(fg) <= thresh[..., None, None])
        mask = torch.where(small_fg, torch.full_like(mask, -0.1), mask)
    return mask
