"""Detection output post-processing (COCO-style result preparation).

Port of ``skix/tracking/postprocess.py``: per-query ``sigmoid`` scores
(times the presence probability with ``use_presence``), the top
``max_dets`` (a stable top-k, ties to the lowest index), boxes cxcywh →
xyxy scaled to ``target_size``, masks resized with jax's bilinear and
binarized at ``sigmoid > 0.5``, and a ``valid`` mask in place of ragged
filtering.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from skix_torch.utils.image import resize


class ProcessedDetections(NamedTuple):
    boxes_xyxy: torch.Tensor        # (B, K, 4) in target-size pixels
    scores: torch.Tensor            # (B, K) presence-gated probabilities
    masks: Optional[torch.Tensor]   # (B, K, H, W) bool, or None
    valid: torch.Tensor             # (B, K) bool: above the threshold


def postprocess_detections(boxes_cxcywh, logits, presence_logit=None,
                           mask_logits=None, target_size=None,
                           max_dets: int = 100,
                           detection_threshold: Optional[float] = None,
                           use_presence: bool = True) -> ProcessedDetections:
    """``boxes_cxcywh (B, Q, 4)`` normalized, ``logits (B, Q)``,
    ``presence_logit (B,)``, ``mask_logits (B, Q, h, w)``. ``target_size
    (H, W)``: None keeps boxes normalized and masks at their own size.
    ``detection_threshold``: None gates nothing; any float (0.0 too) is
    applied."""
    B, Q = logits.shape
    probs = torch.sigmoid(logits)
    if use_presence and presence_logit is not None:
        probs = probs * torch.sigmoid(presence_logit)[:, None]
    k = min(max_dets, Q) if max_dets > 0 else Q
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    scores, idx = order.values[:, :k], order.indices[:, :k]
    boxes = torch.gather(boxes_cxcywh, 1, idx[..., None].expand(-1, -1, 4))
    cx, cy, w, h = boxes.unbind(-1)
    H, W = target_size if target_size is not None else (1, 1)
    boxes_xyxy = torch.stack([(cx - w / 2) * W, (cy - h / 2) * H,
                              (cx + w / 2) * W, (cy + h / 2) * H], dim=-1)
    masks = None
    if mask_logits is not None:
        m = mask_logits[torch.arange(B, device=idx.device)[:, None], idx]
        if target_size is not None:
            m = resize(m, (B, k, H, W), "bilinear")
        masks = torch.sigmoid(m) > 0.5
    valid = (torch.ones_like(scores, dtype=torch.bool)
             if detection_threshold is None
             else scores > detection_threshold)
    return ProcessedDetections(boxes_xyxy=boxes_xyxy, scores=scores,
                               masks=masks, valid=valid)
