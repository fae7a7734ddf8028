"""The compact single-stage person + pose detector (CenterNet-style).

Port of ``skix/models/pose_detector.py`` (``pose_model: compact``): a conv
trunk at 1/8 resolution (3×3 conv, GroupNorm(8), SiLU blocks) with per-cell
heads {objectness, box (l, t, r, b), 17 × (dx, dy, conf) keypoints, mask
logits}, decoded per image by a stable top-K (ties to the lowest index, as
``jax.lax.top_k``) and greedy NMS into the padded ``(B, K, …)`` arrays
that :mod:`skix_torch.perception.selection` consumes. Channels-last, with
skix's flax names (``stem1.conv``, ``res_0.norm``, ``obj_head`` …).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models.layers import Conv, GroupNorm
from skix_torch.ops.nms import nms
from skix_torch.perception.sfm_tracks import top_k
from skix_torch.utils.device import full_float32_convs


class ConvBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv = Conv(cin, features, 3, stride, bias=False)
        self.norm = GroupNorm(8, features)

    def forward(self, x):
        return F.silu(self.norm(self.conv(x)))


class PoseDetections(NamedTuple):
    boxes_cxcywh: torch.Tensor  # (B, K, 4) pixels
    scores: torch.Tensor        # (B, K) objectness
    keypoints: torch.Tensor     # (B, K, 17, 3) x, y, conf (pixels)
    valid: torch.Tensor         # (B, K) bool
    mask_logits: torch.Tensor   # (B, H/8, W/8) person-mask logits


class PoseDetector(nn.Module):
    """Image (B, H, W, 3) in [0, 1] → top-K padded person detections."""

    def __init__(self, width: int = 64, depth: int = 4,
                 num_keypoints: int = 17, top_k: int = 8,
                 score_threshold: float = 0.3, nms_iou: float = 0.6):
        super().__init__()
        self.depth, self.num_keypoints = depth, num_keypoints
        self.top_k, self.score_threshold = top_k, score_threshold
        self.nms_iou = nms_iou
        self.stem1 = ConvBlock(3, width, 2)
        self.stem2 = ConvBlock(width, width, 2)
        self.stem3 = ConvBlock(width, 2 * width, 2)
        for i in range(depth):
            setattr(self, f"res_{i}", ConvBlock(2 * width, 2 * width))
        c = 2 * width
        self.obj_head = Conv(c, 1, 3)
        self.box_head = Conv(c, 4, 3)
        self.kpt_head = Conv(c, num_keypoints * 3, 3)
        self.mask_head = Conv(c, 1, 3)

    def forward(self, images) -> PoseDetections:
        with full_float32_convs():
            return self._forward(images)

    def _forward(self, images):
        B, H, W, _ = images.shape
        nk = self.num_keypoints
        x = (images - 0.5) / 0.5
        h = self.stem3(self.stem2(self.stem1(x)))
        for i in range(self.depth):
            h = h + getattr(self, f"res_{i}")(h)
        gh, gw = h.shape[1], h.shape[2]
        stride = H / gh
        obj = self.obj_head(h)[..., 0]
        ltrb = F.softplus(self.box_head(h)) * stride
        kpt = self.kpt_head(h).reshape(B, gh, gw, nk, 3)
        mask_logits = self.mask_head(h)[..., 0]

        dev = images.device
        ys = (torch.arange(gh, dtype=torch.float32, device=dev) + 0.5) * stride
        xs = (torch.arange(gw, dtype=torch.float32, device=dev) + 0.5) * stride
        cy, cx = torch.meshgrid(ys, xs, indexing="ij")
        flat_scores = torch.sigmoid(obj).reshape(B, gh * gw)
        x1 = (cx - ltrb[..., 0]).reshape(B, -1)
        y1 = (cy - ltrb[..., 1]).reshape(B, -1)
        x2 = (cx + ltrb[..., 2]).reshape(B, -1)
        y2 = (cy + ltrb[..., 3]).reshape(B, -1)
        kx = (cx[..., None] + kpt[..., 0] * stride).reshape(B, -1, nk)
        ky = (cy[..., None] + kpt[..., 1] * stride).reshape(B, -1, nk)
        kc = torch.sigmoid(kpt[..., 2]).reshape(B, -1, nk)

        outs = []
        for b in range(B):
            top_s, idx = top_k(flat_scores[b], self.top_k)
            bxy = torch.stack([x1[b, idx], y1[b, idx], x2[b, idx],
                               y2[b, idx]], -1)
            keep = nms(bxy, top_s, self.nms_iou)
            ok = keep & (top_s > self.score_threshold)
            cxy = torch.stack([(bxy[:, 0] + bxy[:, 2]) / 2,
                               (bxy[:, 1] + bxy[:, 3]) / 2,
                               bxy[:, 2] - bxy[:, 0],
                               bxy[:, 3] - bxy[:, 1]], -1)
            kp = torch.stack([kx[b, idx], ky[b, idx], kc[b, idx]], -1)
            outs.append((cxy, top_s, kp, ok))
        boxes, scores, kps, valid = (torch.stack(z) for z in zip(*outs))
        return PoseDetections(boxes_cxcywh=boxes, scores=scores,
                              keypoints=kps, valid=valid,
                              mask_logits=mask_logits)


@torch.no_grad()
def detect_clip(model: PoseDetector, frames_u8, batch_size: int = 8,
                device=None):
    """Whole-clip detection (``frames_u8`` a numpy array or a uint8 tensor)
    → padded numpy arrays for selection: (boxes
    (T,K,4) cxcywh, keypoints (T,K,17,3), det_valid (T,K), scores (T,K)).
    The last batch is zero-padded to ``batch_size``, as skix pads it."""
    dev = torch.device(device) if device else next(model.parameters()).device
    T = frames_u8.shape[0]
    boxes, kpts, valid, scores = [], [], [], []
    for s in range(0, T, batch_size):
        e = min(s + batch_size, T)
        chunk = torch.as_tensor(frames_u8[s:e], device=dev
                                ).to(torch.float32) / 255.0
        pad = batch_size - (e - s)
        if pad:
            chunk = F.pad(chunk, (0, 0, 0, 0, 0, 0, 0, pad))
        det = model(chunk)
        n = e - s
        boxes.append(det.boxes_cxcywh[:n].cpu().numpy())
        kpts.append(det.keypoints[:n].cpu().numpy())
        valid.append(det.valid[:n].cpu().numpy())
        scores.append(det.scores[:n].cpu().numpy())
    return (np.concatenate(boxes), np.concatenate(kpts),
            np.concatenate(valid), np.concatenate(scores))
