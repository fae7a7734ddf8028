"""Set-of-marks rendering + mask-overlap filtering for the SAM3 agent.

Capability parity with the reference agent helpers
(``sam3/agent/helpers/{som_utils,visualizer,zoom_in,
mask_overlap_removal}.py``): numbered mask overlays the MLLM can point
at, a two-panel zoom-in render per mask (``zoom_in.py:15 render_zoom_in``
box-growth semantics: expand the mask bbox by max(20%, 16 px), grow
further while the mask fills >25% of the crop), and greedy
intersection-over-min-area duplicate suppression
(``mask_overlap_removal.py:74 remove_overlapping_masks``).

A copy of ``skix/agent/som.py``: host-side numpy/cv2, as in skix —
rendering feeds a vision LLM, not the card, and the renders are skix's
bit for bit. Masks travel as in-memory (H, W) bool arrays (the reference
round-trips COCO-RLE strings through JSON files;
`skix_torch.io.coco_export.mask_to_rle` covers serialization when outputs
are saved).
"""

from __future__ import annotations

import colorsys
from typing import List, Optional, Sequence

import numpy as np


def _palette(n: int) -> np.ndarray:
    """``n`` visually-distinct RGB uint8 colors (golden-angle hue walk)."""
    cols = []
    for i in range(max(n, 1)):
        h = (i * 0.61803398875) % 1.0
        r, g, b = colorsys.hsv_to_rgb(h, 0.85, 1.0)
        cols.append((int(r * 255), int(g * 255), int(b * 255)))
    return np.asarray(cols, np.uint8)


def mask_iom(masks1: np.ndarray, masks2: np.ndarray) -> np.ndarray:
    """Pairwise intersection-over-min-area for bool masks.

    ``masks1 (N, H, W)``, ``masks2 (M, H, W)`` → ``(N, M)`` float32.
    Reference semantics: ``mask_overlap_removal.py:30 mask_iom``
    (min-area clamped to ≥1). One f32 matmul instead of the reference's
    16×16 blocked boolean broadcast.
    """
    a = np.asarray(masks1, bool).reshape(len(masks1), -1)
    b = np.asarray(masks2, bool).reshape(len(masks2), -1)
    inter = a.astype(np.float32) @ b.astype(np.float32).T
    area1 = a.sum(-1).astype(np.float32)
    area2 = b.sum(-1).astype(np.float32)
    min_area = np.maximum(np.minimum(area1[:, None], area2[None, :]), 1.0)
    return inter / (min_area + 1e-8)


def remove_overlapping_masks(scores: Sequence[float], masks: np.ndarray,
                             iom_thresh: float = 0.3) -> List[int]:
    """Greedy keep by descending score: a mask survives iff its IoM to
    every already-kept mask is ≤ ``iom_thresh``. Returns kept indices in
    ORIGINAL order (reference ``remove_overlapping_masks`` keeps the
    sample's list order after filtering)."""
    n = len(masks)
    if n <= 1:
        return list(range(n))
    iom = mask_iom(masks, masks)
    order = np.argsort(-np.asarray(scores, np.float64), kind="stable")
    kept: List[int] = []
    for i in order:
        if all(iom[i, j] <= iom_thresh for j in kept):
            kept.append(int(i))
    return sorted(kept)


def render_set_of_marks(image: np.ndarray, masks: Sequence[np.ndarray],
                        alpha: float = 0.45,
                        colors: Optional[np.ndarray] = None,
                        draw_labels: bool = True) -> np.ndarray:
    """Overlay numbered masks (1-based, matching the agent protocol's
    mask indices) on an RGB uint8 image; returns a new uint8 array."""
    import cv2

    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    out = img.astype(np.float32).copy()
    cols = _palette(len(masks)) if colors is None else np.asarray(colors)
    scale = max(img.shape[0], img.shape[1]) / 640.0
    centroids = []
    for i, m in enumerate(masks):
        m = np.asarray(m, bool)
        if m.shape != img.shape[:2]:
            m = cv2.resize(m.astype(np.uint8), (img.shape[1], img.shape[0]),
                           interpolation=cv2.INTER_NEAREST).astype(bool)
        c = cols[i % len(cols)].astype(np.float32)
        out[m] = (1 - alpha) * out[m] + alpha * c
        ys, xs = np.nonzero(m)
        centroids.append((int(xs.mean()), int(ys.mean())) if len(ys)
                         else None)
    out = out.astype(np.uint8)
    if draw_labels:
        for i, ctr in enumerate(centroids):
            if ctr is not None:
                cv2.putText(out, str(i + 1), ctr,
                            cv2.FONT_HERSHEY_SIMPLEX, 0.9 * scale,
                            (255, 255, 255), max(1, int(2 * scale)),
                            cv2.LINE_AA)
    return out


def _zoom_box(x: float, y: float, w: float, h: float, img_h: int,
              img_w: int, mask_area: float) -> tuple:
    """Zoom-in crop box around a mask bbox — reference
    ``zoom_in.py:63 _get_zoom_in_box`` semantics: pad by max(20%, 16 px)
    each side (clamped to the image), then if the mask still covers >25%
    of the crop, grow the crop by sqrt(rel_area / 0.25) so context stays
    visible; shift to stay inside the image."""
    w_new = min(w + max(0.2 * w, 16.0), img_w)
    h_new = min(h + max(0.2 * h, 16.0), img_h)
    rel = mask_area / max(w_new * h_new, 1.0)
    if rel > 0.25:
        ratio = float(np.sqrt(rel / 0.25))
        w_new = min(w_new * ratio, img_w)
        h_new = min(h_new * ratio, img_h)

    def shift(x0, extent, new, limit):
        s = (new - extent) / 2
        if x0 - s + new > limit:
            s = x0 + new - limit
        return min(x0, s)

    return (x - shift(x, w, w_new, img_w), y - shift(y, h, h_new, img_h),
            w_new, h_new)


def render_zoom_in(image: np.ndarray, mask: np.ndarray,
                   alpha: float = 0.45, color: Optional[tuple] = None,
                   out_long_side: int = 512) -> np.ndarray:
    """Cropped, upscaled view of one mask with the overlay — the
    per-mask evidence image of ``examine_each_mask`` (reference
    ``zoom_in.py:15 render_zoom_in``). Returns RGB uint8."""
    import cv2

    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    m = np.asarray(mask, bool)
    if m.shape != img.shape[:2]:
        m = cv2.resize(m.astype(np.uint8), (img.shape[1], img.shape[0]),
                       interpolation=cv2.INTER_NEAREST).astype(bool)
    H, W = img.shape[:2]
    ys, xs = np.nonzero(m)
    if len(ys) == 0:
        x0 = y0 = 0.0
        bw, bh, area = float(W), float(H), 0.0
    else:
        x0, y0 = float(xs.min()), float(ys.min())
        bw, bh = float(xs.max() - xs.min() + 1), float(ys.max() - ys.min() + 1)
        area = float(len(ys))
    zx, zy, zw, zh = _zoom_box(x0, y0, bw, bh, H, W, area)
    xa, ya = max(int(round(zx)), 0), max(int(round(zy)), 0)
    xb = min(int(round(zx + zw)), W)
    yb = min(int(round(zy + zh)), H)
    col = _palette(1)[0] if color is None else np.asarray(color, np.uint8)
    over = img.astype(np.float32).copy()
    over[m] = (1 - alpha) * over[m] + alpha * col.astype(np.float32)
    crop = over[ya:yb, xa:xb].astype(np.uint8)
    long_side = max(crop.shape[0], crop.shape[1], 1)
    s = out_long_side / long_side
    crop = cv2.resize(crop, (max(int(crop.shape[1] * s), 1),
                             max(int(crop.shape[0] * s), 1)),
                      interpolation=cv2.INTER_LINEAR)
    return crop
