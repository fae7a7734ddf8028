"""Masklet (multi-object mask tracking) overlay visualization.

Copy of ``skix/vis/masklet.py`` (numpy and OpenCV on the host; the port
keeps its own copy, as it imports nothing of skix): a stable palette per
object id, alpha-blended masks, boxes and id/probability labels over each
frame, written as an mp4 (:func:`save_masklet_video`) or an image, and the
adapter from a ``propagate_in_video`` frame dict to the reference render
schema (``out_boxes_xywh``/``out_probs``/``out_obj_ids``/
``out_binary_masks``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def pascal_color_map() -> np.ndarray:
    """The 256-entry PASCAL VOC label palette (visualization_utils.py:611),
    uint8 (256, 3)."""
    def bitget(val, idx):
        return (val >> idx) & 1

    cmap = np.zeros((256, 3), np.uint8)
    for i in range(256):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= bitget(c, 0) << (7 - j)
            g |= bitget(c, 1) << (7 - j)
            b |= bitget(c, 2) << (7 - j)
            c >>= 3
        cmap[i] = [r, g, b]
    return cmap


def generate_colors(n_colors: int = 256, seed: int = 0) -> np.ndarray:
    """Visually-spread float colors in [0, 1] (generate_colors:22 intent:
    a stable per-object palette; deterministic here — golden-ratio hue
    walk instead of random sampling)."""
    import colorsys

    hues = (np.arange(n_colors) * 0.61803398875 + seed * 0.1) % 1.0
    return np.array([colorsys.hsv_to_rgb(h, 0.85, 0.95) for h in hues],
                    np.float32)


_COLORS = generate_colors(256)


def masklet_outputs_from_session(out: dict, image_hw) -> dict:
    """Adapt a skix ``propagate_in_video`` per-frame ``outputs`` dict to the
    reference render schema, keeping only active slots."""
    H, W = image_hw
    active = np.asarray(out["active"], bool)
    boxes = np.asarray(out["bbox"], np.float32)[active]
    # xyxy pixels → xywh normalized (the reference protocol's box format)
    xywh = np.stack([boxes[:, 0] / W, boxes[:, 1] / H,
                     (boxes[:, 2] - boxes[:, 0]) / W,
                     (boxes[:, 3] - boxes[:, 1]) / H], axis=1)
    return {
        "out_boxes_xywh": xywh,
        "out_probs": np.asarray(out["score"], np.float32)[active],
        "out_obj_ids": np.asarray(out["obj_id"])[active],
        "out_binary_masks": np.asarray(out["mask"])[active],
    }


def render_masklet_frame(img: np.ndarray, outputs: dict,
                         frame_idx=None, alpha: float = 0.5) -> np.ndarray:
    """Overlay per-object masks + boxes + id/prob labels on one frame
    (visualization_utils.py:388 semantics: stable color by obj_id mod
    palette, alpha mask blend, nearest-resize of low-res masks, xywh
    normalized boxes, frame-index banner)."""
    import cv2

    img = np.asarray(img)
    if img.dtype != np.uint8:
        # Only float inputs get the [0,1]→[0,255] rescale; a legitimately
        # near-black uint8 frame must pass through unchanged.
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    img = img[..., :3] if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
    height, width = img.shape[:2]
    overlay = img.copy()

    probs = outputs.get("out_probs")
    n = len(probs) if probs is not None else len(outputs["out_obj_ids"])
    for i in range(n):
        obj_id = int(outputs["out_obj_ids"][i])
        color255 = (_COLORS[obj_id % len(_COLORS)] * 255).astype(np.uint8)
        mask = np.asarray(outputs["out_binary_masks"][i])
        if mask.shape != (height, width):
            mask = cv2.resize(mask.astype(np.float32), (width, height),
                              interpolation=cv2.INTER_NEAREST)
        mb = mask > 0.5
        for c in range(3):
            overlay[..., c][mb] = (alpha * int(color255[c])
                                   + (1 - alpha) * overlay[..., c][mb]
                                   ).astype(np.uint8)

    for i in range(n):
        obj_id = int(outputs["out_obj_ids"][i])
        color255 = tuple(int(x * 255) for x in _COLORS[obj_id % len(_COLORS)])
        x, y, w, h = np.asarray(outputs["out_boxes_xywh"][i], np.float64)
        x1, y1 = int(x * width), int(y * height)
        x2, y2 = int((x + w) * width), int((y + h) * height)
        cv2.rectangle(overlay, (x1, y1), (x2, y2), color255, 2)
        prob = None if probs is None else probs[i]
        label = (f"id={obj_id}, p={prob:.2f}" if prob is not None
                 else f"id={obj_id}")
        cv2.putText(overlay, label, (x1, max(y1 - 10, 0)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color255, 1, cv2.LINE_AA)

    if frame_idx is not None:
        cv2.putText(overlay, f"Frame {frame_idx}", (10, 30),
                    cv2.FONT_HERSHEY_SIMPLEX, 1.0, (255, 255, 255), 2,
                    cv2.LINE_AA)
    return overlay


def save_masklet_video(video_frames, outputs: dict, out_path,
                       alpha: float = 0.5, fps: float = 10.0) -> Path:
    """Render every annotated frame and write an mp4
    (visualization_utils.py:466 — without the ffmpeg re-encode hop).

    ``video_frames``: (T, H, W, 3) array or list of frames;
    ``outputs``: {frame_idx: render-schema dict}."""
    from skix_torch.io.video import write_video

    frames = []
    for frame_idx in sorted(outputs):
        frames.append(render_masklet_frame(
            np.asarray(video_frames[frame_idx]), outputs[frame_idx],
            frame_idx=frame_idx, alpha=alpha))
    out_path = Path(out_path)
    write_video(out_path, np.stack(frames), fps=fps)
    return out_path


def save_masklet_image(frame, outputs: dict, out_path,
                       alpha: float = 0.5, frame_idx=None) -> Path:
    import cv2

    overlay = render_masklet_frame(np.asarray(frame), outputs,
                                   frame_idx=frame_idx, alpha=alpha)
    out_path = Path(out_path)
    cv2.imwrite(str(out_path), cv2.cvtColor(overlay, cv2.COLOR_RGB2BGR))
    return out_path


def prepare_masks_for_visualization(frame_to_output: dict) -> dict:
    """{frame: render schema} → {frame: {obj_id: mask}} keeping only
    non-empty masks (visualization_utils.py:510)."""
    out = {}
    for frame_idx, fo in frame_to_output.items():
        per_obj = {}
        for idx, obj_id in enumerate(np.asarray(fo["out_obj_ids"]).tolist()):
            mask = np.asarray(fo["out_binary_masks"][idx])
            if mask.any():
                per_obj[int(obj_id)] = mask
        out[frame_idx] = per_obj
    return out


def save_side_by_side(img, gt_outputs: dict, pred_outputs: dict, out_path,
                      title: str = "", alpha: float = 0.5) -> Path:
    """GT vs prediction masklet panels side by side
    (save_side_by_side_visualization:582)."""
    import cv2

    left = render_masklet_frame(np.asarray(img), gt_outputs, alpha=alpha)
    right = render_masklet_frame(np.asarray(img), pred_outputs, alpha=alpha)
    panel = np.concatenate([left, right], axis=1)
    if title:
        cv2.putText(panel, title, (10, panel.shape[0] - 10),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 255, 0), 1,
                    cv2.LINE_AA)
    out_path = Path(out_path)
    cv2.imwrite(str(out_path), cv2.cvtColor(panel, cv2.COLOR_RGB2BGR))
    return out_path
