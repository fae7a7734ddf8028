"""YTVIS-format video dataset — the video-grounding training data layer.

Reference: sam3/train/data/sam3_video_dataset.py ``VideoGroundingDataset``
— training samples ``num_frames`` frames at a random stride in
``[stride_min, stride_max]`` with the stride clamped to what the video
length allows and a random window start (:162-188), optional random
time-axis reversal (:107-124), single images tiled into synthetic videos
(:235 ``_tile_single_image_data``), and videos with too many masklets
skipped (:140). The YTVIS annotation format (one annotation per masklet
with per-frame ``bboxes``/``segmentations``) is the same one the eval
side already speaks (`skix_torch.metrics.tracking_eval.video_instance_ap`,
`skix_torch.io.coco_export`).

A copy of ``skix/data/video.py``: a clip is a FIXED-SLOT pytree —
masklets live at persistent slot indices across the whole clip (slot g ↔
one annotation id), per-frame presence is a bool ``valid (T, G)`` mask —
so the association losses that consume det↔trk identity labels
(`skix_torch.tracking.matcher.det2trk_assoc_loss`,
``tracking_by_detection_assoc_loss``) can be driven directly with static
shapes. Host-side (numpy/cv2), like the COCO layer in
:mod:`skix_torch.data.coco`; the same numpy ``Generator`` gives the
same clips as skix's.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

__all__ = ["VideoDataset", "sample_clip_frames", "tile_image_clip",
           "collate_clips"]


def _decode_seg(seg, h: int, w: int):
    from skix_torch.data.coco import _poly_to_mask

    if seg is None:
        return np.zeros((h, w), bool)
    if isinstance(seg, dict):                 # uncompressed RLE
        from skix_torch.io.coco_export import rle_to_mask

        return rle_to_mask(seg)
    return _poly_to_mask(seg, h, w)


class VideoDataset:
    """Parsed YTVIS-style JSON: ``videos`` (id, file_names, height,
    width), ``annotations`` (one per masklet: video_id, category_id,
    per-frame ``bboxes`` xywh-or-None and ``segmentations``),
    ``categories``.

    ``clip(i, frame_ids)`` → fixed-slot clip dict with ``images
    (T, H, W, 3)`` u8, ``boxes (T, G, 4)`` xyxy px, ``masks (T, G, H, W)``
    bool, ``valid (T, G)``, persistent ``track_ids (G,)`` and ``cls (G,)``.
    """

    def __init__(self, json_path: str | Path,
                 image_root: Optional[str | Path] = None,
                 load_masks: bool = True,
                 max_masklets: Optional[int] = None):
        with open(json_path) as f:
            d = json.load(f)
        self.image_root = (Path(image_root) if image_root
                           else Path(json_path).parent)
        self.load_masks = load_masks
        cats = sorted(c["id"] for c in d.get("categories", [])) or [1]
        self.cat_to_idx = {c: i for i, c in enumerate(cats)}
        self.videos = {v["id"]: v for v in d["videos"]}
        self.anns_by_video: dict = {vid: [] for vid in self.videos}
        for a in d.get("annotations", []):
            if a.get("iscrowd", 0):
                continue
            if a["video_id"] in self.anns_by_video:
                self.anns_by_video[a["video_id"]].append(a)
        ids = sorted(self.videos)
        if max_masklets is not None:
            # reference max_masklet_num_in_video: skip over-capacity
            # videos (sam3_video_dataset.py:140-151)
            ids = [i for i in ids
                   if len(self.anns_by_video[i]) <= max_masklets]
        self.ids = ids

    def __len__(self) -> int:
        return len(self.ids)

    def num_frames(self, i: int) -> int:
        return len(self.videos[self.ids[i]]["file_names"])

    def _load_frame(self, video, t: int):
        import cv2

        path = self.image_root / video["file_names"][t]
        bgr = cv2.imread(str(path))
        if bgr is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)

    def clip(self, i: int, frame_ids: Sequence[int]) -> dict:
        video = self.videos[self.ids[i]]
        anns = sorted(self.anns_by_video[self.ids[i]], key=lambda a: a["id"])
        h, w = video["height"], video["width"]
        T, G = len(frame_ids), len(anns)
        images = np.zeros((T, h, w, 3), np.uint8)
        boxes = np.zeros((T, G, 4), np.float32)
        masks = np.zeros((T, G, h, w), bool)
        valid = np.zeros((T, G), bool)
        for ti, t in enumerate(frame_ids):
            images[ti] = self._load_frame(video, int(t))
            for g, a in enumerate(anns):
                bb = a["bboxes"][t] if t < len(a["bboxes"]) else None
                if bb is None:
                    continue
                x, y, bw, bh = bb
                boxes[ti, g] = [x, y, x + bw, y + bh]
                valid[ti, g] = True
                if self.load_masks:
                    segs = a.get("segmentations")
                    if segs is not None and t < len(segs):
                        masks[ti, g] = _decode_seg(segs[t], h, w)
        return {
            "images": images, "boxes": boxes, "masks": masks,
            "valid": valid,
            "track_ids": np.asarray([a["id"] for a in anns], np.int32),
            "cls": np.asarray(
                [self.cat_to_idx.get(a.get("category_id", 1), 0)
                 for a in anns], np.int32),
            "video_id": self.ids[i],
        }

    def sample_clip(self, i: int, rng: np.random.Generator,
                    num_frames: int = 4, stride_min: int = 1,
                    stride_max: int = 5,
                    random_reverse: bool = True) -> dict:
        """Training clip: reference frame sampling + optional reversal."""
        frame_ids = sample_clip_frames(
            self.num_frames(i), rng, num_frames, stride_min, stride_max,
            random_reverse)
        return self.clip(i, frame_ids)


def sample_clip_frames(num_total: int, rng: np.random.Generator,
                       num_frames: int = 4, stride_min: int = 1,
                       stride_max: int = 5,
                       random_reverse: bool = True) -> np.ndarray:
    """The reference's stage sampler (sam3_video_dataset.py:162-188):
    stride uniform in [min, max], clamped to
    ``floor((T_total − 1)/(n − 1))`` when the video is too short, window
    start uniform over the feasible range; 50% time reversal."""
    if num_total < num_frames:
        raise ValueError(
            f"not enough frames to sample ({num_total} < {num_frames})")
    stride = int(rng.integers(stride_min, stride_max + 1))
    if num_frames > 1:
        gap = (num_frames - 1) * stride
        if gap > num_total - 1:
            stride = (num_total - 1) // (num_frames - 1)
            gap = (num_frames - 1) * stride
        b = int(rng.integers(0, num_total - gap))
        ids = np.arange(b, b + gap + 1, max(stride, 1))[:num_frames]
    else:
        ids = np.asarray([int(rng.integers(0, num_total))])
    if random_reverse and rng.random() < 0.5:
        ids = ids[::-1].copy()
    return ids.astype(np.int64)


def tile_image_clip(rec: dict, num_frames: int) -> dict:
    """Synthetic video from one COCO image record (reference
    ``_tile_single_image_data``): every frame identical, every object a
    persistent masklet. ``rec`` is a :class:`skix_torch.data.coco.CocoDataset`
    record (``image``, ``boxes``, ``masks``, ``cls``)."""
    G = rec["boxes"].shape[0]
    h, w = rec["image"].shape[:2]
    masks = rec.get("masks")
    if masks is None or masks.shape[0] != G:
        masks = np.zeros((G, h, w), bool)
    return {
        "images": np.repeat(rec["image"][None], num_frames, axis=0),
        "boxes": np.repeat(rec["boxes"][None], num_frames, axis=0),
        "masks": np.repeat(masks[None], num_frames, axis=0),
        "valid": np.ones((num_frames, G), bool),
        "track_ids": np.arange(1, G + 1, dtype=np.int32),
        "cls": rec["cls"].astype(np.int32),
        "video_id": rec.get("image_id", 0),
    }


def collate_clips(clips: Sequence[dict], max_objects: int = 16,
                  with_masks: bool = True) -> dict:
    """Pad a batch of same-shape clips to ``max_objects`` masklet slots →
    batched pytree: ``images (B, T, H, W, 3)``, ``boxes (B, T, G, 4)``,
    ``masks (B, T, G, H, W)`` (optional), ``valid (B, T, G)``,
    ``track_ids (B, G)`` (−1 = empty slot), ``cls (B, G)``.

    Slot g of every frame in a clip is the SAME masklet — the identity
    labels the association losses consume are the slot indices."""
    B = len(clips)
    T, H, W = clips[0]["images"].shape[:3]
    G = max_objects
    images = np.zeros((B, T, H, W, 3), np.uint8)
    boxes = np.zeros((B, T, G, 4), np.float32)
    masks = np.zeros((B, T, G, H, W), bool) if with_masks else None
    valid = np.zeros((B, T, G), bool)
    track_ids = np.full((B, G), -1, np.int32)
    cls = np.zeros((B, G), np.int32)
    for b, c in enumerate(clips):
        if c["images"].shape != clips[0]["images"].shape:
            raise ValueError("clips in a batch must share (T, H, W)")
        g = min(c["boxes"].shape[1], G)
        images[b] = c["images"]
        boxes[b, :, :g] = c["boxes"][:, :g]
        valid[b, :, :g] = c["valid"][:, :g]
        track_ids[b, :g] = c["track_ids"][:g]
        cls[b, :g] = c["cls"][:g]
        if with_masks and masks is not None:
            masks[b, :, :g] = c["masks"][:, :g]
    out = {"images": images, "boxes": boxes, "valid": valid,
           "track_ids": track_ids, "cls": cls}
    if with_masks:
        out["masks"] = masks
    return out
