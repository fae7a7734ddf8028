"""COCO-format dataset, augmentation and fixed-shape collation.

A copy of ``skix/data/coco.py`` (numpy, with cv2 imported where it is
used), so that the port reads and batches training data without JAX and
without importing skix: the same seed gives the same batches, byte for
byte. Augmentation runs on the host; collation pads every image to one
static (B, S, S, 3) shape and the objects into ``max_objects`` slots with
a ``valid`` mask.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

# COCO-17 left/right keypoint pairs (category metadata)
KPT_FLIP_PAIRS = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12),
                  (13, 14), (15, 16))


def _poly_to_mask(polys: Sequence[Sequence[float]], h: int, w: int):
    import cv2

    m = np.zeros((h, w), np.uint8)
    pts = [np.asarray(p, np.float32).reshape(-1, 2).round().astype(np.int32)
           for p in polys if len(p) >= 6]
    if pts:
        cv2.fillPoly(m, pts, 1)
    return m.astype(bool)


def rle_to_mask(rle: dict) -> np.ndarray:
    """An uncompressed COCO RLE (``counts`` a list, column-major runs
    starting with zeros) → (H, W) bool; ``skix/io/coco_export.py``."""
    H, W = rle["size"]
    counts = np.asarray(rle["counts"], np.int64)
    ends = np.cumsum(counts)
    starts = np.r_[0, ends[:-1]]
    flat = np.zeros(H * W, bool)
    for s, e in zip(starts[1::2], ends[1::2]):  # runs of ones only
        flat[s:e] = True
    return flat.reshape(W, H).T


class CocoDataset:
    """Parsed COCO instances/person-keypoints JSON.

    ``example(i)`` → dict with ``image`` (H, W, 3) u8, ``boxes`` (N, 4)
    xyxy px, ``cls`` (N,) contiguous class ids, ``keypoints`` (N, 17, 3)
    (x, y, vis — zeros when the file has no keypoints), and ``masks``
    (N, H, W) bool (from polygons or uncompressed RLE; all-False when
    absent). Images load from ``image_root/file_name`` via cv2 (BGR→RGB).
    """

    def __init__(self, json_path: str | Path,
                 image_root: Optional[str | Path] = None,
                 category_ids: Optional[Sequence[int]] = None,
                 load_masks: bool = True):
        with open(json_path) as f:
            d = json.load(f)
        self.image_root = Path(image_root) if image_root else Path(
            json_path).parent
        self.load_masks = load_masks
        cats = sorted(c["id"] for c in d.get("categories", [])) or [1]
        if category_ids is not None:
            cats = [c for c in cats if c in set(category_ids)]
        self.cat_to_idx = {c: i for i, c in enumerate(cats)}
        self.images = {im["id"]: im for im in d["images"]}
        self.anns_by_image: dict = {im_id: [] for im_id in self.images}
        for a in d.get("annotations", []):
            if a.get("iscrowd", 0):
                continue
            if a["category_id"] not in self.cat_to_idx:
                continue
            if a["image_id"] in self.anns_by_image:
                self.anns_by_image[a["image_id"]].append(a)
        self.ids = sorted(self.images)

    def __len__(self) -> int:
        return len(self.ids)

    def example(self, i: int) -> dict:
        import cv2

        im_meta = self.images[self.ids[i]]
        path = self.image_root / im_meta["file_name"]
        bgr = cv2.imread(str(path))
        if bgr is None:
            raise FileNotFoundError(path)
        image = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        h, w = image.shape[:2]
        anns = self.anns_by_image[self.ids[i]]
        n = len(anns)
        boxes = np.zeros((n, 4), np.float32)
        cls = np.zeros((n,), np.int32)
        kpts = np.zeros((n, 17, 3), np.float32)
        masks = np.zeros((n, h, w), bool)
        for j, a in enumerate(anns):
            x, y, bw, bh = a["bbox"]
            boxes[j] = [x, y, x + bw, y + bh]
            cls[j] = self.cat_to_idx[a["category_id"]]
            if a.get("keypoints"):
                kp = np.asarray(a["keypoints"], np.float32).reshape(-1, 3)
                kpts[j, :kp.shape[0]] = kp[:17]
            seg = a.get("segmentation")
            if seg and self.load_masks:
                if isinstance(seg, dict):           # uncompressed RLE
                    if isinstance(seg.get("counts"), list):
                        masks[j] = rle_to_mask(seg)
                else:
                    masks[j] = _poly_to_mask(seg, h, w)
        return {"image": image, "boxes": boxes, "cls": cls,
                "keypoints": kpts, "masks": masks,
                "image_id": self.ids[i]}


# ---------------------------------------------------------------------------
# augmentations (host-side; record in/out)
# ---------------------------------------------------------------------------

def hflip_record(rec: dict) -> dict:
    """Horizontal flip with box mirror + COCO L/R keypoint swap
    (reference transforms/basic.py:72 hflip)."""
    img = rec["image"][:, ::-1]
    w = img.shape[1]
    boxes = rec["boxes"].copy()
    boxes[:, [0, 2]] = w - rec["boxes"][:, [2, 0]]
    kpts = rec["keypoints"].copy()
    kpts[..., 0] = np.where(kpts[..., 2] > 0, w - kpts[..., 0], 0.0)
    for a, b in KPT_FLIP_PAIRS:
        kpts[:, [a, b]] = kpts[:, [b, a]]
    return {**rec, "image": np.ascontiguousarray(img), "boxes": boxes,
            "keypoints": kpts, "masks": rec["masks"][:, :, ::-1]}


def random_resize_crop(rec: dict, rng: np.random.Generator,
                       scale_range=(0.6, 1.4), out_hw=None) -> dict:
    """Random scale jitter + random crop (reference RandomResize +
    RandomSizeCrop). Keypoints leaving the crop become invisible; boxes
    clip to the crop and fully-clipped objects keep a degenerate box
    that collation's validity mask drops."""
    import cv2

    img = rec["image"]
    h, w = img.shape[:2]
    s = float(rng.uniform(*scale_range))
    nh, nw = max(2, int(round(h * s))), max(2, int(round(w * s)))
    img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    boxes = rec["boxes"] * s
    kpts = rec["keypoints"].copy()
    kpts[..., :2] *= s
    masks = rec["masks"]
    if masks.shape[0]:
        masks = np.stack([cv2.resize(m.astype(np.uint8), (nw, nh),
                                     interpolation=cv2.INTER_NEAREST)
                          for m in masks]).astype(bool)
    else:
        masks = np.zeros((0, nh, nw), bool)
    ch, cw = out_hw if out_hw else (h, w)
    ch, cw = min(ch, nh), min(cw, nw)
    y0 = int(rng.integers(0, nh - ch + 1))
    x0 = int(rng.integers(0, nw - cw + 1))
    img = img[y0:y0 + ch, x0:x0 + cw]
    boxes = boxes - [x0, y0, x0, y0]
    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, cw)
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, ch)
    kpts[..., 0] -= x0
    kpts[..., 1] -= y0
    inside = ((kpts[..., 0] >= 0) & (kpts[..., 0] < cw)
              & (kpts[..., 1] >= 0) & (kpts[..., 1] < ch))
    kpts[..., 2] = np.where(inside, kpts[..., 2], 0.0)
    masks = masks[:, y0:y0 + ch, x0:x0 + cw]
    return {**rec, "image": np.ascontiguousarray(img), "boxes": boxes,
            "keypoints": kpts, "masks": masks}


def color_jitter_record(rec: dict, rng: np.random.Generator,
                        brightness: float = 0.4, contrast: float = 0.4,
                        saturation: float = 0.4, hue: float = 0.1) -> dict:
    """Photometric jitter — torchvision ColorJitter semantics as used by
    the reference (transforms/basic_for_api.py:959): the four ops run in
    a random order with factors drawn uniformly from
    [max(0, 1−x), 1+x] (hue from [−h, h]); geometry untouched."""
    img = rec["image"].astype(np.float32)

    def adj_brightness(x, f):
        return x * f

    def adj_contrast(x, f):
        # torchvision: blend with the mean of the grayscale image
        gray = x @ np.array([0.299, 0.587, 0.114], np.float32)
        return x * f + float(gray.mean()) * (1 - f)

    def adj_saturation(x, f):
        gray = (x @ np.array([0.299, 0.587, 0.114], np.float32))[..., None]
        return x * f + gray * (1 - f)

    def adj_hue(x, f):
        import cv2

        hsv = cv2.cvtColor(x.clip(0, 255).astype(np.uint8),
                           cv2.COLOR_RGB2HSV)
        # OpenCV hue is [0, 180); torchvision hue factor is in turns
        hsv[..., 0] = (hsv[..., 0].astype(np.int32)
                       + int(round(f * 180))) % 180
        return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.float32)

    ops = [(adj_brightness, float(rng.uniform(max(0, 1 - brightness),
                                              1 + brightness))),
           (adj_contrast, float(rng.uniform(max(0, 1 - contrast),
                                            1 + contrast))),
           (adj_saturation, float(rng.uniform(max(0, 1 - saturation),
                                              1 + saturation))),
           (adj_hue, float(rng.uniform(-hue, hue)))]
    for i in rng.permutation(4):
        fn, f = ops[int(i)]
        if fn is adj_hue and f == 0.0:
            continue  # identity, but the HSV roundtrip would quantize
        if fn is not adj_hue and f == 1.0:
            continue
        img = fn(img, f)
    return {**rec, "image": img.clip(0, 255).astype(np.uint8)}


def grayscale_record(rec: dict) -> dict:
    """RandomGrayscale body (basic_for_api.py:941): luminance
    replicated to 3 channels."""
    gray = rec["image"].astype(np.float32) @ np.array(
        [0.299, 0.587, 0.114], np.float32)
    img = np.repeat(gray[..., None], 3, -1).clip(0, 255).astype(np.uint8)
    return {**rec, "image": img}


def motion_blur_record(rec: dict, rng: np.random.Generator,
                       kernel_size: int = 5) -> dict:
    """MotionBlur (basic_for_api.py:1289): a 1/k line kernel in a random
    direction ∈ {horizontal, vertical, diagonal}, zero-padded conv."""
    import cv2

    k = np.zeros((kernel_size, kernel_size), np.float32)
    d = int(rng.integers(0, 3))
    if d == 0:
        k[kernel_size // 2, :] = 1.0
    elif d == 1:
        k[:, kernel_size // 2] = 1.0
    else:
        np.fill_diagonal(k, 1.0)
    k /= k.sum()
    img = cv2.filter2D(rec["image"], -1, k,
                       borderType=cv2.BORDER_CONSTANT)
    return {**rec, "image": img}


def mosaic_record(rec: dict, rng: np.random.Generator,
                  grid: int = 2) -> dict:
    """Self-mosaic distractor aug (reference RandomMosaicVideoAPI,
    basic_for_api.py:715 + random_mosaic_frame): the image is downsized
    and tiled into a grid×grid mosaic of itself; annotations follow ONE
    randomly chosen target cell (the other copies become unlabeled
    distractors — hard negatives for tracking/detection)."""
    import cv2

    img = rec["image"]
    h, w = img.shape[:2]
    out = np.zeros_like(img)
    ty = int(rng.integers(0, grid))
    tx = int(rng.integers(0, grid))
    sy = sx = ey = ex = 0
    for gy in range(grid):
        for gx in range(grid):
            y0, y1 = gy * h // grid, (gy + 1) * h // grid
            x0, x1 = gx * w // grid, (gx + 1) * w // grid
            out[y0:y1, x0:x1] = cv2.resize(img, (x1 - x0, y1 - y0),
                                           interpolation=cv2.INTER_LINEAR)
            if (gy, gx) == (ty, tx):
                sy, sx, ey, ex = y0, x0, y1, x1
    fy, fx = (ey - sy) / h, (ex - sx) / w
    boxes = rec["boxes"] * [fx, fy, fx, fy] + [sx, sy, sx, sy]
    kpts = rec["keypoints"].copy()
    kpts[..., 0] = kpts[..., 0] * fx + sx
    kpts[..., 1] = kpts[..., 1] * fy + sy
    masks = rec["masks"]
    if masks.shape[0]:
        mout = np.zeros((masks.shape[0], h, w), bool)
        for j, m in enumerate(masks):
            mout[j, sy:ey, sx:ex] = cv2.resize(
                m.astype(np.uint8), (ex - sx, ey - sy),
                interpolation=cv2.INTER_NEAREST).astype(bool)
        masks = mout
    return {**rec, "image": out, "boxes": boxes.astype(np.float32),
            "keypoints": kpts, "masks": masks}


def resize_pad_to(rec: dict, size: int) -> dict:
    """Aspect-preserving resize so the long side equals ``size``, then
    bottom/right zero-pad to (size, size) — ONE static shape for jit."""
    import cv2

    img = rec["image"]
    h, w = img.shape[:2]
    s = size / max(h, w)
    nh, nw = max(1, int(round(h * s))), max(1, int(round(w * s)))
    img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    out = np.zeros((size, size, 3), img.dtype)
    out[:nh, :nw] = img
    boxes = rec["boxes"] * s
    kpts = rec["keypoints"].copy()
    kpts[..., :2] *= s
    masks = rec["masks"]
    if masks.shape[0]:
        mr = np.stack([cv2.resize(m.astype(np.uint8), (nw, nh),
                                  interpolation=cv2.INTER_NEAREST)
                       for m in masks])
        mout = np.zeros((masks.shape[0], size, size), bool)
        mout[:, :nh, :nw] = mr.astype(bool)
    else:
        mout = np.zeros((0, size, size), bool)
    return {**rec, "image": out, "boxes": boxes, "keypoints": kpts,
            "masks": mout, "scale": s}


def collate_fixed(records: Sequence[dict], max_objects: int = 16,
                  mask_stride: int = 4) -> dict:
    """Stack records into fixed slots: images (B, S, S, 3) u8, boxes
    (B, M, 4), cls (B, M), keypoints (B, M, 17, 3), masks
    (B, M, S/mask_stride, S/mask_stride) bool, valid (B, M) bool.
    Objects beyond M drop (largest-area first keeps the athletes)."""
    B = len(records)
    S = records[0]["image"].shape[0]
    sm = S // mask_stride
    out = {
        "images": np.zeros((B, S, S, 3), np.uint8),
        "boxes": np.zeros((B, max_objects, 4), np.float32),
        "cls": np.zeros((B, max_objects), np.int32),
        "keypoints": np.zeros((B, max_objects, 17, 3), np.float32),
        "masks": np.zeros((B, max_objects, sm, sm), bool),
        "valid": np.zeros((B, max_objects), bool),
    }
    for b, rec in enumerate(records):
        out["images"][b] = rec["image"]
        boxes = rec["boxes"]
        area = (boxes[:, 2] - boxes[:, 0]).clip(0) * \
               (boxes[:, 3] - boxes[:, 1]).clip(0)
        keep = np.argsort(-area)[:max_objects]
        keep = keep[area[keep] > 1.0]       # degenerate (cropped-out) drop
        n = len(keep)
        out["boxes"][b, :n] = boxes[keep]
        out["cls"][b, :n] = rec["cls"][keep]
        out["keypoints"][b, :n] = rec["keypoints"][keep]
        if rec["masks"].shape[0]:
            out["masks"][b, :n] = rec["masks"][keep, ::mask_stride,
                                               ::mask_stride]
        out["valid"][b, :n] = True
    return out


class CocoLoader:
    """Seeded, shuffled epoch iterator yielding fixed-shape batches.

    flip/scale/crop augs on by default (reference train transforms);
    ``augment=False`` gives deterministic eval batches.
    """

    def __init__(self, dataset: CocoDataset, batch_size: int = 8,
                 image_size: int = 512, max_objects: int = 16,
                 mask_stride: int = 4, augment: bool = True, seed: int = 0,
                 scale_range=(0.6, 1.4), photometric: bool = False,
                 p_grayscale: float = 0.05, p_motion_blur: float = 0.1,
                 p_mosaic: float = 0.0):
        """``photometric=True`` adds the reference's pixel-level augs
        (ColorJitter always, grayscale/motion-blur at their probs);
        ``p_mosaic > 0`` enables the self-mosaic distractor aug
        (reference RandomMosaicVideoAPI default prob 0.15)."""
        self.ds = dataset
        self.batch_size = batch_size
        self.image_size = image_size
        self.max_objects = max_objects
        self.mask_stride = mask_stride
        self.augment = augment
        self.scale_range = scale_range
        self.photometric = photometric
        self.p_grayscale = p_grayscale
        self.p_motion_blur = p_motion_blur
        self.p_mosaic = p_mosaic
        self.rng = np.random.default_rng(seed)

    def _prep(self, i: int) -> dict:
        rec = self.ds.example(i)
        if self.augment:
            if self.rng.random() < 0.5:
                rec = hflip_record(rec)
            if self.p_mosaic and self.rng.random() < self.p_mosaic:
                rec = mosaic_record(rec, self.rng)
            rec = random_resize_crop(rec, self.rng,
                                     scale_range=self.scale_range)
            if self.photometric:
                rec = color_jitter_record(rec, self.rng)
                if self.rng.random() < self.p_grayscale:
                    rec = grayscale_record(rec)
                if self.rng.random() < self.p_motion_blur:
                    rec = motion_blur_record(rec, self.rng)
        return resize_pad_to(rec, self.image_size)

    def epoch(self):
        order = np.arange(len(self.ds))
        if self.augment:
            self.rng.shuffle(order)
        if len(order) < self.batch_size:
            # Tiny datasets (fixtures) still yield one full wrap-around
            # batch per epoch — an empty range here would make __iter__
            # spin forever without ever yielding.
            reps = -(-self.batch_size // len(order))
            order = np.tile(order, reps)[:self.batch_size]
        for s in range(0, len(order) - self.batch_size + 1,
                       self.batch_size):
            idx = order[s:s + self.batch_size]
            yield collate_fixed([self._prep(int(i)) for i in idx],
                                self.max_objects, self.mask_stride)

    def __iter__(self):
        while True:     # infinite stream of epochs (trainer counts steps)
            yield from self.epoch()
