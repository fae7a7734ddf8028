"""Data contracts: the pipeline's central per-video record.

The PyTorch port's copy of ``skix.io.contracts``: the same ``pt_info``
field names and shapes, the same flat ``.npz`` serialization (``/``
separated keys such as ``YOLO/keypoints``) and the same reader for the
reference's ``.pt`` pickles, so records written by either package load in
the other.

Shape validation mirrors the semantics of the reference's
``check_pt_info_shapes`` (preprocess.py:184) and ``validate_pt.py:224``.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from pathlib import Path
from typing import Any, Optional

import numpy as np

__all__ = ["PTInfo", "check_pt_info_shapes", "save_pt_info", "load_pt_info"]

_META_KEYS = ("video_name", "video_path", "frame_count", "img_shape", "fps", "duration")


@dataclasses.dataclass
class PTInfo:
    """Typed per-video record (a host-side pytree of numpy arrays)."""

    video_name: str = ""
    video_path: str = ""
    frame_count: int = 0
    img_shape: tuple[int, int] = (0, 0)  # (H, W)
    fps: float = 0.0
    duration: float = 0.0

    frames: Optional[np.ndarray] = None          # (T,H,W,C) uint8
    depth: Optional[np.ndarray] = None           # (T,1,H,W) f32
    optical_flow: Optional[np.ndarray] = None    # (T-1,2,H,W) f32
    none_index: Optional[np.ndarray] = None      # (K,) int — frames with no detection

    # YOLO results
    yolo_bbox: Optional[np.ndarray] = None             # (T,4) f32 xyxy
    yolo_mask: Optional[np.ndarray] = None             # (T,1,H,W) bool/u8
    yolo_keypoints: Optional[np.ndarray] = None        # (T,17,3) f32 (x,y,conf)
    yolo_keypoints_score: Optional[np.ndarray] = None  # (T,17) f32

    # detectron2-equivalent results
    d2_bbox: Optional[np.ndarray] = None               # (T,4) f32
    d2_keypoints: Optional[np.ndarray] = None          # (T,17,2|3) f32
    d2_keypoints_score: Optional[np.ndarray] = None    # (T,17) f32

    def to_flat(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "video_name": np.asarray(self.video_name),
            "video_path": np.asarray(self.video_path),
            "frame_count": np.asarray(self.frame_count, np.int64),
            "img_shape": np.asarray(self.img_shape, np.int64),
            "fps": np.asarray(self.fps, np.float64),
            "duration": np.asarray(self.duration, np.float64),
        }
        arrmap = {
            "frames": self.frames,
            "depth": self.depth,
            "optical_flow": self.optical_flow,
            "none_index": self.none_index,
            "YOLO/bbox": self.yolo_bbox,
            "YOLO/mask": self.yolo_mask,
            "YOLO/keypoints": self.yolo_keypoints,
            "YOLO/keypoints_score": self.yolo_keypoints_score,
            "detectron2/bbox": self.d2_bbox,
            "detectron2/keypoints": self.d2_keypoints,
            "detectron2/keypoints_score": self.d2_keypoints_score,
        }
        for k, v in arrmap.items():
            if v is not None:
                d[k] = np.asarray(v)
        return d

    @classmethod
    def from_flat(cls, d: dict[str, Any]) -> "PTInfo":
        def get(k):
            v = d.get(k)
            return None if v is None else np.asarray(v)

        img_shape = d.get("img_shape")
        return cls(
            video_name=str(np.asarray(d.get("video_name", ""))),
            video_path=str(np.asarray(d.get("video_path", ""))),
            frame_count=int(np.asarray(d.get("frame_count", 0))),
            img_shape=tuple(int(x) for x in np.asarray(img_shape)) if img_shape is not None else (0, 0),
            fps=float(np.asarray(d.get("fps", 0.0))),
            duration=float(np.asarray(d.get("duration", 0.0))),
            frames=get("frames"),
            depth=get("depth"),
            optical_flow=get("optical_flow"),
            none_index=get("none_index"),
            yolo_bbox=get("YOLO/bbox"),
            yolo_mask=get("YOLO/mask"),
            yolo_keypoints=get("YOLO/keypoints"),
            yolo_keypoints_score=get("YOLO/keypoints_score"),
            d2_bbox=get("detectron2/bbox"),
            d2_keypoints=get("detectron2/keypoints"),
            d2_keypoints_score=get("detectron2/keypoints_score"),
        )


def check_pt_info_shapes(info: PTInfo, strict: bool = True) -> list[str]:
    """Validate the cross-field shape invariants of the contract.

    Mirrors the reference's ``check_pt_info_shapes``
    (prepare_dataset/process/preprocess.py:184): every temporal field must
    agree with ``frame_count`` T, spatial fields with ``img_shape``, keypoint
    fields with (17,2|3). Returns a list of problems; raises if ``strict``.
    """
    errs: list[str] = []
    T = info.frame_count
    H, W = info.img_shape

    def chk(name: str, arr: Optional[np.ndarray], shape: tuple):
        if arr is None:
            return
        if arr.ndim != len(shape):
            errs.append(f"{name}: ndim {arr.ndim} != {len(shape)} (shape={arr.shape})")
            return
        for i, (got, want) in enumerate(zip(arr.shape, shape)):
            if want is not None and got != want:
                errs.append(f"{name}: dim {i} = {got}, expected {want} (shape={arr.shape})")

    chk("frames", info.frames, (T, H, W, 3))
    chk("depth", info.depth, (T, 1, H, W))
    chk("optical_flow", info.optical_flow, (max(T - 1, 0), 2, H, W))
    chk("YOLO/bbox", info.yolo_bbox, (T, 4))
    chk("YOLO/mask", info.yolo_mask, (T, 1, H, W))
    chk("YOLO/keypoints", info.yolo_keypoints, (T, 17, 3))
    chk("YOLO/keypoints_score", info.yolo_keypoints_score, (T, 17))
    chk("detectron2/bbox", info.d2_bbox, (T, 4))
    if info.d2_keypoints is not None:
        if info.d2_keypoints.shape[:2] != (T, 17) or info.d2_keypoints.shape[2] not in (2, 3):
            errs.append(f"detectron2/keypoints: shape {info.d2_keypoints.shape}, expected (T,17,2|3)")
    chk("detectron2/keypoints_score", info.d2_keypoints_score, (T, 17))
    if info.none_index is not None and info.none_index.size:
        if info.none_index.min() < 0 or info.none_index.max() >= max(T, 1):
            errs.append(f"none_index out of range [0,{T}): {info.none_index}")

    if errs and strict:
        raise ValueError("pt_info shape check failed:\n  " + "\n  ".join(errs))
    return errs


def save_pt_info(path: str | Path, info: PTInfo, validate: bool = True) -> None:
    """Atomic save (tmp + rename, like the reference's ``_safe_save_pt``,
    prepare_dataset/main.py:37) to compressed-less .npz."""
    if validate:
        check_pt_info_shapes(info)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **info.to_flat())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _from_torch_pt(path: Path) -> PTInfo:
    """Read a reference-format ``.pt`` pickle (on the CPU).

    Tries ``weights_only=True`` first (the pt_info schema is tensors +
    plain containers, preprocess.py:157-173, so it loads under the safe
    unpickler); falls back to full pickle with a loud warning — full
    deserialization executes arbitrary code, only do it on trusted files.
    """
    import torch

    try:
        raw = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        import warnings

        warnings.warn(
            f"{path}: not loadable with weights_only=True; falling back to "
            "full pickle deserialization, which can execute arbitrary code. "
            "Only load .pt records from trusted sources.", stacklevel=3)
        raw = torch.load(path, map_location="cpu", weights_only=False)

    def np_of(x):
        if x is None:
            return None
        if hasattr(x, "detach"):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    yolo = raw.get("YOLO", {}) or {}
    d2 = raw.get("detectron2", {}) or {}
    img_shape = raw.get("img_shape", (0, 0))
    return PTInfo(
        video_name=str(raw.get("video_name", "")),
        video_path=str(raw.get("video_path", "")),
        frame_count=int(raw.get("frame_count", 0)),
        img_shape=tuple(int(v) for v in img_shape),
        fps=float(raw.get("fps", 0.0)),
        duration=float(raw.get("duration", 0.0)),
        frames=np_of(raw.get("frames")),
        depth=np_of(raw.get("depth")),
        optical_flow=np_of(raw.get("optical_flow")),
        none_index=np.asarray(raw.get("none_index", []), np.int64),
        yolo_bbox=np_of(yolo.get("bbox")),
        yolo_mask=np_of(yolo.get("mask")),
        yolo_keypoints=np_of(yolo.get("keypoints")),
        yolo_keypoints_score=np_of(yolo.get("keypoints_score")),
        d2_bbox=np_of(d2.get("bbox")),
        d2_keypoints=np_of(d2.get("keypoints")),
        d2_keypoints_score=np_of(d2.get("keypoints_score")),
    )


def load_pt_info(path: str | Path) -> PTInfo:
    """Load a per-video record from .npz (native) or reference .pt."""
    path = Path(path)
    if path.suffix == ".pt":
        return _from_torch_pt(path)
    with np.load(path, allow_pickle=False) as z:
        return PTInfo.from_flat(dict(z))
