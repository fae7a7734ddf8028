"""Video IO: chunked decode, metadata probe, frames → mp4.

Port of ``skix/io/video.py`` (numpy + OpenCV), copied with ``cv2`` imported
inside each function as skix does: a machine without OpenCV imports the
module and fails only where a video is read or written.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

log = logging.getLogger(__name__)


@dataclass
class VideoMeta:
    path: str
    frame_count: int
    height: int
    width: int
    fps: float

    @property
    def duration(self) -> float:
        return self.frame_count / self.fps if self.fps else 0.0


def probe_video(path: str | Path) -> VideoMeta:
    import cv2

    path = Path(path)
    if path.is_dir():
        files = sorted(p for p in path.iterdir()
                       if p.suffix.lower() in (".jpg", ".jpeg", ".png",
                                               ".bmp"))
        if not files:
            raise FileNotFoundError(f"no image frames in {path}")
        img = cv2.imread(str(files[0]), cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f"cannot decode frame {files[0]}")
        return VideoMeta(path=str(path), frame_count=len(files),
                         height=img.shape[0], width=img.shape[1],
                         fps=30.0)   # frame dirs carry no rate; assume 30
    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {path}")
    meta = VideoMeta(
        path=str(path),
        frame_count=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
        height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        fps=float(cap.get(cv2.CAP_PROP_FPS)),
    )
    cap.release()
    return meta


def read_video_chunks(path: str | Path, chunk_size: int = 64,
                      max_frames: Optional[int] = None
                      ) -> Iterator[np.ndarray]:
    """Yield RGB ``(t, H, W, 3) uint8`` chunks (t ≤ chunk_size).

    ``path`` may be a video file or a DIRECTORY of image frames in
    sorted-name order (the reference accepts either for a session,
    sam3/model/io_utils.py image-folder loader)."""
    import cv2

    path = Path(path)
    if path.is_dir():
        files = sorted(p for p in path.iterdir()
                       if p.suffix.lower() in (".jpg", ".jpeg", ".png",
                                               ".bmp"))
        if not files:
            raise FileNotFoundError(f"no image frames in {path}")
        if max_frames is not None:
            files = files[:max_frames]
        buf = []
        for f in files:
            img = cv2.imread(str(f), cv2.IMREAD_COLOR)
            if img is None:
                raise IOError(f"cannot decode frame {f}")
            buf.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
            if len(buf) == chunk_size:
                yield np.stack(buf)
                buf = []
        if buf:
            yield np.stack(buf)
        return

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {path}")
    buf = []
    emitted = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            buf.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            emitted += 1
            if len(buf) == chunk_size:
                yield np.stack(buf)
                buf = []
            if max_frames is not None and emitted >= max_frames:
                break
        if buf:
            yield np.stack(buf)
    finally:
        cap.release()


def read_video(path: str | Path, max_frames: Optional[int] = None) -> np.ndarray:
    """Whole-clip decode (T, H, W, 3) uint8 — for short clips/tests only."""
    chunks = list(read_video_chunks(path, chunk_size=256, max_frames=max_frames))
    if not chunks:
        return np.zeros((0, 0, 0, 3), np.uint8)
    return np.concatenate(chunks, axis=0)


def write_video(path: str | Path, frames: np.ndarray, fps: float = 30.0) -> None:
    """Write RGB ``(T, H, W, 3) uint8`` frames to mp4."""
    import cv2

    frames = np.asarray(frames)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    T, H, W = frames.shape[:3]
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                          (W, H))
    try:
        for i in range(T):
            out.write(cv2.cvtColor(frames[i], cv2.COLOR_RGB2BGR))
    finally:
        out.release()


def merge_frames_to_video(frame_dir: str | Path, out_path: str | Path,
                          fps: float = 30.0, pattern: str = "*.png") -> int:
    """Merge an image directory (sorted by name) into an mp4 sized by its
    first image. Returns the frame count."""
    import cv2

    files = sorted(Path(frame_dir).glob(pattern))
    if not files:
        return 0
    first = cv2.imread(str(files[0]))
    H, W = first.shape[:2]
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out = cv2.VideoWriter(str(out_path), cv2.VideoWriter_fourcc(*"mp4v"),
                          fps, (W, H))
    try:
        for f in files:
            img = cv2.imread(str(f))
            if img is not None:
                out.write(img)
    finally:
        out.release()
    return len(files)
