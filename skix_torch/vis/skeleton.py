"""2D/3D skeleton drawing: host code (OpenCV and matplotlib on numpy
arrays), a copy of ``skix/vis/skeleton.py``; nothing of it runs on the card.

Capability parity with the reference's shared visualizer stack
(bundle_adjustment/visualization/skeleton_visualizer.py and its copies in
fuse/side, front_side, vis_3d_kpt — SURVEY.md §2.5 notes the 5-way
duplication; defined once here) plus the YOLO skeleton drawing
(prepare_dataset/model/yolov11_pose.py draw_and_save_keypoints).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from skix_torch.geometry.skeletons import (COCO_SKELETON, H36M_BONES,
                                           MHR70_BODY_EDGES)

_EDGE_SETS = {
    "coco": COCO_SKELETON,
    "h36m": H36M_BONES,
    "mhr70": MHR70_BODY_EDGES,
}


def _colors(n: int):
    import matplotlib

    cmap = matplotlib.colormaps["tab20"]
    return (cmap(np.linspace(0, 1, n))[:, :3] * 255).astype(int)


class SkeletonVisualizer:
    """Draws one skeleton layout onto frames (2D) or matplotlib axes (3D)."""

    def __init__(self, layout: str = "mhr70",
                 edges: Optional[Sequence[Tuple[int, int]]] = None):
        self.layout = layout
        self.edges = tuple(edges) if edges is not None else _EDGE_SETS[layout]

    # ---------------- 2D (cv2 on frames) ----------------
    def draw_2d(self, frame: np.ndarray, kpts: np.ndarray,
                scores: Optional[np.ndarray] = None,
                min_score: float = 0.3, radius: int = 3,
                thickness: int = 2) -> np.ndarray:
        """Draw keypoints + edges on an RGB frame copy. ``kpts (J, 2)``."""
        import cv2

        out = np.ascontiguousarray(frame.copy())
        kpts = np.asarray(kpts)
        J = kpts.shape[0]
        ok = np.all(np.isfinite(kpts), axis=-1)
        if scores is not None:
            ok &= np.asarray(scores) >= min_score
        cols = _colors(len(self.edges) + 1)
        for e, (a, b) in enumerate(self.edges):
            if a < J and b < J and ok[a] and ok[b]:
                pa = tuple(np.round(kpts[a]).astype(int))
                pb = tuple(np.round(kpts[b]).astype(int))
                cv2.line(out, pa, pb, tuple(int(c) for c in cols[e]),
                         thickness)
        for j in range(J):
            if ok[j]:
                cv2.circle(out, tuple(np.round(kpts[j]).astype(int)), radius,
                           (255, 255, 255), -1)
        return out

    def render_2d_sequence(self, frames: np.ndarray, kpts_seq: np.ndarray,
                           out_path: str | Path, fps: float = 30.0,
                           scores_seq: Optional[np.ndarray] = None) -> None:
        from skix_torch.io.video import write_video

        drawn = np.stack([
            self.draw_2d(frames[t], kpts_seq[t],
                         None if scores_seq is None else scores_seq[t])
            for t in range(len(frames))
        ])
        write_video(out_path, drawn, fps)

    # ---------------- 3D (matplotlib) ----------------
    def draw_3d(self, ax, kpts3d: np.ndarray, color: str = "tab:blue",
                label: Optional[str] = None) -> None:
        """Draw a 3D skeleton on a mpl 3D axis. ``kpts3d (J, 3)``."""
        kpts3d = np.asarray(kpts3d)
        ok = np.all(np.isfinite(kpts3d), axis=-1)
        first = True
        for a, b in self.edges:
            if a < len(ok) and b < len(ok) and ok[a] and ok[b]:
                ax.plot([kpts3d[a, 0], kpts3d[b, 0]],
                        [kpts3d[a, 1], kpts3d[b, 1]],
                        [kpts3d[a, 2], kpts3d[b, 2]],
                        c=color, label=label if first else None)
                first = False
        pts = kpts3d[ok]
        if len(pts):
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=color, s=8)

    def plot_3d_frame(self, kpts3d: np.ndarray, title: str = "",
                      elev: float = 15.0, azim: float = -70.0) -> np.ndarray:
        """Render one 3D pose to an RGB image array."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(5, 5))
        ax = fig.add_subplot(111, projection="3d")
        self.draw_3d(ax, kpts3d)
        ax.view_init(elev=elev, azim=azim)
        ax.set_title(title)
        _equalize_3d(ax, kpts3d)
        fig.canvas.draw()
        img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
        plt.close(fig)
        return img


def _equalize_3d(ax, pts: np.ndarray) -> None:
    pts = np.asarray(pts)
    ok = np.all(np.isfinite(pts), axis=-1)
    if not ok.any():
        return
    p = pts[ok]
    c = p.mean(0)
    r = max(float(np.max(np.abs(p - c))), 1e-6)
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)
