"""Observed-vs-reprojected comparison panels.

Host code (OpenCV on numpy arrays), a copy of
``skix/vis/reprojection.py``; nothing of it runs on the card.

Capability parity with reference triangulation/reproject.py:203
``reproject_and_visualize`` — side-by-side panel of observed 2D keypoints
vs the reprojection of the triangulated 3D points, with per-joint pixel
error statistics burned in — and the reprojection-error logging the
reference performs after every geometric step (bundle_adjustment/run.py:158).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def reprojection_panel(
    frame: Optional[np.ndarray],     # (H, W, 3) uint8 background or None
    uv_obs: np.ndarray,              # (J, 2)
    uv_reproj: np.ndarray,           # (J, 2)
    image_hw=(1080, 1920),
    title: str = "",
) -> np.ndarray:
    """Render one comparison panel (obs = green, reproj = red, error lines
    yellow) + error stats footer. Returns an RGB image."""
    import cv2

    H, W = (frame.shape[:2] if frame is not None else image_hw)
    canvas = (frame.copy() if frame is not None
              else np.full((H, W, 3), 30, np.uint8))
    uv_obs = np.asarray(uv_obs, np.float64)
    uv_reproj = np.asarray(uv_reproj, np.float64)
    ok = (np.isfinite(uv_obs).all(-1) & np.isfinite(uv_reproj).all(-1))
    err = np.where(ok, np.linalg.norm(uv_obs - uv_reproj, axis=-1), np.nan)
    for j in range(len(uv_obs)):
        if not ok[j]:
            continue
        o = tuple(np.round(uv_obs[j]).astype(int))
        r = tuple(np.round(uv_reproj[j]).astype(int))
        cv2.line(canvas, o, r, (255, 255, 0), 1, cv2.LINE_AA)
        cv2.circle(canvas, o, 4, (0, 255, 0), -1, cv2.LINE_AA)
        cv2.circle(canvas, r, 4, (255, 0, 0), -1, cv2.LINE_AA)
    stats = err[np.isfinite(err)]
    txt = (f"{title}  mean {stats.mean():.2f}px  max {stats.max():.2f}px"
           if len(stats) else f"{title}  no valid joints")
    cv2.rectangle(canvas, (0, H - 28), (W, H), (0, 0, 0), -1)
    cv2.putText(canvas, txt, (8, H - 8), cv2.FONT_HERSHEY_SIMPLEX, 0.6,
                (255, 255, 255), 1, cv2.LINE_AA)
    return canvas


def reprojection_report(uv_obs_seq, uv_reproj_seq, valid=None) -> dict:
    """Clip-level per-joint error stats (the txt-log columns of the
    reference's reprojection checks). Shapes (T, J, 2)."""
    uv_obs_seq = np.asarray(uv_obs_seq, np.float64)
    uv_reproj_seq = np.asarray(uv_reproj_seq, np.float64)
    err = np.linalg.norm(uv_obs_seq - uv_reproj_seq, axis=-1)  # (T, J)
    ok = np.isfinite(err)
    if valid is not None:
        ok &= np.asarray(valid, bool)
    err = np.where(ok, err, np.nan)
    with np.errstate(all="ignore"):
        per_joint = np.nanmean(err, axis=0)
    flat = err[np.isfinite(err)]
    return {
        "mean_px": float(flat.mean()) if len(flat) else float("nan"),
        "median_px": float(np.median(flat)) if len(flat) else float("nan"),
        "max_px": float(flat.max()) if len(flat) else float("nan"),
        "per_joint_mean_px": per_joint.tolist(),
        "valid_fraction": float(ok.mean()),
    }


def save_reprojection_video(frames, uv_obs_seq, uv_reproj_seq,
                            out_path: str | Path, fps: float = 30.0) -> None:
    from skix_torch.io.video import write_video

    panels = [reprojection_panel(
        None if frames is None else frames[t], uv_obs_seq[t],
        uv_reproj_seq[t], title=f"frame {t}")
        for t in range(len(uv_obs_seq))]
    write_video(out_path, np.stack(panels), fps)
