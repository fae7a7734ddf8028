"""Bird's-eye-view utilities: homography, world→BEV projection, drawing.

A copy of ``skix/front_side/bev.py`` (numpy and OpenCV, no JAX): capability
parity with reference front_side/front/bev_utils.py (BeVConfig,
foot_from_bbox_xyxy :10, make_bev_canvas :100, make_bev homography :115) and
front_side/run.py (project_world_to_bev_centered :153 — XZ plane,
meters_per_pixel 0.02, optional 90° rotate; draw_skeleton :200; merge :222).

Projection math is vectorized numpy (this is the visualization tail; the
trajectory/fusion math upstream runs in torch).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

# BEV drawing edge set (reference run.py:103-150 BEV_EDGES_MINIMAL — MHR-70
# leg/torso subset)
BEV_EDGES_MINIMAL = (
    (13, 11), (11, 9), (14, 12), (12, 10), (9, 10),
    (17, 15), (17, 16), (20, 18), (20, 19), (5, 6),
)


@dataclasses.dataclass
class BEVConfig:
    lane_width_m: float = 30.0
    lane_length_m: float = 60.0
    margin_x_m: float = 2.0
    margin_y_m: float = 2.0
    px_per_m: float = 10.0
    meters_per_pixel: float = 0.02  # world-skeleton overlay scale (run.py:245)


def foot_from_bbox_xyxy(bbox: np.ndarray) -> np.ndarray:
    """Foot point = bottom-center of a bbox (reference bev_utils.py:10)."""
    bbox = np.asarray(bbox)
    return np.stack([(bbox[..., 0] + bbox[..., 2]) * 0.5, bbox[..., 3]],
                    axis=-1)


def make_bev_canvas(cfg: BEVConfig) -> Tuple[Tuple[int, int], np.ndarray]:
    """Canvas size (w, h) px + metric→pixel similarity S (reference :100)."""
    Xmin = -cfg.lane_width_m / 2 - cfg.margin_x_m
    Xmax = +cfg.lane_width_m / 2 + cfg.margin_x_m
    Ymax = cfg.lane_length_m + cfg.margin_y_m
    Ymin = -cfg.margin_y_m
    w = int(np.ceil((Xmax - Xmin) * cfg.px_per_m))
    h = int(np.ceil((Ymax - Ymin) * cfg.px_per_m))
    s = cfg.px_per_m
    S = np.array([[s, 0, -Xmin * s], [0, -s, Ymax * s], [0, 0, 1]], np.float64)
    return (w, h), S


def bev_homography(img_pts: Optional[np.ndarray] = None,
                   bev_pts_m: Optional[np.ndarray] = None,
                   cfg: BEVConfig = BEVConfig()):
    """Image px → BEV canvas px homography via 4 ground correspondences
    (reference defaults: 1920×1080 trapezoid ↔ 30×60 m lane)."""
    import cv2

    if img_pts is None:
        img_pts = np.array([[0, 1080], [1920, 1080], [1336, 130], [600, 130]],
                           np.float32)
    if bev_pts_m is None:
        bev_pts_m = np.array([[-15.0, 0.0], [15.0, 0.0], [15.0, 60.0],
                              [-15.0, 60.0]], np.float32)
    H_m, _ = cv2.findHomography(np.asarray(img_pts, np.float32),
                                np.asarray(bev_pts_m, np.float32), method=0)
    if H_m is None or not np.all(np.isfinite(H_m)):
        raise ValueError("degenerate BEV homography")
    size, S = make_bev_canvas(cfg)
    return S @ H_m, size


def apply_homography(H: np.ndarray, pts: np.ndarray) -> np.ndarray:
    pts = np.asarray(pts, np.float64)
    ph = np.concatenate([pts, np.ones((*pts.shape[:-1], 1))], axis=-1)
    out = ph @ H.T
    return out[..., :2] / out[..., 2:3]


def project_world_to_bev(
    kpts_world: np.ndarray,     # (J, 3) or (T, J, 3)
    center_world: np.ndarray,   # (3,)
    center_px: Tuple[int, int],
    meters_per_pixel: float = 0.02,
    use_axes: Tuple[int, int] = (0, 2),
    rot90_left: bool = False,
) -> np.ndarray:
    """World skeleton → BEV pixel coords around a center pixel (reference
    run.py:153). Returns float array with NaN for invalid joints."""
    k = np.asarray(kpts_world, np.float64)
    x_idx, z_idx = use_axes
    dx = k[..., x_idx] - center_world[x_idx]
    dz = k[..., z_idx] - center_world[z_idx]
    if rot90_left:
        dx, dz = dz, dx
    u = center_px[0] + dx / meters_per_pixel
    v = center_px[1] - dz / meters_per_pixel
    ok = np.all(np.isfinite(k), axis=-1)
    uv = np.stack([u, v], axis=-1)
    uv[~ok] = np.nan
    return uv


def draw_bev_skeleton(bev_img: np.ndarray, pts_uv: np.ndarray,
                      edges: Sequence[Tuple[int, int]] = BEV_EDGES_MINIMAL
                      ) -> np.ndarray:
    """Draw skeleton onto a BEV canvas (reference run.py:200)."""
    import cv2

    h, w = bev_img.shape[:2]
    pts = np.asarray(pts_uv)

    def inb(p):
        return (np.all(np.isfinite(p)) and 0 <= p[0] < w and 0 <= p[1] < h)

    for a, b in edges:
        if a < len(pts) and b < len(pts) and inb(pts[a]) and inb(pts[b]):
            cv2.line(bev_img, tuple(np.round(pts[a]).astype(int)),
                     tuple(np.round(pts[b]).astype(int)),
                     (0, 255, 0), 2, cv2.LINE_AA)
    for p in pts:
        if inb(p):
            cv2.circle(bev_img, tuple(np.round(p).astype(int)), 3,
                       (0, 0, 255), -1, cv2.LINE_AA)
    return bev_img
