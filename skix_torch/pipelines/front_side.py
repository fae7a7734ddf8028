"""Stage CLI: side fusion + front BEV trajectory merge.

Port of ``skix/pipelines/front_side.py``. Per person: (a) the two side
SAM-3D-Body views fused into a world skeleton (the fuse stage's
``fuse_person``, on ``cfg.device``, default ``cuda``); (b) the front SAM3
person track's foot points through the ground homography into BEV pixels;
(c) per frame, the trajectory and the skeleton drawn on a BEV canvas
(OpenCV, host side), written as ``<person>_bev.mp4``, with
``<person>_world.npy``, ``<person>_feet_bev.npy`` and
``front_side_summary.json``. A person that fails is logged and skipped, as
in skix. ``render3d: true`` adds ``<person>_bev3d.mp4``, the offscreen 3D
BEV video of the world skeleton (:mod:`skix_torch.vis.render3d`, rasterized
on ``cfg.device``; ``render3d_width``, ``render3d_height``,
``render3d_eye_height``, ``render3d_kp_radius``).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np

from skix_torch.config import cli_main, iter_person_dirs
from skix_torch.front_side.bev import (BEVConfig, apply_homography,
                                       bev_homography, draw_bev_skeleton,
                                       foot_from_bbox_xyxy,
                                       project_world_to_bev)
from skix_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


def load_front_bboxes(path: Path) -> np.ndarray:
    """Front SAM3 person track: (T, 4) xyxy (track 0 of a (T, N, 4) file)."""
    arr = np.load(path, allow_pickle=False)
    if arr.ndim == 3:
        arr = arr[:, 0]
    return np.asarray(arr, np.float32)


def process_person(person: str, side_left: Path, side_right: Path,
                   front_bboxes: Path, out_dir: Path, cfg,
                   device=None) -> dict:
    import cv2

    from skix_torch.io.video import write_video
    from skix_torch.pipelines.fuse import fuse_person, load_sam3d_sequence

    L3, L2 = load_sam3d_sequence(side_left)
    R3, R2 = load_sam3d_sequence(side_right)
    bboxes = load_front_bboxes(front_bboxes)
    T = min(len(L3), len(R3), len(bboxes))

    # (a) side fusion → world skeleton per frame
    fused = fuse_person(L3[:T], R3[:T],
                        None if L2 is None else L2[:T],
                        None if R2 is None else R2[:T], device=device)
    world = fused.smoothed.cpu().numpy()                    # (T, J, 3)

    # (b) front foot points → BEV pixels
    bev_cfg = BEVConfig(meters_per_pixel=float(cfg.get("meters_per_pixel",
                                                       0.02)))
    H, (bw, bh) = bev_homography(cfg.get("img_pts"), cfg.get("bev_pts_m"),
                                 bev_cfg)
    feet_bev = apply_homography(H, foot_from_bbox_xyxy(bboxes[:T]))

    # (c) merge: trajectory + skeleton overlay per frame. skix redraws every
    # earlier foot point on a fresh canvas each frame (T²/2 circles); the
    # trajectory canvas here gets each point once, in the same order, so
    # every frame has the same pixels
    frames = []
    traj = np.full((bh, bw, 3), 10, np.uint8)
    for t in range(T):
        p = feet_bev[t]
        if np.all(np.isfinite(p)) and 0 <= p[0] < bw and 0 <= p[1] < bh:
            cv2.circle(traj, tuple(np.round(p).astype(int)), 2,
                       (255, 200, 0), -1)
        canvas = traj.copy()
        uv = project_world_to_bev(world[t], np.nanmean(world[t], axis=0),
                                  (int(round(feet_bev[t, 0])),
                                   int(round(feet_bev[t, 1]))),
                                  meters_per_pixel=bev_cfg.meters_per_pixel,
                                  rot90_left=True)
        draw_bev_skeleton(canvas, uv)
        frames.append(canvas)

    out_dir.mkdir(parents=True, exist_ok=True)
    write_video(out_dir / f"{person}_bev.mp4", np.stack(frames),
                fps=float(cfg.get("fps", 30.0)))
    if bool(cfg.get("render3d", False)):
        # the offscreen 3D BEV video on the port's rasterizer
        from skix_torch.front_side.bev import BEV_EDGES_MINIMAL
        from skix_torch.vis.render3d import BevVideoRenderer, BevView

        center = np.nanmean(world.reshape(-1, 3), axis=0)
        center = np.where(np.isfinite(center), center, 0.0)
        with BevVideoRenderer(
                out_dir / f"{person}_bev3d.mp4", edges=BEV_EDGES_MINIMAL,
                width=int(cfg.get("render3d_width", 1280)),
                height=int(cfg.get("render3d_height", 720)),
                fps=int(cfg.get("fps", 30)),
                view=BevView(lookat=tuple(center), eye_height=float(
                    cfg.get("render3d_eye_height", 25.0))),
                kp_radius=float(cfg.get("render3d_kp_radius", 0.08)),
                device=device) as r3d:
            r3d.render_many(world)
    np.save(out_dir / f"{person}_world.npy", world)
    np.save(out_dir / f"{person}_feet_bev.npy", feet_bev)
    return {"frames": int(T),
            "traj_length_px": float(np.nansum(np.linalg.norm(
                np.diff(feet_bev, axis=0), axis=-1)))}


@cli_main("front_side")
def main(cfg):
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(cfg.get("device"))
    side_root = Path(cfg.paths.side_root)
    front_root = Path(cfg.paths.front_root)
    out_root = Path(cfg.paths.out_root)
    from skix_torch.pipelines.fuse import _resolve_person_views

    reports = {}
    for person_dir in iter_person_dirs(side_root, cfg):
        views = _resolve_person_views(person_dir)
        fb = front_root / person_dir.name / "person_bboxes.npy"
        if not views or not fb.exists():
            log.warning("person %s: missing side views or front bboxes",
                        person_dir.name)
            continue
        try:
            reports[person_dir.name] = process_person(
                person_dir.name, views["left"], views["right"], fb,
                out_root / person_dir.name, cfg, device)
            log.info("person %s merged", person_dir.name)
        except Exception:  # noqa: BLE001 — per-person isolation, as in skix
            log.exception("person %s failed", person_dir.name)
    out_root.mkdir(parents=True, exist_ok=True)
    (out_root / "front_side_summary.json").write_text(
        json.dumps(reports, indent=2))


if __name__ == "__main__":
    main()
