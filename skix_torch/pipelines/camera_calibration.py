"""Stage CLI: chessboard camera calibration.

Capability parity with reference camera_calibration/main.py (~484 LoC,
SURVEY.md §2.4): CalibConfig (9×6 inner corners, 25 mm squares, rational
k4–k6 model), video-or-image-dir autodetect (:64-70), subpixel corner
refinement (:80), cv2.calibrateCamera, per-image reprojection-error CSV with
worst-``prune_top_ratio`` re-calibration (:49), outputs .npz + OpenCV .yml +
undistortion comparison images (:99-103).

Port of ``skix/pipelines/camera_calibration.py``. Host OpenCV by design,
in skix as here: a one-off offline stage of corner detection and
``cv2.calibrateCamera`` on the CPU, with no device path (it takes no
``device`` key and touches no tensor), not a CPU fallback of a card path.
A video is decoded by the port's ``io/video.read_video_chunks``.
"""

from __future__ import annotations

import csv
import dataclasses
import logging
from pathlib import Path

import numpy as np

from skix_torch.config import cli_main

log = logging.getLogger(__name__)


@dataclasses.dataclass
class CalibConfig:
    board_cols: int = 9          # inner corners per row
    board_rows: int = 6          # inner corners per column
    square_size_mm: float = 25.0
    use_rational_model: bool = True
    prune_top_ratio: float = 0.1
    frame_stride: int = 10       # for video input
    max_images: int = 60


def collect_images(input_path: Path, cfg: CalibConfig):
    """Video file → sampled frames; directory → images (reference :64-70)."""
    import cv2

    if input_path.is_dir():
        imgs = []
        for f in sorted(input_path.glob("*")):
            if f.suffix.lower() in (".png", ".jpg", ".jpeg", ".bmp"):
                img = cv2.imread(str(f))
                if img is not None:
                    imgs.append((f.name, img))
        return imgs[: cfg.max_images]
    from skix_torch.io.video import read_video_chunks

    imgs = []
    i = 0
    for chunk in read_video_chunks(input_path, chunk_size=32):
        for frame in chunk:
            if i % cfg.frame_stride == 0:
                imgs.append((f"frame_{i:06d}", cv2.cvtColor(frame,
                                                            cv2.COLOR_RGB2BGR)))
            i += 1
            if len(imgs) >= cfg.max_images:
                return imgs
    return imgs


def find_chessboard_corners(images, cfg: CalibConfig):
    """Detect + subpixel-refine corners (reference :80)."""
    import cv2

    pattern = (cfg.board_cols, cfg.board_rows)
    objp = np.zeros((cfg.board_cols * cfg.board_rows, 3), np.float32)
    objp[:, :2] = np.mgrid[0:cfg.board_cols, 0:cfg.board_rows].T.reshape(-1, 2)
    objp *= cfg.square_size_mm
    criteria = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3)
    obj_pts, img_pts, names, shape = [], [], [], None
    for name, img in images:
        gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        shape = gray.shape[::-1]
        ok, corners = cv2.findChessboardCorners(gray, pattern, None)
        if not ok:
            continue
        corners = cv2.cornerSubPix(gray, corners, (11, 11), (-1, -1), criteria)
        obj_pts.append(objp)
        img_pts.append(corners)
        names.append(name)
    return obj_pts, img_pts, names, shape


def calibrate(obj_pts, img_pts, image_size, cfg: CalibConfig):
    import cv2

    flags = cv2.CALIB_RATIONAL_MODEL if cfg.use_rational_model else 0
    rms, K, dist, rvecs, tvecs = cv2.calibrateCamera(
        obj_pts, img_pts, image_size, None, None, flags=flags)
    per_img = []
    for i in range(len(obj_pts)):
        proj, _ = cv2.projectPoints(obj_pts[i], rvecs[i], tvecs[i], K, dist)
        per_img.append(float(np.sqrt(np.mean(
            (proj.reshape(-1, 2) - img_pts[i].reshape(-1, 2)) ** 2))))
    return rms, K, dist, per_img


def save_outputs(out_dir: Path, K, dist, rms, per_img, names,
                 sample_img=None) -> None:
    import cv2

    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / "calibration_parameters.npz", K=K, dist=dist, rms=rms)
    fs = cv2.FileStorage(str(out_dir / "calibration_parameters.yml"),
                         cv2.FILE_STORAGE_WRITE)
    fs.write("K", K)
    fs.write("dist", dist)
    fs.write("rms", rms)
    fs.release()
    with open(out_dir / "reprojection_errors.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image", "rms_px"])
        for n, e in zip(names, per_img):
            w.writerow([n, f"{e:.4f}"])
    if sample_img is not None:
        und = cv2.undistort(sample_img, K, dist)
        cv2.imwrite(str(out_dir / "undistort_before.png"), sample_img)
        cv2.imwrite(str(out_dir / "undistort_after.png"), und)


@cli_main("camera_calibration")
def main(cfg_node):
    logging.basicConfig(level=logging.INFO)
    cfg = CalibConfig(
        board_cols=int(cfg_node.get("board_cols", 9)),
        board_rows=int(cfg_node.get("board_rows", 6)),
        square_size_mm=float(cfg_node.get("square_size_mm", 25.0)),
        use_rational_model=bool(cfg_node.get("use_rational_model", True)),
        prune_top_ratio=float(cfg_node.get("prune_top_ratio", 0.1)),
        frame_stride=int(cfg_node.get("frame_stride", 10)),
        max_images=int(cfg_node.get("max_images", 60)),
    )
    input_path = Path(cfg_node.paths.input)
    out_dir = Path(cfg_node.paths.out_dir)
    images = collect_images(input_path, cfg)
    obj_pts, img_pts, names, shape = find_chessboard_corners(images, cfg)
    if len(obj_pts) < 3:
        raise SystemExit(f"only {len(obj_pts)} usable chessboard views")
    rms, K, dist, per_img = calibrate(obj_pts, img_pts, shape, cfg)
    log.info("initial calibration: rms %.4f px over %d views", rms, len(names))

    # prune worst views and re-calibrate (reference prune_top_ratio :49)
    if cfg.prune_top_ratio > 0 and len(obj_pts) >= 6:
        k = max(1, int(len(obj_pts) * cfg.prune_top_ratio))
        keep = np.argsort(per_img)[:-k]
        obj2 = [obj_pts[i] for i in keep]
        img2 = [img_pts[i] for i in keep]
        names2 = [names[i] for i in keep]
        rms2, K2, dist2, per2 = calibrate(obj2, img2, shape, cfg)
        log.info("pruned %d worst views: rms %.4f px", k, rms2)
        if rms2 < rms:
            rms, K, dist, per_img, names = rms2, K2, dist2, per2, names2
    save_outputs(out_dir, K, dist, rms, per_img, names,
                 sample_img=images[0][1] if images else None)
    log.info("calibration saved to %s (rms %.4f px)", out_dir, rms)


if __name__ == "__main__":
    main()
