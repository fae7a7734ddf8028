"""Stage CLI: classical two-view camera pose + DLT triangulation.

Port of ``skix/pipelines/triangulation.py``. Per person: the two views'
COCO keypoints give per-frame relative poses (the ``kpt`` route: one
batched RANSAC over every frame, then one pose from all frames'
correspondences pooled) or the fixed demo extrinsic (``fixed``), or, on
records that store frames, one of the host OpenCV feature routes
(``sift``, ``orb``, ``bbox_sift``, ``kpt_bbox``, copied from skix); then
one clip-wide DLT, the positive-depth and reprojection gate and
Savitzky–Golay smoothing. Writes ``joints_3d_<method>.json`` (with R|t),
``joints_3d_<method>_smoothed.npy``, the bundle-adjustment input
``ba_input_<method>.npz``, the pose log ``<person>_poses.{npz,csv}`` and,
with ``single_view``, each view's ego-motion poses. The geometry runs on
``cfg.device`` (default ``cuda``); the RANSAC hypotheses are drawn on the
CPU (``skix_torch.geometry.epipolar.ransac_samples``), so every device
tries the same samples.
"""

from __future__ import annotations

import csv
import json
import logging
from pathlib import Path

import numpy as np
import torch

from skix_torch.config import cli_main, iter_person_dirs
from skix_torch.io.contracts import load_pt_info
from skix_torch.pipelines.videopose3d import load_2d_keypoints
from skix_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


def default_K():
    """Calibrated DJI Osmo intrinsics (reference triangulation/main.py:51)."""
    return np.array([[1116.93, 0.0, 955.77],
                     [0.0, 1117.33, 538.91],
                     [0.0, 0.0, 1.0]])


def fixed_demo_extrinsic(baseline_m: float = 20.0):
    """Ry(180°) with camera center [0,0,baseline] (reference
    two_view.py:209-221)."""
    R = np.diag([-1.0, 1.0, -1.0])
    C = np.array([0.0, 0.0, baseline_m])
    t = -R @ C
    return R, t


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _generator(seed: int) -> torch.Generator:
    return torch.Generator(device="cpu").manual_seed(seed)


def estimate_poses_kpt(kpts_a, kpts_b, score_a, score_b, K,
                       baseline_m: float, num_hypotheses: int = 256,
                       min_score: float = 0.3, device=None):
    """Per-frame relative pose from keypoint correspondences, every frame
    of the clip in one batch; ``|t|`` scaled to the baseline. Returns numpy
    ``R (T,3,3)``, ``t (T,3)``, inlier counts ``(T,)``."""
    from skix_torch.geometry.epipolar import estimate_relative_pose

    device = resolve_device(device)
    w = ((score_a > min_score) & (score_b > min_score)).astype(np.float32)
    pose = estimate_relative_pose(
        _f32(kpts_a, device), _f32(kpts_b, device), _f32(K, device),
        generator=_generator(0), num_hypotheses=num_hypotheses,
        weights=_f32(w, device))
    t = pose.t.cpu().numpy()
    t = t / (np.linalg.norm(t, axis=-1, keepdims=True) + 1e-9) * baseline_m
    return pose.R.cpu().numpy(), t, pose.num_inliers.cpu().numpy()


def estimate_pose_clip(kpts_a, kpts_b, score_a, score_b, K, baseline_m: float,
                       num_hypotheses: int = 1024, min_score: float = 0.3,
                       max_points: int = 4096, device=None):
    """Clip-level relative pose from every frame's correspondences pooled
    (static cameras: hundreds to thousands of correspondences over the
    subject's whole trajectory, one well-conditioned RANSAC)."""
    from skix_torch.geometry.epipolar import estimate_relative_pose

    device = resolve_device(device)
    pa = kpts_a.reshape(-1, 2)
    pb = kpts_b.reshape(-1, 2)
    w = ((score_a.reshape(-1) > min_score)
         & (score_b.reshape(-1) > min_score)).astype(np.float32)
    if len(pa) > max_points:
        stride = int(np.ceil(len(pa) / max_points))
        pa, pb, w = pa[::stride], pb[::stride], w[::stride]
    pose = estimate_relative_pose(
        _f32(pa, device), _f32(pb, device), _f32(K, device),
        generator=_generator(0), num_hypotheses=num_hypotheses,
        weights=_f32(w, device))
    t = pose.t.cpu().numpy()
    t = t / (np.linalg.norm(t) + 1e-9) * baseline_m
    return pose.R.cpu().numpy(), t, int(pose.num_inliers)


def _essential_pose(p1, p2, K, baseline_m: float):
    """RANSAC essential + recoverPose on pixel correspondences, |t|
    rescaled to the stereo baseline. Shared tail of every cv2-feature
    pose method."""
    import cv2

    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    E, mask = cv2.findEssentialMat(p1, p2, K, method=cv2.RANSAC,
                                   prob=0.999, threshold=1.0)
    if E is None:
        return None
    _, R, t, _ = cv2.recoverPose(E, p1, p2, K, mask=mask)
    t = t.ravel() / (np.linalg.norm(t) + 1e-9) * baseline_m
    return R, t


def estimate_pose_opencv_features(frame_a, frame_b, K, baseline_m: float,
                                  method: str = "sift"):
    """SIFT/ORB pose for one frame pair (host-side cv2; reference
    camera_position.py:120,181)."""
    import cv2

    det = cv2.SIFT_create() if method == "sift" else cv2.ORB_create(2000)
    norm = cv2.NORM_L2 if method == "sift" else cv2.NORM_HAMMING
    kp1, des1 = det.detectAndCompute(frame_a, None)
    kp2, des2 = det.detectAndCompute(frame_b, None)
    if des1 is None or des2 is None or len(kp1) < 8 or len(kp2) < 8:
        return None
    matches = cv2.BFMatcher(norm, crossCheck=True).match(des1, des2)
    if len(matches) < 8:
        return None
    p1 = np.float64([kp1[m.queryIdx].pt for m in matches])
    p2 = np.float64([kp2[m.trainIdx].pt for m in matches])
    return _essential_pose(p1, p2, K, baseline_m)


def _sift_ratio_match_bbox(frame_a, frame_b, bbox_a, bbox_b,
                           ratio: float = 0.75, max_kp: int = 1000):
    """Lowe-ratio SIFT matches restricted to one bbox pair, returned in
    FULL-FRAME pixel coordinates: ``(p1 (M,2), p2 (M,2), dist (M,))``
    float32, or ``None`` when either crop yields no usable features."""
    import cv2

    def crop(frame, bbox):
        x1, y1, x2, y2 = (max(int(v), 0) for v in bbox)
        return frame[y1:y2, x1:x2]

    pa, pb = crop(frame_a, bbox_a), crop(frame_b, bbox_b)
    if pa.size == 0 or pb.size == 0:
        return None
    det = cv2.SIFT_create(nfeatures=max_kp)
    kp1, des1 = det.detectAndCompute(pa, None)
    kp2, des2 = det.detectAndCompute(pb, None)
    if des1 is None or des2 is None or len(kp1) < 2 or len(kp2) < 2:
        return None
    pairs = cv2.BFMatcher().knnMatch(des1, des2, k=2)
    good = [m[0] for m in pairs
            if len(m) == 2 and m[0].distance < ratio * m[1].distance]
    if not good:
        return None
    p1 = np.float32([kp1[m.queryIdx].pt for m in good])
    p2 = np.float32([kp2[m.trainIdx].pt for m in good])
    p1 += np.float32([bbox_a[0], bbox_a[1]])
    p2 += np.float32([bbox_b[0], bbox_b[1]])
    return p1, p2, np.float32([m.distance for m in good])


def estimate_pose_bbox_region(frame_a, frame_b, bbox_a, bbox_b, K,
                              baseline_m: float, ratio: float = 0.75):
    """Pose from SIFT matches INSIDE the tracked-person bbox pair only
    (reference camera_position.py:242 estimate_pose_from_bbox_region):
    ratio-test matches in the crops, shifted back to full-frame
    coordinates, then essential + recoverPose scaled to the baseline."""
    res = _sift_ratio_match_bbox(frame_a, frame_b, bbox_a, bbox_b, ratio)
    if res is None or len(res[0]) < 5:
        return None
    return _essential_pose(res[0], res[1], K, baseline_m)


def estimate_pose_kpt_bbox(frame_a, frame_b, bbox_a, bbox_b, K,
                           baseline_m: float, kpts_a=None, kpts_b=None,
                           kpt_scores=None, kpt_weight: float = 1.5,
                           pix_weight: float = 1.0, top_pix: int = 800,
                           ratio: float = 0.75):
    """Weighted union of bbox-crop SIFT matches and 2D keypoint
    correspondences (reference camera_position_kpt_bbox.py:178
    estimate_pose_from_bbox_and_kpt). findEssentialMat takes no weights,
    so weights become integer row repetitions (weighted inlier voting):
    each route's weights are normalized to max 3·base and clipped to
    [1, 3·base] — keypoints weighted by score at base ``kpt_weight``,
    pixel matches by ``exp(-dist/median_dist)`` at base ``pix_weight``,
    keeping only the ``top_pix`` best matches."""
    def repeat_by_weight(p1, p2, w, base):
        w = np.asarray(w, np.float32)
        w = w / (w.max() + 1e-8) * (3.0 * base)
        reps = np.clip(np.rint(w), 1, max(1, int(3 * base))).astype(int)
        return np.repeat(p1, reps, axis=0), np.repeat(p2, reps, axis=0)

    P1, P2 = [], []
    res = _sift_ratio_match_bbox(frame_a, frame_b, bbox_a, bbox_b, ratio)
    if res is not None:
        p1, p2, d = res
        if top_pix and len(p1) > top_pix:
            idx = np.argsort(d)[:top_pix]
            p1, p2, d = p1[idx], p2[idx], d[idx]
        w = np.exp(-d / (np.median(d) + 1e-6))
        r1, r2 = repeat_by_weight(p1, p2, w, pix_weight)
        P1.append(r1)
        P2.append(r2)
    if kpts_a is not None and kpts_b is not None and len(kpts_a):
        ks = (np.asarray(kpt_scores, np.float32)
              if kpt_scores is not None and len(kpt_scores) == len(kpts_a)
              else np.ones((len(kpts_a),), np.float32))
        r1, r2 = repeat_by_weight(np.asarray(kpts_a, np.float32),
                                  np.asarray(kpts_b, np.float32),
                                  ks, kpt_weight)
        P1.append(r1)
        P2.append(r2)
    if not P1:
        return None
    P1 = np.concatenate(P1, axis=0)
    P2 = np.concatenate(P2, axis=0)
    if len(P1) < 5:
        return None
    return _essential_pose(P1, P2, K, baseline_m)


def estimate_single_view_motion(kpts, scores, K, min_score: float = 0.3,
                                num_hypotheses: int = 128, device=None):
    """Per-view ego/subject motion: the relative pose between consecutive
    frames from keypoint correspondences, the whole clip in one batch."""
    from skix_torch.geometry.epipolar import estimate_relative_pose

    device = resolve_device(device)
    T = kpts.shape[0]
    if T < 2:
        return np.zeros((0, 3, 3)), np.zeros((0, 3))
    a = kpts[:-1].reshape(T - 1, -1, 2)
    b = kpts[1:].reshape(T - 1, -1, 2)
    w = ((scores[:-1].reshape(T - 1, -1) > min_score)
         & (scores[1:].reshape(T - 1, -1) > min_score)).astype(np.float32)
    pose = estimate_relative_pose(
        _f32(a, device), _f32(b, device), _f32(K, device),
        generator=_generator(7), num_hypotheses=num_hypotheses,
        weights=_f32(w, device))
    return pose.R.cpu().numpy(), pose.t.cpu().numpy()


class PoseLog:
    """Per-frame R/t/camera-center accumulator → npz + csv (reference
    two_view.py:57 PoseLogger)."""

    def __init__(self):
        self.rows = []

    def add(self, frame: int, method: str, R, t, n_inliers=0):
        C = -np.asarray(R).T @ np.asarray(t)
        self.rows.append({"frame": frame, "method": method,
                          "R": np.asarray(R), "t": np.asarray(t), "C": C,
                          "n_inliers": int(n_inliers)})

    def save(self, out_dir: Path, stem: str):
        out_dir.mkdir(parents=True, exist_ok=True)
        if not self.rows:
            return
        np.savez(out_dir / f"{stem}_poses.npz",
                 frames=np.array([r["frame"] for r in self.rows]),
                 methods=np.array([r["method"] for r in self.rows]),
                 R=np.stack([r["R"] for r in self.rows]),
                 t=np.stack([r["t"] for r in self.rows]),
                 C=np.stack([r["C"] for r in self.rows]))
        with open(out_dir / f"{stem}_poses.csv", "w", newline="") as f:
            wcsv = csv.writer(f)
            wcsv.writerow(["frame", "method", "Cx", "Cy", "Cz", "n_inliers"])
            for r in sorted(self.rows, key=lambda r: (r["method"], r["frame"])):
                wcsv.writerow([r["frame"], r["method"], *np.round(r["C"], 4),
                               r["n_inliers"]])


def triangulate_and_triage(kpts_a, kpts_b, score_a, score_b, K, R, t, dist,
                           reproj_px_max: float = 25.0,
                           savgol_window: int = 11, device=None):
    """Clip-wide DLT + post-triage (positive depth, reprojection gate, with
    the distortion applied against the raw keypoints) + Savitzky–Golay
    smoothing. Returns tensors ``(X, X_smoothed, ok, mean reprojection
    error)`` on ``device``."""
    from skix_torch.geometry.camera import reprojection_error
    from skix_torch.geometry.smoothing import savgol_smooth
    from skix_torch.geometry.triangulate import (positive_depth_mask,
                                                 triangulate_sequence)

    device = resolve_device(device)
    ka, kb = _f32(kpts_a, device), _f32(kpts_b, device)
    K, R, t = _f32(K, device), _f32(R, device), _f32(t, device)
    d = None if dist is None else _f32(dist, device)
    X = triangulate_sequence(ka, kb, K, R, t, w_a=_f32(score_a, device),
                             w_b=_f32(score_b, device), dist=d)
    eye = torch.eye(3, dtype=X.dtype, device=X.device)
    err_a = reprojection_error(X, ka, K, eye, torch.zeros_like(t), dist=d)
    err_b = reprojection_error(X, kb, K, R, t, dist=d)
    ok = (positive_depth_mask(X, R, t)
          & (err_a < reproj_px_max) & (err_b < reproj_px_max))
    return X, savgol_smooth(X, window=savgol_window), ok, 0.5 * (err_a + err_b)


def save_joints_json(path: Path, X, ok, err, R, t, video_paths):
    """Per-frame 3D joints JSON incl. R|t (reference save.py:31 schema)."""
    X = np.asarray(X)
    ok = np.asarray(ok)
    err = np.asarray(err)
    frames = []
    for i in range(X.shape[0]):
        frames.append({
            "frame": i,
            "joints_3d": X[i].tolist(),
            "valid": ok[i].tolist(),
            "mean_reproj_px": float(np.mean(err[i])),
        })
    payload = {
        "R": np.asarray(R).tolist(),
        "t": np.asarray(t).tolist(),
        "video_paths": list(video_paths),
        "frames": frames,
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload))


@cli_main("triangulation")
def main(cfg):
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(cfg.get("device"))
    K = np.asarray(cfg.get("K", default_K()), np.float64)
    dist = np.asarray(cfg.dist, np.float64) if cfg.get("dist") else None
    baseline = float(cfg.get("baseline_m", 20.0))
    root = Path(cfg.paths.pt_root)
    out_root = Path(cfg.paths.out_root)
    methods = list(cfg.get("methods", ["kpt"]))
    src = cfg.get("kpt_source", "detectron2")

    for person_dir in iter_person_dirs(root, cfg):
        records = sorted(person_dir.glob("*.npz")) + sorted(person_dir.glob("*.pt"))
        if len(records) < 2:
            continue
        ka, sa, _ = load_2d_keypoints(str(records[0]), src)
        kb, sb, _ = load_2d_keypoints(str(records[1]), src)
        T = min(len(ka), len(kb))
        ka, kb, sa, sb = ka[:T], kb[:T], sa[:T], sb[:T]
        out_dir = out_root / person_dir.name
        logp = PoseLog()

        if bool(cfg.get("single_view", True)):
            out_dir.mkdir(parents=True, exist_ok=True)
            for rec, kk, ss in ((records[0], ka, sa), (records[1], kb, sb)):
                Rsv, tsv = estimate_single_view_motion(
                    kk.reshape(T, -1, 2), ss.reshape(T, -1), K, device=device)
                np.savez(out_dir / f"{rec.stem}_single_view_poses.npz",
                         R=Rsv, t=tsv)

        for method in methods:
            if method == "kpt":
                Rs, ts, n_inl = estimate_poses_kpt(
                    ka.reshape(T, -1, 2), kb.reshape(T, -1, 2),
                    sa.reshape(T, -1), sb.reshape(T, -1), K, baseline,
                    device=device)
                for i in range(T):
                    logp.add(i, "kpt", Rs[i], ts[i], n_inl[i])
                R_clip, t_clip, n_pool = estimate_pose_clip(
                    ka, kb, sa, sb, K, baseline, device=device)
                logp.add(-1, "kpt_clip", R_clip, t_clip, n_pool)
            elif method == "fixed":
                R_clip, t_clip = fixed_demo_extrinsic(baseline)
                logp.add(0, "fixed", R_clip, t_clip)
            elif method in ("sift", "orb", "bbox_sift", "kpt_bbox"):
                il = load_pt_info(records[0])
                ir = load_pt_info(records[1])
                if il.frames is None or ir.frames is None:
                    log.warning("method %s needs frames stored in the "
                                "records; skipping", method)
                    continue
                if method in ("bbox_sift", "kpt_bbox"):
                    ba = il.d2_bbox if src == "detectron2" else il.yolo_bbox
                    bb = ir.d2_bbox if src == "detectron2" else ir.yolo_bbox
                    if ba is None or bb is None:
                        log.warning("method %s needs %s bboxes in the "
                                    "records; skipping", method, src)
                        continue
                stride = max(1, T // 10)
                poses = []
                for i in range(0, T, stride):
                    if method == "bbox_sift":
                        res = estimate_pose_bbox_region(
                            il.frames[i], ir.frames[i], ba[i], bb[i], K,
                            baseline)
                    elif method == "kpt_bbox":
                        res = estimate_pose_kpt_bbox(
                            il.frames[i], ir.frames[i], ba[i], bb[i], K,
                            baseline, kpts_a=ka[i].reshape(-1, 2),
                            kpts_b=kb[i].reshape(-1, 2),
                            kpt_scores=sa[i].reshape(-1))
                    else:
                        res = estimate_pose_opencv_features(
                            il.frames[i], ir.frames[i], K, baseline,
                            method=method)
                    if res is not None:
                        logp.add(i, method, *res)
                        poses.append(res)
                if not poses:
                    log.warning("method %s found no usable frame pair",
                                method)
                    continue
                R_clip, t_clip = poses[len(poses) // 2]
            else:
                log.warning("unknown method %s; skipping", method)
                continue
            X, Xs, ok, err = triangulate_and_triage(
                ka, kb, sa, sb, K, R_clip, t_clip, dist, device=device)
            X = X.cpu().numpy()
            save_joints_json(out_dir / f"joints_3d_{method}.json", X,
                             ok.cpu().numpy(), err.cpu().numpy(), R_clip,
                             t_clip, [str(records[0]), str(records[1])])
            np.save(out_dir / f"joints_3d_{method}_smoothed.npy",
                    Xs.cpu().numpy())
            if bool(cfg.get("export_ba", True)):
                out_dir.mkdir(parents=True, exist_ok=True)
                np.savez(out_dir / f"ba_input_{method}.npz",
                         X3d=X,
                         R=np.stack([np.eye(3), np.asarray(R_clip)]),
                         t=np.stack([np.zeros(3), np.asarray(t_clip)]),
                         K=K,
                         x2d=np.stack([ka, kb], axis=1),
                         conf=np.stack([sa, sb], axis=1))
        logp.save(out_dir, person_dir.name)
        log.info("person %s done", person_dir.name)


if __name__ == "__main__":
    main()
