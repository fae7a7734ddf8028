"""COLMAP text-format export of cameras / poses / points.

Port of ``skix/io/colmap_export.py`` (numpy, with the port's rotations):
the standard COLMAP sparse-model text triplet (cameras.txt, images.txt,
points3D.txt), and the track-level reconstruction of the reference's
``np_to_pycolmap`` as plain dataclasses. Quaternions are computed in
float32, as skix computes them (JAX without x64).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from skix_torch.geometry.rotations import matrix_to_quat as _matrix_to_quat


def matrix_to_quat(R) -> np.ndarray:
    """(..., 3, 3) rotations → (..., 4) wxyz quaternions, float32."""
    return _matrix_to_quat(torch.as_tensor(np.asarray(R, np.float32))).numpy()


def quat_to_matrix(q) -> np.ndarray:
    """(..., 4) wxyz quaternions → (..., 3, 3) rotations, float32."""
    from skix_torch.geometry.rotations import quat_to_matrix as _quat_to_matrix

    return _quat_to_matrix(torch.as_tensor(np.asarray(q, np.float32))).numpy()


def export_colmap_text(
    out_dir: str | Path,
    K,                      # (3, 3) shared PINHOLE intrinsics
    image_hw,               # (H, W)
    Rs,                     # (N, 3, 3) world→camera
    ts,                     # (N, 3)
    image_names: Optional[Sequence[str]] = None,
    points3d: Optional[np.ndarray] = None,   # (P, 3)
    point_colors: Optional[np.ndarray] = None,  # (P, 3) uint8
) -> Path:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    K = np.asarray(K)
    H, W = image_hw
    Rs = np.asarray(Rs)
    ts = np.asarray(ts)
    N = len(Rs)
    names = (list(image_names) if image_names is not None
             else [f"frame_{i:06d}.png" for i in range(N)])

    with open(out_dir / "cameras.txt", "w") as f:
        f.write("# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        f.write(f"1 PINHOLE {W} {H} {K[0, 0]:.6f} {K[1, 1]:.6f} "
                f"{K[0, 2]:.6f} {K[1, 2]:.6f}\n")

    with open(out_dir / "images.txt", "w") as f:
        f.write("# Image list: IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, "
                "CAMERA_ID, NAME\n#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        quats = np.asarray(matrix_to_quat(Rs))
        for i in range(N):
            qw, qx, qy, qz = quats[i]
            tx, ty, tz = ts[i]
            f.write(f"{i + 1} {qw:.8f} {qx:.8f} {qy:.8f} {qz:.8f} "
                    f"{tx:.8f} {ty:.8f} {tz:.8f} 1 {names[i]}\n\n")

    with open(out_dir / "points3D.txt", "w") as f:
        f.write("# 3D point list: POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        if points3d is not None:
            pts = np.asarray(points3d)
            cols = (np.asarray(point_colors) if point_colors is not None
                    else np.full((len(pts), 3), 128, np.uint8))
            for i, (p, c) in enumerate(zip(pts, cols)):
                f.write(f"{i + 1} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"{int(c[0])} {int(c[1])} {int(c[2])} 0.0\n")
    return out_dir


def read_colmap_images_txt(path: str | Path):
    """Parse images.txt back to (quats (N,4) wxyz, ts (N,3), names) — for
    round-trip validation."""
    quats, ts, names = [], [], []
    # images.txt alternates pose / POINTS2D lines per image; the POINTS2D
    # line may be EMPTY (zero observations), so blanks must be kept to
    # preserve the alternation — filtering them would misparse observation
    # rows (>=10 numeric tokens) as poses.
    lines = [ln for ln in Path(path).read_text().splitlines()
             if not ln.startswith("#")]
    expect_pose = True
    for ln in lines:
        if expect_pose:
            parts = ln.split()
            if len(parts) < 10:
                continue  # stray blank before any pose row
            quats.append([float(x) for x in parts[1:5]])
            ts.append([float(x) for x in parts[5:8]])
            names.append(parts[9])
            expect_pose = False
        else:
            expect_pose = True  # skip the observations line (may be blank)
    return np.asarray(quats), np.asarray(ts), names


# ---------------------------------------------------------------------------
# Full track-level reconstruction (np_to_pycolmap analog)
# ---------------------------------------------------------------------------
# The reference builds a pycolmap.Reconstruction from batched arrays
# (vggt/vggt/dependency/np_to_pycolmap.py:12 batch_np_matrix_to_pycolmap);
# pycolmap is not available here, so the same structure lives in plain
# dataclasses + the standard COLMAP sparse text format (readable by
# COLMAP / nerfstudio / gsplat tooling).

@dataclass
class ColmapCamera:
    camera_id: int
    model: str              # SIMPLE_PINHOLE | PINHOLE
    width: int
    height: int
    params: np.ndarray      # (3,) f,cx,cy or (4,) fx,fy,cx,cy


@dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray        # (4,) wxyz, world→camera
    tvec: np.ndarray        # (3,)
    camera_id: int
    name: str
    xys: np.ndarray         # (M, 2) observed pixel coords
    point3d_ids: np.ndarray  # (M,) 1-indexed ids into points3d
    registered: bool = True


@dataclass
class ColmapPoint3D:
    point3d_id: int
    xyz: np.ndarray
    rgb: np.ndarray         # (3,) uint8
    error: float
    track: list             # [(image_id, point2d_idx), ...]


@dataclass
class Reconstruction:
    cameras: dict           # camera_id → ColmapCamera
    images: dict            # image_id → ColmapImage
    points3d: dict          # point3d_id → ColmapPoint3D


def _camera_params(K, camera_type: str) -> np.ndarray:
    """np_to_pycolmap.py:293 _build_pycolmap_intri semantics."""
    if camera_type == "PINHOLE":
        return np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float64)
    if camera_type == "SIMPLE_PINHOLE":
        return np.array([(K[0, 0] + K[1, 1]) / 2.0, K[0, 2], K[1, 2]],
                        np.float64)
    raise ValueError(f"Camera type {camera_type} is not supported")


def build_reconstruction(
    points3d,               # (P, 3) world points
    extrinsics,             # (N, 3, 4) world→camera [R|t]
    intrinsics,             # (N, 3, 3)
    tracks,                 # (N, P, 2) pixel observations
    image_size,             # (width, height)
    masks=None,             # (N, P) bool observation validity
    max_reproj_error: float | None = None,
    max_points3D_val: float = 3000.0,
    shared_camera: bool = False,
    camera_type: str = "SIMPLE_PINHOLE",
    min_inlier_per_frame: int = 64,
    points_rgb=None,        # (P, 3) uint8
):
    """Build a COLMAP-structured reconstruction from batched arrays.

    Reference semantics (np_to_pycolmap.py:12-146): optional reprojection
    gating at ``max_reproj_error`` px ANDed into ``masks`` (points behind a
    camera are rejected — the reference's 1e6 assignment lands after the
    diff and is dead code; here z ≤ 0 genuinely fails the gate), the whole
    build aborts to ``(None, None)`` when any frame keeps fewer than
    ``min_inlier_per_frame`` inliers, tracks need ≥ 2 inlier views, and
    per-image Point2D lists carry (xy, point3D_id) with reciprocal track
    elements (image_id, point2D_idx). Ids are 1-indexed like COLMAP.

    Returns ``(Reconstruction, valid_track_mask)``.
    """
    points3d = np.asarray(points3d, np.float64)
    extrinsics = np.asarray(extrinsics, np.float64)
    intrinsics = np.asarray(intrinsics, np.float64)
    tracks = np.asarray(tracks, np.float64)
    N, P, _ = tracks.shape
    assert len(extrinsics) == N and len(intrinsics) == N
    assert len(points3d) == P

    reproj_mask = None
    if max_reproj_error is not None:
        Xh = np.concatenate([points3d, np.ones((P, 1))], axis=1)  # (P, 4)
        cam = np.einsum("nij,pj->npi", extrinsics, Xh)            # (N, P, 3)
        z = cam[..., 2]
        uv_h = np.einsum("nij,npj->npi", intrinsics,
                         cam / np.where(z[..., None] == 0, 1e-12,
                                        z[..., None]))
        diff = np.linalg.norm(uv_h[..., :2] - tracks, axis=-1)
        reproj_mask = (diff < max_reproj_error) & (z > 0)

    if masks is not None and reproj_mask is not None:
        masks = np.logical_and(np.asarray(masks, bool), reproj_mask)
    elif masks is not None:
        masks = np.asarray(masks, bool)
    else:
        masks = reproj_mask
    assert masks is not None, "need masks or max_reproj_error"

    if masks.sum(1).min() < min_inlier_per_frame:
        return None, None

    inlier_num = masks.sum(0)
    valid_mask = inlier_num >= 2
    valid_idx = np.nonzero(valid_mask)[0]

    points3d_map = {}
    for pid, vidx in enumerate(valid_idx, start=1):
        rgb = (np.asarray(points_rgb[vidx], np.uint8)
               if points_rgb is not None else np.zeros(3, np.uint8))
        points3d_map[pid] = ColmapPoint3D(
            point3d_id=pid, xyz=points3d[vidx], rgb=rgb, error=0.0, track=[])

    cameras, images = {}, {}
    W, H = int(image_size[0]), int(image_size[1])
    quats = np.asarray(matrix_to_quat(extrinsics[:, :3, :3]))
    camera = None
    for fidx in range(N):
        if camera is None or not shared_camera:
            camera = ColmapCamera(
                camera_id=fidx + 1, model=camera_type, width=W, height=H,
                params=_camera_params(intrinsics[fidx], camera_type))
            cameras[camera.camera_id] = camera

        xys, pids = [], []
        for pid, vidx in enumerate(valid_idx, start=1):
            pt = points3d_map[pid]
            if not (pt.xyz < max_points3D_val).all():
                continue
            if masks[fidx][vidx]:
                pt.track.append((fidx + 1, len(xys)))
                xys.append(tracks[fidx][vidx])
                pids.append(pid)
        images[fidx + 1] = ColmapImage(
            image_id=fidx + 1, qvec=quats[fidx], tvec=extrinsics[fidx, :3, 3],
            camera_id=camera.camera_id, name=f"image_{fidx + 1}",
            xys=np.asarray(xys, np.float64).reshape(-1, 2),
            point3d_ids=np.asarray(pids, np.int64))
    return Reconstruction(cameras, images, points3d_map), valid_mask


def reconstruction_to_arrays(recon: Reconstruction,
                             camera_type: str = "SIMPLE_PINHOLE"):
    """Inverse direction (np_to_pycolmap.py:148 pycolmap_to_batch_np_matrix):
    → (points3d (maxid, 3), extrinsics (N, 3, 4), intrinsics (N, 3, 3))."""
    max_pid = max(recon.points3d) if recon.points3d else 0
    points3d = np.zeros((max_pid, 3))
    for pid, pt in recon.points3d.items():
        points3d[pid - 1] = pt.xyz
    extrinsics, intrinsics = [], []
    for iid in sorted(recon.images):
        img = recon.images[iid]
        cam = recon.cameras[img.camera_id]
        R = np.asarray(quat_to_matrix(img.qvec))
        extrinsics.append(np.concatenate([R, img.tvec[:, None]], axis=1))
        if cam.model == "PINHOLE":
            fx, fy, cx, cy = cam.params
        else:
            fx = fy = cam.params[0]
            cx, cy = cam.params[1], cam.params[2]
        intrinsics.append(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]]))
    return points3d, np.stack(extrinsics), np.stack(intrinsics)


def write_reconstruction_text(recon: Reconstruction,
                              out_dir: str | Path) -> Path:
    """Write the full COLMAP sparse-model text triplet incl. per-image
    POINTS2D and per-point TRACK[] entries."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    with open(out_dir / "cameras.txt", "w") as f:
        f.write("# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cid in sorted(recon.cameras):
            c = recon.cameras[cid]
            params = " ".join(f"{p:.8f}" for p in c.params)
            f.write(f"{cid} {c.model} {c.width} {c.height} {params}\n")

    with open(out_dir / "images.txt", "w") as f:
        f.write("# Image list: IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, "
                "CAMERA_ID, NAME\n#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for iid in sorted(recon.images):
            im = recon.images[iid]
            qw, qx, qy, qz = im.qvec
            tx, ty, tz = im.tvec
            f.write(f"{iid} {qw:.8f} {qx:.8f} {qy:.8f} {qz:.8f} "
                    f"{tx:.8f} {ty:.8f} {tz:.8f} {im.camera_id} {im.name}\n")
            obs = " ".join(f"{xy[0]:.4f} {xy[1]:.4f} {pid}"
                           for xy, pid in zip(im.xys, im.point3d_ids))
            f.write(obs + "\n")

    with open(out_dir / "points3D.txt", "w") as f:
        f.write("# 3D point list: POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for pid in sorted(recon.points3d):
            pt = recon.points3d[pid]
            track = " ".join(f"{iid} {p2d}" for iid, p2d in pt.track)
            f.write(f"{pid} {pt.xyz[0]:.8f} {pt.xyz[1]:.8f} {pt.xyz[2]:.8f} "
                    f"{int(pt.rgb[0])} {int(pt.rgb[1])} {int(pt.rgb[2])} "
                    f"{pt.error:.4f} {track}\n")
    return out_dir
