"""Stage CLI: confidence-weighted cross-view fusion (raw / unity layouts).

Port of ``skix/pipelines/fuse.py``. Per person: the left and right
SAM-3D-Body sequences, the cross-view consistency confidence (and, where
the 2D keypoints are there, the weak-perspective reprojection confidence,
combined by the geometric mean), right aligned to left by a per-frame
Umeyama, per-joint softmax fusion and the adaptive EMA; writes
``<person>_fused.npy``, ``<person>_smoothed.npy`` and ``fuse_summary.json``
(``frames`` −1 for a person that failed, which is logged and skipped, as in
skix). The fusion runs on ``cfg.device`` (default ``cuda``), one clip at
once but for the EMA's loop over frames.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch

from skix_torch.config import cli_main, iter_person_dirs
from skix_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

# Canonicalization joint ids for MHR-70 (metadata/mhr70.py mhr_names:
# 5/6 = shoulders, 9/10 = hips; no pelvis joint exists, so the left hip
# roots the frame — matching skix/models/mhr.py MHR70_PARENTS). NOTE a
# deliberate deviation: the reference's constants (main_raw.py:19-23
# IDX_PELVIS=14/LHIP=11/RHIP=12) are COCO-17 indices applied to MHR-70
# data — in mhr_names those are right-ankle/left-knee/right-knee, a
# leg-based frame; true hips/shoulders canonicalize the torso the
# formula intends.
MHR70_CANON = dict(root_idx=9, left_hip_idx=9, right_hip_idx=10,
                   left_shoulder_idx=5, right_shoulder_idx=6)


def load_sam3d_sequence(path: Path):
    """Load a (T,J,3) 3D sequence + optional (T,J,2) 2D from either a single
    ``.npz``/``.npy`` or a ``frame_*.npz`` directory (reference
    fuse/load/load_raw.py:29 load_sam_data)."""
    if path.is_dir():
        frames = sorted(path.glob("frame_*.npz"))
        if not frames:
            raise ValueError(f"{path}: no frame_*.npz files")
        k3, k2 = [], []
        for f in frames:
            with np.load(f, allow_pickle=False) as z:
                k3.append(z["pred_keypoints_3d"])
                k2.append(z.get("pred_keypoints_2d"))
        return np.stack(k3), (np.stack(k2) if k2[0] is not None else None)
    if path.suffix == ".npy":
        return np.load(path), None
    with np.load(path, allow_pickle=False) as z:
        if "pred_keypoints_3d" in z or "fused" in z:
            k3 = (z["pred_keypoints_3d"] if "pred_keypoints_3d" in z
                  else z["fused"])
            k2 = z.get("pred_keypoints_2d")
            return np.asarray(k3), (None if k2 is None else np.asarray(k2))
        needs_outputs = "outputs" in z
    if needs_outputs:
        # reference format: np.savez_compressed(..., outputs=[dict, ...])
        # (prepare_side_results/save.py:108) — object array, needs pickle
        with np.load(path, allow_pickle=True) as z:
            outs = list(z["outputs"])
        k3 = np.stack([np.asarray(o["pred_keypoints_3d"]) for o in outs])
        have_2d = all("pred_keypoints_2d" in o for o in outs)
        k2 = (np.stack([np.asarray(o["pred_keypoints_2d"]) for o in outs])
              if have_2d else None)
        return k3, k2
    raise ValueError(f"{path}: no recognizable keypoint arrays")


def fuse_person(left_3d, right_3d, left_2d=None, right_2d=None,
                sigma_px: float = 12.0, sigma_3d: float = 0.08,
                ema_alpha: float = 0.7, ema_range=(0.45, 0.92),
                ema_gain: float = 0.25, device=None):
    """Full per-person fusion: confidences → geometric-mean combine →
    softmax fuse → adaptive EMA; numpy inputs, tensors on ``device`` out
    (a ``FusedSequence``)."""
    from skix_torch.fuse.confidence import (crossview_consistency_confidence,
                                            weakpersp_reproj_confidence)
    from skix_torch.fuse.fuse import fuse_sequence

    device = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    L, R = f32(left_3d), f32(right_3d)
    conf_c, _ = crossview_consistency_confidence(L, R, **MHR70_CANON,
                                                 sigma_3d=sigma_3d)
    conf_l = conf_r = conf_c
    if left_2d is not None:
        wl, _ = weakpersp_reproj_confidence(L, f32(left_2d), sigma_px=sigma_px)
        conf_l = torch.sqrt(wl * conf_c)
    if right_2d is not None:
        wr, _ = weakpersp_reproj_confidence(R, f32(right_2d), sigma_px=sigma_px)
        conf_r = torch.sqrt(wr * conf_c)
    return fuse_sequence(L, R, conf_l=conf_l, conf_r=conf_r,
                         ema_alpha=ema_alpha, ema_alpha_min=ema_range[0],
                         ema_alpha_max=ema_range[1], ema_speed_gain=ema_gain)


def _resolve_person_views(person_dir: Path):
    """pro_*/run_* layouts: left/right per-view inputs (reference
    main_raw.py:96 _resolve_person_paths). Matches 'left'/'right'
    ANYWHERE in file OR directory names (the sam3d stage writes
    per-record frame DIRECTORIES named after record stems, e.g.
    ``cam0_left``); name matches are kept even when only one side
    resolves, and the alphabetical fallback fills only the missing
    side(s)."""
    cands = {}
    for name in ("left", "right"):
        for pat in (f"*{name}*.npz", f"*{name}*.npy", f"*{name}*"):
            hits = sorted(p for p in person_dir.glob(pat)
                          if p.suffix in (".npz", ".npy") or p.is_dir())
            if hits:
                cands[name] = hits[0]
                break
    if len(cands) < 2:
        files = sorted(list(person_dir.glob("*.npz"))
                       + list(person_dir.glob("*.npy")))
        dirs = sorted(d for d in person_dir.iterdir() if d.is_dir())
        pool = [p for p in (files if len(files) >= 2 else dirs)
                if p not in cands.values()]
        for name in ("left", "right"):
            if name not in cands and pool:
                cands[name] = pool.pop(0)
    return cands if len(cands) == 2 else None


@cli_main("fuse")
def main(cfg):
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(cfg.get("device"))
    root = Path(cfg.paths.in_root)
    out_root = Path(cfg.paths.out_root)
    reports = {}
    for person_dir in iter_person_dirs(root, cfg):
        views = _resolve_person_views(person_dir)
        if not views:
            log.warning("person %s: could not resolve 2 views", person_dir.name)
            continue
        try:  # per-person isolation, as in skix
            L3, L2 = load_sam3d_sequence(views["left"])
            R3, R2 = load_sam3d_sequence(views["right"])
            T = min(len(L3), len(R3))
            res = fuse_person(
                L3[:T], R3[:T],
                None if L2 is None else L2[:T],
                None if R2 is None else R2[:T],
                sigma_px=float(cfg.get("sigma_px", 12.0)),
                sigma_3d=float(cfg.get("sigma_3d", 0.08)),
                ema_alpha=float(cfg.get("ema_alpha", 0.7)),
                ema_range=(float(cfg.get("ema_alpha_min", 0.45)),
                           float(cfg.get("ema_alpha_max", 0.92))),
                ema_gain=float(cfg.get("ema_speed_gain", 0.25)),
                device=device)
            out_dir = out_root / person_dir.name
            out_dir.mkdir(parents=True, exist_ok=True)
            np.save(out_dir / f"{person_dir.name}_fused.npy",
                    res.fused.cpu().numpy())
            np.save(out_dir / f"{person_dir.name}_smoothed.npy",
                    res.smoothed.cpu().numpy())
            reports[person_dir.name] = {
                "frames": int(T),
                "mean_conf_l": float(res.conf_l.mean()),
                "mean_conf_r": float(res.conf_r.mean()),
            }
            log.info("person %s fused (%d frames)", person_dir.name, T)
        except Exception:  # noqa: BLE001
            log.exception("person %s failed", person_dir.name)
            reports[person_dir.name] = {"frames": -1}
    out_root.mkdir(parents=True, exist_ok=True)
    (out_root / "fuse_summary.json").write_text(json.dumps(reports, indent=2))


if __name__ == "__main__":
    main()
