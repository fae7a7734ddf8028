"""Unity synthetic ground-truth loading & coordinate harmonization.

A copy of ``skix/io/unity.py`` (numpy only). Capability parity with
reference fuse/load/load_unity.py: per-frame GT jsonl with named joints,
mapped onto the MHR-70 target ids (UNITY_MHR70_MAPPING), 2D pixel harmonization (Unity's v axis flipped:
``v_px = height − v``, :48) and Unity→SAM-3D 3D axis conversion
``(x, y, z) → (−z, −y, x)`` (:93). Arrays come out masked (valid flags)
instead of NaN dicts.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

import numpy as np

from skix_torch.angle.biomech import TARGET_IDS, UNITY_MHR70_MAPPING

_NAME_TO_ID = {v: k for k, v in UNITY_MHR70_MAPPING.items()}
_ID_TO_ROW = {jid: i for i, jid in enumerate(TARGET_IDS)}


def unity_2d_to_pixels(u: float, v: float, height: int = 1080,
                       scale_x: float = 1.0, scale_y: float = 1.0):
    """Unity 2D (v up) → image pixels (v down): v_px = height − v·scale."""
    return u * scale_x, height - v * scale_y


def unity_3d_to_sam3d(x: float, y: float, z: float):
    """Unity axes → SAM-3D axes: (x, y, z) → (−z, −y, x)."""
    return -z, -y, x


def parse_gt_frame(gt_2d_raw: dict, gt_3d_raw: dict, height: int = 1080
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One frame's GT dicts → ``(gt2d (J,2), gt3d (J,3), valid (J,))`` over
    the 15-joint target layout."""
    J = len(TARGET_IDS)
    gt2d = np.full((J, 2), np.nan, np.float64)
    gt3d = np.full((J, 3), np.nan, np.float64)
    for item in gt_2d_raw.get("joints2d", []):
        jid = _NAME_TO_ID.get(item["name"])
        if jid in _ID_TO_ROW:
            gt2d[_ID_TO_ROW[jid]] = unity_2d_to_pixels(
                float(item["u"]), float(item["v"]), height)
    for item in gt_3d_raw.get("joints3d", []):
        jid = _NAME_TO_ID.get(item["name"])
        if jid in _ID_TO_ROW:
            gt3d[_ID_TO_ROW[jid]] = unity_3d_to_sam3d(
                float(item["x"]), float(item["y"]), float(item["z"]))
    valid = np.isfinite(gt2d).all(-1) & np.isfinite(gt3d).all(-1)
    return gt2d, gt3d, valid


def load_unity_gt_jsonl(path_2d: str | Path, path_3d: str | Path,
                        height: int = 1080):
    """Paired 2D/3D GT jsonl files → ``(gt2d (T,J,2), gt3d (T,J,3),
    valid (T,J))``."""
    lines_2d = Path(path_2d).read_text().strip().splitlines()
    lines_3d = Path(path_3d).read_text().strip().splitlines()
    T = min(len(lines_2d), len(lines_3d))
    g2, g3, vv = [], [], []
    for t in range(T):
        a, b, v = parse_gt_frame(json.loads(lines_2d[t]),
                                 json.loads(lines_3d[t]), height)
        g2.append(a)
        g3.append(b)
        vv.append(v)
    return np.stack(g2), np.stack(g3), np.stack(vv)
