"""Joint-angle biomechanics + turn segmentation.

Port of ``skix/angle/biomech.py``: the 15-joint MHR-70 target subset, eight
∠(a,b,c) joint angles, signed upper/lower-body tilt, torso–knee angle, L–R
knee difference, elbow distance from the body midline and the facing
heading, as masked ``(T, …)`` tensor programs on the keypoints' device
(NaN marks a frame whose joints are missing, as in skix); the turn
segmentation runs on the host on the 1-D heading series (numpy, a copy of
skix's).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

_EPS = 1e-9

UNITY_MHR70_MAPPING = {
    1: "Bone_Eye_L", 2: "Bone_Eye_R",
    5: "Upperarm_L", 6: "Upperarm_R",
    7: "lowerarm_l", 8: "lowerarm_r",
    9: "Thigh_L", 10: "Thigh_R",
    11: "calf_l", 12: "calf_r",
    13: "Foot_L", 14: "Foot_R",
    41: "Hand_R", 62: "Hand_L",
    69: "neck_01",
}
TARGET_IDS = tuple(UNITY_MHR70_MAPPING.keys())
ID_TO_INDEX = {jid: i for i, jid in enumerate(TARGET_IDS)}
ID_TO_INDEX_FULL = {jid: jid for jid in TARGET_IDS}


def mapping_for(num_joints: int) -> dict:
    """The id→index map of a 15-joint target subset or a full MHR-70 array."""
    if num_joints >= 70:
        return ID_TO_INDEX_FULL
    if num_joints == len(TARGET_IDS):
        return ID_TO_INDEX
    raise ValueError(
        f"cannot infer MHR joint layout for J={num_joints}; pass id_to_index")


ANGLE_DEFS: Dict[str, Tuple[int, int, int]] = {
    "knee_l": (9, 11, 13),
    "knee_r": (10, 12, 14),
    "elbow_l": (5, 7, 62),
    "elbow_r": (6, 8, 41),
    "shoulder_l": (69, 5, 7),
    "shoulder_r": (69, 6, 8),
    "hip_l": (69, 9, 11),
    "hip_r": (69, 10, 12),
}


def _get(kpts, jid, id_to_index=None):
    m = ID_TO_INDEX if id_to_index is None else id_to_index
    return kpts[..., m[jid], :]


def _valid(v):
    return torch.isfinite(v).all(dim=-1)


def _unit(v):
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.where(n < _EPS, 1.0, n)


def joint_angle_deg(a, b, c):
    """Angle ∠ABC in degrees; NaN where a limb has zero length."""
    ba, bc = a - b, c - b
    denom = torch.linalg.norm(ba, dim=-1) * torch.linalg.norm(bc, dim=-1)
    cos_t = torch.sum(ba * bc, dim=-1) / torch.where(denom < _EPS, 1.0, denom)
    ang = torch.rad2deg(torch.arccos(cos_t.clamp(-1.0, 1.0)))
    return torch.where(denom < _EPS, torch.nan, ang)


def compute_angles(kpts, id_to_index=None, angle_defs=None):
    """Every ANGLE_DEFS series: ``kpts (T, J, 3)`` → dict of (T,)."""
    out = {}
    for name, (ai, bi, ci) in (ANGLE_DEFS if angle_defs is None
                               else angle_defs).items():
        a, b, c = (_get(kpts, j, id_to_index) for j in (ai, bi, ci))
        ok = _valid(a) & _valid(b) & _valid(c)
        out[name] = torch.where(ok, joint_angle_deg(a, b, c), torch.nan)
    return out


def _centers(kpts, id_to_index=None):
    pelvis = 0.5 * (_get(kpts, 9, id_to_index) + _get(kpts, 10, id_to_index))
    shoulder = 0.5 * (_get(kpts, 5, id_to_index) + _get(kpts, 6, id_to_index))
    knee = 0.5 * (_get(kpts, 11, id_to_index) + _get(kpts, 12, id_to_index))
    return pelvis, shoulder, knee


def _lateral_and_forward(kpts, up_axis, id_to_index=None):
    """Per-frame left→right unit vector (hips, else shoulders) and the
    forward direction (its cross product with up, oriented by the sign of
    the up axis's y)."""
    hip_l, hip_r = _get(kpts, 9, id_to_index), _get(kpts, 10, id_to_index)
    sho_l, sho_r = _get(kpts, 5, id_to_index), _get(kpts, 6, id_to_index)
    hips_ok = _valid(hip_l) & _valid(hip_r)
    lr_u = _unit(torch.where(hips_ok[..., None], hip_r - hip_l, sho_r - sho_l))
    ok = hips_ok | (_valid(sho_l) & _valid(sho_r))
    up = torch.as_tensor(up_axis, dtype=kpts.dtype, device=kpts.device)
    up_u = (up / (torch.linalg.norm(up) + _EPS)).expand(lr_u.shape)
    if float(up_axis[1]) < 0:
        fwd = _unit(torch.linalg.cross(up_u, lr_u))
    else:
        fwd = _unit(torch.linalg.cross(lr_u, up_u))
    return lr_u, fwd, up_u, ok


def compute_tilt_angles(kpts, up_axis=(0.0, 1.0, 0.0), id_to_index=None):
    """Signed upper/lower-body tilt (deg, forward +)."""
    pelvis, shoulder, knee = _centers(kpts, id_to_index)
    lr_u, fwd, up_u, ok = _lateral_and_forward(kpts, up_axis, id_to_index)

    def tilt(v):
        v_proj = v - torch.sum(v * lr_u, dim=-1, keepdim=True) * lr_u
        v_u = _unit(v_proj)
        cos_t = torch.sum(v_u * up_u, dim=-1).clamp(-1.0, 1.0)
        theta = torch.rad2deg(torch.arccos(cos_t))
        sign = torch.where(torch.sum(v_u * fwd, dim=-1) >= 0, 1.0, -1.0)
        good = ok & _valid(v) & (torch.linalg.norm(v_proj, dim=-1) > _EPS)
        return torch.where(good, theta * sign, torch.nan)

    return {"tilt_upper": tilt(shoulder - pelvis),
            "tilt_lower": tilt(knee - pelvis)}


def compute_torso_knee_angle(kpts, id_to_index=None):
    """∠(shoulder-center, pelvis, knee-center)."""
    pelvis, shoulder, knee = _centers(kpts, id_to_index)
    ok = _valid(pelvis) & _valid(shoulder) & _valid(knee)
    return {"torso_knee_angle": torch.where(
        ok, joint_angle_deg(shoulder, pelvis, knee), torch.nan)}


def compute_knee_difference(kpts, id_to_index=None):
    """Left − right knee angle (deg)."""
    angles = compute_angles(kpts, id_to_index, {"l": ANGLE_DEFS["knee_l"],
                                                "r": ANGLE_DEFS["knee_r"]})
    return {"knee_diff_lr": angles["l"] - angles["r"]}


def compute_elbow_distance(kpts, id_to_index=None):
    """Horizontal (XZ-plane) elbow distance from the pelvis midline."""
    pelvis, _, _ = _centers(kpts, id_to_index)
    out = {}
    for name, jid in (("elbow_distance_l", 7), ("elbow_distance_r", 8)):
        e = _get(kpts, jid, id_to_index)
        d = torch.sqrt((e[..., 0] - pelvis[..., 0]) ** 2
                       + (e[..., 2] - pelvis[..., 2]) ** 2)
        out[name] = torch.where(_valid(e) & _valid(pelvis), d, torch.nan)
    return out


def compute_facing_heading(kpts, up_axis=(0.0, 1.0, 0.0), id_to_index=None):
    """Ground-plane heading (deg) = atan2(forward_x, forward_z)."""
    _, fwd, _, ok = _lateral_and_forward(kpts, up_axis, id_to_index)
    heading = torch.rad2deg(torch.atan2(fwd[..., 0], fwd[..., 2]))
    return torch.where(ok, heading, torch.nan)


# --------------------------------------------------------------------------
# Turn segmentation (host side, on the 1-D heading series)
# --------------------------------------------------------------------------
def _fill_nan_linear(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    ok = np.isfinite(x)
    if not ok.any():
        return x
    idx = np.arange(len(x))
    return np.interp(idx, idx[ok], x[ok])


def _smooth_1d(x: np.ndarray, window: int) -> np.ndarray:
    if window <= 1 or len(x) < 2:
        return x
    kernel = np.ones(window) / window
    ok = np.isfinite(x).astype(np.float64)
    num = np.convolve(np.where(np.isfinite(x), x, 0.0), kernel, "same")
    den = np.convolve(ok, kernel, "same")
    out = np.full_like(x, np.nan)
    m = den > 0
    out[m] = num[m] / den[m]
    return out


def detect_turn_segments(heading_deg, min_turn_frames: int = 12,
                         min_heading_change_deg: float = 8.0
                         ) -> List[Dict[str, float]]:
    """Angular-velocity zero-crossing turn segmentation of a (T,) heading
    series (NaNs allowed) → turn dicts {turn_id, start_frame, end_frame,
    num_frames, heading_change_deg, direction}."""
    h = np.asarray(heading_deg, np.float64)
    T = h.shape[0]
    if T == 0 or np.sum(np.isfinite(h)) < 5:
        return []
    h = _fill_nan_linear(h)
    h = np.degrees(np.unwrap(np.radians(h)))
    h = _smooth_1d(h, 11)
    vel = _smooth_1d(np.gradient(h), 9)

    sign_change = np.where(vel[:-1] * vel[1:] < 0)[0] + 1
    boundaries = [0]
    for i in sign_change:
        if i - boundaries[-1] >= min_turn_frames:
            boundaries.append(int(i))
    if T - 1 - boundaries[-1] >= 1:
        boundaries.append(T - 1)
    elif boundaries[-1] != T - 1:
        boundaries[-1] = T - 1
    if len(boundaries) < 2:
        return []

    turns = []
    tid = 1
    for s, e in zip(boundaries[:-1], boundaries[1:]):
        if e - s + 1 < min_turn_frames:
            continue
        delta = float(h[e] - h[s])
        if abs(delta) < min_heading_change_deg:
            continue
        turns.append({"turn_id": float(tid), "start_frame": float(s),
                      "end_frame": float(e), "num_frames": float(e - s + 1),
                      "heading_change_deg": delta,
                      "direction": 1.0 if delta > 0 else -1.0})
        tid += 1
    return turns


def compute_all_series(kpts: torch.Tensor, up_axis=(0.0, 1.0, 0.0),
                       id_to_index=None):
    """Every biomechanics series of one clip ``(T, J, 3)`` as numpy arrays,
    and the detected turns; the joint layout (15-joint subset or full
    MHR-70) is taken from J when ``id_to_index`` is None."""
    if id_to_index is None:
        id_to_index = mapping_for(int(kpts.shape[1]))
    parts = {}
    parts.update(compute_angles(kpts, id_to_index))
    parts.update(compute_tilt_angles(kpts, up_axis, id_to_index))
    parts.update(compute_torso_knee_angle(kpts, id_to_index))
    parts.update(compute_knee_difference(kpts, id_to_index))
    parts.update(compute_elbow_distance(kpts, id_to_index))
    parts["heading_deg"] = compute_facing_heading(kpts, up_axis, id_to_index)
    names = list(parts)
    stacked = torch.stack([parts[k] for k in names]).cpu().numpy()
    series = {k: stacked[i] for i, k in enumerate(names)}
    return series, detect_turn_segments(series["heading_deg"])
