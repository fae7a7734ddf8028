"""Skeleton metadata and cross-format keypoint conversion (COCO/H36M/MHR-70).

Port of ``skix/geometry/skeletons.py``: the same index tables (COCO-17 and
H36M-17 in the reference VideoPose3D order, MHR-70's body subset) and the
same conversions, on tensors of shape ``(..., J, C)``.
"""

from __future__ import annotations

import torch

# --------------------------------------------------------------------------
# COCO-17
# --------------------------------------------------------------------------
COCO_NAMES = (
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
)
COCO = {n.upper(): i for i, n in enumerate(
    ("nose", "l_eye", "r_eye", "l_ear", "r_ear", "l_sho", "r_sho", "l_elb",
     "r_elb", "l_wri", "r_wri", "l_hip", "r_hip", "l_kne", "r_kne", "l_ank",
     "r_ank"))}

COCO_SKELETON = (
    (0, 1), (0, 2), (1, 3), (2, 4),
    (5, 6), (5, 7), (7, 9), (6, 8), (8, 10),
    (5, 11), (6, 12), (11, 12),
    (11, 13), (13, 15), (12, 14), (14, 16),
)

# the reference's 12 bones for the length-consistency loss
# (bundle_adjustment/loss.py:118), COCO-17 indices
COCO_BONES_12 = (
    (5, 7), (7, 9), (6, 8), (8, 10),      # arms
    (11, 13), (13, 15), (12, 14), (14, 16),  # legs
    (5, 11), (6, 12), (5, 6), (11, 12),   # torso
)

# --------------------------------------------------------------------------
# H36M-17 (VideoPose3D order)
# --------------------------------------------------------------------------
H36M_NAMES = (
    "pelvis", "right_hip", "right_knee", "right_ankle",
    "left_hip", "left_knee", "left_ankle",
    "spine", "thorax", "neck_nose", "head",
    "left_shoulder", "left_elbow", "left_wrist",
    "right_shoulder", "right_elbow", "right_wrist",
)
H36M = {n.upper(): i for i, n in enumerate(
    ("pel", "r_hip", "r_kne", "r_ank", "l_hip", "l_kne", "l_ank", "spine",
     "thorax", "neck", "head", "l_sho", "l_elb", "l_wri", "r_sho", "r_elb",
     "r_wri"))}
H36M_PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 9, 8, 11, 12, 8, 14, 15)
H36M_BONES = tuple((j, p) for j, p in enumerate(H36M_PARENTS) if p >= 0)
H36M_LEFT = (4, 5, 6, 11, 12, 13)
H36M_RIGHT = (1, 2, 3, 14, 15, 16)
COCO_LEFT = (1, 3, 5, 7, 9, 11, 13, 15)
COCO_RIGHT = (2, 4, 6, 8, 10, 12, 14, 16)
H36M_TORSO = (H36M["PEL"], H36M["NECK"], H36M["L_HIP"], H36M["R_HIP"],
              H36M["L_SHO"], H36M["R_SHO"])
H36M_SYMMETRIC_BONES = (
    ((4, 5), (1, 2)),    # hip->knee
    ((5, 6), (2, 3)),    # knee->ankle
    ((11, 12), (14, 15)),  # shoulder->elbow
    ((12, 13), (15, 16)),  # elbow->wrist
)

# --------------------------------------------------------------------------
# MHR-70 (Momentum Human Rig, first 70 keypoints)
# --------------------------------------------------------------------------
MHR70_NUM_JOINTS = 70
MHR70_BODY = {
    "PELVIS": 0,
    "L_HIP": 1, "R_HIP": 2,
    "SPINE": 3,
    "L_KNEE": 4, "R_KNEE": 5,
    "L_ANKLE": 7, "R_ANKLE": 8,
    "NECK": 12,
    "L_SHOULDER": 16, "R_SHOULDER": 17,
    "L_ELBOW": 18, "R_ELBOW": 19,
    "L_WRIST": 20, "R_WRIST": 21,
    "HEAD": 15,
}
MHR70_BODY_EDGES = (
    (0, 1), (0, 2), (0, 3), (3, 12), (12, 15),
    (1, 4), (4, 7), (2, 5), (5, 8),
    (12, 16), (16, 18), (18, 20),
    (12, 17), (17, 19), (19, 21),
)
MHR70_SYMMETRIC_BONES = (
    ((1, 4), (2, 5)),     # hip->knee
    ((4, 7), (5, 8)),     # knee->ankle
    ((16, 18), (17, 19)),  # shoulder->elbow
    ((18, 20), (19, 21)),  # elbow->wrist
)


def _mid(a, b):
    return 0.5 * (a + b)


def coco_to_h36m(x: torch.Tensor, synthesize_head: bool = True) -> torch.Tensor:
    """COCO-17 → H36M-17 keypoints, ``x (..., 17, C)``: pelvis = mid(hips),
    thorax = mid(shoulders), spine = mid(pelvis, thorax), neck = nose,
    head = nose + 0.5·(nose − mid(eyes)) (or the nose)."""
    def g(i):
        return x[..., i, :]

    pelvis = _mid(g(COCO["L_HIP"]), g(COCO["R_HIP"]))
    thorax = _mid(g(COCO["L_SHO"]), g(COCO["R_SHO"]))
    spine = _mid(pelvis, thorax)
    nose = g(COCO["NOSE"])
    if synthesize_head:
        head = nose + 0.5 * (nose - _mid(g(COCO["L_EYE"]), g(COCO["R_EYE"])))
    else:
        head = nose
    return torch.stack([
        pelvis, g(COCO["R_HIP"]), g(COCO["R_KNE"]), g(COCO["R_ANK"]),
        g(COCO["L_HIP"]), g(COCO["L_KNE"]), g(COCO["L_ANK"]),
        spine, thorax, nose, head,
        g(COCO["L_SHO"]), g(COCO["L_ELB"]), g(COCO["L_WRI"]),
        g(COCO["R_SHO"]), g(COCO["R_ELB"]), g(COCO["R_WRI"]),
    ], dim=-2)


def h36m_to_coco(x: torch.Tensor) -> torch.Tensor:
    """H36M-17 → COCO-17 (the face joints from the neck/nose and head)."""
    def g(i):
        return x[..., i, :]

    nose = g(H36M["NECK"])
    head = g(H36M["HEAD"])
    eye = _mid(nose, head)
    return torch.stack([
        nose, eye, eye, head, head,
        g(H36M["L_SHO"]), g(H36M["R_SHO"]), g(H36M["L_ELB"]), g(H36M["R_ELB"]),
        g(H36M["L_WRI"]), g(H36M["R_WRI"]), g(H36M["L_HIP"]), g(H36M["R_HIP"]),
        g(H36M["L_KNE"]), g(H36M["R_KNE"]), g(H36M["L_ANK"]), g(H36M["R_ANK"]),
    ], dim=-2)


def coco_scores_to_h36m(s: torch.Tensor) -> torch.Tensor:
    """Per-joint COCO confidences ``(..., 17)`` → H36M joints; a synthesized
    joint takes the least score of its sources."""
    def g(i):
        return s[..., i]

    pelvis = torch.minimum(g(COCO["L_HIP"]), g(COCO["R_HIP"]))
    thorax = torch.minimum(g(COCO["L_SHO"]), g(COCO["R_SHO"]))
    spine = torch.minimum(pelvis, thorax)
    nose = g(COCO["NOSE"])
    head = torch.minimum(nose, torch.minimum(g(COCO["L_EYE"]), g(COCO["R_EYE"])))
    return torch.stack([
        pelvis, g(COCO["R_HIP"]), g(COCO["R_KNE"]), g(COCO["R_ANK"]),
        g(COCO["L_HIP"]), g(COCO["L_KNE"]), g(COCO["L_ANK"]),
        spine, thorax, nose, head,
        g(COCO["L_SHO"]), g(COCO["L_ELB"]), g(COCO["L_WRI"]),
        g(COCO["R_SHO"]), g(COCO["R_ELB"]), g(COCO["R_WRI"]),
    ], dim=-1)


def bone_lengths(x: torch.Tensor, bones) -> torch.Tensor:
    """Lengths of ``bones`` ((i, j) pairs) of ``x (..., J, 3)`` → ``(..., B)``."""
    a = [i for i, _ in bones]
    b = [j for _, j in bones]
    return torch.linalg.norm(x[..., a, :] - x[..., b, :], dim=-1)


def flip_keypoints(x: torch.Tensor, left, right, axis_dim: int = 0
                   ) -> torch.Tensor:
    """Mirror keypoints ``(..., J, C)``: negate coordinate ``axis_dim`` and
    swap the left and right joints (flip augmentation)."""
    sign = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
    sign[axis_dim] = -1
    perm = list(range(x.shape[-2]))
    for a, b in zip(left, right):
        perm[a], perm[b] = b, a
    return (x * sign)[..., perm, :]
