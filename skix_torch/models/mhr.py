"""Momentum-Human-Rig (MHR) parameterization and forward-kinematics rig.

Port of ``skix/models/mhr.py``: the parameter-layout tables (the rig's
wiring, numpy data), the XYZ/ZYX euler ↔ matrix ↔ rot6d conversions with
the reference's gimbal branch, the continuous ↔ model-parameter
conversions of body and hands, the PCA hand blend, the parameter assembly,
and ``rig_forward`` (FK + linear-blend skinning + keypoint regression) over
an :class:`MHRRig` of numpy arrays; ``default_rig()`` is skix's 70-joint
template over the real MHR-70 hierarchy.

``rig_forward`` walks the tree one depth level at a time: every joint of a
level takes its parent's world transform in one batched product, so the
forward kinematics of the 70-joint rig is ~9 levels of a few launches
each, not 70 joints of three each. Each joint's products are those of
skix's joint-by-joint loop.

Functions take and return torch tensors (float32) on any device; the rig's
arrays move to the tensor's device once per rig and device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from skix_torch.utils.device import constant

# --------------------------------------------------------------------------
# parameter-layout tables (the rig's wiring)
# --------------------------------------------------------------------------
BODY_3DOF_ROT_IDXS = np.array([
    (0, 2, 4), (6, 8, 10), (12, 13, 14), (15, 16, 17), (18, 19, 20),
    (21, 22, 23), (24, 25, 26), (27, 28, 29), (34, 35, 36), (37, 38, 39),
    (44, 45, 46), (53, 54, 55), (64, 65, 66), (85, 69, 73), (86, 70, 79),
    (87, 71, 82), (88, 72, 76), (91, 92, 93), (112, 96, 100),
    (113, 97, 106), (114, 98, 109), (115, 99, 103), (130, 131, 132),
], np.int32)
BODY_1DOF_ROT_IDXS = np.array([
    1, 3, 5, 7, 9, 11, 30, 31, 32, 33, 40, 41, 42, 43, 47, 48, 49, 50, 51,
    52, 56, 57, 58, 59, 60, 61, 62, 63, 67, 68, 74, 75, 77, 78, 80, 81, 83,
    84, 89, 90, 94, 95, 101, 102, 104, 105, 107, 108, 110, 111, 116, 117,
    118, 119, 120, 121, 122, 123,
], np.int32)
BODY_1DOF_TRANS_IDXS = np.array([124, 125, 126, 127, 128, 129], np.int32)

NUM_BODY_MODEL_PARAMS = 133
NUM_BODY_CONT = (2 * BODY_3DOF_ROT_IDXS.size + 2 * BODY_1DOF_ROT_IDXS.size
                 + BODY_1DOF_TRANS_IDXS.size)  # 260

# per-hand joint DoF counts, ordered by joint
HAND_DOFS = np.array([3, 1, 1, 3, 1, 1, 3, 1, 1, 3, 1, 1, 2, 3, 1, 1],
                     np.int32)
NUM_HAND_MODEL_PARAMS = int(HAND_DOFS.sum())  # 27
NUM_HAND_CONT = 2 * NUM_HAND_MODEL_PARAMS     # 54

# hand-owned entries of the 133-dim body model params
MHR_PARAM_HAND_IDXS = np.arange(62, 116, dtype=np.int32)
MHR_PARAM_HAND_MASK = np.zeros(133, bool)
MHR_PARAM_HAND_MASK[MHR_PARAM_HAND_IDXS] = True


def _hand_masks():
    cont3 = np.concatenate([np.full(2 * k, k == 3, bool) for k in HAND_DOFS])
    cont1 = np.concatenate(
        [np.full(2 * k, k in (1, 2), bool) for k in HAND_DOFS])
    par3 = np.concatenate([np.full(k, k == 3, bool) for k in HAND_DOFS])
    par1 = np.concatenate([np.full(k, k in (1, 2), bool) for k in HAND_DOFS])
    return cont3, cont1, par3, par1


_HAND_CONT_3DOF, _HAND_CONT_1DOF, _HAND_PAR_3DOF, _HAND_PAR_1DOF = \
    _hand_masks()


# the tables as int64 positions (kept on each device by ``constant``)
_B3 = BODY_3DOF_ROT_IDXS.reshape(-1).astype(np.int64)
_B1 = BODY_1DOF_ROT_IDXS.astype(np.int64)
_BT = BODY_1DOF_TRANS_IDXS.astype(np.int64)
_HC3, _HC1, _HP3, _HP1 = (np.flatnonzero(m) for m in (
    _HAND_CONT_3DOF, _HAND_CONT_1DOF, _HAND_PAR_3DOF, _HAND_PAR_1DOF))
_OUT_FLIP = np.array([1.0, -1.0, -1.0], np.float32)


# --------------------------------------------------------------------------
# rotation conversions
# --------------------------------------------------------------------------
def euler_xyz_to_matrix(r: torch.Tensor) -> torch.Tensor:
    """XYZ-Euler ``(..., 3)`` → rotation matrix ``R = Rz(z) Ry(y) Rx(x)``."""
    cx, cy, cz = (torch.cos(r[..., i]) for i in range(3))
    sx, sy, sz = (torch.sin(r[..., i]) for i in range(3))
    row0 = torch.stack([cy * cz, -cx * sz + sx * sy * cz,
                        sx * sz + cx * sy * cz], dim=-1)
    row1 = torch.stack([cy * sz, cx * cz + sx * sy * sz,
                        -sx * cz + cx * sy * sz], dim=-1)
    row2 = torch.stack([-sy, sx * cy, cx * cy], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_euler_xyz(m: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`euler_xyz_to_matrix`, with the reference's gimbal
    branch: where ``sqrt(m00² + m10²) < 1e-6`` x comes from the second row
    and z is 0 (blended arithmetically, as skix does)."""
    sy = torch.sqrt(m[..., 0, 0] ** 2 + m[..., 1, 0] ** 2)
    singular = (sy < 1e-6).to(m.dtype)
    x = torch.atan2(m[..., 2, 1], m[..., 2, 2])
    y = torch.atan2(-m[..., 2, 0], sy)
    z = torch.atan2(m[..., 1, 0], m[..., 0, 0])
    xs = torch.atan2(-m[..., 1, 2], m[..., 1, 1])
    zs = torch.zeros_like(z)
    return torch.stack([x * (1 - singular) + xs * singular, y,
                        z * (1 - singular) + zs * singular], dim=-1)


def euler_zyx_to_matrix(r: torch.Tensor) -> torch.Tensor:
    """ZYX-intrinsic Euler ``(z, y, x)`` → ``Rz Ry Rx`` (the head's global
    rotation convention)."""
    return euler_xyz_to_matrix(torch.stack([r[..., 2], r[..., 1], r[..., 0]],
                                           dim=-1))


def matrix_to_euler_zyx(m: torch.Tensor) -> torch.Tensor:
    e = matrix_to_euler_xyz(m)
    return torch.stack([e[..., 2], e[..., 1], e[..., 0]], dim=-1)


def rot6d_to_matrix_cols(x: torch.Tensor) -> torch.Tensor:
    """6D (first two matrix COLUMNS) → rotation matrix (x = col1 normalized,
    z = x × y, y = z × x)."""
    a1, a2 = x[..., :3], x[..., 3:]
    b1 = a1 / (torch.linalg.vector_norm(a1, dim=-1, keepdim=True) + 1e-9)
    b3 = torch.linalg.cross(b1, a2, dim=-1)
    b3 = b3 / (torch.linalg.vector_norm(b3, dim=-1, keepdim=True) + 1e-9)
    b2 = torch.linalg.cross(b3, b1, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)  # columns


def matrix_to_rot6d_cols(R: torch.Tensor) -> torch.Tensor:
    return torch.cat([R[..., :, 0], R[..., :, 1]], dim=-1)


def euler_xyz_to_cont6d(r: torch.Tensor) -> torch.Tensor:
    return matrix_to_rot6d_cols(euler_xyz_to_matrix(r))


def cont6d_to_euler_xyz(c: torch.Tensor) -> torch.Tensor:
    return matrix_to_euler_xyz(rot6d_to_matrix_cols(c))


def rotation_angle_difference(A: torch.Tensor, B: torch.Tensor
                              ) -> torch.Tensor:
    """Angle (rad) between rotation matrices ``(..., 3, 3)``."""
    R = torch.einsum("...ij,...kj->...ik", A, B)
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))


def fix_wrist_euler(wrist_xzy: torch.Tensor, limits_x=(-2.2, 1.0),
                    limits_z=(-2.2, 1.5), limits_y=(-1.2, 1.5)):
    """Resolve the ±π euler ambiguity toward joint limits. ``wrist_xzy (...,
    3)`` = (X, Z, Y) angles."""
    w = wrist_xzy
    x, z, y = w[..., 0], w[..., 1], w[..., 2]
    x_alt = torch.atan2(torch.sin(x + math.pi), torch.cos(x + math.pi))
    z_alt = torch.atan2(torch.sin(-(z + math.pi)), torch.cos(-(z + math.pi)))
    y_alt = torch.atan2(torch.sin(y + math.pi), torch.cos(y + math.pi))

    def viol(val, lim):
        return (torch.clamp(lim[0] - val, min=0) ** 2
                + torch.clamp(val - lim[1], min=0) ** 2)

    v_orig = viol(x, limits_x) + viol(z, limits_z) + viol(y, limits_y)
    v_alt = viol(x_alt, limits_x) + viol(z_alt, limits_z) + viol(y_alt,
                                                                 limits_y)
    alt = torch.stack([x_alt, z_alt, y_alt], dim=-1)
    return torch.where((v_alt < v_orig)[..., None], alt, w)


# --------------------------------------------------------------------------
# cont ↔ model params (body / hand)
# --------------------------------------------------------------------------
def cont_to_model_params_body(cont: torch.Tensor) -> torch.Tensor:
    """``(..., 260)`` continuous → ``(..., 133)`` model params."""
    lead = cont.shape[:-1]
    n3 = BODY_3DOF_ROT_IDXS.shape[0]
    n1 = BODY_1DOF_ROT_IDXS.shape[0]
    c3 = cont[..., :6 * n3].reshape(*lead, n3, 6)
    c1 = cont[..., 6 * n3:6 * n3 + 2 * n1].reshape(*lead, n1, 2)
    ct = cont[..., 6 * n3 + 2 * n1:]
    e3 = cont6d_to_euler_xyz(c3)
    e1 = torch.atan2(c1[..., 0], c1[..., 1])
    out = cont.new_zeros((*lead, NUM_BODY_MODEL_PARAMS))
    dev = cont.device
    out[..., constant(_B3, dev)] = e3.reshape(*lead, -1)
    out[..., constant(_B1, dev)] = e1
    out[..., constant(_BT, dev)] = ct
    return out


def model_params_to_cont_body(params: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`cont_to_model_params_body`."""
    lead = params.shape[:-1]
    dev = params.device
    e3 = params[..., constant(_B3, dev)].reshape(*lead, -1, 3)
    e1 = params[..., constant(_B1, dev)]
    ct = params[..., constant(_BT, dev)]
    c3 = euler_xyz_to_cont6d(e3).reshape(*lead, -1)
    c1 = torch.stack([torch.sin(e1), torch.cos(e1)], dim=-1).reshape(*lead, -1)
    return torch.cat([c3, c1, ct], dim=-1)


def cont_to_model_params_hand(cont: torch.Tensor) -> torch.Tensor:
    """``(..., 54)`` → ``(..., 27)``."""
    lead = cont.shape[:-1]
    dev = cont.device
    c3 = cont[..., constant(_HC3, dev)].reshape(*lead, -1, 6)
    c1 = cont[..., constant(_HC1, dev)].reshape(*lead, -1, 2)
    e3 = cont6d_to_euler_xyz(c3).reshape(*lead, -1)
    e1 = torch.atan2(c1[..., 0], c1[..., 1])
    out = cont.new_zeros((*lead, NUM_HAND_MODEL_PARAMS))
    out[..., constant(_HP3, dev)] = e3
    out[..., constant(_HP1, dev)] = e1
    return out


def model_params_to_cont_hand(params: torch.Tensor) -> torch.Tensor:
    lead = params.shape[:-1]
    dev = params.device
    e3 = params[..., constant(_HP3, dev)].reshape(*lead, -1, 3)
    e1 = params[..., constant(_HP1, dev)]
    c3 = euler_xyz_to_cont6d(e3).reshape(*lead, -1)
    c1 = torch.stack([torch.sin(e1), torch.cos(e1)], dim=-1).reshape(*lead, -1)
    out = params.new_zeros((*lead, NUM_HAND_CONT))
    out[..., constant(_HC3, dev)] = c3
    out[..., constant(_HC1, dev)] = c1
    return out


def blend_hand_pose(hand_params_pca, hand_pose_mean, hand_pose_comps):
    """PCA hand pose ``(..., 54)`` → model params ``(..., 27)``: ``mean +
    params @ comps``, then cont → model."""
    cont = hand_pose_mean + torch.einsum("...a,ab->...b", hand_params_pca,
                                         hand_pose_comps)
    return cont_to_model_params_hand(cont)


# --------------------------------------------------------------------------
# FK rig
# --------------------------------------------------------------------------
class MHRRig(NamedTuple):
    """Momentum-style skeleton and skinning, all arrays plain numpy data.

    ``param_transform (J·7, P)`` maps the model-parameter vector onto
    per-joint DoFs ``[tx ty tz rx ry rz s]`` (s = log2 uniform scale).
    ``offsets`` are rest local translations (rig units, cm). ``pre_rotation
    (J, 3, 3)`` composes before the parametrized XYZ-euler rotation.
    ``keypoint_mapping (K, V+J)`` regresses keypoints from ``[vertices;
    joint positions]``.
    """

    parents: np.ndarray          # (J,) int, -1 for root
    offsets: np.ndarray          # (J, 3) f32
    pre_rotation: np.ndarray     # (J, 3, 3) f32
    param_transform: np.ndarray  # (J*7, P) f32
    rest_verts: np.ndarray       # (V, 3) f32
    skin_weights: np.ndarray     # (V, K_influences) f32
    skin_joints: np.ndarray      # (V, K_influences) int
    keypoint_mapping: np.ndarray  # (K, V + J) f32
    # euler order of the rig's GLOBAL-rotation params ("xyz" for the default
    # template, "zyx" for the reference's Momentum asset)
    root_euler_order: str = "xyz"

    @property
    def num_joints(self) -> int:
        return self.parents.shape[0]

    @property
    def num_params(self) -> int:
        return self.param_transform.shape[1]


def _depths(parents: np.ndarray) -> np.ndarray:
    depth = np.zeros(len(parents), np.int32)
    for j in range(len(parents)):
        d, a = 0, j
        while parents[a] >= 0:
            a = int(parents[a])
            d += 1
        depth[j] = d
    return depth


def _topo_order(parents: np.ndarray):
    return list(np.argsort(_depths(parents), kind="stable"))


def _rest_joint_positions(rig: MHRRig) -> np.ndarray:
    """Rest-pose world joint positions (zero params), float32 numpy."""
    pos = np.zeros((rig.num_joints, 3), np.float32)
    R = np.zeros((rig.num_joints, 3, 3), np.float32)
    for j in _topo_order(rig.parents):
        p = int(rig.parents[j])
        if p < 0:
            pos[j] = rig.offsets[j]
            R[j] = rig.pre_rotation[j]
        else:
            pos[j] = pos[p] + R[p] @ rig.offsets[j]
            R[j] = R[p] @ rig.pre_rotation[j]
    return pos


class _RigOnDevice(NamedTuple):
    rig: MHRRig                  # keeps the id of the cache key alive
    levels: list                 # [(joints, parents)] per depth ≥ 1
    roots: torch.Tensor
    offsets: torch.Tensor
    pre_rotation: torch.Tensor
    param_transform: torch.Tensor
    rest_verts: torch.Tensor
    rest_joint_pos: torch.Tensor
    skin_weights: torch.Tensor
    skin_joints: torch.Tensor
    keypoint_mapping: torch.Tensor


_ON_DEVICE: dict = {}


def _on_device(rig: MHRRig, device) -> _RigOnDevice:
    key = (id(rig), str(device))
    hit = _ON_DEVICE.get(key)
    if hit is not None and hit.rig is rig:
        return hit
    depth = _depths(rig.parents)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    levels = [(i64(np.flatnonzero(depth == d)),
               i64(rig.parents[depth == d]))
              for d in range(1, int(depth.max()) + 1)]
    out = _RigOnDevice(
        rig, levels, i64(np.flatnonzero(depth == 0)), f32(rig.offsets),
        f32(rig.pre_rotation), f32(rig.param_transform), f32(rig.rest_verts),
        f32(_rest_joint_positions(rig)), f32(rig.skin_weights),
        i64(rig.skin_joints), f32(rig.keypoint_mapping))
    _ON_DEVICE[key] = out
    return out


def rig_forward(rig: MHRRig, model_params: torch.Tensor, shape_offsets=None,
                return_verts: bool = True) -> dict:
    """FK + LBS. ``model_params (..., P)`` → dict with ``joints (..., J, 3)``
    world joint positions, ``joint_rots (..., J, 3, 3)`` world rotations,
    ``joint_scales (..., J)``, ``verts (..., V, 3)`` posed vertices (if
    ``return_verts``) and ``keypoints (..., K, 3)``. ``shape_offsets (...,
    V, 3)`` optionally displaces the rest vertices. World scale accumulates
    down the tree, as in Momentum."""
    r = _on_device(rig, model_params.device)
    batch = model_params.shape[:-1]
    J = rig.num_joints
    dofs = torch.einsum("...p,dp->...d", model_params, r.param_transform)
    dofs = dofs.reshape(*batch, J, 7)
    t = dofs[..., :3]
    R_local = torch.einsum("jab,...jbc->...jac", r.pre_rotation,
                           euler_xyz_to_matrix(dofs[..., 3:6]))
    s = 2.0 ** dofs[..., 6]
    local_t = r.offsets + t

    # FK one depth level at a time: a level's joints read their parents'
    # world transforms (all of a shallower level) in one batched product
    tw = torch.zeros_like(local_t)
    Rw = torch.zeros_like(R_local)
    sw = torch.zeros_like(s)
    tw[..., r.roots, :] = local_t[..., r.roots, :]
    Rw[..., r.roots, :, :] = R_local[..., r.roots, :, :]
    sw[..., r.roots] = s[..., r.roots]
    for joints, parents in r.levels:
        Rp, sp = Rw[..., parents, :, :], sw[..., parents]
        tw[..., joints, :] = tw[..., parents, :] + sp[..., None] * (
            torch.einsum("...jab,...jb->...ja", Rp, local_t[..., joints, :]))
        Rw[..., joints, :, :] = torch.einsum("...jab,...jbc->...jac", Rp,
                                             R_local[..., joints, :, :])
        sw[..., joints] = sp * s[..., joints]

    out = {"joints": tw, "joint_rots": Rw, "joint_scales": sw}
    if return_verts and rig.rest_verts.size:
        rest = r.rest_verts
        if shape_offsets is not None:
            rest = rest + shape_offsets
        else:
            rest = rest.expand(*batch, *rest.shape[-2:])
        sj = r.skin_joints
        vj = rest[..., :, None, :] - r.rest_joint_pos[sj]    # (..., V, K, 3)
        Rj = Rw[..., sj, :, :]                          # (..., V, K, 3, 3)
        tj = tw[..., sj, :]
        scj = sw[..., sj]
        posed = torch.einsum("...vkab,...vkb->...vka", Rj,
                             vj * scj[..., None]) + tj
        out["verts"] = torch.sum(posed * r.skin_weights[..., None], dim=-2)
    if rig.keypoint_mapping.size:
        km = r.keypoint_mapping
        if "verts" in out:
            vj_cat = torch.cat([out["verts"], tw], dim=-2)
        else:  # joints-only regression (vert columns dropped)
            km = km[:, -J:]
            vj_cat = tw
        out["keypoints"] = torch.einsum("kn,...nd->...kd", km, vj_cat)
    return out


# --------------------------------------------------------------------------
# default 70-joint template (real MHR-70 hierarchy; synthetic numerics)
# --------------------------------------------------------------------------
# anatomical parent of each MHR-70 keypoint: left hip (9) is the root, the
# right hip and the neck (69, the spine chain collapsed) hang off it
MHR70_PARENTS = np.array([
    69,  # 0 nose <- neck
    0, 0, 1, 2,          # eyes <- nose, ears <- eyes
    69, 69,              # 5 l-shoulder, 6 r-shoulder <- neck
    5, 6,                # elbows <- shoulders
    -1, 9,               # 9 l-hip (root), 10 r-hip
    9, 10,               # knees <- hips
    11, 12,              # ankles <- knees
    13, 13, 13,          # l big toe, small toe, heel <- l-ankle
    14, 14, 14,          # r foot <- r-ankle
    # right hand (21-40): tips <- first <- second <- third <- wrist(41)
    22, 23, 24, 41,      # thumb
    26, 27, 28, 41,      # index
    30, 31, 32, 41,      # middle
    34, 35, 36, 41,      # ring
    38, 39, 40, 41,      # pinky
    8,                   # 41 right wrist <- right elbow
    # left hand (42-61), wrist = 62
    43, 44, 45, 62,
    47, 48, 49, 62,
    51, 52, 53, 62,
    55, 56, 57, 62,
    59, 60, 61, 62,
    7,                   # 62 left wrist <- left elbow
    7, 8,                # olecranons <- elbows
    7, 8,                # cubital fossae <- elbows
    5, 6,                # acromions <- shoulders
    9,                   # 69 neck <- root (spine chain collapsed)
], np.int32)

_T = 0.03  # finger segment length (m-scale template; rig units = cm)


def _default_offsets() -> np.ndarray:
    o = np.zeros((70, 3), np.float32)
    o[9] = (0, 0, 0)                    # root (left hip)
    o[10] = (0.18, 0, 0)                # right hip
    o[69] = (0.09, 0.52, 0)             # neck (from root, centered up)
    o[0] = (0, 0.10, 0.08)              # nose
    o[1], o[2] = (-0.03, 0.03, -0.02), (0.03, 0.03, -0.02)
    o[3], o[4] = (-0.05, 0.0, -0.05), (0.05, 0.0, -0.05)
    o[5], o[6] = (-0.18, -0.02, 0), (0.18, -0.02, 0)
    o[7], o[8] = (-0.28, 0, 0), (0.28, 0, 0)      # elbows
    o[62], o[41] = (-0.26, 0, 0), (0.26, 0, 0)    # wrists
    o[11], o[12] = (0, -0.44, 0), (0, -0.44, 0)   # knees
    o[13], o[14] = (0, -0.43, 0), (0, -0.43, 0)   # ankles
    o[15], o[16], o[17] = (-0.02, -0.06, 0.14), (-0.06, -0.06, 0.11), \
        (0, -0.07, -0.04)
    o[18], o[19], o[20] = (0.02, -0.06, 0.14), (0.06, -0.06, 0.11), \
        (0, -0.07, -0.04)
    # finger chains: third<-wrist, second<-third, first<-second, tip<-first
    for wrist, base, sgn in ((41, 21, 1), (62, 42, -1)):
        for f in range(5):
            third = base + 4 * f + 3
            lateral = (f - 2) * 0.018
            o[third] = (sgn * 0.08, -0.01, lateral)
            o[third - 1] = (sgn * _T, 0, 0)
            o[third - 2] = (sgn * _T * 0.8, 0, 0)
            o[third - 3] = (sgn * _T * 0.6, 0, 0)
    o[63], o[64] = (-0.03, 0, -0.03), (0.03, 0, -0.03)  # olecranon
    o[65], o[66] = (-0.02, 0, 0.03), (0.02, 0, 0.03)    # cubital fossa
    o[67], o[68] = (-0.04, 0.03, 0), (0.04, 0.03, 0)    # acromion
    return o * 100.0  # rig units are cm (outputs are divided by 100)


# body model-param index → (template joint, dof) wiring of the default
# template: the 23 3-DoF slots drive the major joints, 1-DoF slots drive
# finger hinges (z-axis), translations drive the neck
_3DOF_JOINTS = [9, 10, 69, 0, 5, 6, 7, 8, 11, 12, 13, 14, 62, 41, 22, 26,
                30, 34, 43, 47, 51, 55, 69]
_1DOF_JOINTS = [21, 23, 24, 25, 27, 28, 29, 31, 32, 33, 35, 36, 37, 39, 40,
                38, 42, 44, 45, 46, 48, 49, 50, 52, 53, 54, 56, 57, 58, 60,
                61, 59, 15, 16, 17, 18, 19, 20, 1, 2, 3, 4, 63, 64, 65, 66,
                67, 68, 23, 24, 27, 31, 35, 39, 44, 48, 52, 56]


def default_rig(num_verts: int = 64) -> MHRRig:
    """70-joint rig over the real MHR-70 hierarchy with skix's synthetic
    parameter wiring and small skinned mesh: the stand-in until a converted
    Momentum asset provides the real arrays. Model-parameter vector:
    ``[tx ty tz (root trans, ×10), gx gy gz (global rot euler), body 130]``
    + ``scales 68`` = 204."""
    J = 70
    P = 136 + 68
    parents = MHR70_PARENTS
    offsets = _default_offsets()
    pre_rot = np.tile(np.eye(3, dtype=np.float32), (J, 1, 1))

    pt = np.zeros((J * 7, P), np.float32)
    root = 9
    for d in range(3):           # global translation: params 0..2
        pt[root * 7 + d, d] = 10.0
    for d in range(3):           # global rotation: params 3..5
        pt[root * 7 + 3 + d, 3 + d] = 1.0
    base = 6                     # body params live at 6..135
    for slot, joint in enumerate(_3DOF_JOINTS):
        for axis, pidx in enumerate(BODY_3DOF_ROT_IDXS[slot]):
            if pidx < 130 and joint != root:
                pt[joint * 7 + 3 + axis, base + pidx] = 1.0
    for slot, joint in enumerate(_1DOF_JOINTS):
        pidx = BODY_1DOF_ROT_IDXS[slot]
        if pidx < 130:
            pt[joint * 7 + 5, base + pidx] += 1.0  # z-hinge
    for d, pidx in enumerate(BODY_1DOF_TRANS_IDXS[:3]):
        if pidx < 130:
            pt[69 * 7 + d, base + pidx] = 1.0  # neck translations
    scale_joints = [9, 10, 11, 12, 13, 14, 5, 6, 41, 62, 7, 8, 69, 0]
    for i in range(68):
        j = scale_joints[i % len(scale_joints)]
        pt[j * 7 + 6, 136 + i] = 1.0 / (1 + i // len(scale_joints))

    # synthetic mesh: vertices scattered around a few body joints
    rng = np.random.default_rng(0)
    anchor_joints = np.array([9, 10, 69, 5, 6, 7, 8, 11, 12, 13, 14, 0],
                             np.int32)
    rest_j = np.zeros((J, 3), np.float32)
    Rw = np.zeros((J, 3, 3), np.float32)
    for j in _topo_order(parents):
        p = int(parents[j])
        if p < 0:
            rest_j[j] = offsets[j]
            Rw[j] = pre_rot[j]
        else:
            rest_j[j] = rest_j[p] + Rw[p] @ offsets[j]
            Rw[j] = Rw[p] @ pre_rot[j]
    vidx = np.arange(num_verts)
    anchors = anchor_joints[vidx % len(anchor_joints)]
    rest_verts = rest_j[anchors] + rng.normal(0, 4.0, (num_verts, 3)).astype(
        np.float32)
    skin_joints = np.stack([anchors, parents[anchors].clip(0)], axis=-1)
    skin_weights = np.tile(np.array([[0.8, 0.2]], np.float32), (num_verts, 1))

    # keypoints = joints themselves (identity over the joint block)
    km = np.zeros((70, num_verts + J), np.float32)
    km[np.arange(70), num_verts + np.arange(70)] = 1.0

    return MHRRig(parents=parents, offsets=offsets, pre_rotation=pre_rot,
                  param_transform=pt, rest_verts=rest_verts,
                  skin_weights=skin_weights, skin_joints=skin_joints,
                  keypoint_mapping=km)


# --------------------------------------------------------------------------
# full parameter assembly
# --------------------------------------------------------------------------
def assemble_model_params(global_trans, global_rot_euler, body_pose_params,
                          hand_pose_params, scale_params, scale_mean,
                          scale_comps, hand_pose_mean=None,
                          hand_pose_comps=None, hand_joint_idxs_left=None,
                          hand_joint_idxs_right=None):
    """``[trans·10, global rot, body(130)] ‖ scales``, with the PCA hands
    dropped in where ``hand_pose_params`` is given."""
    body = body_pose_params[..., :130]
    full = torch.cat([global_trans * 10.0, global_rot_euler, body], dim=-1)
    if hand_pose_params is not None:
        nh = NUM_HAND_CONT
        left = blend_hand_pose(hand_pose_params[..., :nh], hand_pose_mean,
                               hand_pose_comps)
        right = blend_hand_pose(hand_pose_params[..., nh:], hand_pose_mean,
                                hand_pose_comps)
        full = full.clone()
        full[..., hand_joint_idxs_left] = left
        full[..., hand_joint_idxs_right] = right
    scales = scale_mean + torch.einsum("...a,ab->...b", scale_params,
                                       scale_comps)
    return torch.cat([full, scales], dim=-1)


def mhr_output_transform(x: torch.Tensor) -> torch.Tensor:
    """cm → m and the camera-system flip of y and z."""
    return x / 100.0 * constant(_OUT_FLIP, x.device, x.dtype)


# --------------------------------------------------------------------------
# rig and buffer registries: models name a rig, converted assets register
# --------------------------------------------------------------------------
_RIG_REGISTRY: dict = {}


def register_rig(name: str, rig: MHRRig) -> None:
    _RIG_REGISTRY[name] = rig


def get_rig(name: str = "default") -> MHRRig:
    if name not in _RIG_REGISTRY:
        if name != "default":
            raise KeyError(f"unknown rig '{name}' "
                           f"(registered: {list(_RIG_REGISTRY)})")
        _RIG_REGISTRY["default"] = default_rig()
    return _RIG_REGISTRY[name]


class MHRBuffers(NamedTuple):
    """The checkpoint-shaped PCA and metadata buffers of the reference head;
    the defaults are identity stand-ins."""

    scale_mean: np.ndarray        # (68,)
    scale_comps: np.ndarray       # (28, 68)
    hand_pose_mean: np.ndarray    # (54,)
    hand_pose_comps: np.ndarray   # (54, 54)
    hand_joint_idxs_left: np.ndarray   # (27,) into the 136 full params
    hand_joint_idxs_right: np.ndarray  # (27,)

    @classmethod
    def default(cls) -> "MHRBuffers":
        return cls(
            scale_mean=np.zeros(68, np.float32),
            scale_comps=np.eye(28, 68).astype(np.float32),
            hand_pose_mean=np.zeros(54, np.float32),
            hand_pose_comps=np.eye(54, dtype=np.float32),
            # body hand params 62..115 sit at +6 in the [trans(3) rot(3)
            # body(130)] full vector; left first
            hand_joint_idxs_left=np.arange(68, 95, dtype=np.int32),
            hand_joint_idxs_right=np.arange(95, 122, dtype=np.int32),
        )


_BUFFERS_REGISTRY: dict = {}


def register_buffers(name: str, bufs: MHRBuffers) -> None:
    _BUFFERS_REGISTRY[name] = bufs


def get_buffers(name: str = "default") -> MHRBuffers:
    if name not in _BUFFERS_REGISTRY:
        if name != "default":
            raise KeyError(f"unknown buffers '{name}'")
        _BUFFERS_REGISTRY["default"] = MHRBuffers.default()
    return _BUFFERS_REGISTRY[name]
