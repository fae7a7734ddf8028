"""Rotation representations: quaternions (w, x, y, z) and rotation vectors.

Port of ``skix/geometry/rotations.py``. Batched over leading axes and safe under
``torch.func`` transforms: the exp and log maps keep their Taylor guards
at θ → 0, so Jacobian products through the LM solver stay finite.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v (..., 3)`` by quaternions ``q (..., 4)``."""
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v)
    uuv = torch.linalg.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qinverse(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``a ⊗ b`` of ``(..., 4)`` quaternions."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion ``(..., 4)`` → rotation matrix ``(..., 3, 3)``."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(*q.shape[:-1], 3, 3)


def _hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of ``v (..., 3)`` → ``(..., 3, 3)``."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                       dim=-1).reshape(*v.shape[:-1], 3, 3)


def rotvec_to_matrix(rv: torch.Tensor) -> torch.Tensor:
    """Exponential map: rotation vector ``(..., 3)`` → matrix ``(..., 3, 3)``
    (Rodrigues, with series guards near θ = 0)."""
    theta2 = torch.sum(rv * rv, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2.clamp(min=1e-16))
    K = _hat(rv)
    eye = torch.eye(3, dtype=rv.dtype, device=rv.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``(..., 3, 3)`` → unit quaternion ``(..., 4)``
    (w, x, y, z), w ≥ 0. Shepperd's method: all four candidates, the one
    with the largest diagonal term selected (branchless)."""
    def m(i, j):
        return R[..., i, j]

    tr = m(0, 0) + m(1, 1) + m(2, 2)

    def cand(s4, a, b, c, order):
        s = 2.0 * torch.sqrt(torch.clamp(s4, min=_EPS))
        vals = [s * 0.25, a / s, b / s, c / s]
        out = [None] * 4
        for pos, idx in enumerate(order):
            out[idx] = vals[pos]
        return torch.stack(out, dim=-1)

    q0 = cand(1.0 + tr, m(2, 1) - m(1, 2), m(0, 2) - m(2, 0),
              m(1, 0) - m(0, 1), (0, 1, 2, 3))
    q1 = cand(1.0 + m(0, 0) - m(1, 1) - m(2, 2),
              m(2, 1) - m(1, 2), m(0, 1) + m(1, 0), m(0, 2) + m(2, 0),
              (1, 0, 2, 3))
    q2 = cand(1.0 + m(1, 1) - m(0, 0) - m(2, 2),
              m(0, 2) - m(2, 0), m(0, 1) + m(1, 0), m(1, 2) + m(2, 1),
              (2, 0, 1, 3))
    q3 = cand(1.0 + m(2, 2) - m(0, 0) - m(1, 1),
              m(1, 0) - m(0, 1), m(0, 2) + m(2, 0), m(1, 2) + m(2, 1),
              (3, 0, 1, 2))
    scores = torch.stack([1.0 + tr,
                          1.0 + m(0, 0) - m(1, 1) - m(2, 2),
                          1.0 + m(1, 1) - m(0, 0) - m(2, 2),
                          1.0 + m(2, 2) - m(0, 0) - m(1, 1)], dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)           # (..., 4 cases, 4)
    best = torch.argmax(scores, dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(qs, -2, idx)[..., 0, :]
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def matrix_to_rotvec(R: torch.Tensor) -> torch.Tensor:
    """Log map: rotation matrix ``(..., 3, 3)`` → rotation vector ``(..., 3)``
    through the quaternion (stable at θ → 0 and θ → π)."""
    q = matrix_to_quat(R)
    w = q[..., 0]
    xyz = q[..., 1:]
    n = torch.linalg.norm(xyz, dim=-1)
    theta = 2.0 * torch.atan2(n, w)
    small = n < 1e-6
    scale = torch.where(small, 2.0, theta / torch.where(small, 1.0, n))
    return xyz * scale[..., None]


def rot6d_to_matrix(x: torch.Tensor) -> torch.Tensor:
    """Continuous 6D representation ``(..., 6)`` → rotation matrix
    ``(..., 3, 3)`` by Gram–Schmidt (the two vectors are its columns)."""
    a1, a2 = x[..., :3], x[..., 3:]
    b1 = a1 / (torch.linalg.norm(a1, dim=-1, keepdim=True) + _EPS)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / (torch.linalg.norm(a2p, dim=-1, keepdim=True) + _EPS)
    b3 = torch.linalg.cross(b1, b2)
    return torch.stack([b1, b2, b3], dim=-1)


def matrix_to_rot6d(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → 6D: its first two columns, concatenated."""
    return torch.cat([R[..., :, 0], R[..., :, 1]], dim=-1)
