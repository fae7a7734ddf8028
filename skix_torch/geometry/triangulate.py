"""Multi-view DLT triangulation as batched linear algebra.

Port of ``skix/geometry/triangulate.py``: every point of the clip is one
row of a batched 4×4 ``eigh`` of the weighted DLT normal matrix (the
eigenvector of the smallest eigenvalue, as in skix), in place of skix's
``vmap``. The normal matrix (entries ~1e6 in pixels) is formed and solved
in float64 and the point returned in the inputs' dtype: in float32 two
eigensolvers (LAPACK's, cuSOLVER's, XLA's) land up to ~1e-3 apart at
20 m, in float64 they agree to the float32 result's rounding. Distorted observations are undistorted first
(:func:`undistort_points`, a fixed number of fixed-point steps).
"""

from __future__ import annotations

import torch

from skix_torch.geometry.camera import distort_rational
from skix_torch.utils.device import by_chunks

_EPS = 1e-12


def projection_matrix(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor
                      ) -> torch.Tensor:
    """``P = K [R|t]`` → (..., 3, 4)."""
    return K @ torch.cat([R, t[..., :, None]], dim=-1)


def triangulate_dlt(uv: torch.Tensor, P: torch.Tensor,
                    w: torch.Tensor | None = None) -> torch.Tensor:
    """Triangulate ``(..., C, 2)`` observations with ``(C, 3, 4)`` cameras →
    ``(..., 3)``. ``w``: optional ``(..., C)`` per-view weights (0 = ignore
    the view)."""
    if w is None:
        w = torch.ones(uv.shape[:-1], dtype=uv.dtype, device=uv.device)
    dtype = uv.dtype
    uv, P, w = uv.double(), P.double(), w.double()
    u = uv[..., 0:1]                                  # (..., C, 1)
    v = uv[..., 1:2]
    r1 = u * P[:, 2, :] - P[:, 0, :]                  # (..., C, 4)
    r2 = v * P[:, 2, :] - P[:, 1, :]
    A = torch.cat([r1, r2], dim=-2)                   # (..., 2C, 4)
    A = A * torch.cat([w, w], dim=-1)[..., None]
    M = A.transpose(-1, -2) @ A                       # (..., 4, 4)
    _, evecs = by_chunks(torch.linalg.eigh, M)
    X = evecs[..., :, 0]                              # smallest eigenvalue
    d = X[..., 3:4]
    return (X[..., :3] / torch.where(d.abs() < _EPS, _EPS, d)).to(dtype)


def triangulate_sequence(kpts_a, kpts_b, K, R, t, w_a=None, w_b=None,
                         dist=None, K_b=None) -> torch.Tensor:
    """Two-view clip triangulation: ``kpts_a/kpts_b (T, J, 2)`` pixels in
    view A (``P1 = K [I|0]``) and view B (``P2 = K_b [R|t]``, ``K_b``
    defaults to ``K``); ``w_* (T, J)`` confidences; ``dist`` optional
    rational distortion of both views. Returns ``(T, J, 3)`` points in
    view-A camera coordinates."""
    if K_b is None:
        K_b = K
    if dist is not None:
        kpts_a = undistort_points(kpts_a, K, dist)
        kpts_b = undistort_points(kpts_b, K_b, dist)
    eye = torch.eye(3, dtype=kpts_a.dtype, device=kpts_a.device)
    zero = torch.zeros(3, dtype=kpts_a.dtype, device=kpts_a.device)
    P = torch.stack([projection_matrix(K, eye, zero),
                     projection_matrix(K_b, R, t)])   # (2, 3, 4)
    uv = torch.stack([kpts_a, kpts_b], dim=-2)        # (T, J, 2, 2)
    if w_a is None and w_b is None:
        w = None
    else:
        ones = torch.ones(kpts_a.shape[:-1], dtype=kpts_a.dtype,
                          device=kpts_a.device)
        w = torch.stack([ones if w_a is None else w_a,
                         ones if w_b is None else w_b], dim=-1)
    return triangulate_dlt(uv, P, w)


def undistort_points(uv: torch.Tensor, K: torch.Tensor, dist, iters: int = 8
                     ) -> torch.Tensor:
    """Invert the rational distortion by ``iters`` fixed-point steps
    (cv2.undistortPoints semantics); returns pixels re-projected through
    ``K`` with zero distortion."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xd = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)
    xn = xd
    for _ in range(iters):
        xn = xn - (distort_rational(xn, dist) - xd)
    return torch.stack([xn[..., 0] * fx + cx, xn[..., 1] * fy + cy], dim=-1)


def positive_depth_mask(X: torch.Tensor, R: torch.Tensor, t: torch.Tensor
                        ) -> torch.Tensor:
    """Cheirality: is each point (view-A coordinates) in front of both
    cameras, the second at ``(R, t)``?"""
    z2 = (torch.einsum("ij,...j->...i", R, X) + t)[..., 2]
    return (X[..., 2] > 0) & (z2 > 0)
