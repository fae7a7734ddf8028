"""Multi-view DLT triangulation as batched linear algebra.

Port of ``skix/geometry/triangulate.py``: every point of the clip is one
row of a batched 4×4 ``eigh`` of the weighted DLT normal matrix (the
eigenvector of the smallest eigenvalue, as in skix), in place of skix's
``vmap``. The lens-distortion path waits for the kernel-free chain.
"""

from __future__ import annotations

import torch

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
    w = w.to(uv.dtype)
    u = uv[..., 0:1]                                  # (..., C, 1)
    v = uv[..., 1:2]
    r1 = u * P[:, 2, :] - P[:, 0, :]                  # (..., C, 4)
    r2 = v * P[:, 2, :] - P[:, 1, :]
    A = torch.cat([r1, r2], dim=-2)                   # (..., 2C, 4)
    A = A * torch.cat([w, w], dim=-1)[..., None]
    M = A.transpose(-1, -2) @ A                       # (..., 4, 4)
    _, evecs = torch.linalg.eigh(M)
    X = evecs[..., :, 0]                              # smallest eigenvalue
    d = X[..., 3:4]
    return X[..., :3] / torch.where(d.abs() < _EPS, _EPS, d)


def triangulate_sequence(kpts_a, kpts_b, K, R, t, w_a=None, w_b=None,
                         K_b=None) -> torch.Tensor:
    """Two-view clip triangulation: ``kpts_a/kpts_b (T, J, 2)`` pixels in
    view A (``P1 = K [I|0]``) and view B (``P2 = K_b [R|t]``, ``K_b``
    defaults to ``K``); ``w_* (T, J)`` confidences. Returns ``(T, J, 3)``
    points in view-A camera coordinates."""
    if K_b is None:
        K_b = K
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
