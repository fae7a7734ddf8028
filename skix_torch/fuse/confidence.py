"""Fusion confidence models, batched over whole clips.

Port of ``skix/fuse/confidence.py``: the weak-perspective reprojection
confidence (a fit ``u ≈ s·X·M + t`` with orthonormal M from the SVD of the
weighted 3×2 cross-covariance, confidence ``exp(−err²/2σ_px²)``) and the
cross-view consistency confidence on canonicalized poses (pelvis origin,
hip x-axis, hip→shoulder y, hip-width scale). Every frame of the clip is
one row of a batched SVD; invalid joints get weight 0 in the fit and
confidence 0 out.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def _finite_mask(x: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(x).all(dim=-1)


def fit_weak_perspective(X3d: torch.Tensor, U2d: torch.Tensor, w=None):
    """Weighted weak-perspective fit per leading index: ``X3d (..., J, 3)``,
    ``U2d (..., J, 2)``, ``w (..., J)`` → (s (...), M (..., 3, 2), t (..., 2)).
    M has orthonormal columns; s is the constrained least-squares scale."""
    if w is None:
        w = torch.ones(X3d.shape[:-1], dtype=X3d.dtype, device=X3d.device)
    w = w.to(X3d.dtype)
    wn = w / (w.sum(-1, keepdim=True) + _EPS)
    mu_x = torch.sum(wn[..., None] * X3d, dim=-2)
    mu_u = torch.sum(wn[..., None] * U2d, dim=-2)
    Xc = X3d - mu_x[..., None, :]
    Uc = U2d - mu_u[..., None, :]
    C = torch.einsum("...ji,...j,...jk->...ik", Xc, wn, Uc)      # (..., 3, 2)
    U, S, Vt = torch.linalg.svd(C, full_matrices=True)
    M = U[..., :, :2] @ Vt
    denom = torch.sum(wn[..., None] * Xc * Xc, dim=(-2, -1))
    s = S.sum(-1) / torch.where(denom < 1e-12, 1e-12, denom)
    t = mu_u - s[..., None] * (mu_x[..., None, :] @ M)[..., 0, :]
    return s, M, t


def weakpersp_reproj_confidence(X3d: torch.Tensor, U2d: torch.Tensor,
                                valid=None, sigma_px: float = 12.0):
    """Per-joint confidence from a weak-perspective fit per frame:
    ``X3d (T,J,3)``, ``U2d (T,J,2)``, ``valid (T,J)`` → ``(conf (T,J),
    err_px (T,J))``; invalid joints: conf 0, err inf, left out of the fit."""
    if valid is None:
        valid = _finite_mask(X3d) & _finite_mask(U2d)
    s, M, t = fit_weak_perspective(X3d, U2d, valid.to(X3d.dtype))
    Uhat = s[..., None, None] * (X3d @ M) + t[..., None, :]
    err = torch.linalg.norm(Uhat - U2d, dim=-1)
    sig2 = max(float(sigma_px), _EPS) ** 2
    conf = torch.where(valid, torch.exp(-(err ** 2) / (2.0 * sig2)), 0.0)
    return conf, torch.where(valid, err, torch.inf)


def canonicalize_pose_3d(X: torch.Tensor, root_idx: int, left_hip_idx: int,
                         right_hip_idx: int, left_shoulder_idx: int,
                         right_shoulder_idx: int, scale_mode: str = "hip"):
    """Canonical frame per pose ``X (..., J, 3)`` → ``(Xc (..., J, 3),
    ok (...,))``; ``ok`` flags a well-conditioned canonicalization (finite
    key joints, non-degenerate axes and scale)."""
    root = X[..., root_idx, :]
    X0 = X - root[..., None, :]
    Lh, Rh = X0[..., left_hip_idx, :], X0[..., right_hip_idx, :]
    Ls, Rs = X0[..., left_shoulder_idx, :], X0[..., right_shoulder_idx, :]
    mid_hip = 0.5 * (Lh + Rh)
    mid_sh = 0.5 * (Ls + Rs)

    def norml(v):
        n = torch.linalg.norm(v, dim=-1, keepdim=True)
        return v / torch.where(n < _EPS, 1.0, n), n[..., 0]

    x_axis, nx = norml(Rh - Lh)
    y_raw, ny = norml(mid_sh - mid_hip)
    z_axis, nz = norml(torch.linalg.cross(x_axis, y_raw))
    y_axis, _ = norml(torch.linalg.cross(z_axis, x_axis))
    R = torch.stack([x_axis, y_axis, z_axis], dim=-2)
    Xr = torch.einsum("...ij,...nj->...ni", R, X0)
    if scale_mode == "hip":
        s = torch.linalg.norm(Rh - Lh, dim=-1)
    elif scale_mode == "torso":
        s = torch.linalg.norm(mid_sh - mid_hip, dim=-1)
    else:
        raise ValueError("scale_mode must be 'hip' or 'torso'")
    key = torch.stack([root, Lh, Rh, Ls, Rs], dim=-2)
    ok = (torch.isfinite(key).all(dim=-1).all(dim=-1) & (s > _EPS)
          & (nx > _EPS) & (ny > _EPS) & (nz > _EPS))
    return Xr / torch.where(s < _EPS, 1.0, s)[..., None, None], ok


def crossview_consistency_confidence(X_a, X_b, root_idx: int,
                                     left_hip_idx: int, right_hip_idx: int,
                                     left_shoulder_idx: int,
                                     right_shoulder_idx: int,
                                     sigma_3d: float = 0.08,
                                     scale_mode: str = "hip", valid_a=None,
                                     valid_b=None):
    """Per-joint cross-view agreement ``X_a, X_b (T,J,3)`` → ``(conf (T,J),
    dist (T,J))``; a frame whose canonicalization is degenerate gives 0."""
    idx = (root_idx, left_hip_idx, right_hip_idx, left_shoulder_idx,
           right_shoulder_idx)
    Xa_c, ok_a = canonicalize_pose_3d(X_a, *idx, scale_mode=scale_mode)
    Xb_c, ok_b = canonicalize_pose_3d(X_b, *idx, scale_mode=scale_mode)
    va = _finite_mask(X_a) if valid_a is None else valid_a.bool()
    vb = _finite_mask(X_b) if valid_b is None else valid_b.bool()
    valid = va & vb & ok_a[..., None] & ok_b[..., None]
    dist = torch.linalg.norm(torch.where(valid[..., None], Xa_c - Xb_c, 0.0),
                             dim=-1)
    sig2 = max(float(sigma_3d), _EPS) ** 2
    conf = torch.where(valid, torch.exp(-(dist ** 2) / (2.0 * sig2)), 0.0)
    return conf, torch.where(valid, dist, torch.inf)
