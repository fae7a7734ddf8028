"""Rigid / similarity alignment: Umeyama and Kabsch with validity weights.

Port of ``skix/geometry/rigid.py``, batched: every function takes point
sets ``(..., N, 3)`` and solves all leading-axis problems with one batched
3×3 SVD (skix ``vmap``s its per-frame solve). Convention: find (s, R, t)
with ``s · R @ y + t ≈ x``; a weight of 0 drops a point.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-9


class RigidTransform(NamedTuple):
    s: torch.Tensor  # (...,) scale
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    def apply(self, y: torch.Tensor) -> torch.Tensor:
        """``s · R y + t`` for points ``y (..., N, 3)``."""
        return (self.s[..., None, None] * (y @ self.R.transpose(-1, -2))
                + self.t[..., None, :])


def umeyama(x: torch.Tensor, y: torch.Tensor, w=None,
            allow_scale: bool = False) -> RigidTransform:
    """Weighted Umeyama: (s, R, t) minimizing Σ wᵢ‖s·R yᵢ + t − xᵢ‖² per
    leading index. ``x, y (..., N, 3)``; ``w (..., N)``. ``allow_scale=False``
    is weighted Kabsch (s = 1). Reflections are corrected by the sign of
    det(U Vᵀ)."""
    if w is None:
        w = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    w = w.to(x.dtype)
    wn = w / (w.sum(-1, keepdim=True) + _EPS)
    mu_x = torch.sum(wn[..., None] * x, dim=-2)
    mu_y = torch.sum(wn[..., None] * y, dim=-2)
    xc = x - mu_x[..., None, :]
    yc = y - mu_y[..., None, :]
    sigma = torch.einsum("...ni,...n,...nj->...ij", yc, wn, xc)
    U, S, Vt = torch.linalg.svd(sigma)
    sign = torch.sign(torch.linalg.det(U @ Vt))
    d = torch.stack([torch.ones_like(sign), torch.ones_like(sign), sign], -1)
    R = ((U * d[..., None, :]) @ Vt).transpose(-1, -2)
    if allow_scale:
        var_y = torch.sum(wn * torch.sum(yc * yc, dim=-1), dim=-1)
        s = torch.sum(S * d, dim=-1) / (var_y + _EPS)
    else:
        s = torch.ones(x.shape[:-2], dtype=x.dtype, device=x.device)
    t = mu_x - s[..., None] * (R @ mu_y[..., None])[..., 0]
    return RigidTransform(s=s, R=R, t=t)


def kabsch(x, y, w=None) -> RigidTransform:
    """Rigid (no-scale) special case."""
    return umeyama(x, y, w=w, allow_scale=False)


def rigid_validity(tr: RigidTransform, x, y, w=None) -> dict:
    """Validity report of a transform: orthonormality, determinant, weighted
    RMS residual and pairwise-distance preservation (scale-adjusted)."""
    if w is None:
        w = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    w = w.to(x.dtype)
    wn = w / (w.sum(-1, keepdim=True) + _EPS)
    R = tr.R
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    ortho_err = torch.linalg.norm(R @ R.transpose(-1, -2) - eye, dim=(-2, -1))
    resid = torch.sqrt(torch.sum(wn * torch.sum((tr.apply(y) - x) ** 2, -1), -1))
    dx = torch.linalg.norm(x[..., :, None, :] - x[..., None, :, :], dim=-1)
    dy = (torch.linalg.norm(y[..., :, None, :] - y[..., None, :, :], dim=-1)
          * tr.s[..., None, None])
    ww = wn[..., :, None] * wn[..., None, :]
    pd_err = torch.sqrt(torch.sum(ww * (dx - dy) ** 2, dim=(-2, -1))
                        / (torch.sum(ww, dim=(-2, -1)) + _EPS))
    return {"ortho_error": ortho_err, "det": torch.linalg.det(R),
            "rms_residual": resid, "pairwise_dist_rms": pd_err}


def procrustes_align(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Similarity-align ``pred (..., J, 3)`` onto ``gt``; returns the aligned
    prediction (P-MPJPE)."""
    return umeyama(gt, pred, allow_scale=True).apply(pred)
