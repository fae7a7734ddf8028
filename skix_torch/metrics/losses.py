"""Pose-error metrics (the MPJPE family).

Port of ``skix/metrics/losses.py`` (the reference VideoPose3D
common/loss.py semantics), on tensors batched over leading axes.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def mpjpe(pred: torch.Tensor, gt: torch.Tensor, valid=None) -> torch.Tensor:
    """Mean per-joint position error; ``valid`` an optional bool mask
    broadcastable to ``pred.shape[:-1]``."""
    d = torch.linalg.norm(pred - gt, dim=-1)
    if valid is None:
        return d.mean()
    valid = torch.broadcast_to(valid.bool(), d.shape)
    return torch.where(valid, d, 0.0).sum() / (valid.sum() + _EPS)


def weighted_mpjpe(pred, gt, w) -> torch.Tensor:
    """Per-joint weighted MPJPE."""
    return (w * torch.linalg.norm(pred - gt, dim=-1)).mean()


def _procrustes_align_batch(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Similarity-align each ``(J, 3)`` pred onto gt (closed-form Umeyama)."""
    mu_p = pred.mean(dim=-2, keepdim=True)
    mu_g = gt.mean(dim=-2, keepdim=True)
    pc, gc = pred - mu_p, gt - mu_g
    norm_p = torch.sqrt(torch.sum(pc ** 2, dim=(-2, -1), keepdim=True)) + _EPS
    norm_g = torch.sqrt(torch.sum(gc ** 2, dim=(-2, -1), keepdim=True)) + _EPS
    H = torch.einsum("...ji,...jk->...ik", pc / norm_p, gc / norm_g)
    U, S, Vt = torch.linalg.svd(H)
    sign = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.ones(H.shape[:-2] + (3,), dtype=pred.dtype, device=pred.device)
    D[..., -1] = sign
    R = (U * D[..., None, :]) @ Vt
    scale = torch.sum(S * D, dim=-1)[..., None, None] * norm_g / norm_p
    return scale * torch.einsum("...ji,...kj->...ki", R, pc) + mu_g


def p_mpjpe(pred, gt) -> torch.Tensor:
    """Procrustes-aligned MPJPE over ``(..., J, 3)`` (protocol #2)."""
    aligned = _procrustes_align_batch(pred, gt)
    return torch.linalg.norm(aligned - gt, dim=-1).mean()


def n_mpjpe(pred, gt) -> torch.Tensor:
    """Scale-normalized MPJPE (optimal per-sample scale on pred)."""
    num = torch.sum(pred * gt, dim=(-2, -1), keepdim=True)
    den = torch.sum(pred * pred, dim=(-2, -1), keepdim=True) + _EPS
    return mpjpe(pred * num / den, gt)


def mean_velocity_error(pred, gt, axis: int = 0) -> torch.Tensor:
    """MPJVE: mean per-joint first-difference error."""
    return torch.linalg.norm(torch.diff(pred, dim=axis)
                             - torch.diff(gt, dim=axis), dim=-1).mean()


def per_joint_error(pred, gt) -> torch.Tensor:
    """``(..., J)`` per-joint errors."""
    return torch.linalg.norm(pred - gt, dim=-1)
