"""GT-based and GT-free sequence evaluation.

Port of ``skix/metrics/evaluation.py``: temporal jitter and acceleration,
bone-length CV, L/R symmetry, the GT-free fusion report and the
before/after-fusion MPJPE report, clip at once on tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from skix_torch.metrics.losses import mpjpe, per_joint_error

_EPS = 1e-9


def temporal_metrics(X: torch.Tensor, valid=None) -> dict:
    """Jitter (mean first-difference speed) and acceleration (mean second
    difference) over joint-frames (valid ones only, given ``valid (T, J)``)."""
    vel = X[1:] - X[:-1]
    acc = X[2:] - 2 * X[1:-1] + X[:-2]
    if valid is None:
        return {"jitter": torch.linalg.norm(vel, dim=-1).mean(),
                "accel": torch.linalg.norm(acc, dim=-1).mean()}
    valid = valid.bool()
    v_ok = (valid[1:] & valid[:-1])[..., None]
    a_ok = (valid[2:] & valid[1:-1] & valid[:-2])[..., None]
    vel = torch.where(v_ok, vel, 0.0)
    acc = torch.where(a_ok, acc, 0.0)
    return {"jitter": torch.linalg.norm(vel, dim=-1).sum() / (v_ok.sum() + _EPS),
            "accel": torch.linalg.norm(acc, dim=-1).sum() / (a_ok.sum() + _EPS)}


def bone_length_cv(X: torch.Tensor, bones, valid=None) -> torch.Tensor:
    """Mean coefficient of variation of bone lengths over time."""
    a = [i for i, _ in bones]
    b = [j for _, j in bones]
    L = torch.linalg.norm(X[:, a] - X[:, b], dim=-1)          # (T, B)
    if valid is not None:
        valid = valid.bool()
        ok = valid[:, a] & valid[:, b]
        n = ok.sum(0) + _EPS
        mean = torch.where(ok, L, 0.0).sum(0) / n
        var = torch.where(ok, (L - mean) ** 2, 0.0).sum(0) / n
    else:
        mean = L.mean(0)
        var = L.var(0, correction=0)
    return (torch.sqrt(var) / (mean + _EPS)).mean()


def symmetry_error(X: torch.Tensor, symmetric_bones) -> torch.Tensor:
    """Mean relative L/R bone-length asymmetry."""
    errs = []
    for (li, lj), (ri, rj) in symmetric_bones:
        ll = torch.linalg.norm(X[..., li, :] - X[..., lj, :], dim=-1)
        lr = torch.linalg.norm(X[..., ri, :] - X[..., rj, :], dim=-1)
        errs.append((ll - lr).abs() / (0.5 * (ll + lr) + _EPS))
    return torch.stack(errs).mean()


def eval_fused_sequence(fused, left, right, bones, symmetric_bones,
                        valid=None) -> dict:
    """GT-free fusion report: bone CV, symmetry, fused-vs-input distances,
    jitter and acceleration."""
    rep = {
        "bone_cv": bone_length_cv(fused, bones, valid),
        "symmetry": symmetry_error(fused, symmetric_bones),
        "dist_to_left": torch.linalg.norm(fused - left, dim=-1).mean(),
        "dist_to_right": torch.linalg.norm(fused - right, dim=-1).mean(),
    }
    rep.update(temporal_metrics(fused, valid))
    return rep


def before_after_fusion_report(gt, left=None, right=None, fused=None,
                               smoothed=None, valid=None) -> dict:
    """MPJPE of every available stage output against GT, and the fused
    output's %-improvement over the best single view."""
    out: dict = {}
    singles = []
    for name, x in (("left", left), ("right", right)):
        if x is not None:
            e = float(mpjpe(x, gt, valid))
            out[f"mpjpe_{name}"] = e
            singles.append(e)
    for name, x in (("fused", fused), ("smoothed", smoothed)):
        if x is not None:
            out[f"mpjpe_{name}"] = float(mpjpe(x, gt, valid))
            out[f"per_joint_{name}"] = np.asarray(
                per_joint_error(x, gt).mean(0).cpu())
    if singles and fused is not None:
        best = min(singles)
        out["improvement_pct"] = 100.0 * (best - out["mpjpe_fused"]) / (best + _EPS)
    return out
