"""Multi-view bundle adjustment: the reference's five losses + LM and Adam.

Port of ``skix/solvers/ba.py``: ``method="lm"`` (matrix-free
Levenberg–Marquardt, ``skix_torch.solvers.lm``) or ``method="adam"``
(optax's Adam, written out, over ½‖r‖² for ``adam_iters`` steps). The same
five terms (confidence-weighted
reprojection, camera-center temporal smoothness, baseline regularizer,
12-bone length consistency, pose temporal smoothness), the same modes
(``pose_only`` = joints, ``pose_cam_t`` = joints + translations, ``full`` =
joints + rotations + translations) and the same flat parameter order
(free names sorted, as ``ravel_pytree`` orders a dict). Rotations are
optimized as rotation vectors through the exact SO(3) exp map;
``stop_gradient`` becomes ``.detach()``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from skix_torch.geometry.rotations import matrix_to_rotvec, rotvec_to_matrix
from skix_torch.geometry.skeletons import COCO_BONES_12
from skix_torch.solvers.lm import levenberg_marquardt

_EPS = 1e-9


def project_tcj(X, R, t, K):
    """World joints ``(T, J, 3)`` through ``R (C,3,3) | (T,C,3,3)``,
    ``t (C,3) | (T,C,3)``, ``K (C,3,3) | (3,3)`` → pixels ``(T, C, J, 2)``
    (z clamped at 1e-6, linear intrinsics)."""
    if K.dim() == 2:
        C = R.shape[0] if R.dim() == 3 else R.shape[1]
        K = K.expand(C, 3, 3)
    if R.dim() == 3:
        Xc = torch.einsum("cij,tnj->tcni", R, X) + t[None, :, None, :]
    else:
        Xc = torch.einsum("tcij,tnj->tcni", R, X) + t[:, :, None, :]
    z = torch.clamp(Xc[..., 2:3], min=1e-6)
    xy = Xc[..., :2] / z
    fx = K[..., 0, 0][None, :, None]
    fy = K[..., 1, 1][None, :, None]
    cx = K[..., 0, 2][None, :, None]
    cy = K[..., 1, 2][None, :, None]
    return torch.stack([xy[..., 0] * fx + cx, xy[..., 1] * fy + cy], dim=-1)


def camera_centers(R, t):
    """C = −Rᵀt, shape of t."""
    return -torch.einsum("...ji,...j->...i", R, t)


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Weights and solver settings (defaults = reference configs/vggt.yaml:43-53)."""

    w_reproj: float = 1.0
    w_cam_smooth: float = 0.1
    w_baseline: float = 0.01
    w_bone: float = 0.1
    w_temporal: float = 0.1
    mode: str = "full"            # pose_only | pose_cam_t | full
    method: str = "lm"            # lm | adam
    max_steps: int = 50           # LM outer steps
    cg_iters: int = 30
    adam_iters: int = 2000
    adam_lr: float = 1e-2         # reference's intended lr
    bones: tuple = COCO_BONES_12


def _bone_index(cfg: BAConfig, device) -> torch.Tensor:
    return torch.as_tensor(cfg.bones, dtype=torch.long,
                           device=device).reshape(-1, 2)


def ba_loss_terms(X, rvec, tvec, K, x2d, conf2d, cfg: BAConfig,
                  ref_bone_len=None) -> dict:
    """The five scalar loss terms, reference-weighted."""
    R = rotvec_to_matrix(rvec)
    pred = project_tcj(X, R, tvec, K)
    d2 = torch.sum((pred - x2d) ** 2, dim=-1)
    reproj = cfg.w_reproj * torch.sum(conf2d * d2) / (torch.sum(conf2d) + 1e-6)
    zero = torch.zeros((), dtype=X.dtype, device=X.device)

    C = camera_centers(R, tvec)
    if C.dim() == 3:
        cam_smooth = cfg.w_cam_smooth * torch.mean((C[1:] - C[:-1]) ** 2)
        Cb = C
    else:
        cam_smooth = zero
        Cb = C[None]
    if Cb.shape[1] >= 2:
        baseline = torch.linalg.norm(Cb[:, 0] - Cb[:, 1], dim=-1)
        base_mean = baseline.mean().detach()
        baseline_reg = cfg.w_baseline * torch.mean((baseline - base_mean) ** 2)
    else:
        baseline_reg = zero

    bones = _bone_index(cfg, X.device)
    if len(bones):
        L = torch.linalg.norm(X[:, bones[:, 0]] - X[:, bones[:, 1]], dim=-1)
        ref = (L.mean(dim=0, keepdim=True).detach() if ref_bone_len is None
               else ref_bone_len[None, :])
        bone = cfg.w_bone * torch.mean((L - ref) ** 2)
    else:
        bone = zero

    temporal = (cfg.w_temporal * torch.mean((X[1:] - X[:-1]) ** 2)
                if X.shape[0] >= 2 else zero)
    return {"reprojection": reproj, "camera_smooth": cam_smooth,
            "baseline_reg": baseline_reg, "bone_length": bone,
            "pose_temporal": temporal}


def _residual_blocks(X, rvec, tvec, K, x2d, conf2d, cfg: BAConfig,
                     ref_bone_len=None):
    """Least-squares residual vector whose ½‖r‖² ≈ Σ loss terms."""
    R = rotvec_to_matrix(rvec)
    pred = project_tcj(X, R, tvec, K)
    w_r = torch.sqrt(2.0 * cfg.w_reproj * conf2d / (torch.sum(conf2d) + 1e-6))
    parts = [(w_r[..., None] * (pred - x2d)).reshape(-1)]

    C = camera_centers(R, tvec)
    if C.dim() == 3:
        d = C[1:] - C[:-1]
        parts.append((2.0 * cfg.w_cam_smooth / d.numel()) ** 0.5 * d.reshape(-1))
        Cb = C
    else:
        Cb = C[None]
    if Cb.shape[1] >= 2:
        baseline = torch.linalg.norm(Cb[:, 0] - Cb[:, 1], dim=-1)
        base_mean = baseline.mean().detach()
        parts.append((2.0 * cfg.w_baseline / baseline.numel()) ** 0.5
                     * (baseline - base_mean).reshape(-1))

    bones = _bone_index(cfg, X.device)
    if len(bones):
        seg = X[:, bones[:, 0]] - X[:, bones[:, 1]]
        L = torch.linalg.norm(seg + _EPS, dim=-1)
        ref = (L.mean(dim=0, keepdim=True).detach() if ref_bone_len is None
               else ref_bone_len[None, :])
        parts.append((2.0 * cfg.w_bone / L.numel()) ** 0.5
                     * (L - ref).reshape(-1))

    if X.shape[0] >= 2:
        dX = X[1:] - X[:-1]
        parts.append((2.0 * cfg.w_temporal / dX.numel()) ** 0.5
                     * dX.reshape(-1))
    return torch.cat(parts)


def _adam_run(residual_fn, iters: int, lr: float, flat0: torch.Tensor,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """``iters`` Adam steps (optax's ``adam``: bias-corrected moments, eps
    outside the square root) on ``½‖residual_fn(x)‖²`` from ``flat0``.
    Returns ``(x, loss at flat0, loss at x)``."""
    def loss_fn(x):
        r = residual_fn(x)
        return 0.5 * torch.dot(r, r)

    grad_and_loss = torch.func.grad_and_value(loss_fn)
    x = flat0.detach()
    mu = torch.zeros_like(x)
    nu = torch.zeros_like(x)
    first = None
    for step in range(1, iters + 1):
        g, loss = grad_and_loss(x)
        if first is None:
            first = loss
        mu = b1 * mu + (1.0 - b1) * g
        nu = b2 * nu + (1.0 - b2) * g * g
        mu_hat = mu / (1.0 - b1 ** step)
        nu_hat = nu / (1.0 - b2 ** step)
        x = x - lr * mu_hat / (torch.sqrt(nu_hat) + eps)
    return x, first if first is not None else loss_fn(x), loss_fn(x)


class BAResult(NamedTuple):
    X: torch.Tensor            # (T, J, 3) refined joints
    R: torch.Tensor            # (C, 3, 3) or (T, C, 3, 3)
    t: torch.Tensor            # (C, 3) or (T, C, 3)
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: int
    losses: dict               # final loss-term breakdown


def bundle_adjust(X_init, R_init, t_init, K, x2d, conf2d=None,
                  cfg: Optional[BAConfig] = None, ref_bone_len=None
                  ) -> BAResult:
    """Refine joints and/or cameras against 2D observations.

    ``X_init (T,J,3)``; ``R_init (C,3,3)|(T,C,3,3)``; ``t_init`` matching;
    ``K (C,3,3)``; ``x2d (T,C,J,2)``; ``conf2d (T,C,J)`` (None → ones). All
    float32 tensors on one device.
    """
    cfg = cfg or BAConfig()
    if cfg.mode not in ("pose_only", "pose_cam_t", "full"):
        raise ValueError(f"unknown BA mode {cfg.mode!r}")
    if cfg.method not in ("lm", "adam"):
        raise ValueError(f"unknown BA method {cfg.method!r}")
    if conf2d is None:
        conf2d = torch.ones(x2d.shape[:-1], dtype=x2d.dtype, device=x2d.device)
    rvec_init = matrix_to_rotvec(R_init)

    free = {"X": X_init}
    frozen = {}
    (free if cfg.mode in ("pose_cam_t", "full") else frozen)["tvec"] = t_init
    (free if cfg.mode == "full" else frozen)["rvec"] = rvec_init
    names = sorted(free)
    shapes = [free[k].shape for k in names]
    sizes = [free[k].numel() for k in names]
    flat0 = torch.cat([free[k].reshape(-1) for k in names])

    def unravel(flat):
        p = dict(frozen)
        for k, shp, piece in zip(names, shapes, torch.split(flat, sizes)):
            p[k] = piece.reshape(shp)
        return p

    def residual_fn(flat):
        p = unravel(flat)
        return _residual_blocks(p["X"], p["rvec"], p["tvec"], K, x2d,
                                conf2d, cfg, ref_bone_len)

    if cfg.method == "lm":
        res = levenberg_marquardt(residual_fn, flat0, max_steps=cfg.max_steps,
                                  cg_iters=cfg.cg_iters)
        flat, init_cost, final_cost, iters = (res.x, res.initial_cost,
                                              res.cost, res.iterations)
    else:
        flat, init_cost, final_cost = _adam_run(residual_fn, cfg.adam_iters,
                                                cfg.adam_lr, flat0)
        iters = cfg.adam_iters
    p = unravel(flat)
    terms = ba_loss_terms(p["X"], p["rvec"], p["tvec"], K, x2d, conf2d, cfg,
                          ref_bone_len)
    return BAResult(X=p["X"], R=rotvec_to_matrix(p["rvec"]), t=p["tvec"],
                    initial_cost=init_cost, final_cost=final_cost,
                    iterations=iters, losses=terms)
