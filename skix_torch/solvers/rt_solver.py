"""Two-camera R|t refinement from 3D points + 2D observations.

Port of ``skix/solvers/rt_solver.py`` (reference parity:
VideoPose3D/slove_rt_from_3d.py:104,140,244 — PnP/essential
initialization, then ``scipy.optimize.least_squares`` with soft-L1 over
``[rvec_L, t_L, rvec_R, t_R (, X)]`` reprojection residuals). The
problem solves with the port's matrix-free LM (``solvers/lm``) and a
soft-L1 robustifier applied at the residual level; initialization comes
from the RANSAC essential matrix (``geometry/epipolar``).

skix flattens the free parameters ``{rl, tl, rr, tr[, X]}`` with
``ravel_pytree``; here the flat vector has the same layout, the keys in
sorted order (``X``, ``rl``, ``rr``, ``tl``, ``tr``), each raveled row-major,
so both solvers see the same vector and draw the same probes over it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from skix_torch.geometry.camera import project_points
from skix_torch.geometry.epipolar import (estimate_relative_pose,
                                          scale_translation_to_baseline)
from skix_torch.geometry.rotations import matrix_to_rotvec, rotvec_to_matrix
from skix_torch.solvers.lm import levenberg_marquardt
from skix_torch.utils.device import resolve_device


class RTSolution(NamedTuple):
    R_left: torch.Tensor
    t_left: torch.Tensor
    R_right: torch.Tensor
    t_right: torch.Tensor
    X: torch.Tensor            # (N, 3) possibly refined points
    initial_cost: torch.Tensor
    final_cost: torch.Tensor


def _soft_l1(r, delta: float = 1.0):
    """Residual-level robustifier ``φ(r) = r / (1 + (r/δ)²)^¼``: the LM
    objective ½‖φ‖² = ½ r²/√(1+(r/δ)²) is quadratic for small residuals and
    δ·|r|-linear for gross outliers, with a bounded derivative at r → 0
    (skix's choice over √(2(√(1+r²)−1)), whose derivative there is not)."""
    return r / (1.0 + (r / delta) ** 2) ** 0.25


def ravel(free: dict) -> tuple[torch.Tensor, Callable]:
    """``(flat, unravel)`` of a dict of tensors in ``ravel_pytree``'s
    layout: keys sorted, each leaf raveled row-major."""
    keys = sorted(free)
    shapes = [free[k].shape for k in keys]
    sizes = [free[k].numel() for k in keys]
    flat = torch.cat([free[k].reshape(-1) for k in keys])

    def unravel(x):
        return {k: part.reshape(shape) for k, part, shape in
                zip(keys, torch.split(x, sizes), shapes)}

    return flat, unravel


def solve_rt_from_3d(
    X3d,                    # (N, 3) world points (e.g. lifted/fused pose)
    uv_left,                # (N, 2) pixels in the left view
    uv_right,               # (N, 2)
    K,
    conf=None,
    refine_points: bool = False,
    init: Optional[dict] = None,
    baseline_m: Optional[float] = None,
    max_steps: int = 60,
    cg_iters: int = 30,
    soft_l1_delta: float = 4.0,
    device=None,
) -> RTSolution:
    """Jointly refine both cameras' R|t (optionally the points too) against
    reprojection residuals, on ``device`` (default ``cuda``) in float32.
    Modes mirror the reference CLI: cameras-only (``refine_points=False``)
    or full (``True``)."""
    device = resolve_device(device)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    X3d, uv_l, uv_r, K = f32(X3d), f32(uv_left), f32(uv_right), f32(K)
    N = X3d.shape[0]
    w = torch.ones(N, device=device) if conf is None else f32(conf)
    sw = torch.sqrt(w / (torch.sum(w) + 1e-9))[:, None]
    uv = torch.stack([uv_l, uv_r])

    if init is None:
        pose = estimate_relative_pose(uv_l, uv_r, K)
        t_rel = (scale_translation_to_baseline(pose.t, baseline_m)
                 if baseline_m else pose.t)
        init = {"rl": torch.zeros(3), "tl": torch.zeros(3),
                "rr": matrix_to_rotvec(pose.R), "tr": t_rel}
    free = {k: f32(v) for k, v in init.items()}
    if refine_points:
        free["X"] = X3d
    flat0, unravel = ravel(free)

    def residual_fn(flat):
        # both views in one batched projection: the residuals in skix's
        # order, [left (N, 2) raveled, right (N, 2) raveled]
        p = unravel(flat)
        X = p.get("X", X3d)
        R = rotvec_to_matrix(torch.stack([p["rl"], p["rr"]]))[:, None]
        t = torch.stack([p["tl"], p["tr"]])[:, None]
        r = (sw * (project_points(X, K, R, t) - uv)).reshape(-1)
        return _soft_l1(r, soft_l1_delta)

    res = levenberg_marquardt(residual_fn, flat0, max_steps=max_steps,
                              cg_iters=cg_iters)
    p = unravel(res.x)
    return RTSolution(
        R_left=rotvec_to_matrix(p["rl"]), t_left=p["tl"],
        R_right=rotvec_to_matrix(p["rr"]), t_right=p["tr"],
        X=p.get("X", X3d),
        initial_cost=res.initial_cost, final_cost=res.cost)
