"""Temporal smoothing: EMA (plain and adaptive), Savitzky–Golay, moving average.

Port of ``skix/geometry/smoothing.py``. Missing data is a ``valid`` mask,
never NaN. The two EMAs carry the previous output from frame to frame
(skix's ``lax.scan``), so they are a loop over T on the tensors' device:
each step is a handful of elementwise kernels over the (J, 3) frame.
Savitzky–Golay is a depthwise ``F.conv1d`` with the reversed coefficients
(``conv1d`` and ``lax.conv_general_dilated`` are both cross-correlations)
over the same reflection padding, in float32 on the card too (cuDNN's
TF32 off in its scope).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from skix_torch.utils.device import full_float32_convs


def ema(x: torch.Tensor, alpha: float, valid=None) -> torch.Tensor:
    """Plain EMA over axis 0: ``y_t = α x_t + (1−α) y_{t−1}``; an invalid
    frame carries the previous smoothed value forward."""
    if valid is None:
        valid = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    valid = torch.broadcast_to(valid.bool(), x.shape)
    y = torch.where(valid[0], x[0], 0.0)
    out = [y]
    for t in range(1, x.shape[0]):
        y = torch.where(valid[t], alpha * x[t] + (1.0 - alpha) * y, y)
        out.append(y)
    return torch.stack(out)


def adaptive_ema(x: torch.Tensor, alpha: float = 0.7, alpha_joint=None,
                 alpha_min: float = 0.45, alpha_max: float = 0.92,
                 speed_gain: float = 0.25, valid=None) -> torch.Tensor:
    """Adaptive per-joint, speed-aware EMA over a ``(T, J, 3)`` sequence:
    ``α_t = clip(α_j + gain·‖x_t − y_{t−1}‖, α_min, α_max)``; an invalid
    current joint holds the previous output, a valid one after invalid
    history restarts from the observation. ``valid (T, J)`` bool."""
    T, J = x.shape[0], x.shape[1]
    if alpha_joint is None:
        alpha_joint = torch.full((J,), alpha, dtype=x.dtype, device=x.device)
    alpha_joint = torch.as_tensor(alpha_joint, dtype=x.dtype,
                                  device=x.device).clamp(alpha_min, alpha_max)
    if valid is None:
        valid = torch.ones((T, J), dtype=torch.bool, device=x.device)
    valid = valid.bool()
    y = torch.where(valid[0][:, None], x[0], 0.0)
    ok = valid[0]
    out = [y]
    for t in range(1, T):
        xt, vt = x[t], valid[t]
        speed = torch.linalg.norm(xt - y, dim=-1)
        a = torch.clamp(alpha_joint + speed_gain * speed, alpha_min,
                        alpha_max)[:, None]
        y_both = a * xt + (1.0 - a) * y
        y = torch.where((vt & ok)[:, None], y_both,
                        torch.where(vt[:, None], xt, y))
        ok = vt | ok
        out.append(y)
    return torch.stack(out)


def savgol_coeffs(window: int, polyorder: int, deriv: int = 0) -> np.ndarray:
    """Savitzky–Golay FIR coefficients (host side, float64)."""
    if window % 2 != 1:
        raise ValueError("window must be odd")
    half = window // 2
    pos = np.arange(-half, half + 1, dtype=np.float64)
    A = pos[:, None] ** np.arange(polyorder + 1)[None, :]
    return (np.linalg.pinv(A)[deriv] * math.factorial(deriv)).astype(np.float64)


def savgol_smooth(x: torch.Tensor, window: int = 11, polyorder: int = 3
                  ) -> torch.Tensor:
    """Savitzky–Golay smoothing along axis 0 of ``x (T, ...)``, one
    depthwise convolution over symmetric reflection padding; a clip shorter
    than the window comes back unchanged."""
    T = x.shape[0]
    if T < window:
        return x
    coeffs = torch.as_tensor(savgol_coeffs(window, polyorder)[::-1].copy(),
                             dtype=x.dtype, device=x.device)
    flat = x.reshape(T, -1)
    half = window // 2
    padded = torch.cat([flat[1:half + 1].flip(0), flat,
                        flat[-half - 1:-1].flip(0)], dim=0)
    Fn = flat.shape[1]
    with full_float32_convs():
        out = F.conv1d(padded.T[None].contiguous(),
                       coeffs.expand(Fn, 1, window).contiguous(), groups=Fn)
    return out[0].T.reshape(x.shape)


def moving_average(x: torch.Tensor, window: int) -> torch.Tensor:
    """Centered moving average along axis 0, edge-padded."""
    T = x.shape[0]
    half = window // 2
    flat = x.reshape(T, -1)
    padded = torch.cat([flat[:1].expand(half, -1), flat,
                        flat[-1:].expand(window - half - 1, -1)], dim=0)
    csum = torch.cumsum(torch.cat([torch.zeros_like(flat[:1]), padded]), dim=0)
    return ((csum[window:] - csum[:-window]) / window).reshape(x.shape)


def velocity(x: torch.Tensor) -> torch.Tensor:
    """First difference along time: (T, ...) → (T-1, ...)."""
    return x[1:] - x[:-1]


def jerk_metric(x: torch.Tensor) -> torch.Tensor:
    """Mean second-difference magnitude (temporal jitter)."""
    acc = x[2:] - 2 * x[1:-1] + x[:-2]
    return torch.linalg.norm(acc, dim=-1).mean()
