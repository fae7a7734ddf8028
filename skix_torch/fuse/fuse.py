"""Confidence-weighted cross-view fusion, vectorized over whole clips.

Port of ``skix/fuse/fuse.py``: the MHR-70 raw route (align right→left by
Umeyama per frame, log-confidence softmax weights, weighted mean with
single-view fallback, adaptive EMA) and the H36M no-extrinsics route
(pelvis-origin and pelvis–neck-scale normalization, Umeyama on the six
torso joints, τ-gated per-joint average). Every per-frame solve is one row
of a batched SVD; missing joints are ``valid`` masks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from skix_torch.geometry.rigid import umeyama
from skix_torch.geometry.skeletons import H36M, H36M_TORSO
from skix_torch.geometry.smoothing import adaptive_ema

_EPS = 1e-9


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(x).all(dim=-1)


def softmax2(qa: torch.Tensor, qb: torch.Tensor):
    """2-way softmax weights from quality scores."""
    m = torch.maximum(qa, qb)
    ea, eb = torch.exp(qa - m), torch.exp(qb - m)
    s = ea + eb + _EPS
    return ea / s, eb / s


# --------------------------------------------------------------------------
# No-GT per-joint quality scores
# --------------------------------------------------------------------------
def incidence_matrix(num_joints: int, edges) -> np.ndarray:
    """(J, E) 0/1 joint-edge incidence (host side)."""
    inc = np.zeros((num_joints, len(edges)), np.float32)
    for e, (a, b) in enumerate(edges):
        inc[a, e] = 1.0
        inc[b, e] = 1.0
    return inc


def q_from_bone_deviation(X: torch.Tensor, edges, med_lens: torch.Tensor,
                          valid=None) -> torch.Tensor:
    """q_bone(j) = −mean over incident edges of |len(e) − median(e)|; −100
    where no incident edge is valid, −1e9 for an invalid joint."""
    J = X.shape[-2]
    edges = np.asarray(edges)
    inc = torch.as_tensor(incidence_matrix(J, edges), dtype=X.dtype,
                          device=X.device)
    valid = _finite(X) if valid is None else valid.bool()
    a, b = edges[:, 0].tolist(), edges[:, 1].tolist()
    L = torch.linalg.norm(X[..., a, :] - X[..., b, :], dim=-1)
    edge_ok = valid[..., a] & valid[..., b] & torch.isfinite(med_lens)[None, :]
    dev = torch.where(edge_ok, (L - med_lens[None, :]).abs(), 0.0)
    cnt = torch.einsum("je,te->tj", inc, edge_ok.to(X.dtype))
    dev_sum = torch.einsum("je,te->tj", inc, dev)
    q = torch.where(cnt > 0, -(dev_sum / (cnt + _EPS)), -100.0)
    return torch.where(valid, q, -1e9)


def median_bone_lengths(X: torch.Tensor, edges, valid=None) -> torch.Tensor:
    """Per-edge median bone length over a clip (the mean of the two middle
    valid values), NaN for an edge never valid."""
    edges = np.asarray(edges)
    valid = _finite(X) if valid is None else valid.bool()
    a, b = edges[:, 0].tolist(), edges[:, 1].tolist()
    L = torch.linalg.norm(X[..., a, :] - X[..., b, :], dim=-1)
    ok = valid[..., a] & valid[..., b]
    srt = torch.sort(torch.where(ok, L, torch.inf), dim=0).values
    n = ok.sum(0)
    T = L.shape[0]
    lo = ((n - 1) // 2).clamp(0, T - 1)
    hi = (n // 2).clamp(0, T - 1)
    med = 0.5 * (srt.gather(0, lo[None])[0] + srt.gather(0, hi[None])[0])
    return torch.where(n > 0, med, torch.nan)


def q_from_temporal(X_prev, X_curr, beta: float = 1.0, valid_prev=None,
                    valid_curr=None) -> torch.Tensor:
    """q_temp(j) = −β‖x_t − x_{t−1}‖; 0 without a previous value, −1e9 for
    an invalid current joint."""
    vp = _finite(X_prev) if valid_prev is None else valid_prev.bool()
    vc = _finite(X_curr) if valid_curr is None else valid_curr.bool()
    d = torch.linalg.norm(torch.where((vp & vc)[..., None], X_curr - X_prev,
                                      0.0), dim=-1)
    return torch.where(vc, torch.where(vp & vc, -beta * d, 0.0), -1e9)


def q_2d_sanity(U2d: torch.Tensor, width: int, height: int, valid=None):
    """0 if finite and in the image, else −50."""
    v = _finite(U2d) if valid is None else valid.bool()
    inb = ((U2d[..., 0] >= 0) & (U2d[..., 0] < width)
           & (U2d[..., 1] >= 0) & (U2d[..., 1] < height))
    return torch.where(v & inb, 0.0, -50.0)


def combine_q(q_bone, q_temp=None, q_sanity=None, w_bone: float = 1.0,
              w_temp: float = 0.3, w_san: float = 0.2):
    q = w_bone * q_bone
    if q_temp is not None:
        q = q + w_temp * q_temp
    if q_sanity is not None:
        q = q + w_san * q_sanity
    return q


def body_side_bias(left_mask: torch.Tensor, right_mask: torch.Tensor,
                   bias_val: float = 1.0) -> torch.Tensor:
    """+bias for left-side joints, −bias for right-side, 0 elsewhere."""
    return torch.where(left_mask.bool(), bias_val,
                       torch.where(right_mask.bool(), -bias_val, 0.0))


# --------------------------------------------------------------------------
# Rigid alignment + per-joint fusion
# --------------------------------------------------------------------------
def align_right_to_left(left, right, valid_left=None, valid_right=None,
                        allow_scale: bool = True) -> torch.Tensor:
    """Per-frame Umeyama of right → left over the jointly valid joints,
    ``(T, J, 3)`` → the aligned right view."""
    vl = _finite(left) if valid_left is None else valid_left.bool()
    vr = _finite(right) if valid_right is None else valid_right.bool()
    w = (vl & vr).to(left.dtype)
    keep = w[..., None] > 0
    tr = umeyama(torch.where(keep, left, 0.0), torch.where(keep, right, 0.0),
                 w=w, allow_scale=allow_scale)
    return tr.apply(right)


def fuse_two_views(Xl, Xr, q_l, q_r, valid_l=None, valid_r=None):
    """Per-joint softmax-weighted mean with single-view fallback →
    ``(fused (T,J,3), fused_valid (T,J))``."""
    vl = _finite(Xl) if valid_l is None else valid_l.bool()
    vr = _finite(Xr) if valid_r is None else valid_r.bool()
    wl, wr = softmax2(q_l, q_r)
    Xl0 = torch.where(vl[..., None], Xl, 0.0)
    Xr0 = torch.where(vr[..., None], Xr, 0.0)
    both = ((wl[..., None] * Xl0 + wr[..., None] * Xr0)
            / (wl[..., None] + wr[..., None] + _EPS))
    fused = torch.where((vl & vr)[..., None], both,
                        torch.where(vl[..., None], Xl0, Xr0))
    return fused, vl | vr


class FusedSequence(NamedTuple):
    fused: torch.Tensor      # (T, J, 3) raw fused
    smoothed: torch.Tensor   # (T, J, 3) EMA-smoothed
    valid: torch.Tensor      # (T, J)
    conf_l: torch.Tensor     # (T, J) left-view confidence used
    conf_r: torch.Tensor     # (T, J)


def fuse_sequence(left, right, conf_l=None, conf_r=None, valid_l=None,
                  valid_r=None, align: bool = True, allow_scale: bool = True,
                  ema_alpha: float = 0.7, ema_alpha_min: float = 0.45,
                  ema_alpha_max: float = 0.92, ema_speed_gain: float = 0.25,
                  alpha_joint=None) -> FusedSequence:
    """Align right → left, softmax-fuse on log-confidences, adaptive-EMA
    smooth."""
    vl = _finite(left) if valid_l is None else valid_l.bool()
    vr = _finite(right) if valid_r is None else valid_r.bool()
    r_al = align_right_to_left(left, right, vl, vr, allow_scale) if align else right
    cl = torch.ones(vl.shape, dtype=left.dtype, device=left.device) \
        if conf_l is None else conf_l
    cr = torch.ones(vr.shape, dtype=left.dtype, device=left.device) \
        if conf_r is None else conf_r
    fused, fv = fuse_two_views(torch.where(vl[..., None], left, 0.0),
                               torch.where(vr[..., None], r_al, 0.0),
                               torch.log(cl.clamp(min=1e-6)),
                               torch.log(cr.clamp(min=1e-6)), vl, vr)
    smoothed = adaptive_ema(fused, alpha=ema_alpha, alpha_joint=alpha_joint,
                            alpha_min=ema_alpha_min, alpha_max=ema_alpha_max,
                            speed_gain=ema_speed_gain, valid=fv)
    return FusedSequence(fused=fused, smoothed=smoothed, valid=fv,
                         conf_l=cl, conf_r=cr)


# --------------------------------------------------------------------------
# H36M no-extrinsics route (VideoPose3D/fuse)
# --------------------------------------------------------------------------
def center_scale_h36m(X: torch.Tensor):
    """Pelvis origin + pelvis–neck scale normalization of ``(..., 17, 3)``."""
    pelvis = X[..., H36M["PEL"], :]
    s = torch.linalg.norm(X[..., H36M["NECK"], :] - pelvis, dim=-1)
    s = torch.where(s > 1e-8, s, 1.0)
    return (X - pelvis[..., None, :]) / s[..., None, None], s


def fuse_pose_no_extrinsics(left_3d, right_3d, tau=0.08,
                            allow_scale: bool = False, wL=None, wR=None):
    """No-extrinsics two-view H36M fusion of ``(T, 17, 3)`` clips: both
    views normalized, right → left by Umeyama on the torso joints, then per
    joint the higher-weight view where the views disagree by more than τ,
    else the weighted average. Returns ``(fused (T,17,3), diag dict)``."""
    L, R = left_3d, right_3d
    if L.dim() == 2:
        L, R = L[None], R[None]
    T, J = L.shape[0], L.shape[1]
    ones = torch.ones((T, J), dtype=L.dtype, device=L.device)
    wL = ones if wL is None else torch.broadcast_to(wL, (T, J))
    wR = ones if wR is None else torch.broadcast_to(wR, (T, J))
    tau_v = torch.broadcast_to(torch.as_tensor(tau, dtype=L.dtype,
                                               device=L.device), (J,))
    Ln, _ = center_scale_h36m(L)
    Rn, _ = center_scale_h36m(R)
    torso = list(H36M_TORSO)
    R_al = umeyama(Ln[:, torso], Rn[:, torso], allow_scale=allow_scale).apply(Rn)
    d = torch.linalg.norm(Ln - R_al, dim=-1)
    avg = (wL[..., None] * Ln + wR[..., None] * R_al) / (wL + wR + _EPS)[..., None]
    gated = torch.where((wL >= wR)[..., None], Ln, R_al)
    far = d > tau_v[None, :]
    fused = torch.where(far[..., None], gated, avg)
    return fused, {"mean_disagreement": d.mean(),
                   "gated_fraction": far.to(L.dtype).mean(),
                   "per_frame_disagreement": d.mean(-1)}
