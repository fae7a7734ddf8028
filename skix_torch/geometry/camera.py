"""Camera models: screen normalization, world↔camera, distortion, projection.

Port of ``skix/geometry/camera.py``: the same reference semantics
(VideoPose3D's screen normalization and H36M distortion model, the OpenCV
rational model, pinhole ``K [R|t]``), on tensors batched over leading axes.
"""

from __future__ import annotations

import torch

from skix_torch.geometry.rotations import qinverse, qrot


def normalize_screen_coordinates(x: torch.Tensor, w, h) -> torch.Tensor:
    """Map pixel coords ``(..., 2)`` from [0,w]×[0,h] to [-1,1]×[-h/w,h/w]."""
    offs = torch.tensor([1.0, h / w], dtype=x.dtype, device=x.device)
    return x / w * 2.0 - offs


def image_coordinates(x: torch.Tensor, w, h) -> torch.Tensor:
    """Inverse of :func:`normalize_screen_coordinates`."""
    offs = torch.tensor([1.0, h / w], dtype=x.dtype, device=x.device)
    return (x + offs) * w / 2.0


def world_to_camera(x: torch.Tensor, q: torch.Tensor, t: torch.Tensor
                    ) -> torch.Tensor:
    """World → camera with orientation quaternion ``q (4,)`` and position
    ``t (3,)``."""
    qi = qinverse(q).expand(*x.shape[:-1], 4)
    return qrot(qi, x - t)


def camera_to_world(x: torch.Tensor, q: torch.Tensor, t: torch.Tensor
                    ) -> torch.Tensor:
    return qrot(q.expand(*x.shape[:-1], 4), x) + t


def project_to_2d_h36m(x: torch.Tensor, camera_params: torch.Tensor
                       ) -> torch.Tensor:
    """H36M distortion projection of camera-space ``x (..., 3)``;
    ``camera_params (..., 9)`` = (fx, fy, cx, cy, k1, k2, k3, p1, p2)."""
    cp = camera_params
    while cp.dim() < x.dim():
        cp = cp[..., None, :]
    f, c, k, p = cp[..., :2], cp[..., 2:4], cp[..., 4:7], cp[..., 7:9]
    xx = torch.clamp(x[..., :2] / x[..., 2:], -1.0, 1.0)
    r2 = torch.sum(xx * xx, dim=-1, keepdim=True)
    radial = 1.0 + torch.sum(k * torch.cat([r2, r2 ** 2, r2 ** 3], dim=-1),
                             dim=-1, keepdim=True)
    tan = torch.sum(p * xx, dim=-1, keepdim=True)
    return f * (xx * (radial + tan) + p * r2) + c


def project_linear(x: torch.Tensor, camera_params: torch.Tensor
                   ) -> torch.Tensor:
    """Linear pinhole projection (fx, fy, cx, cy only)."""
    cp = camera_params
    while cp.dim() < x.dim():
        cp = cp[..., None, :]
    xx = torch.clamp(x[..., :2] / x[..., 2:], -1.0, 1.0)
    return cp[..., :2] * xx + cp[..., 2:4]


def distort_rational(xn: torch.Tensor, dist) -> torch.Tensor:
    """OpenCV distortion of normalized coords ``xn (..., 2)``; ``dist`` has
    0/4/5/8/12/14 coefficients (k1,k2,p1,p2[,k3[,k4,k5,k6[,s1..s4[,τx,τy]]]]),
    zero-extended to 14 (the tilt terms are not applied, as in skix)."""
    d = torch.zeros(14, dtype=xn.dtype, device=xn.device)
    dist = torch.as_tensor(dist, dtype=xn.dtype, device=xn.device)
    d[:dist.numel()] = dist.reshape(-1)
    k1, k2, p1, p2, k3, k4, k5, k6 = d[:8].unbind()
    s1, s2, s3, s4 = d[8:12].unbind()
    u, v = xn[..., 0], xn[..., 1]
    r2 = u * u + v * v
    r4, r6 = r2 * r2, r2 * r2 * r2
    radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (1.0 + k4 * r2 + k5 * r4
                                                    + k6 * r6)
    ud = (u * radial + 2.0 * p1 * u * v + p2 * (r2 + 2.0 * u * u)
          + s1 * r2 + s2 * r4)
    vd = (v * radial + p1 * (r2 + 2.0 * v * v) + 2.0 * p2 * u * v
          + s3 * r2 + s4 * r4)
    return torch.stack([ud, vd], dim=-1)


def project_points(X: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
                   t: torch.Tensor, dist=None) -> torch.Tensor:
    """World points ``X (..., 3)`` → pixels ``(..., 2)`` through
    ``K [R|t]``; ``K (3,3)`` or batched ``(..., 3,3)`` (a batched K's
    intrinsics broadcast against ``X``'s last batch axis, as in skix)."""
    Xc = torch.einsum("...ij,...j->...i", R, X) + t
    z = Xc[..., 2:3]
    xn = Xc[..., :2] / torch.where(z.abs() < 1e-9, 1e-9, z)
    if dist is not None:
        xn = distort_rational(xn, dist)
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    if fx.dim():
        fx, fy, cx, cy = fx[..., None], fy[..., None], cx[..., None], cy[..., None]
    return torch.stack([fx * xn[..., 0] + cx, fy * xn[..., 1] + cy], dim=-1)


def camera_center(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Camera center ``C = -Rᵀ t``."""
    return -torch.einsum("...ji,...j->...i", R, t)


def reprojection_error(X, uv_obs, K, R, t, dist=None, valid=None):
    """Per-point pixel reprojection error ``(...,)``, 0 where ``valid`` is
    False."""
    err = torch.linalg.norm(project_points(X, K, R, t, dist) - uv_obs, dim=-1)
    if valid is not None:
        err = torch.where(valid, err, 0.0)
    return err
