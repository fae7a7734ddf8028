"""Two-view epipolar geometry: essential matrix, RANSAC, pose recovery.

Port of ``skix/geometry/epipolar.py``: a fixed-round hypothesis RANSAC (S
minimal 8-point samples drawn up front, all S essential matrices fitted in
one batched eigendecomposition, every hypothesis scored against every point
by the Sampson distance, the best inlier set refitted) and the cheirality
vote over the four decompositions of E. Every function is batched over
leading axes, so a clip's frames go through as one batch (skix ``vmap``s).

The hypotheses come from :func:`ransac_samples`, drawn by a CPU
``torch.Generator`` and moved to the points' device, so the card and the
CPU try the same samples. skix draws them with ``jax.random``, a stream
torch cannot reproduce; :func:`estimate_relative_pose` therefore also
takes ``samples=`` (skix's draws, in the parity tests).

Ties and precision. skix fits E in float32 on unnormalized coordinates;
a minimal sample's null vector then carries rounding of order 1e-4 and
more, and a fifth of the hypotheses' inlier counts depend on which
eigensolver ran (LAPACK, XLA, cuSOLVER). The port makes the same choices
on every device:

- the normal equations are formed and solved in float64;
- a system with at most 8 weighted points (every RANSAC sample, a refit
  on ≤ 8 inliers) is solved in Hartley-normalized coordinates: for 8
  distinct points the null vector is the same, and well conditioned;
- a sample drawn with replacement often repeats a point: its null space
  has two or more dimensions, and ``EIGHT_POINT_TIE`` picks the vector of
  least weighted norm in it, where each eigensolver would pick its own;
- ``torch.argmax`` returns the first maximal index, as ``jnp.argmax``
  does, for the best hypothesis and for the cheirality vote, whose four
  candidates come in an order that does not depend on the SVD's signs
  (:func:`recover_pose`).

On skix's triangulation test (exact correspondences, 204 pooled points)
the port's clip pose is the exact one within 1e-4 of the baseline, skix's
float32 one 1.5e-3 off (``tests/test_torch_chain_cli_triangulation.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from skix_torch.utils.device import by_chunks

_EPS = 1e-12
# ε·(trace(M) + 1)·diag(1..9)/9 added to a degenerate system's AᵀA: the
# null vector of least weighted norm, on every device (a system of 8 or
# more distinct points keeps its AᵀA, whose null vector is unique)
EIGHT_POINT_TIE = 1e-10
_TIE_DIAG = torch.diag(torch.arange(1, 10, dtype=torch.float64) / 9)


def normalize_points(uv: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixels → normalized camera coords with K⁻¹ (no distortion)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)


def _eight_point(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor,
                 minimal=None, degenerate=None) -> torch.Tensor:
    """Weighted 8-point algorithm on normalized coords ``(..., N, 2)`` with
    weights ``(..., N)`` → E ``(..., 3, 3)`` in the inputs' dtype, singular
    values projected to (1, 1, 0); the normal equations and their
    eigensolve run in float64. Where ``minimal (...)`` is set (at most 8
    points carry weight: a RANSAC sample, a refit on ≤ 8 inliers) the
    system is exactly or under-determined, and is solved in
    Hartley-normalized coordinates: the same null vector, well conditioned.
    Where ``degenerate (...)`` is set (fewer than 8 distinct points) the
    null space has two or more dimensions, and the deterministic vector is
    taken (see the module docstring)."""
    x1, x2, w64 = x1.double(), x2.double(), w.double()
    if minimal is not None:
        m = minimal[..., None, None]
        (n1, T1), (n2, T2) = _hartley(x1, w64), _hartley(x2, w64)
        x1, x2 = torch.where(m, n1, x1), torch.where(m, n2, x2)
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-1) * w64[..., None]
    M = A.transpose(-1, -2) @ A
    if degenerate is not None:
        tr = M.diagonal(dim1=-2, dim2=-1).sum(-1)
        tie = torch.where(degenerate, EIGHT_POINT_TIE * (tr + 1.0), 0.0)
        M = M + tie[..., None, None] * _TIE_DIAG.to(M)
    _, evecs = by_chunks(torch.linalg.eigh, M)
    E = evecs[..., :, 0].reshape(*evecs.shape[:-2], 3, 3)
    if minimal is not None:
        E = torch.where(m, T2.transpose(-1, -2) @ E @ T1, E)
    U, _, Vt = by_chunks(torch.linalg.svd, E)
    diag = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return ((U * diag) @ Vt).to(w.dtype)


def _hartley(x: torch.Tensor, w: torch.Tensor):
    """Points ``(..., N, 2)`` moved to the centroid of those of weight > 0
    and scaled to their mean distance √2, and the 3×3 map ``T`` that does
    it."""
    on = (w > 0).to(x.dtype)
    n = on.sum(-1, keepdim=True).clamp(min=1.0)
    c = (on[..., None] * x).sum(-2) / n                      # (..., 2)
    d = (on * torch.linalg.norm(x - c[..., None, :], dim=-1)).sum(-1) / n[..., 0]
    s = 2.0 ** 0.5 / torch.where(d > 0, d, 1.0)
    T = torch.zeros(*x.shape[:-2], 3, 3, dtype=x.dtype, device=x.device)
    T[..., 0, 0] = s
    T[..., 1, 1] = s
    T[..., :2, 2] = -s[..., None] * c
    T[..., 2, 2] = 1.0
    return (x - c[..., None, :]) * s[..., None, None], T


def sampson_distance(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
                     ) -> torch.Tensor:
    """First-order geometric error of the epipolar constraint: ``E
    (..., 3, 3)`` against points ``(..., N, 2)`` → ``(..., N)`` (the batch
    axes broadcast)."""
    ones = torch.ones_like(x1[..., :1])
    p1 = torch.cat([x1, ones], dim=-1)
    p2 = torch.cat([x2, ones], dim=-1)
    Ex1 = p1 @ E.transpose(-1, -2)
    Etx2 = p2 @ E
    num = torch.sum(p2 * Ex1, dim=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / (den + _EPS)


def decompose_essential(E: torch.Tensor):
    """E → (R1, R2, t̂): the two rotations and the unit translation."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    return U @ W @ Vt, U @ W.T @ Vt, U[..., :, 2]


def _depths(R, t, x1, x2):
    """Depths ``(z1, z2)`` of each correspondence along both rays, by least
    squares on ``z2·x2h = R (z1·x1h) + t``; ``R (..., 3, 3)``, ``t (..., 3)``
    against points ``(..., N, 2)``."""
    ones = torch.ones_like(x1[..., :1])
    x1h = torch.cat([x1, ones], dim=-1)
    x2h = torch.cat([x2, ones], dim=-1)
    Rx1 = x1h @ R.transpose(-1, -2)
    a11 = torch.sum(Rx1 * Rx1, dim=-1)
    a12 = -torch.sum(Rx1 * x2h, dim=-1)
    a22 = torch.sum(x2h * x2h, dim=-1)
    b1 = -torch.sum(Rx1 * t[..., None, :], dim=-1)
    b2 = torch.sum(x2h * t[..., None, :], dim=-1)
    det = a11 * a22 - a12 * a12
    z1 = (b1 * a22 - a12 * b2) / (det + _EPS)
    z2 = (a11 * b2 - a12 * b1) / (det + _EPS)
    return z1, z2


class RelativePose(NamedTuple):
    R: torch.Tensor           # (..., 3, 3)
    t: torch.Tensor           # (..., 3) unit-norm
    E: torch.Tensor           # (..., 3, 3)
    inliers: torch.Tensor     # (..., N) bool
    num_inliers: torch.Tensor  # (...,) int


def recover_pose(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, w=None):
    """The (R, t) among the four decompositions of E with the most weighted
    points in front of both cameras. The candidates are ordered (Ra t,
    Ra −t, Rb t, Rb −t) with Ra the rotation of larger trace and t's
    largest component positive, so a tied vote (no inlier in front of
    either camera, say) picks the same pose whichever way the SVD chose
    its signs: skix's order (R1, R2, ±t) follows its SVD's."""
    R1, R2, t = decompose_essential(E)
    swap = (R2.diagonal(dim1=-2, dim2=-1).sum(-1)
            > R1.diagonal(dim1=-2, dim2=-1).sum(-1))[..., None, None]
    R1, R2 = torch.where(swap, R2, R1), torch.where(swap, R1, R2)
    lead = torch.take_along_dim(t, t.abs().argmax(-1, keepdim=True), dim=-1)
    t = torch.where(lead < 0, -t, t)
    cands_R = torch.stack([R1, R1, R2, R2], dim=-3)          # (..., 4, 3, 3)
    cands_t = torch.stack([t, -t, t, -t], dim=-2)            # (..., 4, 3)
    if w is None:
        w = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    z1, z2 = _depths(cands_R, cands_t, x1[..., None, :, :], x2[..., None, :, :])
    votes = torch.sum(w[..., None, :] * ((z1 > 0) & (z2 > 0)), dim=-1)
    best = torch.argmax(votes, dim=-1)
    R = torch.take_along_dim(cands_R, best[..., None, None, None], dim=-3)
    tt = torch.take_along_dim(cands_t, best[..., None, None], dim=-2)
    return R[..., 0, :, :], tt[..., 0, :]


def ransac_samples(weights: torch.Tensor, num_hypotheses: int,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """``(..., S, 8)`` point indices drawn with replacement, uniformly over
    the points of weight > 0 (over all points where none has), as skix's
    ``jax.random.categorical`` on 0 / −1e9 logits. Drawn on the CPU from
    ``generator`` (default: seeded 0) and moved to ``weights``' device."""
    if generator is None:
        generator = torch.Generator(device="cpu").manual_seed(0)
    N = weights.shape[-1]
    p = (weights.detach().cpu().reshape(-1, N) > 0).to(torch.float32)
    p[p.sum(-1) == 0] = 1.0
    idx = torch.multinomial(p, num_hypotheses * 8, replacement=True,
                            generator=generator)
    return idx.reshape(*weights.shape[:-1], num_hypotheses, 8).to(weights.device)


def _gather_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x (..., N, 2)`` at ``idx (..., S, 8)`` → ``(..., S, 8, 2)``."""
    S = idx.shape[-2]
    xs = x[..., None, :, :].expand(*x.shape[:-2], S, *x.shape[-2:])
    return torch.take_along_dim(xs, idx[..., None], dim=-2)


def estimate_relative_pose(uv1: torch.Tensor, uv2: torch.Tensor,
                           K: torch.Tensor, generator=None,
                           num_hypotheses: int = 256,
                           inlier_threshold_px: float = 2.0, weights=None,
                           samples=None) -> RelativePose:
    """RANSAC essential matrix + pose for frame pairs ``uv1, uv2 (..., N,
    2)`` (pixels); ``weights (..., N)`` (0 excludes a point); ``samples
    (..., S, 8)`` the hypotheses' indices (default :func:`ransac_samples`
    from ``generator``)."""
    if weights is None:
        weights = torch.ones(uv1.shape[:-1], dtype=uv1.dtype, device=uv1.device)
    weights = weights.to(uv1.dtype)
    x1 = normalize_points(uv1, K)
    x2 = normalize_points(uv2, K)
    f_mean = 0.5 * (K[0, 0] + K[1, 1])
    thr = (inlier_threshold_px / f_mean) ** 2
    if samples is None:
        samples = ransac_samples(weights, num_hypotheses, generator)
    samples = samples.to(device=uv1.device, dtype=torch.long)

    s1 = _gather_points(x1, samples)
    srt = samples.sort(dim=-1).values
    repeats = (srt[..., 1:] == srt[..., :-1]).any(-1)
    Es = _eight_point(s1, _gather_points(x2, samples),
                      torch.ones(s1.shape[:-1], dtype=x1.dtype, device=x1.device),
                      minimal=torch.ones_like(repeats), degenerate=repeats)
    d = sampson_distance(Es, x1[..., None, :, :], x2[..., None, :, :])
    inls = (d < thr) & (weights[..., None, :] > 0)            # (..., S, N)
    best = torch.argmax(inls.sum(-1), dim=-1)
    best_inl = torch.take_along_dim(inls, best[..., None, None], dim=-2)[..., 0, :]

    w_refit = torch.where(best_inl, weights, 0.0)
    count = (w_refit > 0).sum(-1)
    E = _eight_point(x1, x2, w_refit, minimal=count <= 8, degenerate=count < 8)
    final_inl = (sampson_distance(E, x1, x2) < thr) & (weights > 0)
    R, t = recover_pose(E, x1, x2, w=final_inl.to(x1.dtype))
    return RelativePose(R=R, t=t, E=E, inliers=final_inl,
                        num_inliers=final_inl.sum(-1))


def scale_translation_to_baseline(t: torch.Tensor, baseline_m: float
                                  ) -> torch.Tensor:
    """Scale a unit translation to a known stereo baseline."""
    return t / (torch.linalg.norm(t, dim=-1, keepdim=True) + _EPS) * baseline_m
