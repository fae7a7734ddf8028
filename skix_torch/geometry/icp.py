"""Fixed-iteration point-set ICP with bbox gating.

Port of ``skix/geometry/icp.py``: refine the rigid (or similarity)
transform that maps one point cloud onto another (VGGT point maps of two
views), correspondences restricted to points inside the person bbox.
Each iteration finds every source point's nearest target point from the
dense squared distances ``Σ (moved[:, None] − tgt_masked[None])²``,
computed as skix does (no ‖a‖² + ‖b‖² − 2ab form, whose rounding
differs), then solves the weighted Umeyama update. The loop has a fixed
trip count, as skix's ``lax.fori_loop``.

The distances are built in row chunks of at most ``_CHUNK_ELEMS``
(source row, target) pairs, so the (N, M) intermediates stay bounded at
large N; each element's arithmetic is the same as unchunked. The nearest
index is the first occurrence of the minimum, on the card as on the CPU
(``torch.argmin`` on CUDA does not promise it on ties).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from skix_torch.geometry.rigid import umeyama
from skix_torch.utils.device import resolve_device

_BIG = 1e12
_CHUNK_ELEMS = 1 << 24      # (rows × M) distances a chunk: 64 MiB in f32


class ICPResult(NamedTuple):
    R: torch.Tensor            # (3, 3) — maps source → target
    t: torch.Tensor            # (3,)
    rms: torch.Tensor          # final inlier RMS distance
    inlier_frac: torch.Tensor
    nn_idx: torch.Tensor       # (N,) the last iteration's nearest targets


def bbox_gate_mask(uv: torch.Tensor, bbox_xyxy) -> torch.Tensor:
    """Valid mask for 2D projections inside a bbox. ``uv (N, 2)``."""
    b = torch.as_tensor(bbox_xyxy, dtype=uv.dtype, device=uv.device)
    return ((uv[:, 0] >= b[0]) & (uv[:, 0] <= b[2])
            & (uv[:, 1] >= b[1]) & (uv[:, 1] <= b[3]))


def nearest_neighbours(points: torch.Tensor, targets: torch.Tensor):
    """``(idx, dist)``: for each of ``points (N, 3)`` the index of its
    nearest row of ``targets (M, 3)`` (the first on a tie) and the
    distance to it, in row chunks of at most ``_CHUNK_ELEMS`` pairs."""
    M = targets.shape[0]
    rows = max(1, _CHUNK_ELEMS // max(M, 1))
    cols = torch.arange(M, device=points.device)
    idx, d2min = [], []
    for s in range(0, points.shape[0], rows):
        d = points[s:s + rows, None, :] - targets[None]
        # the three squares added in order, as skix's sum over the axis
        d2 = d[..., 0] ** 2 + d[..., 1] ** 2 + d[..., 2] ** 2
        mn = d2.amin(dim=1)
        idx.append(torch.where(d2 == mn[:, None], cols, M).amin(dim=1))
        d2min.append(mn)
    return torch.cat(idx), torch.sqrt(torch.cat(d2min))


def icp(
    source,                 # (N, 3)
    target,                 # (M, 3)
    source_valid=None,      # (N,) bool (e.g. bbox-gated pointmap pixels)
    target_valid=None,      # (M,)
    iterations: int = 10,
    max_corr_dist: float | None = None,
    allow_scale: bool = False,
    R_init=None,
    t_init=None,
    device=None,
) -> ICPResult:
    """Estimate (R, t) aligning ``source`` onto ``target``, on ``device``
    (default ``cuda``), in float32 as skix."""
    device = resolve_device(device)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    source, target = f32(source), f32(target)
    N, M = source.shape[0], target.shape[0]

    def mask(valid, n):
        if valid is None:
            return torch.ones(n, dtype=torch.bool, device=device)
        return torch.as_tensor(valid, device=device).bool()

    sv, tv = mask(source_valid, N), mask(target_valid, M)
    R = torch.eye(3, device=device) if R_init is None else f32(R_init)
    t = torch.zeros(3, device=device) if t_init is None else f32(t_init)
    tgt_masked = torch.where(tv[:, None], target, _BIG)

    def weights(nn_d):
        w = sv.to(torch.float32)
        if max_corr_dist is not None:
            w = w * (nn_d < max_corr_dist)
        return w

    nn_idx = None
    for _ in range(iterations):
        nn_idx, nn_d = nearest_neighbours(source @ R.T + t, tgt_masked)
        w = weights(nn_d) * tv[nn_idx]
        tr = umeyama(target[nn_idx], source, w=w, allow_scale=allow_scale)
        R, t = tr.R * tr.s, tr.t

    last_idx, nn_d = nearest_neighbours(source @ R.T + t, tgt_masked)
    w = weights(nn_d)
    rms = torch.sqrt(torch.sum(w * nn_d ** 2) / (torch.sum(w) + 1e-9))
    return ICPResult(R=R, t=t, rms=rms,
                     inlier_frac=torch.sum(w) / (torch.sum(sv) + 1e-9),
                     nn_idx=last_idx if nn_idx is None else nn_idx)
