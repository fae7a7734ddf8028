"""Euclidean distance transform.

Port of ``skix/ops/edt.py``: the separable two-pass transform, each 1-D
pass the dense min-plus product ``d[i] = min_j (cost[j] + (i − j)²)``.
skix forms the whole ``(..., n, n)`` sum at once, which for one 1008²
mask is 4.1 GB of float32 in eager torch; here the rows go through in
chunks of at most ``_CHUNK_ELEMS`` elements of that sum. A minimum of the
same float32 sums is the same in any order, so the values are skix's bit
for bit. Plain torch, as skix's is plain XLA.
"""

from __future__ import annotations

import torch

_INF = 1e12
_CHUNK_ELEMS = 1 << 26        # elements of one chunk's (rows, n, n) sum


def _edt_1d_sq(cost):
    """``cost (..., n)`` → ``min_j cost[..., j] + (i − j)²``, each i."""
    n = cost.shape[-1]
    i = torch.arange(n, dtype=cost.dtype, device=cost.device)
    sq = (i[:, None] - i[None, :]) ** 2                      # (n, n)
    rows = cost.reshape(-1, n)
    out = torch.empty_like(rows)
    step = max(1, _CHUNK_ELEMS // (n * n))
    for r in range(0, rows.shape[0], step):
        out[r:r + step] = (rows[r:r + step, None, :] + sq).amin(-1)
    return out.reshape(cost.shape)


def edt(mask):
    """Distance from every pixel to the nearest foreground pixel of bool
    masks ``(..., H, W)`` (0 inside a mask), float32."""
    mask = torch.as_tensor(mask).to(torch.bool)
    cost = torch.where(mask, 0.0, _INF).to(torch.float32)
    d = _edt_1d_sq(cost)                                      # along W
    d = _edt_1d_sq(d.transpose(-1, -2).contiguous()).transpose(-1, -2)
    return torch.sqrt(torch.clamp(d, min=0.0))


def signed_edt(mask):
    """Positive outside the mask, negative inside (distance to boundary)."""
    mask = torch.as_tensor(mask).to(torch.bool)
    return torch.where(mask, -edt(~mask), edt(mask))
