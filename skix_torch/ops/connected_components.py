"""Connected-component labeling by min-label propagation.

Port of ``skix/ops/connected_components.py``. Every foreground pixel takes
the least label of its 4-neighbourhood each sweep, then two pointer jumps
(label ← label[label]) shorten the chains; the labels are the row-major
index of each component's first pixel. skix runs the sweeps in a
``lax.while_loop`` capped at ``max_iters``; here the loop is a Python loop
over a batch of masks with one host read a sweep (whether any label moved).
The cap is kept: where it binds (a long spiral) the labels are skix's, not
union-find's roots. Plain torch, as skix's is plain XLA.
"""

from __future__ import annotations

import torch

_INF = torch.iinfo(torch.int32).max


def _neighbor_min(lbl, mask):
    """The least label of each foreground pixel and its 4 neighbours
    (``_INF`` outside the masks); ``lbl``/``mask`` ``(N, H, W)``."""
    inf = torch.full_like(lbl[:, :1], _INF)
    up = torch.cat([inf, lbl[:, :-1]], 1)
    down = torch.cat([lbl[:, 1:], inf], 1)
    inf = torch.full_like(lbl[:, :, :1], _INF)
    left = torch.cat([inf, lbl[:, :, :-1]], 2)
    right = torch.cat([lbl[:, :, 1:], inf], 2)
    m = torch.minimum(torch.minimum(up, down), torch.minimum(left, right))
    return torch.where(mask, torch.minimum(lbl, m), torch.full_like(lbl, _INF))


def _jump(lbl):
    """Pointer jumping: each label becomes the label at the pixel it names."""
    N, H, W = lbl.shape
    flat = lbl.reshape(N, H * W)
    bg = flat == _INF
    hop = flat.gather(1, torch.where(bg, 0, flat).long())
    return torch.where(bg, flat, hop).reshape(N, H, W)


def connected_components(mask, max_iters: int = 64):
    """Label the 4-connected components of bool masks ``(..., H, W)``.

    Returns int32 labels of the same shape: background −1, each component
    labelled by the row-major linear index of its first pixel (within its
    own mask). At most ``max_iters`` sweeps, as skix's."""
    mask = torch.as_tensor(mask).to(torch.bool)
    H, W = mask.shape[-2:]
    m = mask.reshape(-1, H, W)
    idx = torch.arange(H * W, dtype=torch.int32,
                       device=m.device).reshape(1, H, W)
    lbl = torch.where(m, idx, torch.full_like(idx, _INF))
    for _ in range(max_iters):
        new = _jump(_jump(_neighbor_min(lbl, m)))
        moved = bool((new != lbl).any())
        lbl = new
        if not moved:
            break
    return torch.where(m, lbl, torch.full_like(lbl, -1)).reshape(mask.shape)


def component_sizes(labels, max_components: int):
    """Sizes of the components of labels ``(..., H, W)`` (from
    :func:`connected_components`), keyed by root in order of appearance.

    Returns ``(roots, sizes)``, each ``(..., max_components)`` int32,
    padded with −1 and 0 (skix's static shapes)."""
    labels = torch.as_tensor(labels)
    H, W = labels.shape[-2:]
    flat = labels.reshape(-1, H * W).to(torch.int64)
    N = flat.shape[0]
    idx = torch.arange(H * W, device=flat.device)
    is_root = (flat >= 0) & (flat == idx)
    rank = torch.cumsum(is_root.to(torch.int64), 1) - 1
    slot = torch.where(is_root, rank, max_components).clamp(0, max_components)
    roots = torch.full((N, max_components + 1), -1, dtype=torch.int64,
                       device=flat.device).scatter_reduce(
        1, slot, torch.where(is_root, flat, -1), "amax")[:, :max_components]
    safe = flat.clamp(min=0)
    hist = torch.zeros_like(flat).scatter_add_(1, safe, (flat >= 0).long())
    sizes = torch.where(roots >= 0, hist.gather(1, roots.clamp(min=0)), 0)
    shape = (*labels.shape[:-2], max_components)
    return (roots.to(torch.int32).reshape(shape),
            sizes.to(torch.int32).reshape(shape))
