"""Interactive-training point and box samplers and conditioning-frame
selection.

Port of ``skix/tracking/point_sampling.py`` (the reference tracker's
``sam3_tracker_utils.py``): noised box-corner prompts, correction clicks
drawn uniformly from the error regions or placed at the error region's
deepest point by the Euclidean distance transform, best-ground-truth
selection among multimask outputs, 1-D sine positional embeddings and the
fixed-slot conditioning-frame selection.

skix draws from ``jax.random`` keys; here draws come from an explicit
``torch.Generator`` on its own device and move to the masks' device, so
card and CPU sample alike. Each sampler also takes the precomputed noise
(``box_noise``, ``pts_noise``), which lets two implementations share one
draw. Every argmax and argmin takes the first occurrence of the extreme
(torch's own promise no tie order on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from skix_torch.ops.edt import edt

_INF = 1e12


def _first_argmax(x, dim: int = -1):
    """Index of the first occurrence of the maximum along ``dim``."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    idx = torch.arange(n, device=x.device).reshape(shape)
    top = x.amax(dim=dim, keepdim=True)
    return torch.where(x == top, idx, n).amin(dim=dim)


def _first_argmin(x, dim: int = -1):
    return _first_argmax(-x, dim)


def _uniform(shape, generator, device):
    """uniform[0, 1) float32 drawn on the generator's device, moved to
    ``device``."""
    gdev = generator.device if generator is not None else "cpu"
    return torch.rand(shape, generator=generator, device=gdev).to(device)


def mask_to_box(masks):
    """``(B, 1, H, W)`` bool masks → ``(B, 1, 4)`` int32 xyxy boxes with
    inclusive max corners (the reference's convention, unlike
    :func:`skix_torch.ops.masks.masks_to_boxes`); an empty mask gives
    zeros."""
    m = torch.as_tensor(masks).to(torch.bool)[:, 0]
    B, H, W = m.shape
    rows = m.any(dim=2)
    cols = m.any(dim=1)
    ys = torch.arange(H, dtype=torch.int32, device=m.device)
    xs = torch.arange(W, dtype=torch.int32, device=m.device)
    box = torch.stack([torch.where(cols, xs, W).amin(1),
                       torch.where(rows, ys, H).amin(1),
                       torch.where(cols, xs, -1).amax(1),
                       torch.where(rows, ys, -1).amax(1)], dim=-1)
    empty = ~rows.any(dim=1)
    return torch.where(empty[:, None], 0, box)[:, None, :].to(torch.int32)


def sample_box_points(masks, generator=None, noise: float = 0.1,
                      noise_bound: int = 20, top_left_label: int = 2,
                      bottom_right_label: int = 3, box_noise=None):
    """Noised top-left/bottom-right box-corner prompts from masks
    ``(B, 1, H, W)``. Returns ``(B, 2, 2)`` float32 (x, y) coords and
    ``(B, 2)`` int32 labels (2 top-left, 3 bottom-right). ``box_noise``:
    uniform[−1, 1) noise ``(B, 1, 4)``, else drawn from ``generator``."""
    masks = torch.as_tensor(masks).to(torch.bool)
    B, _, H, W = masks.shape
    box = mask_to_box(masks).to(torch.float32)              # (B, 1, 4)
    labels = torch.tensor([top_left_label, bottom_right_label],
                          dtype=torch.int32, device=masks.device).repeat(B)
    if noise > 0.0:
        bw = box[..., 2] - box[..., 0]
        bh = box[..., 3] - box[..., 1]
        max_dx = torch.clamp(bw * noise, max=float(noise_bound))
        max_dy = torch.clamp(bh * noise, max=float(noise_bound))
        if box_noise is None:
            box_noise = 2.0 * _uniform((B, 1, 4), generator,
                                       masks.device) - 1.0
        box_noise = torch.as_tensor(box_noise, dtype=torch.float32,
                                    device=masks.device) * torch.stack(
            [max_dx, max_dy, max_dx, max_dy], dim=-1)
        bounds = torch.tensor([W - 1, H - 1, W - 1, H - 1],
                              dtype=torch.float32, device=masks.device)
        box = torch.minimum(torch.clamp(box + box_noise, min=0.0), bounds)
    return box.reshape(-1, 2, 2), labels.reshape(-1, 2)


def _error_masks(gt_masks, pred_masks):
    gt = torch.as_tensor(gt_masks).to(torch.bool)
    pred = (torch.zeros_like(gt) if pred_masks is None
            else torch.as_tensor(pred_masks, device=gt.device).to(torch.bool))
    # (gt, pred, fp: a negative click corrects it, fn: a positive one)
    return gt, pred, ~gt & pred, gt & ~pred


def sample_random_points_from_errors(gt_masks, pred_masks, generator=None,
                                     num_pt: int = 1, pts_noise=None):
    """``num_pt`` random clicks from the error regions: the first argmax of
    masked uniform noise over the joint (FP, FN) channel map picks the
    pixel, its channel the label (1 positive / FN, 0 negative / FP); a
    prediction that is exactly right draws a negative click from the
    background. Returns ``(B, num_pt, 2)`` float32 (x, y) points and
    ``(B, num_pt)`` int32 labels. ``pts_noise``: uniform[0, 1)
    ``(B, num_pt, H, W, 2)``, else drawn from ``generator``."""
    gt, pred, fp, fn = _error_masks(gt_masks, pred_masks)
    B, _, H, W = gt.shape
    all_correct = (gt == pred).reshape(B, -1).all(dim=1)[:, None, None]
    if pts_noise is None:
        pts_noise = _uniform((B, num_pt, H, W, 2), generator, gt.device)
    pts_noise = torch.as_tensor(pts_noise, dtype=torch.float32,
                                device=gt.device)
    neg = (fp[:, 0] | (all_correct & ~gt[:, 0]))[:, None]   # (B, 1, H, W)
    pos = fn[:, 0][:, None]
    noise = torch.stack([pts_noise[..., 0] * neg, pts_noise[..., 1] * pos],
                        dim=-1)
    idx = _first_argmax(noise.reshape(B, num_pt, -1), dim=2)
    labels = (idx % 2).to(torch.int32)
    idx = idx // 2
    points = torch.stack([idx % W, idx // W], dim=2).to(torch.float32)
    return points, labels


def sample_one_point_from_error_center(gt_masks, pred_masks,
                                       padding: bool = True):
    """One deterministic click at the deepest pixel of the error regions:
    the greatest Euclidean distance to the region's boundary
    (:func:`skix_torch.ops.edt.edt` of the region's complement), positive
    if the deepest false negative beats the deepest false positive.
    Returns ``(B, 1, 2)`` float32 (x, y) points and ``(B, 1)`` int32
    labels."""
    gt, pred, fp, fn = _error_masks(gt_masks, pred_masks)
    B, _, H, W = gt.shape
    fp2, fn2 = fp[:, 0], fn[:, 0]
    if padding:
        fp2 = F.pad(fp2, (1, 1, 1, 1))
        fn2 = F.pad(fn2, (1, 1, 1, 1))
    fn_dt, fp_dt = edt(~fn2), edt(~fp2)
    if padding:
        fn_dt = fn_dt[:, 1:-1, 1:-1]
        fp_dt = fp_dt[:, 1:-1, 1:-1]
    fn_flat, fp_flat = fn_dt.reshape(B, -1), fp_dt.reshape(B, -1)
    is_positive = fn_flat.amax(-1) > fp_flat.amax(-1)
    chosen = torch.where(is_positive, _first_argmax(fn_flat),
                         _first_argmax(fp_flat))
    points = torch.stack([chosen % W, chosen // W], dim=-1).to(torch.float32)
    return points[:, None, :], is_positive.to(torch.int32)[:, None]


def get_next_point(gt_masks, pred_masks, method: str, generator=None):
    """The correction click of ``method``: ``"uniform"`` or ``"center"``."""
    if method == "uniform":
        return sample_random_points_from_errors(gt_masks, pred_masks,
                                                generator)
    if method == "center":
        return sample_one_point_from_error_center(gt_masks, pred_masks)
    raise ValueError(f"unknown sampling method {method}")


def get_1d_sine_pe(pos_inds, dim: int, temperature: float = 10000):
    """1-D sine positional embedding ``(..., dim)`` float32."""
    pos_inds = torch.as_tensor(pos_inds, dtype=torch.float32)
    pe_dim = dim // 2
    dim_t = torch.arange(pe_dim, dtype=torch.float32, device=pos_inds.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / pe_dim)
    pos = pos_inds[..., None] / dim_t
    return torch.cat([torch.sin(pos), torch.cos(pos)], dim=-1)


def get_best_gt_match_from_multimasks(pred_multimasks, gt_masks,
                                      pred_scores=None):
    """The multimask channel ``(B, 1, H, W)`` that best matches the ground
    truth by IoU, ``pred_scores`` deciding when every IoU of the batch is
    zero (the reference's batch-wide test, kept)."""
    pred_multimasks = torch.as_tensor(pred_multimasks)
    if pred_multimasks.shape[1] == 1:
        return pred_multimasks
    gt = torch.as_tensor(gt_masks, device=pred_multimasks.device).to(
        torch.bool)
    binary = pred_multimasks > 0
    area_i = (binary & gt).sum(dim=(2, 3)).to(torch.float32)
    area_u = (binary | gt).sum(dim=(2, 3)).to(torch.float32)
    ious = area_i / torch.clamp(area_u, min=1.0)
    scores = ious
    if pred_scores is not None and not bool((ious > 0).any()):
        scores = torch.as_tensor(pred_scores, dtype=torch.float32,
                                 device=ious.device)
    best = _first_argmax(scores, dim=-1)
    return torch.take_along_dim(pred_multimasks,
                                best[:, None, None, None], dim=1)


def select_closest_cond_frames(frame_idx: int, frame_indices, valid,
                               max_cond_frame_num: int,
                               keep_first_cond_frame: bool = False):
    """Which of ``N`` conditioning slots condition frame ``frame_idx``:
    the closest slot strictly before it and the closest at or after it
    (and, with ``keep_first_cond_frame``, the first), then the nearest
    others until ``max_cond_frame_num`` (−1 keeps every valid slot); ties
    in distance go to the earlier frame. ``frame_indices (N,)`` int,
    ``valid (N,)`` bool. Returns (selected, unselected) bool ``(N,)``.
    The reference's quirk with ``keep_first_cond_frame`` (forced picks
    over the budget keep all but the last candidates) is kept."""
    t = torch.as_tensor(frame_indices).to(torch.int64)
    valid = torch.as_tensor(valid, device=t.device).to(torch.bool)
    N = t.shape[0]
    if max_cond_frame_num == -1:
        return valid, torch.zeros_like(valid)
    assert max_cond_frame_num >= 2, "allow using 2+ conditioning frames"
    arange = torch.arange(N, device=t.device)
    i32 = torch.iinfo(torch.int32)

    def slot_of_max(mask):
        return _first_argmax(torch.where(mask, t, i32.min)), bool(mask.any())

    def slot_of_min(mask):
        return _first_argmin(torch.where(mask, t, i32.max)), bool(mask.any())

    before = valid & (t < frame_idx)
    forced = torch.zeros(N, dtype=torch.bool, device=t.device)
    if keep_first_cond_frame:
        first, has_first = slot_of_min(before)
        alt, has_alt = slot_of_max(valid & (t > frame_idx))
        if has_first or has_alt:
            forced |= arange == (first if has_first else alt)
    b_slot, has_b = slot_of_max(before)
    if has_b:
        forced |= arange == b_slot
    a_slot, has_a = slot_of_min(valid & (t >= frame_idx))
    if has_a:
        forced |= arange == a_slot

    # fill the rest by |t − frame_idx|, ties by ascending t
    cand = valid & ~forced
    penalty = torch.where(cand, (t - frame_idx).abs().to(torch.float32),
                          torch.full((N,), _INF, device=t.device))
    order = torch.sort(t, stable=True).indices
    order = order[torch.sort(penalty[order], stable=True).indices]
    rank = torch.empty_like(arange)
    rank[order] = arange
    room = max_cond_frame_num - int(forced.sum())
    n_cand = int(cand.sum())
    take = max(room if room >= 0 else n_cand + room, 0)
    fill = cand & (rank < take)
    selected = (valid if int(valid.sum()) <= max_cond_frame_num
                else forced | fill)
    return selected, valid & ~selected
