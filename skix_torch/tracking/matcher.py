"""Set matching and the detector's training losses.

Port of ``skix/tracking/matcher.py``: box helpers, the DETR matching cost,
the greedy assignment (one-to-one, and one-to-many with ``repeats`` for
the DAC o2m queries), the focal / IoU-aware BCE / presence / dice losses,
``detection_loss``, ``sam3_detection_loss`` and ``sam3_mask_loss`` on the
full grid and on PointRend's sampled points, and the video association
losses (``det2trk_assoc_loss``, ``tracking_by_detection_assoc_loss``). skix maps its per-image
functions over the batch with ``jax.vmap``; here every function takes
leading batch axes, and the aux layers of the decoder ride the same batched
call.

``torch.argmin`` returns the first minimum, as ``jnp.argmin`` does, so the
greedy assignment takes the same pairs from the same costs. Matching is
discrete: the assignment carries no gradient (it is built from a detached
cost), the losses are differentiable.

The exact assignment (``exact=True``) is skix's Bertsekas auction with
ε-scaling (:func:`auction_assign`). skix runs its rounds in a
``lax.while_loop``; here a round is a handful of tensor ops over every
problem of the batch at once, and the host reads one flag a round to stop.
Every quantity is float32 and every discrete choice is a stable sort or a
first-occurrence argmax, so the card and the CPU give the same assignment.
The PointRend points are drawn on the CPU from an explicit
``torch.Generator`` and moved to the device (:func:`uniform_points`), so the
card and the CPU sample the same points.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from skix_torch.ops.nms import box_iou

# the auction's ε phases and bidding rounds since the last reset (read by
# the chip smoke test, which zeroes it)
AUCTION_ROUNDS = {"phases": 0, "rounds": 0, "max_per_phase": 0}


# --------------------------------------------------------------------------
# boxes (cxcywh normalized, DETR convention)
# --------------------------------------------------------------------------
def cxcywh_to_xyxy(b):
    cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def generalized_iou(a_xyxy, b_xyxy):
    """Pairwise gIoU ``(..., N, M)`` of ``(..., N, 4)`` and ``(..., M, 4)``."""
    iou = box_iou(a_xyxy, b_xyxy)
    lt = torch.minimum(a_xyxy[..., :, None, :2], b_xyxy[..., None, :, :2])
    rb = torch.maximum(a_xyxy[..., :, None, 2:], b_xyxy[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    hull = wh[..., 0] * wh[..., 1]
    area_a = (torch.clamp(a_xyxy[..., 2] - a_xyxy[..., 0], min=0)
              * torch.clamp(a_xyxy[..., 3] - a_xyxy[..., 1], min=0))
    area_b = (torch.clamp(b_xyxy[..., 2] - b_xyxy[..., 0], min=0)
              * torch.clamp(b_xyxy[..., 3] - b_xyxy[..., 1], min=0))
    areas = area_a[..., :, None] + area_b[..., None, :]
    inter = iou * areas / (1 + iou + 1e-9)
    union = areas - inter
    return iou - (hull - union) / (hull + 1e-9)


def _elementwise_iou(a_xyxy, b_xyxy, eps: float = 1e-7):
    """Paired box IoU: ``a, b (..., 4)`` xyxy → ``(...)``."""
    lt = torch.maximum(a_xyxy[..., :2], b_xyxy[..., :2])
    rb = torch.minimum(a_xyxy[..., 2:], b_xyxy[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (torch.clamp(a_xyxy[..., 2] - a_xyxy[..., 0], min=0.0)
              * torch.clamp(a_xyxy[..., 3] - a_xyxy[..., 1], min=0.0))
    area_b = (torch.clamp(b_xyxy[..., 2] - b_xyxy[..., 0], min=0.0)
              * torch.clamp(b_xyxy[..., 3] - b_xyxy[..., 1], min=0.0))
    return inter / (area_a + area_b - inter + eps)


def _take(x, idx):
    """``x (..., G, *rest)`` at ``idx (..., Q)`` along the G axis →
    ``(..., Q, *rest)`` (skix's per-image ``x[idx]``)."""
    lead = idx.shape[:-1]
    flat_x = x.reshape(-1, *x.shape[len(lead):])
    flat_i = idx.reshape(-1, idx.shape[-1])
    rows = torch.arange(flat_x.shape[0], device=x.device)[:, None]
    out = flat_x[rows, flat_i]
    return out.reshape(*lead, *out.shape[1:])


# --------------------------------------------------------------------------
# matching
# --------------------------------------------------------------------------
def matching_cost(pred_boxes, pred_scores, gt_boxes, cost_class: float = 1.0,
                  cost_l1: float = 5.0, cost_giou: float = 2.0):
    """DETR matching cost ``(..., Q, G)``: −score + L1(box) − gIoU."""
    l1 = (pred_boxes[..., :, None, :] - gt_boxes[..., None, :, :]).abs().sum(-1)
    giou = generalized_iou(cxcywh_to_xyxy(pred_boxes),
                           cxcywh_to_xyxy(gt_boxes))
    return (-cost_class * pred_scores[..., :, None] + cost_l1 * l1
            - cost_giou * giou)


def greedy_assign(cost, gt_valid, rounds: int | None = None,
                  repeats: int = 1):
    """Fixed-iteration greedy assignment: take the global minimum-cost pair,
    strike its row and column, repeat. ``cost (..., Q, G)``, ``gt_valid
    (..., G)`` → ``assign (..., Q)`` int64, the gt index or −1.

    ``repeats > 1`` gives one-to-many matching: the cost columns are tiled
    ``repeats`` times, so each ground-truth box takes up to ``repeats``
    distinct queries (the DAC o2m assignment)."""
    Q, G = cost.shape[-2:]
    lead = cost.shape[:-2]
    if repeats > 1:
        cost = cost.repeat(*([1] * (cost.dim() - 1)), repeats)
        gt_valid = gt_valid.repeat(*([1] * (gt_valid.dim() - 1)), repeats)
    Gr = G * repeats
    big = 1e9
    m = torch.where(gt_valid[..., None, :], cost.detach(),
                    torch.full_like(cost, big)).reshape(-1, Q * Gr)
    n = m.shape[0]
    rounds = rounds if rounds is not None else min(Q, Gr)
    dev = cost.device
    rows = torch.arange(n, device=dev)
    q_ids = torch.arange(Q, device=dev)
    g_ids = torch.arange(Gr, device=dev)
    assign = torch.full((n, Q), -1, dtype=torch.int64, device=dev)
    for _ in range(rounds):
        flat = torch.argmin(m, dim=1)
        qi, gi = flat // Gr, flat % Gr
        ok = m[rows, flat] < big / 2
        assign[rows, qi] = torch.where(ok, gi % G, assign[rows, qi])
        strike = (((q_ids[None, :] == qi[:, None])[:, :, None]
                   | (g_ids[None, :] == gi[:, None])[:, None, :])
                  & ok[:, None, None])
        m = m.masked_fill(strike.reshape(n, Q * Gr), big)
    return assign.reshape(*lead, Q)


def auction_assign(cost, gt_valid, repeats: int = 1, n_phases: int = 9,
                   scale: float = 8.0, max_rounds: int = 512):
    """Exact linear assignment: skix's Bertsekas forward auction with
    ε-scaling. ``cost (..., Q, G)``, ``gt_valid (..., G)`` → ``assign
    (..., Q)`` int64, the gt index or −1.

    Persons are the valid gt columns, objects the queries; every unassigned
    person bids at once (the Jacobi variant). Prices persist over
    ``n_phases`` phases whose ε shrinks by ``scale`` down to 1e-8 of the
    cost range, so the last phase's assignment is optimal to n·ε. Two rules
    keep the rounds few, as in skix: the queries no person can take go to
    interchangeable dummy persons, which take the cheapest objects in one
    waterfill a round, and with ``repeats > 1`` (one-to-many, the DAC o2m
    matching) each gt is a group of ``repeats`` similar persons whose u
    unassigned members bid on its u best objects against the common
    (u+1)-th best value. A phase stops after ``max_rounds`` rounds, or once
    every query is owned when there are more gt slots than queries.

    The problems of the leading axes run together: a round updates those
    still bidding, as skix's ``vmap`` of its ``while_loop`` does, and the
    host reads whether any still bids once a round."""
    cost = cost.detach().to(torch.float32)
    Q, G = cost.shape[-2:]
    lead = cost.shape[:-2]
    r = int(repeats)
    dev = cost.device
    cost = cost.reshape(-1, Q, G)
    valid = gt_valid.reshape(-1, G).to(torch.bool)
    n = cost.shape[0]
    if n == 0 or Q == 0 or G == 0:
        return torch.full((*lead, Q), -1, dtype=torch.int64, device=dev)

    cost_t = cost.transpose(1, 2)                            # (n, G, Q)
    vq = valid[:, :, None]
    zero = torch.zeros((), device=dev)
    benefit = torch.where(vq, -cost_t, zero)
    finite = torch.where(vq, cost_t, zero)
    span = torch.clamp(finite.amax((1, 2)) - finite.amin((1, 2)), min=1e-6)
    eps0 = span / 2.0
    eps_min = span * 1e-8
    neg = -1e30
    qs = torch.arange(Q, device=dev)
    gs = torch.arange(G, device=dev)
    k_dummy = Q - r * valid.sum(1)                           # (n,), may be ≤ 0
    topk = min(r + 1, Q)
    slots = torch.arange(topk, device=dev)
    rank_ids = qs.expand(n, Q)

    def group_counts(owner):
        real = (owner >= 0) & (owner < G)
        return torch.zeros((n, G), dtype=torch.int64, device=dev).scatter_add_(
            1, owner.clamp(0, G - 1), real.to(torch.int64))

    def bidding(owner):
        short = (valid & (group_counts(owner) < r)).any(1)
        # more valid slots than queries: stop once every query is owned
        return short & ((owner >= 0).sum(1) < Q)

    def round_body(price, owner, eps):
        u = torch.where(valid, r - group_counts(owner), 0)   # (n, G)
        held = owner[:, None, :] == gs[None, :, None]        # (n, G, Q)
        v = torch.where(vq & ~held, benefit - price[:, None, :],
                        torch.full((), neg, device=dev))
        vals, idxs = torch.sort(v, dim=-1, descending=True, stable=True)
        vals, idxs = vals[..., :topk], idxs[..., :topk]
        # the group's common w2: its (u+1)-th best available value
        w2 = vals.gather(-1, u.clamp(0, topk - 1)[..., None])[..., 0]
        w2 = torch.where(w2 > neg / 2, w2, vals[..., 0] - eps0[:, None])
        # slot i of a group bids on its i-th best object when i < u
        slot_ok = (slots < u[..., None]) & (vals > neg / 2)  # (n, G, topk)
        bids = benefit.gather(-1, idxs) - w2[..., None]
        onehot = (idxs[..., None] == qs) & slot_ok[..., None]
        bidm = torch.where(onehot, bids[..., None],
                           torch.full((), neg, device=dev)).reshape(
            n, G * topk, Q)
        best_bid = bidm.amax(1)
        win = torch.argmax(bidm, 1) // topk                  # first maximum
        has = best_bid > neg / 2
        price = torch.where(has, best_bid + eps[:, None], price)
        owner = torch.where(has, win, owner)
        # waterfill: the unassigned dummies take the k_dummy cheapest
        # objects, levelled to the (k_dummy+1)-th smallest price
        du = k_dummy - (owner == G).sum(1)
        order = torch.argsort(price, dim=1, stable=True)
        ranks = torch.empty_like(order).scatter_(1, order, rank_ids)
        level = price.gather(1, order.gather(
            1, k_dummy.clamp(0, Q - 1)[:, None]))
        grab = ((ranks < k_dummy[:, None]) & (du > 0)[:, None]
                & (k_dummy > 0)[:, None])
        price = torch.where(grab, torch.maximum(price, level), price)
        owner = torch.where(grab, G, owner)
        return price, owner

    price = torch.zeros((n, Q), device=dev)
    owner = torch.full((n, Q), -1, dtype=torch.int64, device=dev)
    for kp in range(n_phases):
        eps = torch.maximum(eps0 * scale ** -kp, eps_min)
        owner = torch.full((n, Q), -1, dtype=torch.int64, device=dev)
        rounds = 0
        while rounds < max_rounds:
            active = bidding(owner)
            if not bool(active.any()):
                break
            p2, o2 = round_body(price, owner, eps)
            price = torch.where(active[:, None], p2, price)
            owner = torch.where(active[:, None], o2, owner)
            rounds += 1
        AUCTION_ROUNDS["phases"] += 1
        AUCTION_ROUNDS["rounds"] += rounds
        AUCTION_ROUNDS["max_per_phase"] = max(
            AUCTION_ROUNDS["max_per_phase"], rounds)
    real = (owner >= 0) & (owner < G)
    return torch.where(real, owner, -1).reshape(*lead, Q)


def hungarian_assign_host(cost: np.ndarray, gt_valid: np.ndarray
                          ) -> np.ndarray:
    """Exact Hungarian assignment on the host (scipy), skix's reference
    and evaluation path: ``cost (Q, G)``, ``gt_valid (G,)`` → ``(Q,)``
    int64, the gt index or −1."""
    from scipy.optimize import linear_sum_assignment

    assign = np.full(cost.shape[0], -1, np.int64)
    if int(gt_valid.sum()) == 0:
        return assign
    rows, cols = linear_sum_assignment(cost[:, gt_valid.astype(bool)])
    assign[rows] = np.where(gt_valid)[0][cols]
    return assign


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
def optax_sigmoid_ce(logits, labels):
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25,
                       gamma: float = 2.0):
    """Per-element focal loss."""
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return a_t * ((1 - p_t) ** gamma) * ce


def dice_loss(mask_logits, target_masks, eps: float = 1.0):
    """Dice over the last two axes (flattened): ``(..., H, W)`` vs the same
    → ``(...)``."""
    p = torch.sigmoid(mask_logits).flatten(-2)
    t = target_masks.flatten(-2)
    num = 2 * (p * t).sum(-1) + eps
    den = p.sum(-1) + t.sum(-1) + eps
    return 1 - num / den


def iabce_classification_loss(pred_logits, pred_boxes_cxcywh, gt_boxes,
                              assign, pos_weight: float = 10.0,
                              alpha: float = 0.25, gamma: float = 2.0,
                              keep=None):
    """IoU-aware BCE classification per image, ``(..., Q)`` logits →
    ``(...)``: matched queries take BCE against the detached soft target
    ``clip(p^alpha · IoU^(1−alpha), 0.01)`` times ``pos_weight``, the others
    BCE against 0 times ``p^gamma``; mean over queries; ``keep (...)``
    zeroes an image with no visible ground truth."""
    prob = torch.sigmoid(pred_logits)
    matched = assign >= 0
    safe = torch.clamp(assign, min=0)
    iou = _elementwise_iou(cxcywh_to_xyxy(pred_boxes_cxcywh),
                           cxcywh_to_xyxy(_take(gt_boxes, safe)))
    t = torch.clamp(prob ** alpha * torch.clamp(iou, min=0.0) ** (1 - alpha),
                    min=0.01)
    t = torch.where(matched, t, torch.zeros_like(t)).detach()
    pos = optax_sigmoid_ce(pred_logits, t) * matched * pos_weight
    neg = (optax_sigmoid_ce(pred_logits, torch.zeros_like(t)) * ~matched
           * prob ** gamma)
    loss = (pos + neg).mean(-1)
    if keep is not None:
        loss = loss * keep.to(loss.dtype)
    return loss


def presence_loss(presence_logit, gt_boxes, gt_valid, alpha: float = 0.5,
                  gamma: float = 0.0):
    """Presence-head focal BCE per image against "a visible ground truth
    exists" (valid, w > 0, h > 0); returns ``(loss, keep)``, each
    ``(...)``."""
    visible = gt_valid & (gt_boxes[..., 2] > 0) & (gt_boxes[..., 3] > 0)
    keep = visible.any(-1).to(torch.float32)
    ce = optax_sigmoid_ce(presence_logit, keep)
    p = torch.sigmoid(presence_logit)
    p_t = p * keep + (1 - p) * (1 - keep)
    a_t = alpha * keep + (1 - alpha) * (1 - keep)
    return a_t * ((1 - p_t) ** gamma) * ce, keep


def _same_object(ids_a, ids_b):
    """``(B, Qa, Qb)``: both matched (id ≥ 0) to the same GT object id."""
    a_m, b_m = ids_a >= 0, ids_b >= 0
    return (a_m[:, :, None] & b_m[:, None, :]
            & (ids_a[:, :, None] == ids_b[:, None, :]))


def _assoc_labels(same, src_matched, new_label: int):
    """Per source query: the first target sharing its GT object id (a
    first-occurrence argmax over ``same (B, Qsrc, Qtgt)``), else
    ``new_label`` where the source is matched, else −1 (ignored)."""
    has = same.any(-1)
    idx = torch.argmax(same.to(torch.uint8), -1)
    labels = torch.where(has, idx, torch.full_like(idx, -1))
    return torch.where(src_matched & ~has, torch.full_like(idx, new_label),
                       labels)


def _assoc_ce(logits, labels, frame_has_trk, num_boxes):
    """Softmax CE of ``logits (B, Q, K)`` at ``labels`` (−1 ignored), zeroed
    on frames with no valid track, summed over ``B * max(num_boxes, 1)``."""
    logp = torch.log_softmax(logits, -1)
    ce = -torch.gather(logp, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    ce = torch.where(labels >= 0, ce, torch.zeros_like(ce))
    ce = ce * frame_has_trk.to(ce.dtype)
    nb = torch.as_tensor(num_boxes, dtype=ce.dtype, device=ce.device)
    return ce.sum() / (logits.shape[0] * torch.clamp(nb, min=1))


def det2trk_assoc_loss(assoc_logits, matched_obj_ids_det,
                       matched_obj_ids_trk, num_boxes,
                       det_logits=None, use_fp_loss: bool = False,
                       treat_fp_as_new_obj: bool = False,
                       is_exhaustive=None):
    """Detection→tracking association loss (skix's ``det2trk_assoc_loss``,
    the reference's ``Det2TrkAssoc.get_loss``, train/loss/loss_fns.py:
    1153-1226): label = index of the tracking query matched to the same GT
    object id; else ``Q_trk`` ("new object") when matched to GT but no
    track; else ``Q_trk + 1`` ("false positive") when unmatched with
    score > 0 and ``use_fp_loss`` (optionally exhaustive-only / folded into
    new-object); else −1 (ignored). Softmax CE over ``Q_trk + 2`` classes,
    zeroed on frames with no valid tracking query, normalized by
    ``B * max(num_boxes, 1)``.

    ``assoc_logits (B, Q_det, Q_trk+2)``; ``matched_obj_ids_* (B, Q)``
    int (−1 = unmatched); differentiable in the logits.
    """
    Q_trk = assoc_logits.shape[-1] - 2
    det_m = matched_obj_ids_det >= 0
    labels = _assoc_labels(_same_object(matched_obj_ids_det,
                                        matched_obj_ids_trk), det_m, Q_trk)
    if use_fp_loss:
        if det_logits is None:
            raise ValueError("use_fp_loss requires det_logits")
        fp = ~det_m & (det_logits > 0)
        if treat_fp_as_new_obj:
            labels = torch.where(fp, torch.full_like(labels, Q_trk), labels)
        else:
            if is_exhaustive is not None:
                fp = fp & is_exhaustive[:, None]
            labels = torch.where(fp, torch.full_like(labels, Q_trk + 1),
                                 labels)
    frame_has_trk = (matched_obj_ids_trk >= 0).any(-1, keepdim=True)
    return _assoc_ce(assoc_logits, labels, frame_has_trk, num_boxes)


def tracking_by_detection_assoc_loss(assoc_logits, matched_obj_ids_det,
                                     prev_trk_object_ids, num_boxes):
    """Bidirectional association loss (skix's
    ``tracking_by_detection_assoc_loss``, the reference's
    ``TrackingByDetectionAssoc.get_loss``, train/loss/loss_fns.py:
    1229-1307). ``assoc_logits (B, Q_det+1, Q_trk+1)``: the last row and
    column are the "occluded"/"new-object" classes.

    - det→trk: CE over ``Q_trk+1`` on rows ``:-1`` — label = matching
      track index, ``Q_trk`` ("new object") when GT-matched trackless,
      −1 ignored;
    - trk→det: the transposed table, CE over ``Q_det+1`` — label =
      matching detection index, ``Q_det`` ("occluded") when GT-matched
      detectionless, −1 ignored;
    - both gated on frames with ≥1 valid track and normalized by
      ``B * max(num_boxes, 1)``. Returns ``(loss_det2trk, loss_trk2det)``.
    """
    Q_det, Q_trk = assoc_logits.shape[1] - 1, assoc_logits.shape[2] - 1
    det_m = matched_obj_ids_det >= 0
    trk_m = prev_trk_object_ids >= 0
    same = _same_object(matched_obj_ids_det, prev_trk_object_ids)
    frame_has_trk = trk_m.any(-1, keepdim=True)
    d2t = _assoc_ce(assoc_logits[:, :-1], _assoc_labels(same, det_m, Q_trk),
                    frame_has_trk, num_boxes)
    t2d = _assoc_ce(assoc_logits.transpose(1, 2)[:, :-1],
                    _assoc_labels(same.transpose(1, 2), trk_m, Q_det),
                    frame_has_trk, num_boxes)
    return d2t, t2d


class DetrLosses(NamedTuple):
    total: torch.Tensor
    cls: torch.Tensor
    l1: torch.Tensor
    giou: torch.Tensor


def detection_loss(pred_boxes, pred_logits, gt_boxes, gt_valid,
                   w_class: float = 1.0, w_l1: float = 5.0,
                   w_giou: float = 2.0, repeats: int = 1,
                   exact: bool = False, cls: str = "focal",
                   pos_weight: float = 10.0) -> DetrLosses:
    """Matched set loss per image: the greedy assignment (the auction with
    ``exact``), then classification (``cls`` "focal" or "iabce") + L1 +
    gIoU on the matched pairs.
    ``pred_boxes (..., Q, 4)``, ``pred_logits (..., Q)``, ``gt_boxes
    (..., G, 4)``, ``gt_valid (..., G)``; each loss is ``(...)``.
    ``repeats > 1`` matches one-to-many (DAC o2m)."""
    scores = torch.sigmoid(pred_logits)
    cost = matching_cost(pred_boxes, scores, gt_boxes)
    assign_fn = auction_assign if exact else greedy_assign
    assign = assign_fn(cost, gt_valid, repeats=repeats)
    matched = assign >= 0
    safe = torch.clamp(assign, min=0)
    tgt = _take(gt_boxes, safe)
    if cls == "iabce":
        visible = gt_valid & (gt_boxes[..., 2] > 0) & (gt_boxes[..., 3] > 0)
        cls_loss = iabce_classification_loss(
            pred_logits, pred_boxes, gt_boxes, assign,
            pos_weight=pos_weight, keep=visible.any(-1))
    else:
        cls_loss = sigmoid_focal_loss(pred_logits,
                                      matched.to(torch.float32)).mean(-1)
    n = matched.sum(-1)
    l1 = torch.where(matched[..., None], (pred_boxes - tgt).abs(),
                     torch.zeros_like(tgt)).sum((-1, -2)) / (n * 4 + 1e-6)
    g = generalized_iou(cxcywh_to_xyxy(pred_boxes), cxcywh_to_xyxy(gt_boxes))
    g_matched = torch.gather(g, -1, safe[..., None])[..., 0]
    giou = torch.where(matched, 1.0 - g_matched,
                       torch.zeros_like(g_matched)).sum(-1) / (n + 1e-6)
    total = w_class * cls_loss + w_l1 * l1 + w_giou * giou
    return DetrLosses(total=total, cls=cls_loss, l1=l1, giou=giou)


def _layer_means(boxes, logits, gt_boxes, gt_valid, **kw):
    """Per-layer batch means of ``detection_loss(...).total`` for stacked
    layers ``boxes (L, B, Q, 4)``, ``logits (L, B, Q)``: the layers share
    one batched matching, skix maps them one by one."""
    L, B = boxes.shape[:2]
    gb = gt_boxes.expand(L, *gt_boxes.shape)
    gv = gt_valid.expand(L, *gt_valid.shape)
    total = detection_loss(boxes, logits, gb, gv, **kw).total
    return [total[i].mean() for i in range(L)]


def sam3_detection_loss(out, gt_boxes, gt_valid, aux_weight: float = 0.5,
                        o2m_weight: float = 1.0, o2m_repeats: int = 3,
                        exact: bool = False, cls: str = "focal",
                        w_class: float = 1.0, w_presence: float = 0.0):
    """Batched SAM3 detector loss: the one-to-one matched loss, per-layer
    aux box supervision (each aux layer matched with its own logits when
    the detections carry ``aux_scores``, else with the final ones), the
    presence focal term at ``w_presence``, and, when the detections carry
    DAC ``o2m_*`` outputs, the one-to-many loss at ``o2m_weight``.
    ``gt_boxes (B, G, 4)`` cxcywh, ``gt_valid (B, G)`` bool."""
    kw = dict(exact=exact, cls=cls, w_class=w_class)

    def layers(boxes, logits, repeats=1):
        return _layer_means(torch.stack(boxes), torch.stack(logits),
                            gt_boxes, gt_valid, repeats=repeats, **kw)

    total = layers([out.boxes_cxcywh], [out.scores])[0]
    if w_presence and getattr(out, "presence", None) is not None:
        pres, _ = presence_loss(out.presence, gt_boxes, gt_valid)
        total = total + w_presence * pres.mean()
    n_aux = max(len(out.aux_boxes) - 1, 1)
    aux_scores = getattr(out, "aux_scores", ()) or ()
    if len(out.aux_boxes) > 1:
        aux_boxes = out.aux_boxes[:-1]
        aux = sum(layers(aux_boxes, [
            aux_scores[i] if i < len(aux_scores) else out.scores
            for i in range(len(aux_boxes))]))
        total = total + aux_weight * aux / n_aux
    if getattr(out, "o2m_boxes", None) is not None:
        o2m = layers([out.o2m_boxes], [out.o2m_scores], o2m_repeats)[0]
        o2m_aux_scores = getattr(out, "o2m_aux_scores", ()) or ()
        if len(out.o2m_aux_boxes) > 1:
            aux_boxes = out.o2m_aux_boxes[:-1]
            o2m_aux = sum(layers(aux_boxes, [
                o2m_aux_scores[i] if i < len(o2m_aux_scores)
                else out.o2m_scores for i in range(len(aux_boxes))],
                o2m_repeats))
            o2m = o2m + aux_weight * o2m_aux / n_aux
        total = total + o2m_weight * o2m
    return total


def point_sample(masks, coords):
    """Bilinear samples of ``masks (..., H, W)`` at ``coords (..., P, 2)``, xy
    in [0, 1]² → ``(..., P)``: ``F.grid_sample(align_corners=False,
    padding_mode="zeros")`` semantics written as skix writes them, four
    gathered taps, pixel centres at (i + 0.5)/N, a tap outside the mask
    contributing zero. The leading axes of both must match."""
    H, W = masks.shape[-2:]
    x = coords[..., 0] * W - 0.5
    y = coords[..., 1] * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    flat = masks.reshape(*masks.shape[:-2], H * W)

    def tap(xi, yi):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xi = xi.clamp(0, W - 1).to(torch.int64)
        yi = yi.clamp(0, H - 1).to(torch.int64)
        v = torch.gather(flat, -1, yi * W + xi)
        return torch.where(inside, v, torch.zeros((), device=v.device))

    v00 = tap(x0, y0)
    v01 = tap(x0 + 1, y0)
    v10 = tap(x0, y0 + 1)
    v11 = tap(x0 + 1, y0 + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def uniform_points(generator, shape, device):
    """``shape`` uniform draws in [0, 1) from the CPU ``generator``, moved to
    ``device``: the card and the CPU get the same points."""
    return torch.rand(shape, generator=generator).to(device)


def uncertain_point_coords(mask_logits, generator, num_points: int,
                           oversample_ratio: float = 3.0,
                           importance_ratio: float = 0.75):
    """PointRend uncertainty sampling with uncertainty −|logit| (skix's
    ``uncertain_point_coords``): ``num_points · oversample_ratio`` uniform
    candidates per mask, the ``importance_ratio`` share of them with the
    smallest |sampled logit| (a stable sort: the lowest index on ties), the
    rest fresh uniform points. ``mask_logits (..., H, W)`` → ``(...,
    num_points, 2)`` xy in [0, 1]², no gradient."""
    n_over = int(num_points * oversample_ratio)
    n_imp = int(importance_ratio * num_points)
    n_rand = num_points - n_imp
    lead = mask_logits.shape[:-2]
    dev = mask_logits.device
    cand = uniform_points(generator, (*lead, n_over, 2), dev)
    unc = -point_sample(mask_logits.detach(), cand).abs()
    idx = torch.sort(unc, dim=-1, descending=True,
                     stable=True).indices[..., :n_imp]
    picked = torch.gather(cand, -2, idx[..., None].expand(*idx.shape, 2))
    if n_rand > 0:
        fresh = uniform_points(generator, (*lead, n_rand, 2), dev)
        picked = torch.cat([picked, fresh], -2)
    return picked


def sam3_mask_loss(out, gt_boxes, gt_masks, gt_valid, w_ce: float = 1.0,
                   w_dice: float = 1.0, exact: bool = False,
                   num_sample_points: int | None = None,
                   oversample_ratio: float = 3.0,
                   importance_ratio: float = 0.75, generator=None):
    """Matched mask supervision: queries are assigned to ground truth by the
    box/score cost (greedy; the auction with ``exact``), then each matched
    query's mask logits against its mask ``gt_masks (B, G, Hg, Wg)`` bool:
    on the full grid, sigmoid CE + dice with the masks resized (nearest, as
    ``jax.image.resize``) to the logits' ``(Hm, Wm)``; with
    ``num_sample_points``, PointRend's sampled loss, focal + dice on that
    many uncertainty-sampled points a mask (drawn from ``generator``), the
    ground truth sampled at its own resolution."""
    from skix_torch.utils.image import resize

    B, Q, Hm, Wm = out.mask_logits.shape
    sampled = num_sample_points is not None
    if sampled and generator is None:
        raise ValueError("num_sample_points requires a generator")
    gt_masks = gt_masks.to(torch.float32)
    if not sampled and gt_masks.shape[-2:] != (Hm, Wm):
        gt_masks = resize(gt_masks, (*gt_masks.shape[:-2], Hm, Wm), "nearest")
    cost = matching_cost(out.boxes_cxcywh, torch.sigmoid(out.scores), gt_boxes)
    assign = (auction_assign if exact else greedy_assign)(cost, gt_valid)
    matched = assign >= 0
    tgt = _take(gt_masks, torch.clamp(assign, min=0))   # (B, Q, H·, W·)
    if sampled:
        coords = uncertain_point_coords(out.mask_logits, generator,
                                        int(num_sample_points),
                                        oversample_ratio, importance_ratio)
        p_pts = point_sample(out.mask_logits, coords)        # (B, Q, P)
        t_pts = point_sample(tgt, coords)
        ce = sigmoid_focal_loss(p_pts, t_pts).mean(-1)
        d = dice_loss(p_pts[..., None], t_pts[..., None])
    else:
        ce = optax_sigmoid_ce(out.mask_logits, tgt).mean((-1, -2))
        d = dice_loss(out.mask_logits, tgt)
    per_q = torch.where(matched, w_ce * ce + w_dice * d, torch.zeros_like(ce))
    return (per_q.sum(-1) / torch.clamp(matched.sum(-1), min=1)).mean()
