"""Set matching and the detector's training losses.

Port of ``skix/tracking/matcher.py``: box helpers, the DETR matching cost,
the greedy assignment (one-to-one, and one-to-many with ``repeats`` for
the DAC o2m queries), the focal / IoU-aware BCE / presence / dice losses,
``detection_loss``, ``sam3_detection_loss`` and ``sam3_mask_loss`` on its
full-grid path. skix maps its per-image functions over the batch with
``jax.vmap``; here every function takes leading batch axes, and the aux
layers of the decoder ride the same batched call.

``torch.argmin`` returns the first minimum, as ``jnp.argmin`` does, so the
greedy assignment takes the same pairs from the same costs. Matching is
discrete: the assignment carries no gradient (it is built from a detached
cost), the losses are differentiable.

Still to port, each raising ``NotImplementedError``: the exact auction
assignment (``exact=True``) and the PointRend sampled mask loss
(``num_sample_points``), which draws its points from ``jax.random``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from skix_torch.ops.nms import box_iou

_AUCTION_SLICE = ("exact matching (auction_assign) comes with ROADMAP "
                  "Queue 1 item 12")
_POINTREND_SLICE = ("the PointRend sampled mask loss (num_sample_points) "
                    "comes with ROADMAP Queue 1 item 12")


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


def refuse_unported(exact: bool, num_sample_points=None) -> None:
    """Raise ``NotImplementedError`` for the options still to port: exact
    (auction) matching and the PointRend sampled mask loss."""
    if exact:
        raise NotImplementedError(_AUCTION_SLICE)
    if num_sample_points is not None:
        raise NotImplementedError(_POINTREND_SLICE)


def auction_assign(cost, gt_valid, repeats: int = 1, **kw):
    """skix's exact auction assignment: not ported yet."""
    raise NotImplementedError(_AUCTION_SLICE)


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
    """Matched set loss per image: greedy assignment, then classification
    (``cls`` "focal" or "iabce") + L1 + gIoU on the matched pairs.
    ``pred_boxes (..., Q, 4)``, ``pred_logits (..., Q)``, ``gt_boxes
    (..., G, 4)``, ``gt_valid (..., G)``; each loss is ``(...)``.
    ``repeats > 1`` matches one-to-many (DAC o2m)."""
    refuse_unported(exact)
    scores = torch.sigmoid(pred_logits)
    cost = matching_cost(pred_boxes, scores, gt_boxes)
    assign = greedy_assign(cost, gt_valid, repeats=repeats)
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


def sam3_mask_loss(out, gt_boxes, gt_masks, gt_valid, w_ce: float = 1.0,
                   w_dice: float = 1.0, exact: bool = False,
                   num_sample_points: int | None = None, rng=None, **kw):
    """Matched mask supervision on the full grid: queries are assigned to
    ground truth by the box/score cost (greedy), then sigmoid CE + dice
    between each matched query's mask logits and its mask. ``gt_masks (B,
    G, Hg, Wg)`` bool, resized (nearest, as ``jax.image.resize``) to the
    logits' ``(Hm, Wm)``."""
    from skix_torch.utils.image import resize

    refuse_unported(exact, num_sample_points)
    B, Q, Hm, Wm = out.mask_logits.shape
    gt_masks = gt_masks.to(torch.float32)
    if gt_masks.shape[-2:] != (Hm, Wm):
        gt_masks = resize(gt_masks, (*gt_masks.shape[:-2], Hm, Wm), "nearest")
    cost = matching_cost(out.boxes_cxcywh, torch.sigmoid(out.scores), gt_boxes)
    assign = greedy_assign(cost, gt_valid)
    matched = assign >= 0
    tgt = _take(gt_masks, torch.clamp(assign, min=0))      # (B, Q, Hm, Wm)
    ce = optax_sigmoid_ce(out.mask_logits, tgt).mean((-1, -2))
    d = dice_loss(out.mask_logits, tgt)
    per_q = torch.where(matched, w_ce * ce + w_dice * d, torch.zeros_like(ce))
    return (per_q.sum(-1) / torch.clamp(matched.sum(-1), min=1)).mean()
