"""YOLO-pose training loss: dense task-aligned assignment and the class,
box, DFL and keypoint terms (ultralytics' ``v8PoseLoss`` semantics).

Port of ``skix/models/yolo_loss.py``: the assignment is one dense (B, A, G)
tensor program over fixed ground-truth slots (``gt_valid`` masks the
padding). Its discrete choices, the per-gt top-k threshold and the
anchor's gt by largest IoU, are a stable sort (the lowest index on ties, as
``jax.lax.top_k``) and a first-occurrence argmax, so the card and the CPU
pick the same anchors.
"""

from __future__ import annotations

import math

import torch

from skix_torch.models.yolo_pose import (RawPredictions, decode_boxes,
                                         decode_keypoints)

# COCO-17 OKS sigmas (keypoint evaluation constants)
OKS_SIGMAS = (.026, .025, .025, .035, .035, .079, .079, .072, .072, .062,
              .062, .107, .107, .087, .087, .089, .089)


def box_iou_xyxy(a, b, eps: float = 1e-9):
    """IoU between ``(..., A, 4)`` and ``(..., G, 4)`` → ``(..., A, G)``."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]))[..., :, None]
    area_b = ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]))[..., None, :]
    return inter / (area_a + area_b - inter + eps)


def ciou(pred, gt, eps: float = 1e-9):
    """Complete IoU between matched ``(..., 4)`` xyxy boxes → ``(...)``."""
    lt = torch.maximum(pred[..., :2], gt[..., :2])
    rb = torch.minimum(pred[..., 2:], gt[..., 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    wp = pred[..., 2] - pred[..., 0]
    hp = pred[..., 3] - pred[..., 1]
    wg = gt[..., 2] - gt[..., 0]
    hg = gt[..., 3] - gt[..., 1]
    union = wp * hp + wg * hg - inter + eps
    iou = inter / union
    # enclosing box diagonal and centre distance
    elt = torch.minimum(pred[..., :2], gt[..., :2])
    erb = torch.maximum(pred[..., 2:], gt[..., 2:])
    c2 = ((erb - elt) ** 2).sum(-1) + eps
    pc = (pred[..., :2] + pred[..., 2:]) / 2
    gc = (gt[..., :2] + gt[..., 2:]) / 2
    rho2 = ((pc - gc) ** 2).sum(-1)
    v = (4 / math.pi ** 2) * (torch.arctan(wg / (hg + eps))
                              - torch.arctan(wp / (hp + eps))) ** 2
    alpha = v / (v - iou + (1 + eps))
    return iou - rho2 / c2 - alpha.detach() * v


def task_aligned_assign(raw: RawPredictions, gt_boxes, gt_cls, gt_valid,
                        topk: int = 10, alpha: float = 0.5,
                        beta: float = 6.0):
    """Dense TAL: align = score^alpha · iou^beta over the anchors inside a
    gt, the top-k anchors of each gt, an anchor claimed by several gts
    kept by the one of largest IoU. → ``(assigned_gt (B, A) int64, fg (B,
    A) bool, target_scores (B, A, nc))``."""
    pred_boxes = decode_boxes(raw).detach()                   # (B, A, 4)
    scores = torch.sigmoid(raw.cls_logits).detach()
    B, A, nc = scores.shape
    G = gt_boxes.shape[1]
    centers = raw.anchors * raw.strides[:, None]              # (A, 2) px

    iou = box_iou_xyxy(pred_boxes, gt_boxes)                  # (B, A, G)
    cls_score = torch.gather(scores, -1, gt_cls[:, None, :].expand(
        B, A, G).to(torch.int64))
    align = cls_score ** alpha * iou ** beta
    cx = centers[None, :, None, 0]
    cy = centers[None, :, None, 1]
    in_gt = ((cx > gt_boxes[:, None, :, 0]) & (cx < gt_boxes[:, None, :, 2])
             & (cy > gt_boxes[:, None, :, 1]) & (cy < gt_boxes[:, None, :, 3]))
    valid = in_gt & gt_valid[:, None, :]
    align = torch.where(valid, align, torch.zeros((), device=align.device))

    # the k-th largest align of each gt over the anchors
    k = min(topk, A)
    thresh = torch.sort(align.transpose(1, 2), dim=-1, descending=True,
                        stable=True).values[..., k - 1]       # (B, G)
    mask = valid & (align >= torch.clamp(thresh[:, None, :], min=1e-9))

    # an anchor claimed by several gts: the one of largest IoU (the first)
    masked_iou = torch.where(mask, iou, torch.full((), -1.0,
                                                   device=iou.device))
    assigned = torch.argmax(masked_iou, -1)                   # (B, A)
    fg = mask.any(-1)

    # target scores: per gt its aligns scaled so that the largest is its
    # largest IoU
    zero = torch.zeros((), device=align.device)
    pos_align = torch.where(mask, align, zero)
    max_align = pos_align.amax(1, keepdim=True)               # (B, 1, G)
    max_iou = torch.where(mask, iou, zero).amax(1, keepdim=True)
    norm = pos_align * max_iou / (max_align + 1e-9)           # (B, A, G)
    t = torch.gather(norm, -1, assigned[..., None])[..., 0]
    cls_onehot = torch.nn.functional.one_hot(
        torch.gather(gt_cls.to(torch.int64), -1, assigned), nc).to(
        torch.float32)
    target_scores = cls_onehot * torch.where(fg, t, zero)[..., None]
    return assigned, fg, target_scores


def pose_detection_loss(raw: RawPredictions, gt_boxes, gt_kpts, gt_valid,
                        gt_cls=None, box_w: float = 7.5, cls_w: float = 0.5,
                        dfl_w: float = 1.5, kpt_w: float = 12.0,
                        kobj_w: float = 1.0):
    """The total loss and a dict of its terms. ``gt_boxes (B, G, 4)`` xyxy
    px, ``gt_kpts (B, G, 17, 3)`` x, y, visibility, ``gt_valid (B, G)``
    bool, ``gt_cls (B, G)`` int (all 0 when None)."""
    B, A = raw.cls_logits.shape[:2]
    G = gt_boxes.shape[1]
    dev = raw.cls_logits.device
    if gt_cls is None:
        gt_cls = torch.zeros((B, G), dtype=torch.int64, device=dev)
    assigned, fg, target_scores = task_aligned_assign(raw, gt_boxes, gt_cls,
                                                      gt_valid)
    ts_sum = torch.clamp(target_scores.sum(), min=1.0)
    zero = torch.zeros((), device=dev)

    # cls: BCE against the aligned soft targets, over every anchor
    logits = raw.cls_logits
    bce = (torch.clamp(logits, min=0) - logits * target_scores
           + torch.log1p(torch.exp(-logits.abs())))
    loss_cls = bce.sum() / ts_sum

    # each anchor's gt
    tb = torch.gather(gt_boxes, 1, assigned[..., None].expand(B, A, 4))
    nk = gt_kpts.shape[2]
    tk = torch.gather(gt_kpts, 1, assigned[..., None, None].expand(
        B, A, nk, 3))
    w = torch.where(fg, target_scores.amax(-1), zero)         # (B, A)

    # box: CIoU on the foreground anchors
    pred_boxes = decode_boxes(raw)
    loss_box = (w * (1.0 - ciou(pred_boxes, tb))).sum() / ts_sum

    # DFL: cross-entropy on the two integer bins around the gt distance
    s = raw.strides[None, :, None]
    a = raw.anchors[None]
    gt_ltrb = torch.cat([a - tb[..., :2] / s, tb[..., 2:] / s - a], -1)
    reg_max = raw.box_dist.shape[-1]
    gt_ltrb = torch.clamp(gt_ltrb, 0, reg_max - 1 - 0.01)
    lo = torch.floor(gt_ltrb)
    hi = lo + 1
    wl = hi - gt_ltrb
    logp = torch.log_softmax(raw.box_dist, -1)

    def take(idx):
        return torch.gather(logp, -1, idx[..., None].to(torch.int64))[..., 0]

    dfl = -(take(lo) * wl + take(hi) * (1.0 - wl)).mean(-1)    # (B, A)
    loss_dfl = (w * dfl).sum() / ts_sum

    # keypoints: OKS-style xy loss plus visibility BCE on the foreground
    pk = decode_keypoints(raw)                                 # (B, A, 17, 3)
    area = torch.clamp((tb[..., 2] - tb[..., 0]) * (tb[..., 3] - tb[..., 1]),
                       min=1e-9)[..., None]
    d2 = ((pk[..., :2] - tk[..., :2]) ** 2).sum(-1)
    kpt_mask = tk[..., 2] > 0
    sigmas = torch.tensor(OKS_SIGMAS, dtype=torch.float32, device=dev)
    e = d2 / ((2 * sigmas[None, None]) ** 2 * (area + 1e-9) * 2)
    # the OKS term saturates once a keypoint is far off; the scale-normalized
    # L1 term keeps pulling it back
    l1 = torch.sqrt(d2 + 1e-9) / torch.sqrt(area)
    okd = torch.where(kpt_mask, 1.0 - torch.exp(-e) + 0.5 * l1, zero)
    denom = torch.clamp(kpt_mask.sum(-1), min=1)
    loss_kpt = (w * okd.sum(-1) / denom).sum() / ts_sum

    kl = raw.kpt_raw[..., 2]
    kt = kpt_mask.to(torch.float32)
    kbce = (torch.clamp(kl, min=0) - kl * kt
            + torch.log1p(torch.exp(-kl.abs()))).mean(-1)
    loss_kobj = (w * kbce).sum() / ts_sum

    total = (box_w * loss_box + cls_w * loss_cls + dfl_w * loss_dfl
             + kpt_w * loss_kpt + kobj_w * loss_kobj)
    return total, {"cls": loss_cls, "box": loss_box, "dfl": loss_dfl,
                   "kpt": loss_kpt, "kobj": loss_kobj,
                   "num_fg": fg.sum().to(torch.float32)}
