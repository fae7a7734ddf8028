"""Keypoint R-CNN (ResNet-50 FPN): the D2-slot 2D keypoint source.

Port of ``skix/models/keypoint_rcnn.py``: the inference path and the two
heads' training losses (:func:`keypoint_head_loss`, :func:`box_head_loss`).
Every
data-dependent quantity is a fixed slot count, as in skix:

- proposals: per FPN level the top ``pre_nms_topk`` objectness logits
  (a stable top-k, ties to the lowest index, as ``jax.lax.top_k``) decoded
  against offset-0 anchors (:func:`level_anchors`, :func:`apply_deltas`),
  NMS 0.7, the top ``post_nms_topk``;
- RoIAlign: skix's one bilinear sample per bin centre (aligned, −0.5
  offset, base indices clamped to ``W−2``/``H−2``), as one batched gather
  over the boxes (:func:`roi_align`); every box samples P2..P5 and the
  levels blend by a one-hot canonical assignment
  (:func:`multilevel_roi_align`);
- box head (2 FC + predictors), per-class NMS, the top ``detections``;
  keypoint head (8 conv, ConvTranspose, bilinear ×2), argmax decoding
  (:func:`decode_keypoint_heatmaps`).

FrozenBatchNorm keeps its four arrays as parameters (``weight``, ``bias``,
``running_mean``, ``running_var``), so a skix checkpoint loads leaf for
leaf. The detectron2 converter returns the port's ``state_dict``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models.layers import Conv, ConvTranspose, Dense
from skix_torch.ops.nms import nms
from skix_torch.perception.sfm_tracks import top_k
from skix_torch.utils.device import constant, full_float32_convs
from skix_torch.utils.image import resize

BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)   # detectron2 box-head weights
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
ANCHOR_SIZES = (32, 64, 128, 256, 512)       # per FPN level P2..P6
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


class FrozenBN(nn.Module):
    """FrozenBatchNorm2d: a constant per-channel affine from stored
    statistics, ``x · scale + (b − m · scale)`` with ``scale = w ·
    rsqrt(v + 1e-5)``."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.running_mean = nn.Parameter(torch.zeros(features))
        self.running_var = nn.Parameter(torch.ones(features))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + 1e-5)
        return x * scale + (self.bias - self.running_mean * scale)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, out: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(cin, mid, 1, bias=False)
        self.conv1_norm = FrozenBN(mid)
        self.conv2 = Conv(mid, mid, 3, stride, bias=False)
        self.conv2_norm = FrozenBN(mid)
        self.conv3 = Conv(mid, out, 1, bias=False)
        self.conv3_norm = FrozenBN(out)
        self.has_shortcut = cin != out or stride != 1
        if self.has_shortcut:
            self.shortcut = Conv(cin, out, 1, stride, bias=False)
            self.shortcut_norm = FrozenBN(out)

    def forward(self, x):
        h = F.relu(self.conv1_norm(self.conv1(x)))
        h = F.relu(self.conv2_norm(self.conv2(h)))
        h = self.conv3_norm(self.conv3(h))
        if self.has_shortcut:
            x = self.shortcut_norm(self.shortcut(x))
        return F.relu(x + h)


_STAGES = ((3, 64, 256), (4, 128, 512), (6, 256, 1024), (3, 512, 2048))


def _nearest_to(t, like):
    """``t`` nearest-resized (jax's rule) to ``like``'s grid."""
    return resize(t, (t.shape[0], *like.shape[1:3], t.shape[3]), "nearest")


class ResNet50FPN(nn.Module):
    """ResNet-50 trunk + FPN → (P2, P3, P4, P5, P6), 256 channels."""

    def __init__(self, fpn_dim: int = 256):
        super().__init__()
        self.stem_conv1 = Conv(3, 64, 7, 2, padding=3, bias=False)
        self.stem_norm = FrozenBN(64)
        cin = 64
        for si, (n_blocks, mid, out) in enumerate(_STAGES):
            for bi in range(n_blocks):
                stride = 2 if (bi == 0 and si > 0) else 1
                setattr(self, f"res{si + 2}_{bi}",
                        Bottleneck(cin, mid, out, stride))
                cin = out
        for lv, c in zip((2, 3, 4, 5), (256, 512, 1024, 2048)):
            setattr(self, f"fpn_lateral{lv}", Conv(c, fpn_dim, 1))
            setattr(self, f"fpn_output{lv}", Conv(fpn_dim, fpn_dim, 3))

    def forward(self, x):
        h = F.relu(self.stem_norm(self.stem_conv1(x)))
        h = F.max_pool2d(F.pad(h.permute(0, 3, 1, 2), (1, 1, 1, 1),
                               value=-torch.inf), 3, 2).permute(0, 2, 3, 1)
        feats = []
        for si, (n_blocks, _, _) in enumerate(_STAGES):
            for bi in range(n_blocks):
                h = getattr(self, f"res{si + 2}_{bi}")(h)
            feats.append(h)
        c2, c3, c4, c5 = feats
        m5 = self.fpn_lateral5(c5)
        m4 = self.fpn_lateral4(c4) + _nearest_to(m5, c4)
        m3 = self.fpn_lateral3(c3) + _nearest_to(m4, c3)
        m2 = self.fpn_lateral2(c2) + _nearest_to(m3, c2)
        p5 = self.fpn_output5(m5)
        return (self.fpn_output2(m2), self.fpn_output3(m3),
                self.fpn_output4(m4), p5, p5[:, ::2, ::2])


class RPNHead(nn.Module):
    def __init__(self, num_anchors: int = 3):
        super().__init__()
        self.conv = Conv(256, 256, 3)
        self.objectness_logits = Conv(256, num_anchors, 1)
        self.anchor_deltas = Conv(256, 4 * num_anchors, 1)

    def forward(self, feats):
        outs = []
        for f in feats:
            h = F.relu(self.conv(f))
            outs.append((self.objectness_logits(h), self.anchor_deltas(h)))
        return outs


_LEVEL_ANCHORS: dict = {}


def level_anchors(gh: int, gw: int, stride: int, size: float,
                  ratios=ANCHOR_RATIOS) -> np.ndarray:
    """(gh·gw·A, 4) xyxy anchors for one level, centred at ``x · stride``
    (detectron2's ``offset=0.0``). Cached per level (the array is the
    constant the model copies to its device once)."""
    key = (gh, gw, stride, size, tuple(ratios))
    if key in _LEVEL_ANCHORS:
        return _LEVEL_ANCHORS[key]
    ys = np.arange(gh, dtype=np.float32) * stride
    xs = np.arange(gw, dtype=np.float32) * stride
    cy, cx = np.meshgrid(ys, xs, indexing="ij")
    boxes = []
    for r in ratios:
        w = size * np.sqrt(1.0 / r)
        h = size * np.sqrt(r)
        boxes.append(np.stack([cx - w / 2, cy - h / 2,
                               cx + w / 2, cy + h / 2], -1))
    out = np.stack(boxes, 2).reshape(-1, 4).astype(np.float32)
    _LEVEL_ANCHORS[key] = out
    return out


def apply_deltas(anchors, deltas, weights=(1.0, 1.0, 1.0, 1.0),
                 clip: float = 4.135):
    """(dx, dy, dw, dh) box regression (detectron2 Box2BoxTransform; clip
    = log(1000/16))."""
    wx, wy, ww, wh = weights
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) / 2
    ay = (anchors[..., 1] + anchors[..., 3]) / 2
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=clip)
    dh = torch.clamp(deltas[..., 3] / wh, max=clip)
    cx = ax + dx * aw
    cy = ay + dy * ah
    w = aw * torch.exp(dw)
    h = ah * torch.exp(dh)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def roi_align(feat, boxes, out_size: int, stride: int):
    """RoIAlign(aligned=True) with one bilinear sample per bin centre, as
    one batched gather: ``feat (H, W, C)``, ``boxes (N, 4)`` xyxy pixels →
    ``(N, S, S, C)``."""
    H, W, C = feat.shape
    S = out_size
    x0, y0, x1, y1 = boxes.unbind(-1)
    bw = torch.clamp((x1 - x0) / S, min=1e-6)
    bh = torch.clamp((y1 - y0) / S, min=1e-6)
    ar = torch.arange(S, dtype=torch.float32, device=feat.device) + 0.5
    xs = (x0[:, None] + ar * bw[:, None]) / stride - 0.5       # (N, S)
    ys = (y0[:, None] + ar * bh[:, None]) / stride - 0.5
    x0i = torch.clamp(torch.floor(xs), 0, W - 2).to(torch.long)
    y0i = torch.clamp(torch.floor(ys), 0, H - 2).to(torch.long)
    fx = torch.clamp(xs - x0i, 0.0, 1.0)
    fy = torch.clamp(ys - y0i, 0.0, 1.0)
    flat = feat.reshape(H * W, C)

    def tap(dy, dx):
        idx = (y0i[:, :, None] + dy) * W + (x0i[:, None, :] + dx)  # (N,S,S)
        return flat[idx.reshape(-1)].reshape(*idx.shape, C)

    wx = fx[:, None, :, None]
    wy = fy[:, :, None, None]
    return (tap(0, 0) * (1 - wx) * (1 - wy) + tap(0, 1) * wx * (1 - wy)
            + tap(1, 0) * (1 - wx) * wy + tap(1, 1) * wx * wy)


def multilevel_roi_align(feats: Sequence, boxes, out_size: int,
                         strides=(4, 8, 16, 32)):
    """Sample every level, blend by the canonical level assignment
    k = floor(4 + log2(sqrt(area)/224)) clamped to [2, 5]."""
    area = torch.clamp((boxes[:, 2] - boxes[:, 0])
                       * (boxes[:, 3] - boxes[:, 1]), min=1e-6)
    k = torch.floor(4.0 + torch.log2(torch.sqrt(area) / 224.0 + 1e-9))
    k = torch.clamp(k, 2, 5).to(torch.long) - 2
    onehot = F.one_hot(k, 4).to(torch.float32)
    crops = torch.stack([roi_align(f, boxes, out_size, s)
                         for f, s in zip(feats[:4], strides)])
    return torch.einsum("lnhwc,nl->nhwc", crops, onehot)


class BoxHead(nn.Module):
    """2-FC head + predictors (num_classes = 1 → 2 class logits)."""

    def __init__(self, num_classes: int = 1, in_features: int = 256 * 49):
        super().__init__()
        self.fc1 = Dense(in_features, 1024)
        self.fc2 = Dense(1024, 1024)
        self.cls_score = Dense(1024, num_classes + 1)
        self.bbox_pred = Dense(1024, 4 * num_classes)

    def forward(self, rois):
        h = rois.reshape(rois.shape[0], -1)
        h = F.relu(self.fc2(F.relu(self.fc1(h))))
        return self.cls_score(h), self.bbox_pred(h)


class KeypointHead(nn.Module):
    """8 × conv3x3(512) → ConvTranspose(4, stride 2, padding 1) → bilinear
    ×2 (jax's resize)."""

    def __init__(self, num_keypoints: int = 17, cin: int = 256):
        super().__init__()
        for i in range(8):
            setattr(self, f"conv_fcn{i + 1}", Conv(cin if i == 0 else 512,
                                                   512, 3))
        self.score_lowres = ConvTranspose(512, num_keypoints, 4, stride=2,
                                          padding=1)

    def forward(self, rois):
        h = rois
        for i in range(8):
            h = F.relu(getattr(self, f"conv_fcn{i + 1}")(h))
        h = self.score_lowres(h)
        N, H, W, K = h.shape
        return resize(h, (N, 2 * H, 2 * W, K), "bilinear")


class KeypointRCNNOutputs(NamedTuple):
    boxes_xyxy: torch.Tensor   # (B, K, 4)
    scores: torch.Tensor       # (B, K)
    keypoints: torch.Tensor    # (B, K, 17, 3) x, y, prob
    valid: torch.Tensor        # (B, K) bool


class RawRCNN(NamedTuple):
    """One image's raw heads (before any NMS) and its proposals."""

    rpn_logits: list           # per level (gh·gw·A,) objectness logits
    rpn_deltas: list           # per level (gh·gw·A, 4)
    proposals: torch.Tensor    # (P, 4) clipped proposal boxes
    cls_logits: torch.Tensor   # (P, 2) box-head logits on the proposals
    box_deltas: torch.Tensor   # (P, 4)


def _clip_boxes(b, H, W):
    return torch.stack([torch.clamp(b[:, 0], 0, W), torch.clamp(b[:, 1], 0, H),
                        torch.clamp(b[:, 2], 0, W), torch.clamp(b[:, 3], 0, H)],
                       -1)


class KeypointRCNN(nn.Module):
    """Backbone + RPN + heads at fixed slot counts: images (B, H, W, 3) in
    [0, 1] → :class:`KeypointRCNNOutputs`."""

    def __init__(self, num_keypoints: int = 17, pre_nms_topk: int = 256,
                 post_nms_topk: int = 64, detections: int = 8,
                 score_threshold: float = 0.7, nms_iou: float = 0.5):
        super().__init__()
        self.pre_nms_topk, self.post_nms_topk = pre_nms_topk, post_nms_topk
        self.detections, self.score_threshold = detections, score_threshold
        self.nms_iou = nms_iou
        self.backbone = ResNet50FPN()
        self.rpn_head = RPNHead(len(ANCHOR_RATIOS))
        self.box_head = BoxHead(1)
        self.kpt_head = KeypointHead(num_keypoints)

    def propose(self, rpn_outs, shapes):
        """One image's proposal slots from its RPN outputs → (P, 4) boxes +
        (P,) logits."""
        all_boxes, all_logits = [], []
        for (obj, deltas), (gh, gw, stride, size) in zip(rpn_outs, shapes):
            anch = constant(level_anchors(gh, gw, stride, size), obj.device)
            logit = obj.reshape(-1)
            dl = deltas.reshape(-1, 4)
            k = min(self.pre_nms_topk, logit.shape[0])
            top, idx = top_k(logit, k)
            all_boxes.append(apply_deltas(anch[idx], dl[idx]))
            all_logits.append(top)
        boxes = torch.cat(all_boxes, 0)
        logits = torch.cat(all_logits, 0)
        keep = nms(boxes, logits, 0.7)
        scored = torch.where(keep, logits, torch.full_like(logits, -torch.inf))
        top, idx = top_k(scored, self.post_nms_topk)
        return boxes[idx], top

    def _trunk(self, images):
        dev = images.device
        x = (images - constant(_MEAN, dev)) / constant(_STD, dev)
        feats = self.backbone(x)
        rpn_outs = self.rpn_head(feats)
        shapes = [(f.shape[1], f.shape[2], st, sz)
                  for f, st, sz in zip(feats, (4, 8, 16, 32, 64),
                                       ANCHOR_SIZES)]
        return feats, rpn_outs, shapes

    def _proposals_and_box_head(self, feats_i, rpn_i, shapes, H, W):
        props, _ = self.propose(rpn_i, shapes)
        props = _clip_boxes(props, H, W)
        rois = multilevel_roi_align(feats_i, props, 7)
        scores, deltas = self.box_head(rois)
        return props, scores, deltas

    def raw_heads(self, images) -> list:
        """Per image the RPN heads, the proposals and the box head's raw
        outputs on them (:class:`RawRCNN`): what comes before the second
        NMS, for checks that hold two runs to each other."""
        with full_float32_convs():
            feats, rpn_outs, shapes = self._trunk(images)
            H, W = images.shape[1:3]
            out = []
            for b in range(images.shape[0]):
                rpn_i = [(o[b], d[b]) for o, d in rpn_outs]
                props, scores, deltas = self._proposals_and_box_head(
                    [f[b] for f in feats], rpn_i, shapes, H, W)
                out.append(RawRCNN(
                    rpn_logits=[o.reshape(-1) for o, _ in rpn_i],
                    rpn_deltas=[d.reshape(-1, 4) for _, d in rpn_i],
                    proposals=props, cls_logits=scores, box_deltas=deltas))
            return out

    def forward(self, images) -> KeypointRCNNOutputs:
        with full_float32_convs():
            return self._forward(images)

    def _forward(self, images):
        B, H, W, _ = images.shape
        feats, rpn_outs, shapes = self._trunk(images)
        outs = []
        for b in range(B):
            feats_i = [f[b] for f in feats]
            props, scores, deltas = self._proposals_and_box_head(
                feats_i, [(o[b], d[b]) for o, d in rpn_outs], shapes, H, W)
            p = torch.softmax(scores, -1)[:, 0]          # person prob
            boxes = _clip_boxes(apply_deltas(props, deltas, BBOX_REG_WEIGHTS),
                                H, W)
            keep = nms(boxes, p, self.nms_iou)
            scored = torch.where(keep, p, torch.full_like(p, -torch.inf))
            top, idx = top_k(scored, self.detections)
            det_boxes = boxes[idx]
            heat = self.kpt_head(multilevel_roi_align(feats_i, det_boxes, 14))
            kpts = decode_keypoint_heatmaps(heat, det_boxes)
            ok = top > self.score_threshold
            outs.append((det_boxes, torch.where(torch.isfinite(top), top,
                                                torch.zeros_like(top)),
                         kpts, ok))
        b, s, k, v = (torch.stack(z) for z in zip(*outs))
        return KeypointRCNNOutputs(boxes_xyxy=b, scores=s, keypoints=k,
                                   valid=v)


def decode_keypoint_heatmaps(heat, boxes):
    """(N, S, S, 17) logits + (N, 4) boxes → (N, 17, 3) x, y, prob: the
    argmax bin centre (the first maximum) mapped into the box."""
    N, S, _, K = heat.shape
    flat = heat.permute(0, 3, 1, 2).reshape(N, K, S * S)
    prob = torch.softmax(flat, -1)
    idx = torch.argmax(flat, -1)
    py = (idx // S).to(torch.float32) + 0.5
    px = (idx % S).to(torch.float32) + 0.5
    w = torch.clamp(boxes[:, 2] - boxes[:, 0], min=1e-6)[:, None]
    h = torch.clamp(boxes[:, 3] - boxes[:, 1], min=1e-6)[:, None]
    x = boxes[:, 0][:, None] + px / S * w
    y = boxes[:, 1][:, None] + py / S * h
    p = torch.gather(prob, -1, idx[..., None])[..., 0]
    return torch.stack([x, y, p], -1)


def keypoint_head_loss(heat, boxes, gt_kpts, valid):
    """Spatial-softmax CE at the GT keypoint's bin (detectron2
    keypoint_rcnn_loss). heat (B, N, S, S, 17); boxes/gt in pixels; the
    mean over the keypoints inside their box, visible, in a valid slot."""
    B, N, S, _, K = heat.shape
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1e-6)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1e-6)
    gx = (gt_kpts[..., 0] - boxes[..., 0][..., None]) / w[..., None] * S
    gy = (gt_kpts[..., 1] - boxes[..., 1][..., None]) / h[..., None] * S
    inside = ((gx >= 0) & (gx < S) & (gy >= 0) & (gy < S)
              & (gt_kpts[..., 2] > 0) & valid[..., None])
    xi = torch.clamp(gx.to(torch.int64), 0, S - 1)
    yi = torch.clamp(gy.to(torch.int64), 0, S - 1)
    flat = heat.permute(0, 1, 4, 2, 3).reshape(B, N, K, S * S)
    logp = torch.log_softmax(flat, -1)
    ce = -torch.gather(logp, -1, (yi * S + xi)[..., None])[..., 0]
    denom = torch.clamp(inside.sum(), min=1)
    return torch.where(inside, ce, torch.zeros_like(ce)).sum() / denom


def box_head_loss(scores, deltas, proposals, gt_boxes, valid):
    """Softmax CE (person vs background on padded slots) + smooth-L1 on
    the regression deltas for valid slots."""
    labels = torch.where(valid, 0, 1)                   # 0=person, 1=bg
    ce = -torch.gather(torch.log_softmax(scores, -1), -1,
                       labels[..., None])[..., 0].mean()
    wx, wy, ww, wh = BBOX_REG_WEIGHTS
    pw = torch.clamp(proposals[..., 2] - proposals[..., 0], min=1e-6)
    ph = torch.clamp(proposals[..., 3] - proposals[..., 1], min=1e-6)
    px = (proposals[..., 0] + proposals[..., 2]) / 2
    py = (proposals[..., 1] + proposals[..., 3]) / 2
    gw = torch.clamp(gt_boxes[..., 2] - gt_boxes[..., 0], min=1e-6)
    gh = torch.clamp(gt_boxes[..., 3] - gt_boxes[..., 1], min=1e-6)
    gx = (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2
    gy = (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2
    tgt = torch.stack([wx * (gx - px) / pw, wy * (gy - py) / ph,
                       ww * torch.log(gw / pw), wh * torch.log(gh / ph)], -1)
    d = torch.abs(deltas - tgt)
    sl1 = torch.where(d < 1.0, 0.5 * d * d, d - 0.5).sum(-1)
    denom = torch.clamp(valid.sum(), min=1)
    return ce + torch.where(valid, sl1, torch.zeros_like(sl1)).sum() / denom


# ---------------------------------------------------------------------------
# detectron2 converter (reference layout → the port's state_dict)
# ---------------------------------------------------------------------------

def _np_of(t):
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                      else t, np.float32)


def _conv(sd, pre):
    return {"kernel": _np_of(sd[f"{pre}.weight"]).transpose(2, 3, 1, 0),
            **({"bias": _np_of(sd[f"{pre}.bias"])}
               if f"{pre}.bias" in sd else {})}


def _norm(sd, pre):
    return {k: _np_of(sd[f"{pre}.{k}"])
            for k in ("weight", "bias", "running_mean", "running_var")}


def _dense(sd, pre):
    return {"kernel": _np_of(sd[f"{pre}.weight"]).T,
            "bias": _np_of(sd[f"{pre}.bias"])}


def convert_detectron2_keypoint_rcnn(state_dict) -> dict:
    """detectron2 keypoint_rcnn_R_50_FPN state dict → the ``state_dict`` of
    :class:`KeypointRCNN`, through skix's flax layout (the keypoint head's
    deconv kernel flipped in space there; the port's ``ConvTranspose``
    flips it back where it applies it)."""
    from skix_torch.convert import flax_to_state_dict

    sd = state_dict
    bb: dict = {
        "stem_conv1": _conv(sd, "backbone.bottom_up.stem.conv1"),
        "stem_norm": _norm(sd, "backbone.bottom_up.stem.conv1.norm"),
    }
    for si, (n_blocks, _, _) in enumerate(_STAGES):
        for bi in range(n_blocks):
            pre = f"backbone.bottom_up.res{si + 2}.{bi}"
            blk = {}
            for ci in (1, 2, 3):
                blk[f"conv{ci}"] = _conv(sd, f"{pre}.conv{ci}")
                blk[f"conv{ci}_norm"] = _norm(sd, f"{pre}.conv{ci}.norm")
            if f"{pre}.shortcut.weight" in sd:
                blk["shortcut"] = _conv(sd, f"{pre}.shortcut")
                blk["shortcut_norm"] = _norm(sd, f"{pre}.shortcut.norm")
            bb[f"res{si + 2}_{bi}"] = blk
    for lv in (2, 3, 4, 5):
        bb[f"fpn_lateral{lv}"] = _conv(sd, f"backbone.fpn_lateral{lv}")
        bb[f"fpn_output{lv}"] = _conv(sd, f"backbone.fpn_output{lv}")
    rpn = {name: _conv(sd, f"proposal_generator.rpn_head.{name}")
           for name in ("conv", "objectness_logits", "anchor_deltas")}
    box = {"fc1": _dense(sd, "roi_heads.box_head.fc1"),
           "fc2": _dense(sd, "roi_heads.box_head.fc2"),
           "cls_score": _dense(sd, "roi_heads.box_predictor.cls_score"),
           "bbox_pred": _dense(sd, "roi_heads.box_predictor.bbox_pred")}
    kpt: dict = {f"conv_fcn{i + 1}": _conv(
        sd, f"roi_heads.keypoint_head.conv_fcn{i + 1}") for i in range(8)}
    w = _np_of(sd["roi_heads.keypoint_head.score_lowres.weight"])
    kpt["score_lowres"] = {
        "kernel": np.ascontiguousarray(w.transpose(2, 3, 0, 1)[::-1, ::-1]),
        "bias": _np_of(sd["roi_heads.keypoint_head.score_lowres.bias"])}
    return flax_to_state_dict({"params": {
        "backbone": bb, "rpn_head": rpn, "box_head": box, "kpt_head": kpt}})


def reference_state_dict_spec(num_keypoints: int = 17) -> dict:
    """Every tensor of detectron2's keypoint-rcnn state dict → its shape
    (torch order): the converter's oracle."""
    spec: dict = {}

    def conv(pre, cin, cout, k, bias=True):
        spec[f"{pre}.weight"] = (cout, cin, k, k)
        if bias:
            spec[f"{pre}.bias"] = (cout,)

    def convnorm(pre, cin, cout, k):
        conv(pre, cin, cout, k, bias=False)
        for s in ("weight", "bias", "running_mean", "running_var"):
            spec[f"{pre}.norm.{s}"] = (cout,)

    convnorm("backbone.bottom_up.stem.conv1", 3, 64, 7)
    cin = 64
    for si, (n_blocks, mid, cout) in enumerate(_STAGES):
        for bi in range(n_blocks):
            pre = f"backbone.bottom_up.res{si + 2}.{bi}"
            convnorm(f"{pre}.conv1", cin, mid, 1)
            convnorm(f"{pre}.conv2", mid, mid, 3)
            convnorm(f"{pre}.conv3", mid, cout, 1)
            if bi == 0:
                convnorm(f"{pre}.shortcut", cin, cout, 1)
            cin = cout
    for lv, c in zip((2, 3, 4, 5), (256, 512, 1024, 2048)):
        conv(f"backbone.fpn_lateral{lv}", c, 256, 1)
        conv(f"backbone.fpn_output{lv}", 256, 256, 3)
    conv("proposal_generator.rpn_head.conv", 256, 256, 3)
    conv("proposal_generator.rpn_head.objectness_logits", 256, 3, 1)
    conv("proposal_generator.rpn_head.anchor_deltas", 256, 12, 1)
    spec["roi_heads.box_head.fc1.weight"] = (1024, 256 * 7 * 7)
    spec["roi_heads.box_head.fc1.bias"] = (1024,)
    spec["roi_heads.box_head.fc2.weight"] = (1024, 1024)
    spec["roi_heads.box_head.fc2.bias"] = (1024,)
    spec["roi_heads.box_predictor.cls_score.weight"] = (2, 1024)
    spec["roi_heads.box_predictor.cls_score.bias"] = (2,)
    spec["roi_heads.box_predictor.bbox_pred.weight"] = (4, 1024)
    spec["roi_heads.box_predictor.bbox_pred.bias"] = (4,)
    cin = 256
    for i in range(8):
        conv(f"roi_heads.keypoint_head.conv_fcn{i + 1}", cin, 512, 3)
        cin = 512
    spec["roi_heads.keypoint_head.score_lowres.weight"] = (
        512, num_keypoints, 4, 4)
    spec["roi_heads.keypoint_head.score_lowres.bias"] = (num_keypoints,)
    return spec
