"""Cascade Mask R-CNN over a ViT-Det trunk: the side stage's human detector.

Port of ``skix/models/cascade_rcnn.py`` (detectron2's
``cascade_mask_rcnn_vitdet_h_75ep``), inference only. Every data-dependent
quantity is a fixed slot count, as in skix:

- the trunk (:class:`ViTDetD2`): a 16 px patch convolution, the 14 × 14
  pretraining position table resized to the grid with jax's bicubic
  (Keys, a = −0.5), blocks attending in 14 × 14 windows (the 64 × 64 grid
  of a 1024 px image pads to 70) or globally at ``global_indexes``, each
  with detectron2's decomposed relative-position bias. The attention is
  plain torch (matmul, bias, softmax, matmul): its head dim is 80 at
  ViT-H and it adds a bias, which the flash kernels take neither of;
- the SimpleFeaturePyramid (P2..P6), the two-conv RPN head on the port's
  Keypoint R-CNN anchors, deltas and RoIAlign;
- proposals: per level the top ``pre_nms_topk`` logits (a stable top-k,
  ties to the lowest index), clipped, NMS 0.7, the top ``post_nms_topk``;
- three cascade stages on every proposal slot: stage k's class-agnostic
  deltas (weights :data:`CASCADE_STAGE_WEIGHTS`) refine its input boxes;
  the scores are the mean of the three stages' softmax; per-class NMS by
  a class offset, the top ``detections``, the mask head on them.

:class:`HumanDetector` resizes frames as detectron2's ResizeShortestEdge
(jax's antialiased bilinear, :func:`skix_torch.utils.image.resize`), pads
them to one square program shape and maps boxes back
(``detect_frames``), and gives a clip fixed person slots
(``detect_clip``);
:func:`postprocess_human_boxes` filters and lexsorts (x1 first).
:func:`convert_detectron2_cascade_vitdet` reads a detectron2 state dict
into the port's ``state_dict``; :func:`cascade_reference_state_dict_spec`
is its shape oracle.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models.keypoint_rcnn import (ANCHOR_RATIOS, ANCHOR_SIZES,
                                             apply_deltas, level_anchors,
                                             multilevel_roi_align)
from skix_torch.models.layers import (Conv, ConvTranspose, Dense, LayerNorm,
                                      PatchConv, init_like_flax)
from skix_torch.ops.nms import nms
from skix_torch.perception.sfm_tracks import top_k
from skix_torch.tracking.vitdet import window_partition, window_unpartition
from skix_torch.utils.device import constant, full_float32_convs
from skix_torch.utils.image import resize

# per-stage Box2BoxTransform weights (10,5), (20,10), (30,15)
CASCADE_STAGE_WEIGHTS = ((10.0, 10.0, 5.0, 5.0),
                         (20.0, 20.0, 10.0, 10.0),
                         (30.0, 30.0, 15.0, 15.0))
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


# --------------------------------------------------------------------------
# decomposed relative position bias (detectron2 get_rel_pos /
# add_decomposed_rel_pos)
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=32)
def rel_pos_index(q_size: int, k_size: int) -> np.ndarray:
    """(q, k) gather index into a (2·max(q,k)−1, C) rel-pos table, with
    detectron2's short-side scaling when the sizes differ."""
    ratio_q = max(k_size / q_size, 1.0)
    ratio_k = max(q_size / k_size, 1.0)
    q = np.arange(q_size, dtype=np.float64)[:, None] * ratio_q
    k = np.arange(k_size, dtype=np.float64)[None, :] * ratio_k
    rel = q - k + (k_size - 1) * ratio_k
    return rel.astype(np.int64)


def resize_rel_pos(table, target_len: int):
    """A (L, C) rel-pos table linearly resized to (target_len, C), as jax's
    ``"linear"`` resize."""
    if table.shape[0] == target_len:
        return table
    return resize(table, (target_len, table.shape[1]), "bilinear")


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w,
                           q_hw: Tuple[int, int], k_hw: Tuple[int, int]):
    """attn (B, qh·qw, kh·kw) + the decomposed rel-pos bias of q
    (B, qh·qw, C)."""
    qh, qw = q_hw
    kh, kw = k_hw
    dev = q.device
    Rh = resize_rel_pos(rel_pos_h, 2 * max(qh, kh) - 1)[
        constant(rel_pos_index(qh, kh), dev)]               # (qh, kh, C)
    Rw = resize_rel_pos(rel_pos_w, 2 * max(qw, kw) - 1)[
        constant(rel_pos_index(qw, kw), dev)]               # (qw, kw, C)
    r_q = q.reshape(q.shape[0], qh, qw, -1)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = attn.reshape(-1, qh, qw, kh, kw)
    attn = attn + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]
    return attn.reshape(-1, qh * qw, kh * kw)


class D2Attention(nn.Module):
    """detectron2 ViT attention: fused qkv + decomposed rel-pos bias, in
    plain torch."""

    def __init__(self, dim: int, num_heads: int,
                 input_size: Tuple[int, int] = (14, 14)):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))

    def forward(self, x, hw: Tuple[int, int]):
        B, N, C = x.shape
        H = self.num_heads
        hd = C // H
        qkv = self.qkv(x).reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        q, k, v = (t.reshape(B * H, N, hd) for t in qkv)
        attn = (q * (hd ** -0.5)) @ k.transpose(1, 2)
        attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h,
                                      self.rel_pos_w, hw, hw)
        out = (torch.softmax(attn, dim=-1) @ v).reshape(B, H, N, hd)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class D2Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 0,
                 mlp_ratio: float = 4.0, rel_pos_size: int = 14):
        super().__init__()
        self.window_size = window_size
        self.norm1 = LayerNorm(dim, 1e-6)
        self.attn = D2Attention(dim, num_heads, (rel_pos_size,) * 2)
        self.norm2 = LayerNorm(dim, 1e-6)
        self.mlp_fc1 = Dense(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = Dense(int(dim * mlp_ratio), dim)

    def forward(self, x):
        B, H, W, C = x.shape
        ws = self.window_size
        h = self.norm1(x)
        if ws > 0:
            win, pad_hw = window_partition(h, ws)
            h = window_unpartition(self.attn(win, (ws, ws)), ws, pad_hw,
                                   (H, W))
        else:
            h = self.attn(h.reshape(B, H * W, C), (H, W)).reshape(B, H, W, C)
        x = x + h
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))


class ViTDetD2(nn.Module):
    """detectron2's plain ViT trunk: ``x (B, H, W, 3)`` normalized →
    ``(B, H/16, W/16, C)``."""

    def __init__(self, embed_dim: int = 1280, depth: int = 32,
                 num_heads: int = 16, patch_size: int = 16,
                 window_size: int = 14,
                 global_indexes: Sequence[int] = (7, 15, 23, 31),
                 pretrain_grid: int = 14, image_size: int = 1024):
        super().__init__()
        self.patch_size, self.depth = patch_size, depth
        self.patch_embed = PatchConv(3, embed_dim, patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, pretrain_grid,
                                                  pretrain_grid, embed_dim))
        glob = set(global_indexes)
        grid = image_size // patch_size
        for i in range(depth):
            self.add_module(f"block{i}", D2Block(
                embed_dim, num_heads, window_size=0 if i in glob
                else window_size,
                rel_pos_size=grid if i in glob else window_size))

    def forward(self, x):
        B, H, W, _ = x.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        x = self.patch_embed(x)
        pos = self.pos_embed
        if pos.shape[1:3] != (gh, gw):      # d2 get_abs_pos: bicubic
            pos = resize(pos, (1, gh, gw, pos.shape[-1]), "bicubic")
        x = x + pos
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return x


class ConvLN(nn.Module):
    """detectron2 Conv2d(bias=False, norm=LN)."""

    def __init__(self, cin: int, features: int, kernel: int):
        super().__init__()
        self.conv = Conv(cin, features, kernel, bias=False)
        self.norm = LayerNorm(features, 1e-6)

    def forward(self, x):
        return self.norm(self.conv(x))


def _max_pool2(x):
    """flax ``max_pool((2, 2), strides=(2, 2))`` (VALID) of ``(B, H, W, C)``."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class SimpleFeaturePyramid(nn.Module):
    """One stride-16 map → P2..P5 (deconv / identity / max-pool rescales,
    each then 1×1 + 3×3 LN convs); P6 = every other pixel of P5."""

    def __init__(self, in_dim: int, out_channels: int = 256):
        super().__init__()
        C = in_dim
        self.s4_deconv1 = ConvTranspose(C, C // 2)
        self.s4_ln = LayerNorm(C // 2, 1e-6)
        self.s4_deconv2 = ConvTranspose(C // 2, C // 4)
        self.s8_deconv = ConvTranspose(C, C // 2)
        for lv, c in zip((2, 3, 4, 5), (C // 4, C // 2, C, C)):
            self.add_module(f"p{lv}_conv1", ConvLN(c, out_channels, 1))
            self.add_module(f"p{lv}_conv2", ConvLN(out_channels,
                                                   out_channels, 3))

    def forward(self, x):
        s4 = self.s4_deconv2(F.gelu(self.s4_ln(self.s4_deconv1(x))))
        feats = []
        for lv, h in zip((2, 3, 4, 5),
                         (s4, self.s8_deconv(x), x, _max_pool2(x))):
            h = getattr(self, f"p{lv}_conv1")(h)
            feats.append(getattr(self, f"p{lv}_conv2")(h))
        feats.append(feats[-1][:, ::2, ::2])        # P6: 1×1 pool, stride 2
        return feats


class D2RPNHead(nn.Module):
    """StandardRPNHead with two 3×3 convs (the ViTDet configuration)."""

    def __init__(self, num_anchors: int = 3):
        super().__init__()
        self.conv0 = Conv(256, 256, 3)
        self.conv1 = Conv(256, 256, 3)
        self.objectness_logits = Conv(256, num_anchors, 1)
        self.anchor_deltas = Conv(256, 4 * num_anchors, 1)

    def forward(self, feats):
        outs = []
        for f in feats:
            h = F.relu(self.conv1(F.relu(self.conv0(f))))
            outs.append((self.objectness_logits(h), self.anchor_deltas(h)))
        return outs


class CascadeBoxHead(nn.Module):
    """4 × conv3×3(LN) + FC 1024 + class scores + class-agnostic deltas."""

    def __init__(self, num_classes: int = 80):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i + 1}", ConvLN(256, 256, 3))
        self.fc1 = Dense(256 * 7 * 7, 1024)
        self.cls_score = Dense(1024, num_classes + 1)
        self.bbox_pred = Dense(1024, 4)

    def forward(self, rois):
        h = rois
        for i in range(4):
            h = F.relu(getattr(self, f"conv{i + 1}")(h))
        h = F.relu(self.fc1(h.reshape(h.shape[0], -1)))
        return self.cls_score(h), self.bbox_pred(h)


class MaskHead(nn.Module):
    """4 × conv3×3(LN) + deconv ×2 + 1×1 predictor (the published layout;
    the stage reads boxes only)."""

    def __init__(self, num_classes: int = 80):
        super().__init__()
        for i in range(4):
            self.add_module(f"mask_fcn{i + 1}", ConvLN(256, 256, 3))
        self.deconv = ConvTranspose(256, 256)
        self.predictor = Conv(256, num_classes, 1)

    def forward(self, rois):
        h = rois
        for i in range(4):
            h = F.relu(getattr(self, f"mask_fcn{i + 1}")(h))
        return self.predictor(F.relu(self.deconv(h)))


class CascadeDetections(NamedTuple):
    boxes_xyxy: torch.Tensor   # (B, K, 4)
    scores: torch.Tensor       # (B, K) three-stage mean prob of the class
    classes: torch.Tensor      # (B, K) int64
    valid: torch.Tensor        # (B, K) bool
    masks: torch.Tensor        # (B, K, 28, 28) sigmoid probs of the class


class RawCascade(NamedTuple):
    """One image's heads before any NMS of the box stages."""

    rpn_logits: list           # per level (gh·gw·A,)
    rpn_deltas: list           # per level (gh·gw·A, 4)
    proposals: torch.Tensor    # (P, 4) clipped proposal slots
    stage_logits: list         # per stage (P, num_classes + 1)
    stage_deltas: list         # per stage (P, 4)
    boxes: torch.Tensor        # (P, 4) the last stage's refined boxes


def _clip(boxes, H, W):
    return torch.stack([torch.clamp(boxes[:, 0], 0, W),
                        torch.clamp(boxes[:, 1], 0, H),
                        torch.clamp(boxes[:, 2], 0, W),
                        torch.clamp(boxes[:, 3], 0, H)], -1)


class CascadeMaskRCNN(nn.Module):
    """Fixed-slot cascade inference: images (B, H, W, 3) in [0, 1] →
    :class:`CascadeDetections`. ``image_size`` sizes the global blocks'
    rel-pos tables (the grid of the square program shape)."""

    def __init__(self, embed_dim: int = 1280, depth: int = 32,
                 num_heads: int = 16, patch_size: int = 16,
                 window_size: int = 14,
                 global_indexes: Sequence[int] = (7, 15, 23, 31),
                 num_classes: int = 80, pre_nms_topk: int = 256,
                 post_nms_topk: int = 128, detections: int = 16,
                 score_threshold: float = 0.25, nms_iou: float = 0.5,
                 image_size: int = 1024):
        super().__init__()
        self.num_classes = num_classes
        self.pre_nms_topk, self.post_nms_topk = pre_nms_topk, post_nms_topk
        self.detections, self.score_threshold = detections, score_threshold
        self.nms_iou = nms_iou
        self.net = ViTDetD2(embed_dim, depth, num_heads, patch_size,
                            window_size, global_indexes,
                            image_size=image_size)
        self.fpn = SimpleFeaturePyramid(embed_dim)
        self.rpn_head = D2RPNHead(len(ANCHOR_RATIOS))
        for k in range(3):
            self.add_module(f"box_head{k}", CascadeBoxHead(num_classes))
        self.mask_head = MaskHead(num_classes)

    def init_weights(self, generator=None):
        """flax's initializers: LeCun-normal kernels, zero biases, unit
        LayerNorms; the rel-pos and position tables stay zero."""
        init_like_flax(self, generator)
        with torch.no_grad():
            self.net.pos_embed.zero_()
            for m in self.modules():
                if isinstance(m, D2Attention):
                    m.rel_pos_h.zero_()
                    m.rel_pos_w.zero_()
        return self

    def propose(self, rpn_outs, shapes, hw):
        """One image's proposal slots (P, 4) from its RPN outputs."""
        H, W = hw
        all_boxes, all_logits = [], []
        for (obj, deltas), (gh, gw, stride, size) in zip(rpn_outs, shapes):
            anch = constant(level_anchors(gh, gw, stride, size), obj.device)
            logit = obj.reshape(-1)
            dl = deltas.reshape(-1, 4)
            top, idx = top_k(logit, min(self.pre_nms_topk, logit.shape[0]))
            all_boxes.append(apply_deltas(anch[idx], dl[idx]))
            all_logits.append(top)
        boxes = _clip(torch.cat(all_boxes, 0), H, W)
        logits = torch.cat(all_logits, 0)
        keep = nms(boxes, logits, 0.7)
        scored = torch.where(keep, logits, torch.full_like(logits, -torch.inf))
        _, idx = top_k(scored, self.post_nms_topk)
        return boxes[idx]

    def _trunk(self, images):
        dev = images.device
        x = (images - constant(_MEAN, dev)) / constant(_STD, dev)
        feats = self.fpn(self.net(x))
        rpn_outs = self.rpn_head(feats)
        shapes = [(f.shape[1], f.shape[2], st, sz)
                  for f, st, sz in zip(feats, (4, 8, 16, 32, 64),
                                       ANCHOR_SIZES)]
        return feats, rpn_outs, shapes

    def _stages(self, feats_i, boxes, H, W):
        """The three cascade stages on one image's proposal slots."""
        logits, deltas = [], []
        for k in range(3):
            rois = multilevel_roi_align(feats_i, boxes, 7)
            s, d = getattr(self, f"box_head{k}")(rois)
            logits.append(s)
            deltas.append(d)
            boxes = _clip(apply_deltas(boxes, d, CASCADE_STAGE_WEIGHTS[k]),
                          H, W)
        return logits, deltas, boxes

    @torch.no_grad()
    def raw_heads(self, images) -> list:
        """Per image the RPN heads, the proposals and each cascade stage's
        raw outputs (:class:`RawCascade`): what comes before the per-class
        NMS, for checks that hold two runs to each other."""
        with full_float32_convs():
            feats, rpn_outs, shapes = self._trunk(images)
            H, W = images.shape[1:3]
            out = []
            for b in range(images.shape[0]):
                rpn_i = [(o[b], d[b]) for o, d in rpn_outs]
                props = self.propose(rpn_i, shapes, (H, W))
                logits, deltas, boxes = self._stages([f[b] for f in feats],
                                                     props, H, W)
                out.append(RawCascade(
                    rpn_logits=[o.reshape(-1) for o, _ in rpn_i],
                    rpn_deltas=[d.reshape(-1, 4) for _, d in rpn_i],
                    proposals=props, stage_logits=logits,
                    stage_deltas=deltas, boxes=boxes))
            return out

    @torch.no_grad()
    def forward(self, images) -> CascadeDetections:
        with full_float32_convs():
            return self._forward(images)

    def _forward(self, images):
        B, H, W, _ = images.shape
        feats, rpn_outs, shapes = self._trunk(images)
        outs = []
        for b in range(B):
            feats_i = [f[b] for f in feats]
            props = self.propose([(o[b], d[b]) for o, d in rpn_outs], shapes,
                                 (H, W))
            logits, _, boxes = self._stages(feats_i, props, H, W)
            p = torch.stack([torch.softmax(s, -1) for s in logits]).mean(0)
            p = p[:, :self.num_classes]
            best_p, best_cls = torch.max(p, -1)
            # per-class NMS on the fixed budget: boxes offset by class
            offset = best_cls.to(torch.float32)[:, None] * 4096.0
            keep = nms(boxes + offset, best_p, self.nms_iou)
            scored = torch.where(keep, best_p,
                                 torch.full_like(best_p, -torch.inf))
            top, idx = top_k(scored, self.detections)
            det_boxes, det_cls = boxes[idx], best_cls[idx]
            mlogit = self.mask_head(multilevel_roi_align(feats_i, det_boxes,
                                                         14))
            m = torch.sigmoid(torch.gather(
                mlogit, -1, det_cls[:, None, None, None].expand(
                    -1, *mlogit.shape[1:3], 1)))[..., 0]
            finite = torch.isfinite(top)
            outs.append((det_boxes, torch.where(finite, top,
                                                torch.zeros_like(top)),
                         det_cls, finite & (top > self.score_threshold), m))
        b, s, c, v, m = (torch.stack(z) for z in zip(*outs))
        return CascadeDetections(boxes_xyxy=b, scores=s, classes=c, valid=v,
                                 masks=m)


# --------------------------------------------------------------------------
# HumanDetector (the reference's build_detector.py facade)
# --------------------------------------------------------------------------
def postprocess_human_boxes(boxes_xyxy, scores, classes, valid,
                            image_hw: Tuple[int, int],
                            det_cat_id: int = 0, bbox_thr: float = 0.5,
                            default_to_full_image: bool = True) -> np.ndarray:
    """Keep ``classes == det_cat_id`` above ``bbox_thr``; with none and
    ``default_to_full_image``, one full-image box; rows lexsorted by (x1
    first, then y1, x2, y2)."""
    boxes = np.asarray(boxes_xyxy, np.float64)
    ok = (np.asarray(valid, bool) & (np.asarray(classes) == det_cat_id)
          & (np.asarray(scores) > bbox_thr))
    boxes = boxes[ok]
    if len(boxes) == 0:
        if not default_to_full_image:
            return np.zeros((0, 4), np.float64)
        h, w = image_hw
        return np.array([[0, 0, w, h]], np.float64)
    order = np.lexsort((boxes[:, 3], boxes[:, 2], boxes[:, 1], boxes[:, 0]))
    return boxes[order]


class HumanDetector:
    """The cascade with the reference detector's pre- and post-processing:
    the short edge resized to ``image_size`` (the long edge capped at it),
    frames padded to one ``image_size`` square, boxes mapped back to the
    original pixels. ``model`` carries its weights and lives on its
    device; frames come as numpy and results go back to the host once a
    batch."""

    def __init__(self, model: CascadeMaskRCNN, image_size: int = 1024):
        self.model = model.eval()
        self.image_size = int(image_size)
        self.device = next(model.parameters()).device

    def _scale(self, h: int, w: int) -> float:
        s = self.image_size / min(h, w)
        if max(h, w) * s > self.image_size:       # max_size cap
            s = self.image_size / max(h, w)
        return s

    def detect_frames(self, frames) -> CascadeDetections:
        """(T, H, W, 3) float in [0, 1] (numpy or a tensor) →
        :class:`CascadeDetections` of numpy arrays in the original
        pixels."""
        T, h, w = frames.shape[:3]
        s = self._scale(h, w)
        nh, nw = int(round(h * s)), int(round(w * s))
        x = resize(torch.as_tensor(frames, device=self.device),
                   (T, nh, nw, 3), "bilinear")
        x = F.pad(x, (0, 0, 0, self.image_size - nw, 0, self.image_size - nh))
        out = self.model(x)
        boxes, scores, classes, valid, masks = (t.cpu().numpy() for t in out)
        return CascadeDetections(boxes_xyxy=boxes / s, scores=scores,
                                 classes=classes, valid=valid, masks=masks)

    def detect_clip(self, frames_u8: np.ndarray, batch_size: int = 4,
                    det_cat_id: int = 0, bbox_thr: float = 0.5,
                    max_people: int = 4):
        """(T, H, W, 3) uint8 → ``(T, max_people, 4)`` boxes and ``(T,
        max_people)`` valid: fixed person slots in the lexsort's order. A
        short last batch is padded with zero frames."""
        T, h, w = frames_u8.shape[:3]
        boxes = np.zeros((T, max_people, 4), np.float32)
        valid = np.zeros((T, max_people), bool)
        for s0 in range(0, T, batch_size):
            e = min(s0 + batch_size, T)
            fr = torch.as_tensor(np.ascontiguousarray(frames_u8[s0:e]),
                                 device=self.device).to(torch.float32) / 255.0
            if e - s0 < batch_size:
                fr = F.pad(fr, (0, 0, 0, 0, 0, 0, 0, batch_size - (e - s0)))
            out = self.detect_frames(fr)
            for i in range(e - s0):
                b = postprocess_human_boxes(
                    out.boxes_xyxy[i], out.scores[i], out.classes[i],
                    out.valid[i], (h, w), det_cat_id, bbox_thr,
                    default_to_full_image=True)[:max_people]
                boxes[s0 + i, :len(b)] = b
                valid[s0 + i, :len(b)] = True
        return boxes, valid


# --------------------------------------------------------------------------
# detectron2 converter (reference layout → the port's state_dict)
# --------------------------------------------------------------------------
def _np_of(t):
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                      else t, np.float32)


def _conv(sd, pre):
    out = {"kernel": _np_of(sd[f"{pre}.weight"]).transpose(2, 3, 1, 0)}
    if f"{pre}.bias" in sd:
        out["bias"] = _np_of(sd[f"{pre}.bias"])
    return out


def _deconv(sd, pre):
    # torch ConvTranspose2d (I, O, kh, kw) → flax (kh, kw, I, O) flipped in
    # space (flax does not flip; the port's ConvTranspose flips it back)
    w = _np_of(sd[f"{pre}.weight"]).transpose(2, 3, 0, 1)[::-1, ::-1]
    out = {"kernel": np.ascontiguousarray(w)}
    if f"{pre}.bias" in sd:
        out["bias"] = _np_of(sd[f"{pre}.bias"])
    return out


def _ln(sd, pre):
    return {"scale": _np_of(sd[f"{pre}.weight"]),
            "bias": _np_of(sd[f"{pre}.bias"])}


def _dense(sd, pre):
    return {"kernel": _np_of(sd[f"{pre}.weight"]).T,
            "bias": _np_of(sd[f"{pre}.bias"])}


def _convln(sd, pre):
    return {"conv": _conv(sd, pre), "norm": _ln(sd, f"{pre}.norm")}


def convert_detectron2_cascade_vitdet(state_dict) -> dict:
    """A detectron2 cascade_mask_rcnn_vitdet state dict → the ``state_dict``
    of :class:`CascadeMaskRCNN`, through skix's flax layout. The flat
    ``(1, g² (+1), C)`` position table keeps its grid square (a leading cls
    token is dropped)."""
    from skix_torch.convert import flax_to_state_dict

    sd = state_dict
    depth = 1 + max(int(k.split(".")[3])
                    for k in sd if k.startswith("backbone.net.blocks."))
    net: dict = {"patch_embed": _conv(sd, "backbone.net.patch_embed.proj")}
    pe = _np_of(sd["backbone.net.pos_embed"])
    g = int(round(pe.shape[1] ** 0.5))
    if g * g != pe.shape[1]:                    # a leading cls token
        pe = pe[:, 1:]
        g = int(round(pe.shape[1] ** 0.5))
    net["pos_embed"] = pe.reshape(1, g, g, -1)
    for i in range(depth):
        pre = f"backbone.net.blocks.{i}"
        net[f"block{i}"] = {
            "norm1": _ln(sd, f"{pre}.norm1"), "norm2": _ln(sd, f"{pre}.norm2"),
            "attn": {"qkv": _dense(sd, f"{pre}.attn.qkv"),
                     "proj": _dense(sd, f"{pre}.attn.proj"),
                     "rel_pos_h": _np_of(sd[f"{pre}.attn.rel_pos_h"]),
                     "rel_pos_w": _np_of(sd[f"{pre}.attn.rel_pos_w"])},
            "mlp_fc1": _dense(sd, f"{pre}.mlp.fc1"),
            "mlp_fc2": _dense(sd, f"{pre}.mlp.fc2")}
    # SimpleFeaturePyramid's sequential indices per scale:
    #   simfp_2: 0 deconv, 1 LN, 2 GELU, 3 deconv, 4 conv1x1+LN, 5 conv3x3+LN
    #   simfp_3: 0 deconv, 1 conv1x1+LN, 2 conv3x3+LN
    #   simfp_4: 0 conv1x1+LN, 1 conv3x3+LN
    #   simfp_5: 0 maxpool, 1 conv1x1+LN, 2 conv3x3+LN
    fpn = {"s4_deconv1": _deconv(sd, "backbone.simfp_2.0"),
           "s4_ln": _ln(sd, "backbone.simfp_2.1"),
           "s4_deconv2": _deconv(sd, "backbone.simfp_2.3"),
           "p2_conv1": _convln(sd, "backbone.simfp_2.4"),
           "p2_conv2": _convln(sd, "backbone.simfp_2.5"),
           "s8_deconv": _deconv(sd, "backbone.simfp_3.0"),
           "p3_conv1": _convln(sd, "backbone.simfp_3.1"),
           "p3_conv2": _convln(sd, "backbone.simfp_3.2"),
           "p4_conv1": _convln(sd, "backbone.simfp_4.0"),
           "p4_conv2": _convln(sd, "backbone.simfp_4.1"),
           "p5_conv1": _convln(sd, "backbone.simfp_5.1"),
           "p5_conv2": _convln(sd, "backbone.simfp_5.2")}
    rpn_pre = "proposal_generator.rpn_head"
    rpn = {"conv0": _conv(sd, f"{rpn_pre}.conv.conv0"),
           "conv1": _conv(sd, f"{rpn_pre}.conv.conv1"),
           "objectness_logits": _conv(sd, f"{rpn_pre}.objectness_logits"),
           "anchor_deltas": _conv(sd, f"{rpn_pre}.anchor_deltas")}
    params: dict = {"net": net, "fpn": fpn, "rpn_head": rpn}
    for k in range(3):
        head = {f"conv{c}": _convln(sd, f"roi_heads.box_head.{k}.conv{c}")
                for c in range(1, 5)}
        head["fc1"] = _dense(sd, f"roi_heads.box_head.{k}.fc1")
        for name in ("cls_score", "bbox_pred"):
            head[name] = _dense(sd, f"roi_heads.box_predictor.{k}.{name}")
        params[f"box_head{k}"] = head
    mh = {f"mask_fcn{c}": _convln(sd, f"roi_heads.mask_head.mask_fcn{c}")
          for c in range(1, 5)}
    mh["deconv"] = _deconv(sd, "roi_heads.mask_head.deconv")
    mh["predictor"] = _conv(sd, "roi_heads.mask_head.predictor")
    params["mask_head"] = mh
    return flax_to_state_dict({"params": params})


def cascade_reference_state_dict_spec(embed_dim: int = 1280, depth: int = 32,
                                      num_heads: int = 16,
                                      window_size: int = 14,
                                      global_grid: int = 64,
                                      num_classes: int = 80,
                                      global_indexes=(7, 15, 23, 31),
                                      cls_token: bool = True) -> dict:
    """Every tensor of detectron2's cascade-vitdet state dict → its shape
    (torch order): the converter's oracle."""
    spec: dict = {}
    hd = embed_dim // num_heads

    def conv(pre, cin, cout, k, bias=True):
        spec[f"{pre}.weight"] = (cout, cin, k, k)
        if bias:
            spec[f"{pre}.bias"] = (cout,)

    def deconv(pre, cin, cout, k):
        spec[f"{pre}.weight"] = (cin, cout, k, k)
        spec[f"{pre}.bias"] = (cout,)

    def ln(pre, c):
        spec[f"{pre}.weight"] = (c,)
        spec[f"{pre}.bias"] = (c,)

    def dense(pre, cin, cout):
        spec[f"{pre}.weight"] = (cout, cin)
        spec[f"{pre}.bias"] = (cout,)

    def convln(pre, cin, cout, k):
        conv(pre, cin, cout, k, bias=False)
        ln(f"{pre}.norm", cout)

    conv("backbone.net.patch_embed.proj", 3, embed_dim, 16)
    spec["backbone.net.pos_embed"] = (1, 14 * 14 + (1 if cls_token else 0),
                                      embed_dim)
    for i in range(depth):
        pre = f"backbone.net.blocks.{i}"
        ln(f"{pre}.norm1", embed_dim)
        ln(f"{pre}.norm2", embed_dim)
        dense(f"{pre}.attn.qkv", embed_dim, 3 * embed_dim)
        dense(f"{pre}.attn.proj", embed_dim, embed_dim)
        ext = global_grid if i in tuple(global_indexes) else window_size
        spec[f"{pre}.attn.rel_pos_h"] = (2 * ext - 1, hd)
        spec[f"{pre}.attn.rel_pos_w"] = (2 * ext - 1, hd)
        dense(f"{pre}.mlp.fc1", embed_dim, 4 * embed_dim)
        dense(f"{pre}.mlp.fc2", 4 * embed_dim, embed_dim)
    deconv("backbone.simfp_2.0", embed_dim, embed_dim // 2, 2)
    ln("backbone.simfp_2.1", embed_dim // 2)
    deconv("backbone.simfp_2.3", embed_dim // 2, embed_dim // 4, 2)
    convln("backbone.simfp_2.4", embed_dim // 4, 256, 1)
    convln("backbone.simfp_2.5", 256, 256, 3)
    deconv("backbone.simfp_3.0", embed_dim, embed_dim // 2, 2)
    convln("backbone.simfp_3.1", embed_dim // 2, 256, 1)
    convln("backbone.simfp_3.2", 256, 256, 3)
    convln("backbone.simfp_4.0", embed_dim, 256, 1)
    convln("backbone.simfp_4.1", 256, 256, 3)
    convln("backbone.simfp_5.1", embed_dim, 256, 1)
    convln("backbone.simfp_5.2", 256, 256, 3)
    conv("proposal_generator.rpn_head.conv.conv0", 256, 256, 3)
    conv("proposal_generator.rpn_head.conv.conv1", 256, 256, 3)
    conv("proposal_generator.rpn_head.objectness_logits", 256, 3, 1)
    conv("proposal_generator.rpn_head.anchor_deltas", 256, 12, 1)
    for k in range(3):
        cin = 256
        for c in range(1, 5):
            convln(f"roi_heads.box_head.{k}.conv{c}", cin, 256, 3)
        dense(f"roi_heads.box_head.{k}.fc1", 256 * 7 * 7, 1024)
        dense(f"roi_heads.box_predictor.{k}.cls_score", 1024, num_classes + 1)
        dense(f"roi_heads.box_predictor.{k}.bbox_pred", 1024, 4)
    for c in range(1, 5):
        convln(f"roi_heads.mask_head.mask_fcn{c}", 256, 256, 3)
    deconv("roi_heads.mask_head.deconv", 256, 256, 2)
    conv("roi_heads.mask_head.predictor", 256, num_classes, 1)
    return spec
