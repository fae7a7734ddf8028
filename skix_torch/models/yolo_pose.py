"""YOLO-class single-stage detectors: pose, detect-only and segmentation.

Port of ``skix/models/yolo_pose.py``. Both ultralytics generations, picked
by ``version``: 8 (C2f trunk, SPPF, PAN-FPN neck, plain classification
branch) and 11 (C3k2 blocks with optional nested C3k bottlenecks, a C2PSA
attention stage after SPPF, the depthwise-separable classification
branch). ``scale`` picks the n/s/m/l/x widths and depths of ultralytics'
tables. Every conv is ultralytics' ``Conv``: bias-free conv, BatchNorm
(eps 1e-3, running statistics; in training mode flax's batch statistics and
momentum 0.97), SiLU.

- :class:`YoloPose` → :class:`RawPredictions` (DFL box logits, class
  logits, keypoint offsets, anchors, strides); :func:`detect` decodes and
  keeps the top-K after NMS.
- :class:`YoloDetect` → box and class heads; :func:`detect_boxes`, with
  ultralytics' ``classes=`` filter.
- :class:`YoloSeg` → box and class heads, mask coefficients and the
  stride-4 prototype bank (:class:`Proto`); :func:`detect_seg` builds the
  kept detections' masks, cropped to their boxes
  (:func:`crop_masks_to_boxes`).

Decoding is skix's: a stable top-``pre_nms_k`` pool (ties to the lowest
index, as ``jax.lax.top_k``), greedy NMS, then the top-K survivors.
``PSAAttention`` is an explicit softmax over the /32 grid, in torch ops as
skix writes it outside its kernels. Channels-last, with skix's flax names
(``b0``, ``h13``, ``cv2_0_1`` …), so ``skix_torch.convert`` loads a skix
checkpoint; the ultralytics converters and state-dict specs are ported too
(:func:`convert_ultralytics_pose`, ``_detect``, ``_seg``: they return the
port's ``state_dict``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models.layers import Conv, ConvTranspose, batch_norm_train
from skix_torch.ops.nms import nms
from skix_torch.perception.sfm_tracks import top_k
from skix_torch.utils.device import constant, full_float32_convs
from skix_torch.utils.image import resize

# depth_mult, width_mult, max_channels (ultralytics scale tables)
SCALES = {
    "n": (0.34, 0.25, 1024),
    "s": (0.34, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}
# yolo11.yaml scales; for m/l/x every C3k2 forces c3k=True (parse_model)
SCALES11 = {
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}


def _make_divisible(c: float, d: int = 8) -> int:
    return max(d, int(round(c / d) * d))


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` on channels-last input, skix's ``momentum=0.97``:
    in inference ``(x − mean) · (rsqrt(var + eps) · scale) + bias``, flax's
    order; in training mode (``module.train()``) the batch statistics, the
    running ones moved to 0.97 · old + 0.03 · batch
    (``layers.batch_norm_train``)."""

    def __init__(self, dim: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x):
        if self.training:
            return batch_norm_train(x, self.weight, self.bias,
                                    self.running_mean, self.running_var, 0.97,
                                    self.eps, tuple(range(x.dim() - 1)))
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias


class ConvBNAct(nn.Module):
    """ultralytics ``Conv``: Conv2d(bias=False) + BN (+ SiLU unless
    ``act=False``); ``groups=features`` is ultralytics' ``DWConv``."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, act: bool = True, groups: int = 1):
        super().__init__()
        self.conv = Conv(cin, features, kernel, stride, groups=groups,
                         bias=False)
        self.bn = BatchNorm(features)
        self.act = act

    def forward(self, x):
        h = self.bn(self.conv(x))
        return F.silu(h) if self.act else h


class Bottleneck(nn.Module):
    """cv1 3×3 to ``hidden`` channels (full width when None), cv2 3×3 back
    to ``features``, residual when ``shortcut``."""

    def __init__(self, features: int, shortcut: bool = True,
                 hidden: Optional[int] = None):
        super().__init__()
        c_ = features if hidden is None else hidden
        self.cv1 = ConvBNAct(features, c_, 3)
        self.cv2 = ConvBNAct(c_, features, 3)
        self.shortcut = shortcut

    def forward(self, x):
        h = self.cv2(self.cv1(x))
        return x + h if self.shortcut else h


class C2f(nn.Module):
    """1×1 expand → split → n bottlenecks, each appended → 1×1 fuse."""

    def __init__(self, cin: int, features: int, n: int = 1,
                 shortcut: bool = True):
        super().__init__()
        c = features // 2
        self.n = n
        self.cv1 = ConvBNAct(cin, 2 * c, 1)
        for i in range(n):
            setattr(self, f"m_{i}", Bottleneck(c, shortcut))
        self.cv2 = ConvBNAct((2 + n) * c, features, 1)

    def forward(self, x):
        parts = list(torch.chunk(self.cv1(x), 2, -1))
        for i in range(self.n):
            parts.append(getattr(self, f"m_{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, -1))


class C3k(nn.Module):
    """ultralytics ``C3k``: cv3(cat(m(cv1(x)), cv2(x))), 3×3 bottlenecks."""

    def __init__(self, features: int, n: int = 2, shortcut: bool = True):
        super().__init__()
        c_ = features // 2
        self.n = n
        self.cv1 = ConvBNAct(features, c_, 1)
        self.cv2 = ConvBNAct(features, c_, 1)
        for i in range(n):
            setattr(self, f"m_{i}", Bottleneck(c_, shortcut))
        self.cv3 = ConvBNAct(2 * c_, features, 1)

    def forward(self, x):
        a = self.cv1(x)
        b = self.cv2(x)
        for i in range(self.n):
            a = getattr(self, f"m_{i}")(a)
        return self.cv3(torch.cat([a, b], -1))


class C3k2(nn.Module):
    """ultralytics ``C3k2`` (YOLO11): a C2f whose per-chunk module is a
    nested :class:`C3k` when ``c3k``, else a half-width Bottleneck; hidden
    width ``int(features · e)``."""

    def __init__(self, cin: int, features: int, n: int = 1,
                 c3k: bool = False, e: float = 0.5, shortcut: bool = True):
        super().__init__()
        c = int(features * e)
        self.n = n
        self.cv1 = ConvBNAct(cin, 2 * c, 1)
        for i in range(n):
            setattr(self, f"m_{i}", C3k(c, 2, shortcut) if c3k
                    else Bottleneck(c, shortcut, hidden=c // 2))
        self.cv2 = ConvBNAct((2 + n) * c, features, 1)

    def forward(self, x):
        parts = list(torch.chunk(self.cv1(x), 2, -1))
        for i in range(self.n):
            parts.append(getattr(self, f"m_{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, -1))


class PSAAttention(nn.Module):
    """ultralytics ``Attention`` inside C2PSA: 1×1 ConvBN qkv → softmax
    attention per head over the H·W tokens + a depthwise 3×3 positional
    term on v → 1×1 ConvBN projection."""

    def __init__(self, dim: int, num_heads: int, attn_ratio: float = 0.5):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        hd = dim // num_heads
        self.kd = int(hd * attn_ratio)
        self.qkv = ConvBNAct(dim, dim + 2 * self.kd * num_heads, 1, act=False)
        self.pe = ConvBNAct(dim, dim, 3, act=False, groups=dim)
        self.proj = ConvBNAct(dim, dim, 1, act=False)

    def forward(self, x):
        B, H, W, _ = x.shape
        nh, kd = self.num_heads, self.kd
        hd = self.dim // nh
        qkv = self.qkv(x).reshape(B, H * W, nh, 2 * kd + hd)
        q, k, v = torch.split(qkv, [kd, kd, hd], -1)
        attn = torch.einsum("binc,bjnc->bnij", q, k) * (kd ** -0.5)
        attn = torch.softmax(attn, -1)
        out = torch.einsum("bjnd,bnij->bind", v, attn).reshape(B, H, W,
                                                               self.dim)
        pe = self.pe(v.reshape(B, H, W, self.dim))
        return self.proj(out + pe)


class PSABlock(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.attn = PSAAttention(dim, num_heads, 0.5)
        self.ffn_0 = ConvBNAct(dim, 2 * dim, 1)
        self.ffn_1 = ConvBNAct(2 * dim, dim, 1, act=False)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn_1(self.ffn_0(x))


class C2PSA(nn.Module):
    """1×1 split → n PSABlocks on one half → 1×1 fuse; heads = c // 64, as
    ultralytics hard-codes it."""

    def __init__(self, features: int, n: int = 1):
        super().__init__()
        c = features // 2
        self.n = n
        self.cv1 = ConvBNAct(features, 2 * c, 1)
        for i in range(n):
            setattr(self, f"m_{i}", PSABlock(c, max(1, c // 64)))
        self.cv2 = ConvBNAct(2 * c, features, 1)

    def forward(self, x):
        a, b = torch.chunk(self.cv1(x), 2, -1)
        for i in range(self.n):
            b = getattr(self, f"m_{i}")(b)
        return self.cv2(torch.cat([a, b], -1))


def max_pool_same(x, k: int, stride: int = 1):
    """flax ``max_pool(x, (k, k), strides, padding="SAME")`` on channels-last
    input (padding with −inf, split as flax splits it)."""
    from skix_torch.models.layers import _same_pads

    ph = _same_pads(x.shape[1], k, stride)
    pw = _same_pads(x.shape[2], k, stride)
    xn = F.pad(x.permute(0, 3, 1, 2), (*pw, *ph), value=-torch.inf)
    return F.max_pool2d(xn, k, stride).permute(0, 2, 3, 1)


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained stride-1 max pools."""

    def __init__(self, cin: int, features: int, pool: int = 5):
        super().__init__()
        c = cin // 2
        self.pool = pool
        self.cv1 = ConvBNAct(cin, c, 1)
        self.cv2 = ConvBNAct(4 * c, features, 1)

    def forward(self, x):
        outs = [self.cv1(x)]
        for _ in range(3):
            outs.append(max_pool_same(outs[-1], self.pool))
        return self.cv2(torch.cat(outs, -1))


def _up2(t):
    B, H, W, C = t.shape
    return resize(t, (B, 2 * H, 2 * W, C), "nearest")


def _register_trunk(model: nn.Module, scale: str, version: int):
    """Register the shared backbone + neck on ``model`` at its root, with
    the ultralytics yaml's layer numbers as names (v8: b0..b9, h12..h21;
    v11: b0..b10, h13..h22), as skix's free trunk function does, so that
    every head carries the same flat names; :func:`_run_trunk` runs it →
    (o3, o4, o5) at /8, /16, /32."""
    ch, n3, n6 = _widths(scale, version)
    c1, c2, c3, c4, c5 = ch
    if version == 11:
        a = scale in "mlx"
        layers = {
            "b0": ConvBNAct(3, c1, 3, 2), "b1": ConvBNAct(c1, c2, 3, 2),
            "b2": C3k2(c2, c3, n3, a, 0.25), "b3": ConvBNAct(c3, c3, 3, 2),
            "b4": C3k2(c3, c4, n3, a, 0.25), "b5": ConvBNAct(c4, c4, 3, 2),
            "b6": C3k2(c4, c4, n3, True, 0.5), "b7": ConvBNAct(c4, c5, 3, 2),
            "b8": C3k2(c5, c5, n3, True, 0.5), "b9": SPPF(c5, c5, 5),
            "b10": C2PSA(c5, n3),
            "h13": C3k2(c5 + c4, c4, n3, a, 0.5),
            "h16": C3k2(c4 + c4, c3, n3, a, 0.5),
            "h17": ConvBNAct(c3, c3, 3, 2),
            "h19": C3k2(c3 + c4, c4, n3, a, 0.5),
            "h20": ConvBNAct(c4, c4, 3, 2),
            "h22": C3k2(c4 + c5, c5, n3, True, 0.5)}
    else:
        layers = {
            "b0": ConvBNAct(3, c1, 3, 2), "b1": ConvBNAct(c1, c2, 3, 2),
            "b2": C2f(c2, c2, n3), "b3": ConvBNAct(c2, c3, 3, 2),
            "b4": C2f(c3, c3, n6), "b5": ConvBNAct(c3, c4, 3, 2),
            "b6": C2f(c4, c4, n6), "b7": ConvBNAct(c4, c5, 3, 2),
            "b8": C2f(c5, c5, n3), "b9": SPPF(c5, c5, 5),
            "h12": C2f(c5 + c4, c4, n3, False),
            "h15": C2f(c4 + c3, c3, n3, False),
            "h16": ConvBNAct(c3, c3, 3, 2),
            "h18": C2f(c3 + c4, c4, n3, False),
            "h19": ConvBNAct(c4, c4, 3, 2),
            "h21": C2f(c4 + c5, c5, n3, False)}
    for name, layer in layers.items():
        setattr(model, name, layer)


def _run_trunk(m: nn.Module, x, version: int):
    if version == 11:
        h = m.b3(m.b2(m.b1(m.b0(x))))
        p3 = m.b4(h)
        p4 = m.b6(m.b5(p3))
        p5 = m.b10(m.b9(m.b8(m.b7(p4))))
        t4 = m.h13(torch.cat([_up2(p5), p4], -1))
        o3 = m.h16(torch.cat([_up2(t4), p3], -1))
        o4 = m.h19(torch.cat([m.h17(o3), t4], -1))
        o5 = m.h22(torch.cat([m.h20(o4), p5], -1))
        return o3, o4, o5
    h = m.b3(m.b2(m.b1(m.b0(x))))
    p3 = m.b4(h)
    p4 = m.b6(m.b5(p3))
    p5 = m.b9(m.b8(m.b7(p4)))
    t4 = m.h12(torch.cat([_up2(p5), p4], -1))
    o3 = m.h15(torch.cat([_up2(t4), p3], -1))
    o4 = m.h18(torch.cat([m.h16(o3), t4], -1))
    o5 = m.h21(torch.cat([m.h19(o4), p5], -1))
    return o3, o4, o5


def _widths(scale: str, version: int):
    """(channel plan, repeat counts) for one scale/version."""
    d, w, mc = (SCALES11 if version == 11 else SCALES)[scale]
    ch = [_make_divisible(min(c * w, mc * w))
          for c in (64, 128, 256, 512, 1024)]
    if version == 11:
        n = max(1, round(2 * d))
        return ch, n, n
    return ch, max(1, round(3 * d)), max(1, round(6 * d))


class PoseDetections(NamedTuple):
    boxes_xyxy: torch.Tensor   # (B, K, 4) pixels
    scores: torch.Tensor       # (B, K)
    keypoints: torch.Tensor    # (B, K, 17, 3) x, y, conf (pixels)
    valid: torch.Tensor        # (B, K) bool


class RawPredictions(NamedTuple):
    box_dist: torch.Tensor     # (B, A, 4, reg_max) DFL logits
    cls_logits: torch.Tensor   # (B, A, nc)
    kpt_raw: torch.Tensor      # (B, A, 17, 3) raw offsets + conf logit
    anchors: torch.Tensor      # (A, 2) grid-cell centres (grid units)
    strides: torch.Tensor      # (A,) pixels per grid unit


_ANCHORS: dict = {}


def _anchor_tables(shapes):
    """(A, 2) cell centres and (A,) strides of the three levels, as numpy
    arrays built once per level-shape triple (kept for ``constant``)."""
    key = tuple(shapes)
    if key not in _ANCHORS:
        anchors, strides = [], []
        for (gh, gw), stride in zip(shapes, (8, 16, 32)):
            ys, xs = np.meshgrid(np.arange(gh) + 0.5, np.arange(gw) + 0.5,
                                 indexing="ij")
            anchors.append(np.stack([xs.ravel(), ys.ravel()], -1))
            strides.append(np.full(gh * gw, stride, np.float32))
        _ANCHORS[key] = (np.concatenate(anchors, 0).astype(np.float32),
                         np.concatenate(strides, 0))
    return _ANCHORS[key]


class _YoloBase(nn.Module):
    """Trunk + the decoupled box (cv2) and class (cv3) branches, plus a
    third (cv4) branch of ``cv4_out`` channels when given."""

    def __init__(self, scale: str, num_classes: int, reg_max: int,
                 version: int, cv4_out: Optional[int] = None,
                 cv4_width: Optional[int] = None):
        super().__init__()
        self.scale, self.version = scale, version
        self.num_classes, self.reg_max = num_classes, reg_max
        _register_trunk(self, scale, version)
        ch, _, _ = _widths(scale, version)
        c3 = ch[2]
        cb = max(16, c3 // 4, 4 * reg_max)
        cc = max(c3, min(num_classes, 100))
        for li, cin in enumerate(ch[2:]):
            setattr(self, f"cv2_{li}_0", ConvBNAct(cin, cb, 3))
            setattr(self, f"cv2_{li}_1", ConvBNAct(cb, cb, 3))
            setattr(self, f"cv2_{li}_2", Conv(cb, 4 * reg_max, 1))
            if version == 11:
                setattr(self, f"cv3_{li}_0_0", ConvBNAct(cin, cin, 3,
                                                         groups=cin))
                setattr(self, f"cv3_{li}_0_1", ConvBNAct(cin, cc, 1))
                setattr(self, f"cv3_{li}_1_0", ConvBNAct(cc, cc, 3,
                                                         groups=cc))
                setattr(self, f"cv3_{li}_1_1", ConvBNAct(cc, cc, 1))
            else:
                setattr(self, f"cv3_{li}_0", ConvBNAct(cin, cc, 3))
                setattr(self, f"cv3_{li}_1", ConvBNAct(cc, cc, 3))
            setattr(self, f"cv3_{li}_2", Conv(cc, num_classes, 1))
            if cv4_out is not None:
                setattr(self, f"cv4_{li}_0", ConvBNAct(cin, cv4_width, 3))
                setattr(self, f"cv4_{li}_1", ConvBNAct(cv4_width, cv4_width,
                                                       3))
                setattr(self, f"cv4_{li}_2", Conv(cv4_width, cv4_out, 1))

    def widths(self):
        return _widths(self.scale, self.version)

    def _branch(self, name, li, x):
        for j in range(2):
            x = getattr(self, f"{name}_{li}_{j}")(x)
        return getattr(self, f"{name}_{li}_2")(x)

    def _cls(self, li, x):
        if self.version == 11:
            for j in range(2):
                for k in range(2):
                    x = getattr(self, f"cv3_{li}_{j}_{k}")(x)
        else:
            for j in range(2):
                x = getattr(self, f"cv3_{li}_{j}")(x)
        return getattr(self, f"cv3_{li}_2")(x)

    def _heads(self, images, cv4: bool):
        """(o3, dists, clss, cv4 outputs, anchors, strides)."""
        feats = _run_trunk(self, images, self.version)
        B = images.shape[0]
        dists, clss, extra, shapes = [], [], [], []
        for li, feat in enumerate(feats):
            gh, gw = feat.shape[1], feat.shape[2]
            dists.append(self._branch("cv2", li, feat).reshape(
                B, gh * gw, 4, self.reg_max))
            clss.append(self._cls(li, feat).reshape(B, gh * gw,
                                                    self.num_classes))
            if cv4:
                extra.append(self._branch("cv4", li, feat).reshape(
                    B, gh * gw, -1))
            shapes.append((gh, gw))
        anchors, strides = _anchor_tables(shapes)
        dev = images.device
        return (feats[0], torch.cat(dists, 1), torch.cat(clss, 1),
                torch.cat(extra, 1) if cv4 else None,
                constant(anchors, dev), constant(strides, dev))


class YoloPose(_YoloBase):
    """YOLOv8/YOLO11-pose: image (B, H, W, 3) in [0, 1] (H, W multiples of
    32) → per-anchor raw heads; :func:`detect` for boxes."""

    def __init__(self, scale: str = "s", num_keypoints: int = 17,
                 num_classes: int = 1, reg_max: int = 16, version: int = 8):
        nk = num_keypoints * 3
        c3 = _widths(scale, version)[0][2]
        super().__init__(scale, num_classes, reg_max, version, nk,
                         max(c3 // 4, nk))
        self.num_keypoints = num_keypoints

    def forward(self, images) -> RawPredictions:
        with full_float32_convs():
            _, dist, cls, kpt, anchors, strides = self._heads(images, True)
        B, A = cls.shape[:2]
        return RawPredictions(box_dist=dist, cls_logits=cls,
                              kpt_raw=kpt.reshape(B, A, self.num_keypoints, 3),
                              anchors=anchors, strides=strides)

    def train_forward(self, images):
        """skix's ``apply(..., train=True, mutable=["batch_stats"])``: the
        raw predictions from batch statistics (the model is left in
        training mode) and the updated running statistics, ``{buffer name:
        tensor}``."""
        self.train()
        raw = self(images)
        return raw, {n: b for n, b in self.named_buffers()
                     if n.endswith(("running_mean", "running_var"))}


def dfl_expectation(box_dist):
    """(…, 4, reg_max) logits → (…, 4) expected l, t, r, b distances (grid
    units): softmax over the bins, dot with the bin index."""
    reg_max = box_dist.shape[-1]
    p = torch.softmax(box_dist, -1)
    return p @ torch.arange(reg_max, dtype=torch.float32,
                            device=box_dist.device)


def decode_boxes(raw):
    """Per-anchor xyxy pixel boxes from DFL distances (dist2bbox)."""
    ltrb = dfl_expectation(raw.box_dist)
    a = raw.anchors[None]
    s = raw.strides[None, :, None]
    return torch.cat([(a - ltrb[..., :2]) * s, (a + ltrb[..., 2:]) * s], -1)


def decode_keypoints(raw: RawPredictions):
    """ultralytics kpts_decode: xy = (raw·2 + anchor − 0.5) · stride."""
    a = raw.anchors[None, :, None, :]
    s = raw.strides[None, :, None, None]
    xy = (raw.kpt_raw[..., :2] * 2.0 + (a - 0.5)) * s
    return torch.cat([xy, torch.sigmoid(raw.kpt_raw[..., 2:3])], -1)


def _pool_nms_top(sc, bx, pool: int, nms_iou: float, k: int,
                  score_threshold: float):
    """One image: the top-``pool`` candidates, NMS, then the top ``k``
    survivors → (pool indices, slot indices into the pool, pool scores,
    valid)."""
    pool_s, idx = top_k(sc, pool)
    keep = nms(bx[idx], pool_s, nms_iou)
    ranked = torch.where(keep, pool_s, torch.full_like(pool_s, -torch.inf))
    top_s, sel = top_k(ranked, k)
    ok = torch.isfinite(top_s) & (top_s > score_threshold)
    return idx, sel, pool_s, ok


def detect(raw: RawPredictions, top_k: int = 8, score_threshold: float = 0.25,
           nms_iou: float = 0.7, pre_nms_k: int = 128) -> PoseDetections:
    """Static-shape postprocess: per image a top-``pre_nms_k`` candidate
    pool → NMS → the top-``top_k`` survivors into padded slots."""
    boxes = decode_boxes(raw)
    kpts = decode_keypoints(raw)
    scores = torch.sigmoid(raw.cls_logits).amax(-1)
    pool = min(max(pre_nms_k, top_k), scores.shape[-1])
    outs = []
    for b in range(scores.shape[0]):
        idx, sel, pool_s, ok = _pool_nms_top(scores[b], boxes[b], pool,
                                             nms_iou, top_k, score_threshold)
        outs.append((boxes[b][idx][sel], pool_s[sel], kpts[b][idx][sel], ok))
    b, s, k, v = (torch.stack(z) for z in zip(*outs))
    return PoseDetections(boxes_xyxy=b, scores=s, keypoints=k, valid=v)


# ---------------------------------------------------------------------------
# detect-only variant (plain yolo11x.pt)
# ---------------------------------------------------------------------------


class RawDetectPredictions(NamedTuple):
    box_dist: torch.Tensor     # (B, A, 4, reg_max) DFL logits
    cls_logits: torch.Tensor   # (B, A, nc)
    anchors: torch.Tensor      # (A, 2)
    strides: torch.Tensor      # (A,)


class BoxDetections(NamedTuple):
    boxes_xyxy: torch.Tensor   # (B, K, 4) pixels
    scores: torch.Tensor       # (B, K)
    cls: torch.Tensor          # (B, K) int32 class ids
    valid: torch.Tensor        # (B, K) bool


class YoloDetect(_YoloBase):
    """YOLOv8/YOLO11 detect-only: box + class heads (COCO-80 by default)."""

    def __init__(self, scale: str = "s", num_classes: int = 80,
                 reg_max: int = 16, version: int = 8):
        super().__init__(scale, num_classes, reg_max, version)

    def forward(self, images) -> RawDetectPredictions:
        with full_float32_convs():
            _, dist, cls, _, anchors, strides = self._heads(images, False)
        return RawDetectPredictions(box_dist=dist, cls_logits=cls,
                                    anchors=anchors, strides=strides)


def detect_boxes(raw: RawDetectPredictions, top_k: int = 8,
                 score_threshold: float = 0.25, nms_iou: float = 0.7,
                 pre_nms_k: int = 128,
                 classes: Optional[Sequence[int]] = None) -> BoxDetections:
    """Static-shape detect-only postprocess. ``classes`` restricts the
    class-score max to the listed ids before candidate ranking (ultralytics'
    ``classes=0`` person filter)."""
    boxes = decode_boxes(raw)
    probs = torch.sigmoid(raw.cls_logits)
    if classes is not None:
        keep_c = torch.zeros(probs.shape[-1], dtype=torch.bool,
                             device=probs.device)
        keep_c[list(classes)] = True
        probs = torch.where(keep_c[None, None], probs,
                            torch.zeros_like(probs))
    scores = probs.amax(-1)
    cls_ids = probs.argmax(-1).to(torch.int32)
    pool = min(max(pre_nms_k, top_k), scores.shape[-1])
    outs = []
    for b in range(scores.shape[0]):
        idx, sel, pool_s, ok = _pool_nms_top(scores[b], boxes[b], pool,
                                             nms_iou, top_k, score_threshold)
        outs.append((boxes[b][idx][sel], pool_s[sel], cls_ids[b][idx][sel],
                     ok))
    b, s, c, v = (torch.stack(z) for z in zip(*outs))
    return BoxDetections(boxes_xyxy=b, scores=s, cls=c, valid=v)


# ---------------------------------------------------------------------------
# segmentation variant (ultralytics -seg)
# ---------------------------------------------------------------------------


class Proto(nn.Module):
    """ultralytics ``Proto``: P3 feature → (B, Hp, Wp, nm) prototypes at
    stride 4 (Conv → learned 2× ConvTranspose → Conv → 1×1 Conv)."""

    def __init__(self, cin: int, mid: int, nm: int = 32):
        super().__init__()
        self.cv1 = ConvBNAct(cin, mid, 3)
        self.upsample = ConvTranspose(mid, mid, 2)
        self.cv2 = ConvBNAct(mid, mid, 3)
        self.cv3 = ConvBNAct(mid, nm, 1)

    def forward(self, x):
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


class RawSegPredictions(NamedTuple):
    box_dist: torch.Tensor     # (B, A, 4, reg_max) DFL logits
    cls_logits: torch.Tensor   # (B, A, nc)
    mask_coefs: torch.Tensor   # (B, A, nm)
    protos: torch.Tensor       # (B, Hp, Wp, nm) stride-4 prototypes
    anchors: torch.Tensor      # (A, 2)
    strides: torch.Tensor      # (A,)


class SegDetections(NamedTuple):
    boxes_xyxy: torch.Tensor   # (B, K, 4) pixels
    scores: torch.Tensor       # (B, K)
    masks: torch.Tensor        # (B, K, Hp, Wp) f32 probabilities, cropped
    valid: torch.Tensor        # (B, K) bool


class YoloSeg(_YoloBase):
    """YOLOv8/11-seg: per-anchor raw heads + mask prototypes; the pose
    branch's slot (cv4) regresses ``nm`` mask coefficients."""

    def __init__(self, scale: str = "s", num_classes: int = 1, nm: int = 32,
                 reg_max: int = 16, version: int = 8):
        c3 = _widths(scale, version)[0][2]
        super().__init__(scale, num_classes, reg_max, version, nm,
                         max(c3 // 4, nm))
        self.nm = nm
        self.proto = Proto(c3, self.proto_channels(), nm)

    def proto_channels(self) -> int:
        # parse_model: npr = make_divisible(min(256, max_ch) * width, 8)
        d, w, mc = (SCALES11 if self.version == 11 else SCALES)[self.scale]
        return _make_divisible(min(256 * w, mc * w))

    def forward(self, images) -> RawSegPredictions:
        with full_float32_convs():
            o3, dist, cls, coefs, anchors, strides = self._heads(images, True)
            protos = self.proto(o3)
        return RawSegPredictions(box_dist=dist, cls_logits=cls,
                                 mask_coefs=coefs, protos=protos,
                                 anchors=anchors, strides=strides)


def crop_masks_to_boxes(masks, boxes_xyxy, mask_stride: float = 4.0):
    """Zero the mask probability outside each detection's box (ultralytics
    ``crop_mask``). ``masks (..., K, Hp, Wp)``, ``boxes (..., K, 4)`` in
    image pixels; the mask grid is ``mask_stride`` px a cell."""
    Hp, Wp = masks.shape[-2:]
    bx = boxes_xyxy[..., None, None, :] / mask_stride
    xs = torch.arange(Wp, dtype=torch.float32, device=masks.device)[None, :]
    ys = torch.arange(Hp, dtype=torch.float32, device=masks.device)[:, None]
    inside = ((xs >= bx[..., 0]) & (xs < bx[..., 2])
              & (ys >= bx[..., 1]) & (ys < bx[..., 3]))
    return masks * inside


def detect_seg(raw: RawSegPredictions, top_k: int = 8,
               score_threshold: float = 0.25, nms_iou: float = 0.7,
               pre_nms_k: int = 128) -> SegDetections:
    """Static-shape seg postprocess: NMS on a large candidate pool → the
    top-``top_k`` survivors → their masks from the prototype bank
    (sigmoid(coefs · protos), box-cropped: ultralytics ``process_mask``)."""
    boxes = decode_boxes(raw)
    scores = torch.sigmoid(raw.cls_logits).amax(-1)
    pool = min(max(pre_nms_k, top_k), scores.shape[-1])
    outs = []
    for b in range(scores.shape[0]):
        idx, sel, pool_s, ok = _pool_nms_top(scores[b], boxes[b], pool,
                                             nms_iou, top_k, score_threshold)
        sel_boxes = boxes[b][idx][sel]
        sel_coefs = raw.mask_coefs[b][idx][sel]
        m = torch.sigmoid(torch.einsum("kn,hwn->khw", sel_coefs,
                                       raw.protos[b]))
        outs.append((sel_boxes, pool_s[sel],
                     crop_masks_to_boxes(m, sel_boxes), ok))
    b, s, m, v = (torch.stack(z) for z in zip(*outs))
    return SegDetections(boxes_xyxy=b, scores=s, masks=m, valid=v)


# ---------------------------------------------------------------------------
# ultralytics converters (reference layout → the port's state_dict)
# ---------------------------------------------------------------------------

_LAYER_MAP = {
    "b0": 0, "b1": 1, "b2": 2, "b3": 3, "b4": 4, "b5": 5, "b6": 6,
    "b7": 7, "b8": 8, "b9": 9, "h12": 12, "h15": 15, "h16": 16,
    "h18": 18, "h19": 19, "h21": 21,
}
_HEAD_LAYER = 22
_LAYER_MAP11 = {
    "b0": 0, "b1": 1, "b2": 2, "b3": 3, "b4": 4, "b5": 5, "b6": 6,
    "b7": 7, "b8": 8, "b9": 9, "b10": 10, "h13": 13, "h16": 16,
    "h17": 17, "h19": 19, "h20": 20, "h22": 22,
}
_HEAD_LAYER11 = 23
_C3K2_LAYERS11 = {"b2": False, "b4": False, "b6": True, "b8": True,
                  "h13": False, "h16": False, "h19": False, "h22": True}


def _np_of(t):
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                      else t, np.float32)


def _conv_kernel(w):
    # torch (O, I, kh, kw) → flax (kh, kw, I, O)
    return _np_of(w).transpose(2, 3, 1, 0)


def _convbn(sd, pre):
    return (
        {"conv": {"kernel": _conv_kernel(sd[f"{pre}.conv.weight"])},
         "bn": {"scale": _np_of(sd[f"{pre}.bn.weight"]),
                "bias": _np_of(sd[f"{pre}.bn.bias"])}},
        {"bn": {"mean": _np_of(sd[f"{pre}.bn.running_mean"]),
                "var": _np_of(sd[f"{pre}.bn.running_var"])}},
    )


def _blocks(sd, pre, subs):
    p, s = {}, {}
    for sub in subs:
        p[sub], s[sub] = _convbn(sd, f"{pre}.{sub}")
    return p, s


def _c2f(sd, pre, n):
    p, s = _blocks(sd, pre, ("cv1", "cv2"))
    for i in range(n):
        p[f"m_{i}"], s[f"m_{i}"] = _blocks(sd, f"{pre}.m.{i}", ("cv1", "cv2"))
    return p, s


def _c3k(sd, pre):
    p, s = _blocks(sd, pre, ("cv1", "cv2", "cv3"))
    for j in range(2):
        p[f"m_{j}"], s[f"m_{j}"] = _blocks(sd, f"{pre}.m.{j}", ("cv1", "cv2"))
    return p, s


def _c3k2(sd, pre, n, c3k):
    p, s = _blocks(sd, pre, ("cv1", "cv2"))
    for i in range(n):
        p[f"m_{i}"], s[f"m_{i}"] = (_c3k(sd, f"{pre}.m.{i}") if c3k else
                                    _blocks(sd, f"{pre}.m.{i}",
                                            ("cv1", "cv2")))
    return p, s


def _c2psa(sd, pre, n):
    p, s = _blocks(sd, pre, ("cv1", "cv2"))
    for i in range(n):
        ap, asn = _blocks(sd, f"{pre}.m.{i}.attn", ("qkv", "proj", "pe"))
        bp, bs = {"attn": ap}, {"attn": asn}
        bp["ffn_0"], bs["ffn_0"] = _convbn(sd, f"{pre}.m.{i}.ffn.0")
        bp["ffn_1"], bs["ffn_1"] = _convbn(sd, f"{pre}.m.{i}.ffn.1")
        p[f"m_{i}"], s[f"m_{i}"] = bp, bs
    return p, s


def _strip(state_dict, prefix):
    return {k[len(prefix):] if prefix and k.startswith(prefix) else k: v
            for k, v in state_dict.items()}


def _to_port(params, stats):
    from skix_torch.convert import flax_to_state_dict

    return flax_to_state_dict({"params": params, "batch_stats": stats})


def _convert_trunk_and_heads(sd, n3, n6, version=8, scale="s",
                             cv4_branch=True):
    """The flax trees (params, batch_stats) of the trunk and the cv2/cv3
    branches, plus cv4 when present (pose keypoints and seg coefficients
    share the slot)."""
    params: dict = {}
    stats: dict = {}
    if version == 11:
        for name, idx in _LAYER_MAP11.items():
            pre = str(idx)
            if name in _C3K2_LAYERS11:
                c3k = _C3K2_LAYERS11[name] or scale in "mlx"
                params[name], stats[name] = _c3k2(sd, pre, n3, c3k)
            elif name == "b9":
                params[name], stats[name] = _blocks(sd, pre, ("cv1", "cv2"))
            elif name == "b10":
                params[name], stats[name] = _c2psa(sd, pre, n3)
            else:
                params[name], stats[name] = _convbn(sd, pre)
        head = _HEAD_LAYER11
    else:
        for name, idx in _LAYER_MAP.items():
            pre = str(idx)
            if name in ("b2", "b8", "h12", "h15", "h18", "h21"):
                params[name], stats[name] = _c2f(sd, pre, n3)
            elif name in ("b4", "b6"):
                params[name], stats[name] = _c2f(sd, pre, n6)
            elif f"{pre}.cv1.conv.weight" in sd:        # SPPF (b9)
                params[name], stats[name] = _blocks(sd, pre, ("cv1", "cv2"))
            else:
                params[name], stats[name] = _convbn(sd, pre)
        head = _HEAD_LAYER

    for branch in (("cv2", "cv4") if cv4_branch else ("cv2",)):
        for li in range(3):
            pre = f"{head}.{branch}.{li}"
            for j in range(2):
                params[f"{branch}_{li}_{j}"], stats[f"{branch}_{li}_{j}"] = \
                    _convbn(sd, f"{pre}.{j}")
            params[f"{branch}_{li}_2"] = {
                "kernel": _conv_kernel(sd[f"{pre}.2.weight"]),
                "bias": _np_of(sd[f"{pre}.2.bias"])}
    for li in range(3):
        pre = f"{head}.cv3.{li}"
        if version == 11:
            for j in range(2):
                for k in range(2):
                    params[f"cv3_{li}_{j}_{k}"], stats[f"cv3_{li}_{j}_{k}"] = \
                        _convbn(sd, f"{pre}.{j}.{k}")
        else:
            for j in range(2):
                params[f"cv3_{li}_{j}"], stats[f"cv3_{li}_{j}"] = \
                    _convbn(sd, f"{pre}.{j}")
        params[f"cv3_{li}_2"] = {
            "kernel": _conv_kernel(sd[f"{pre}.2.weight"]),
            "bias": _np_of(sd[f"{pre}.2.bias"])}
    return params, stats


def convert_ultralytics_pose(state_dict, scale: str = "s",
                             num_keypoints: int = 17, num_classes: int = 1,
                             prefix: str = "model.",
                             version: int = 8) -> dict:
    """ultralytics YOLO-pose ``model.state_dict()`` → the ``state_dict`` of
    :class:`YoloPose` (``version`` 8: C2f trunk, head at model.22; 11:
    C3k2/C2PSA trunk, head at model.23). ``prefix=""`` for dicts saved
    without the ``model.`` scope. The DFL projection is fixed (arange) and
    no parameter."""
    sd = _strip(state_dict, prefix)
    _, n3, n6 = _widths(scale, version)
    return _to_port(*_convert_trunk_and_heads(sd, n3, n6, version, scale))


def convert_ultralytics_detect(state_dict, scale: str = "s",
                               num_classes: int = 80,
                               prefix: str = "model.",
                               version: int = 8) -> dict:
    """ultralytics plain-Detect ``model.state_dict()`` (``yolo11x.pt``) →
    the ``state_dict`` of :class:`YoloDetect` (no cv4 branch)."""
    sd = _strip(state_dict, prefix)
    _, n3, n6 = _widths(scale, version)
    return _to_port(*_convert_trunk_and_heads(sd, n3, n6, version, scale,
                                              cv4_branch=False))


def convert_ultralytics_seg(state_dict, scale: str = "s",
                            num_classes: int = 1, prefix: str = "model.",
                            version: int = 8) -> dict:
    """ultralytics YOLOv8/11-seg ``model.state_dict()`` → the ``state_dict``
    of :class:`YoloSeg`: the pose mapping (cv4 carries the coefficients)
    plus ``model.N.proto``, whose torch ``ConvTranspose2d`` kernel is
    flipped in space into flax's layout (the port's ``ConvTranspose``
    flips it back where it applies it)."""
    sd = _strip(state_dict, prefix)
    _, n3, n6 = _widths(scale, version)
    params, stats = _convert_trunk_and_heads(sd, n3, n6, version, scale)
    head = _HEAD_LAYER11 if version == 11 else _HEAD_LAYER
    pre = f"{head}.proto"
    proto_p, proto_s = _blocks(sd, pre, ("cv1", "cv2", "cv3"))
    w = _np_of(sd[f"{pre}.upsample.weight"])    # torch (in, out, kh, kw)
    proto_p["upsample"] = {
        "kernel": np.ascontiguousarray(w.transpose(2, 3, 0, 1)[::-1, ::-1]),
        "bias": _np_of(sd[f"{pre}.upsample.bias"])}
    params["proto"], stats["proto"] = proto_p, proto_s
    return _to_port(params, stats)


def reference_state_dict_spec(scale: str = "s", num_keypoints: int = 17,
                              num_classes: int = 1,
                              version: int = 8) -> dict:
    """Every tensor of an ultralytics YOLO-pose ``model.state_dict()`` for
    this scale/version → its shape (torch order): the converters' oracle
    where ultralytics is not installed."""
    ch, n3, n6 = _widths(scale, version)
    c1, c2, c3, c4, c5 = ch
    reg_max = 16
    spec: dict = {}

    def convbn(pre, cin, cout, k, groups=1):
        spec[f"{pre}.conv.weight"] = (cout, cin // groups, k, k)
        for suf in ("weight", "bias", "running_mean", "running_var"):
            spec[f"{pre}.bn.{suf}"] = (cout,)

    def c2f(pre, cin, cout, n, k=3):
        c = cout // 2
        convbn(f"{pre}.cv1", cin, 2 * c, 1)
        convbn(f"{pre}.cv2", (2 + n) * c, cout, 1)
        for i in range(n):
            convbn(f"{pre}.m.{i}.cv1", c, c, k)
            convbn(f"{pre}.m.{i}.cv2", c, c, k)

    def c3k2(pre, cin, cout, n, c3k, e):
        c = int(cout * e)
        convbn(f"{pre}.cv1", cin, 2 * c, 1)
        convbn(f"{pre}.cv2", (2 + n) * c, cout, 1)
        for i in range(n):
            if c3k:
                c_ = c // 2
                convbn(f"{pre}.m.{i}.cv1", c, c_, 1)
                convbn(f"{pre}.m.{i}.cv2", c, c_, 1)
                convbn(f"{pre}.m.{i}.cv3", 2 * c_, c, 1)
                for j in range(2):
                    convbn(f"{pre}.m.{i}.m.{j}.cv1", c_, c_, 3)
                    convbn(f"{pre}.m.{i}.m.{j}.cv2", c_, c_, 3)
            else:
                convbn(f"{pre}.m.{i}.cv1", c, c // 2, 3)
                convbn(f"{pre}.m.{i}.cv2", c // 2, c, 3)

    if version == 11:
        mlx = scale in "mlx"
        ck3 = {k: (v or mlx) for k, v in _C3K2_LAYERS11.items()}
        convbn("model.0", 3, c1, 3)
        convbn("model.1", c1, c2, 3)
        c3k2("model.2", c2, c3, n3, ck3["b2"], 0.25)
        convbn("model.3", c3, c3, 3)
        c3k2("model.4", c3, c4, n3, ck3["b4"], 0.25)
        convbn("model.5", c4, c4, 3)
        c3k2("model.6", c4, c4, n3, True, 0.5)
        convbn("model.7", c4, c5, 3)
        c3k2("model.8", c5, c5, n3, True, 0.5)
        convbn("model.9.cv1", c5, c5 // 2, 1)
        convbn("model.9.cv2", 2 * c5, c5, 1)
        c = c5 // 2
        nh = max(1, c // 64)
        kd = int(c // nh * 0.5)
        convbn("model.10.cv1", c5, 2 * c, 1)
        convbn("model.10.cv2", 2 * c, c5, 1)
        for i in range(n3):
            convbn(f"model.10.m.{i}.attn.qkv", c, c + 2 * kd * nh, 1)
            convbn(f"model.10.m.{i}.attn.proj", c, c, 1)
            convbn(f"model.10.m.{i}.attn.pe", c, c, 3, groups=c)
            convbn(f"model.10.m.{i}.ffn.0", c, 2 * c, 1)
            convbn(f"model.10.m.{i}.ffn.1", 2 * c, c, 1)
        c3k2("model.13", c5 + c4, c4, n3, ck3["h13"], 0.5)
        c3k2("model.16", c4 + c4, c3, n3, ck3["h16"], 0.5)
        convbn("model.17", c3, c3, 3)
        c3k2("model.19", c3 + c4, c4, n3, ck3["h19"], 0.5)
        convbn("model.20", c4, c4, 3)
        c3k2("model.22", c4 + c5, c5, n3, True, 0.5)
        head = _HEAD_LAYER11
    else:
        convbn("model.0", 3, c1, 3)
        convbn("model.1", c1, c2, 3)
        c2f("model.2", c2, c2, n3)
        convbn("model.3", c2, c3, 3)
        c2f("model.4", c3, c3, n6)
        convbn("model.5", c3, c4, 3)
        c2f("model.6", c4, c4, n6)
        convbn("model.7", c4, c5, 3)
        c2f("model.8", c5, c5, n3)
        convbn("model.9.cv1", c5, c5 // 2, 1)
        convbn("model.9.cv2", 2 * c5, c5, 1)
        c2f("model.12", c5 + c4, c4, n3)
        c2f("model.15", c4 + c3, c3, n3)
        convbn("model.16", c3, c3, 3)
        c2f("model.18", c3 + c4, c4, n3)
        convbn("model.19", c4, c4, 3)
        c2f("model.21", c4 + c5, c5, n3)
        head = _HEAD_LAYER

    nk = num_keypoints * 3
    cb = max(16, c3 // 4, 4 * reg_max)
    cc = max(c3, min(num_classes, 100))
    ck = max(c3 // 4, nk)
    for li, cin in enumerate((c3, c4, c5)):
        convbn(f"model.{head}.cv2.{li}.0", cin, cb, 3)
        convbn(f"model.{head}.cv2.{li}.1", cb, cb, 3)
        spec[f"model.{head}.cv2.{li}.2.weight"] = (4 * reg_max, cb, 1, 1)
        spec[f"model.{head}.cv2.{li}.2.bias"] = (4 * reg_max,)
        if version == 11:
            convbn(f"model.{head}.cv3.{li}.0.0", cin, cin, 3, groups=cin)
            convbn(f"model.{head}.cv3.{li}.0.1", cin, cc, 1)
            convbn(f"model.{head}.cv3.{li}.1.0", cc, cc, 3, groups=cc)
            convbn(f"model.{head}.cv3.{li}.1.1", cc, cc, 1)
        else:
            convbn(f"model.{head}.cv3.{li}.0", cin, cc, 3)
            convbn(f"model.{head}.cv3.{li}.1", cc, cc, 3)
        spec[f"model.{head}.cv3.{li}.2.weight"] = (num_classes, cc, 1, 1)
        spec[f"model.{head}.cv3.{li}.2.bias"] = (num_classes,)
        convbn(f"model.{head}.cv4.{li}.0", cin, ck, 3)
        convbn(f"model.{head}.cv4.{li}.1", ck, ck, 3)
        spec[f"model.{head}.cv4.{li}.2.weight"] = (nk, ck, 1, 1)
        spec[f"model.{head}.cv4.{li}.2.bias"] = (nk,)
    return spec


def reference_state_dict_spec_seg(scale: str = "s", num_classes: int = 1,
                                  version: int = 8) -> dict:
    """The ultralytics YOLOv8/11-seg state dict's entries → shapes: the
    pose spec with the cv4 rows regressing ``nm`` coefficients, plus
    ``model.N.proto``."""
    ch, _, _ = _widths(scale, version)
    c3 = ch[2]
    nm = 32
    spec = reference_state_dict_spec(scale=scale, num_classes=num_classes,
                                     version=version)
    head = _HEAD_LAYER11 if version == 11 else _HEAD_LAYER
    spec = {k: v for k, v in spec.items() if ".cv4." not in k}
    ck = max(c3 // 4, nm)
    for li, cin in enumerate(ch[2:]):
        for suf in ("weight", "bias", "running_mean", "running_var"):
            spec[f"model.{head}.cv4.{li}.0.bn.{suf}"] = (ck,)
            spec[f"model.{head}.cv4.{li}.1.bn.{suf}"] = (ck,)
        spec[f"model.{head}.cv4.{li}.0.conv.weight"] = (ck, cin, 3, 3)
        spec[f"model.{head}.cv4.{li}.1.conv.weight"] = (ck, ck, 3, 3)
        spec[f"model.{head}.cv4.{li}.2.weight"] = (nm, ck, 1, 1)
        spec[f"model.{head}.cv4.{li}.2.bias"] = (nm,)
    d, w, mc = (SCALES11 if version == 11 else SCALES)[scale]
    npr = _make_divisible(min(256 * w, mc * w))
    for pre, cin, cout, k in (("cv1", c3, npr, 3), ("cv2", npr, npr, 3),
                              ("cv3", npr, nm, 1)):
        spec[f"model.{head}.proto.{pre}.conv.weight"] = (cout, cin, k, k)
        for suf in ("weight", "bias", "running_mean", "running_var"):
            spec[f"model.{head}.proto.{pre}.bn.{suf}"] = (cout,)
    spec[f"model.{head}.proto.upsample.weight"] = (npr, npr, 2, 2)
    spec[f"model.{head}.proto.upsample.bias"] = (npr,)
    return spec


def reference_state_dict_spec_detect(scale: str = "s", num_classes: int = 80,
                                     version: int = 8) -> dict:
    """The ultralytics plain-Detect state dict's entries → shapes: the pose
    spec's trunk + cv2/cv3 rows, no cv4."""
    spec = reference_state_dict_spec(scale=scale, num_classes=num_classes,
                                     version=version)
    return {k: v for k, v in spec.items() if ".cv4." not in k}
