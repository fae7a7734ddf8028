"""ALIKED learned keypoint extractor (lightglue layout).

Port of ``skix/perception/aliked.py``:

- ``deform_conv2d`` in torch ops (no torchvision): per-tap bilinear
  samples at learned offsets build a ``(B, H, W, K², C_in)`` tensor that
  one product contracts with the kernel (torchvision's sampling rule: a
  corner tap counts only inside the image);
- the backbone: ConvBlock(c1) → ResBlock(c2) → ResBlock(c3, DCN) →
  ResBlock(c4, DCN) over 1×/2×/8×/32× average-pooled scales, per-scale
  1×1 projections, align-corners upsampling, an L2-normalized feature map
  and a sigmoid score head; BatchNorm with its running statistics, SELU;
- DKD detection: max-pool NMS, border suppression, a fixed ``max_pts``
  top-k (ties to the lowest flat index), soft-argmax refinement over
  (2r+1)² patches, the refined score by bilinear resampling;
- ``SDDH``, the sparse deformable descriptor head (exposed; the SfM query
  path uses keypoints only).

Convolutions run in float32 with cuDNN's TF32 off. ``convert_aliked``
reads the lightglue ``aliked.py`` state dict into skix's flax trees (the
backbone with its ``batch_stats``, the descriptor head), which
``skix_torch.convert`` loads. Like skix's, the converter targets the
published layout without a lightglue oracle to hold it to.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models.layers import Conv, init_like_flax, lecun_normal_
from skix_torch.perception.sfm_tracks import _as_image, top_k
from skix_torch.utils.device import full_float32_convs

ALIKED_CFGS = {
    "aliked-t16": dict(c1=8, c2=16, c3=32, c4=64, dim=64, K=3, M=16),
    "aliked-n16": dict(c1=16, c2=32, c3=64, c4=128, dim=128, K=3, M=16),
    "aliked-n16rot": dict(c1=16, c2=32, c3=64, c4=128, dim=128, K=3, M=16),
    "aliked-n32": dict(c1=16, c2=32, c3=64, c4=128, dim=128, K=3, M=32),
}


# ---------------------------------------------------------------------------
# bilinear sampling + deformable convolution
# ---------------------------------------------------------------------------
def bilinear_sample(img: torch.Tensor, py: torch.Tensor,
                    px: torch.Tensor) -> torch.Tensor:
    """Samples of ``img (H, W, C)`` at float pixel coordinates ``py``/``px
    (...)``; each corner tap contributes only inside the image (zeros
    padding)."""
    H, W = img.shape[:2]
    y0f, x0f = torch.floor(py), torch.floor(px)
    wy, wx = (py - y0f)[..., None], (px - x0f)[..., None]
    y0, x0 = y0f.long(), x0f.long()

    def tap(yi, xi):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        v = img[torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)]
        return torch.where(inb[..., None], v, torch.zeros_like(v))

    return ((1 - wy) * (1 - wx) * tap(y0, x0)
            + (1 - wy) * wx * tap(y0, x0 + 1)
            + wy * (1 - wx) * tap(y0 + 1, x0)
            + wy * wx * tap(y0 + 1, x0 + 1))


def deform_conv2d(x, offsets, weight, bias=None, mask=None):
    """Deformable convolution, stride 1, SAME padding, torchvision's
    semantics in NHWC: ``x (B, H, W, C_in)``, ``offsets (B, H, W, 2·K²)``
    interleaved (Δy, Δx) per tap (taps row-major), ``weight (K, K, C_in,
    C_out)`` (flax's layout), optional ``mask (B, H, W, K²)`` → ``(B, H,
    W, C_out)``. Coordinates are float32."""
    B, H, W, Cin = x.shape
    K = weight.shape[0]
    pad = K // 2
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=x.device),
                            torch.arange(W, dtype=torch.float32, device=x.device),
                            indexing="ij")
    off = offsets.to(torch.float32).reshape(B, H, W, K * K, 2)
    taps = []
    for i in range(K):
        for j in range(K):
            k = i * K + j
            py = yy[None] + (i - pad) + off[:, :, :, k, 0]
            px = xx[None] + (j - pad) + off[:, :, :, k, 1]
            taps.append(torch.stack([bilinear_sample(x[b], py[b], px[b])
                                     for b in range(B)]))
    sampled = torch.stack(taps, dim=3)                 # (B, H, W, K², C_in)
    if mask is not None:
        sampled = sampled * mask[..., None]
    out = torch.einsum("bhwkc,kco->bhwo", sampled,
                       weight.reshape(K * K, Cin, -1)).to(x.dtype)
    return out if bias is None else out + bias


def upsample_align_corners(x: torch.Tensor, out_h: int, out_w: int):
    """Bilinear upsample of ``x (B, H, W, C)`` with torch's
    ``align_corners=True`` grid (output i → input i·(in−1)/(out−1))."""
    B, H, W, _ = x.shape
    py = (torch.arange(out_h, device=x.device)
          * ((H - 1) / max(out_h - 1, 1))).to(torch.float32)
    px = (torch.arange(out_w, device=x.device)
          * ((W - 1) / max(out_w - 1, 1))).to(torch.float32)
    gy, gx = torch.meshgrid(py, px, indexing="ij")
    return torch.stack([bilinear_sample(x[b].float(), gy, gx)
                        for b in range(B)]).to(x.dtype)


# ---------------------------------------------------------------------------
# backbone modules
# ---------------------------------------------------------------------------
class DeformableConv2d(nn.Module):
    """A regular conv predicts per-tap offsets (clamped to ±max(H, W)/4),
    then the deformable product applies ``regular_conv``'s kernel (flax
    layout, (K, K, C_in, C_out)) at those offsets."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 use_mask: bool = False):
        super().__init__()
        K = kernel_size
        self.use_mask = use_mask
        self.offset_conv = Conv(in_features, (3 if use_mask else 2) * K * K, K)
        self.regular_conv = nn.Parameter(torch.zeros(K, K, in_features,
                                                     features))

    def forward(self, x):
        K = self.regular_conv.shape[0]
        n_off = 2 * K * K
        raw = self.offset_conv(x)
        off, mask = raw, None
        if self.use_mask:
            off, mask = raw[..., :n_off], torch.sigmoid(raw[..., n_off:])
        max_off = max(x.shape[1], x.shape[2]) / 4.0
        off = torch.clamp(off, -max_off, max_off)
        return deform_conv2d(x, off, self.regular_conv, mask=mask)


class BatchNorm(nn.Module):
    """flax ``BatchNorm(use_running_average=True)`` over the last axis:
    ``(x − mean) · (rsqrt(var + eps) · scale) + bias``."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias


def _conv(cin, cout, dcn):
    return DeformableConv2d(cin, cout) if dcn else Conv(cin, cout, 3,
                                                         bias=False)


class ConvBlock(nn.Module):
    """conv3×3 → BN → SELU, twice."""

    def __init__(self, cin: int, features: int, dcn: bool = False):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, features, dcn), BatchNorm(features)
        self.conv2, self.bn2 = _conv(features, features, dcn), BatchNorm(features)

    def forward(self, x):
        h = F.selu(self.bn1(self.conv1(x)))
        return F.selu(self.bn2(self.conv2(h)))


class ResBlock(nn.Module):
    """gate(bn1(conv1)) → bn2(conv2), plus the 1×1-projected identity,
    gate."""

    def __init__(self, cin: int, features: int, dcn: bool = False):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, features, dcn), BatchNorm(features)
        self.conv2, self.bn2 = _conv(features, features, dcn), BatchNorm(features)
        self.downsample = Conv(cin, features, 1)

    def forward(self, x):
        h = F.selu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        return F.selu(h + self.downsample(x))


def _avg_pool(h, k):
    return F.avg_pool2d(h.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


class ALIKED(nn.Module):
    """image ``(B, H, W, 3)`` in [0, 1] → (feature map ``(B, H, W, dim)``
    L2-normalized, score map ``(B, H, W)``)."""

    def __init__(self, model_name: str = "aliked-n16"):
        super().__init__()
        cfg = ALIKED_CFGS[model_name]
        c1, c2, c3, c4, dim = (cfg[k] for k in ("c1", "c2", "c3", "c4", "dim"))
        self.block1 = ConvBlock(3, c1)
        self.block2 = ResBlock(c1, c2)
        self.block3 = ResBlock(c2, c3, dcn=True)
        self.block4 = ResBlock(c3, c4, dcn=True)
        for i, c in enumerate((c1, c2, c3, c4), start=1):
            setattr(self, f"conv{i}", Conv(c, dim // 4, 1, bias=False))
        self.score_head_0 = Conv(dim, 8, 1, bias=False)
        self.score_head_2 = Conv(8, 4, 3, bias=False)
        self.score_head_4 = Conv(4, 4, 3, bias=False)
        self.score_head_6 = Conv(4, 1, 3, bias=False)

    def init_weights(self, generator=None) -> "ALIKED":
        """flax's initializers; the deformable kernels He-normal."""
        init_like_flax(self, generator)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, DeformableConv2d):
                    w = m.regular_conv
                    fan_in = w.shape[0] * w.shape[1] * w.shape[2]
                    lecun_normal_(w, fan_in, generator).mul_(2.0 ** 0.5)
        return self

    def forward(self, x):
        B, H, W, _ = x.shape
        with full_float32_convs():
            x1 = self.block1(x)
            x2 = self.block2(_avg_pool(x1, 2))
            x3 = self.block3(_avg_pool(x2, 4))
            x4 = self.block4(_avg_pool(x3, 4))
            f = torch.cat([
                F.selu(self.conv1(x1)),
                upsample_align_corners(F.selu(self.conv2(x2)), H, W),
                upsample_align_corners(F.selu(self.conv3(x3)), H, W),
                upsample_align_corners(F.selu(self.conv4(x4)), H, W),
            ], dim=-1)
            s = F.selu(self.score_head_0(f))
            s = F.selu(self.score_head_2(s))
            s = F.selu(self.score_head_4(s))
            s = self.score_head_6(s)
        score = torch.sigmoid(s.float())[..., 0]
        feat = f.float()
        feat = feat / torch.clamp(torch.linalg.norm(feat, dim=-1, keepdim=True),
                                  min=1e-12)
        return feat, score


class SDDH(nn.Module):
    """Sparse deformable descriptor head: per keypoint, a K×K feature patch
    predicts ``n_pos`` sampling offsets; the samples there pass a 1×1
    ``sf_conv`` + SELU and flatten into a 1×1 ``convM`` → L2-normalized
    descriptors. ``forward(feature_map (H, W, dim), kpts_xy (N, 2))`` →
    ``(N, dim)``. Parameters in skix's (flax) layout."""

    def __init__(self, dim: int, kernel_size: int = 3, n_pos: int = 16):
        super().__init__()
        K, M, C = kernel_size, n_pos, dim
        self.K, self.M = K, M
        self.offset_conv_0 = nn.Parameter(torch.zeros(K, K, C, 2 * M))
        self.offset_conv_0_bias = nn.Parameter(torch.zeros(2 * M))
        self.offset_conv_2 = nn.Parameter(torch.zeros(2 * M, 2 * M))
        self.offset_conv_2_bias = nn.Parameter(torch.zeros(2 * M))
        self.sf_conv = nn.Parameter(torch.zeros(C, C))
        self.convM = nn.Parameter(torch.zeros(M * C, C))

    def forward(self, fmap, kpts_xy):
        K, M = self.K, self.M
        H, W, C = fmap.shape
        N = kpts_xy.shape[0]
        base = torch.floor(kpts_xy).long()
        r = torch.arange(K, device=fmap.device) - K // 2
        dy, dx = torch.meshgrid(r, r, indexing="ij")
        py = base[:, 1, None, None] + dy[None]
        px = base[:, 0, None, None] + dx[None]
        inb = (py >= 0) & (py < H) & (px >= 0) & (px < W)
        patch = fmap[torch.clamp(py, 0, H - 1), torch.clamp(px, 0, W - 1)]
        patch = torch.where(inb[..., None], patch, torch.zeros_like(patch))
        h = F.selu(torch.einsum("nklc,klcm->nm", patch, self.offset_conv_0)
                   + self.offset_conv_0_bias)
        off = (h @ self.offset_conv_2 + self.offset_conv_2_bias).reshape(N, M, 2)
        max_off = max(H, W) / 4.0
        pos = kpts_xy[:, None, :] + torch.clamp(off, -max_off, max_off)
        samples = F.selu(bilinear_sample(fmap, pos[..., 1], pos[..., 0])
                         @ self.sf_conv)
        desc = samples.reshape(N, M * C) @ self.convM
        return desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True),
                                  min=1e-12)


# ---------------------------------------------------------------------------
# DKD keypoint detection
# ---------------------------------------------------------------------------
def dkd_detect(score_map: torch.Tensor, max_pts: int, det_thres: float = 0.2,
               radius: int = 2, temperature: float = 0.1):
    """``score_map (H, W)`` → ``(xy (max_pts, 2) sub-pixel, score
    (max_pts,), valid (max_pts,))``: single-pass max-pool NMS, the
    reference's border zeroing (valid range r+1 … size−r−1), top-k,
    temperature soft-argmax over (2r+1)² patches, bilinear score."""
    H, W = score_map.shape
    local_max = F.max_pool2d(score_map[None, None], 2 * radius + 1, 1,
                             radius)[0, 0]
    zeros = torch.zeros_like(score_map)
    nms = torch.where(score_map == local_max, score_map, zeros)
    yy = torch.arange(H, device=score_map.device)[:, None]
    xx = torch.arange(W, device=score_map.device)[None, :]
    border = ((xx > radius) & (xx < W - radius)
              & (yy > radius) & (yy < H - radius))
    nms = torch.where(border, nms, zeros)
    top, idx = top_k(nms.reshape(-1), max_pts)
    valid = top > det_thres
    iy, ix = idx // W, idx % W
    r = torch.arange(-radius, radius + 1, device=score_map.device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    patch = score_map[torch.clamp(iy[:, None, None] + dy[None], 0, H - 1),
                      torch.clamp(ix[:, None, None] + dx[None], 0, W - 1)]
    patch = patch.reshape(len(idx), -1)
    p = torch.softmax((patch - patch.max(dim=1, keepdim=True).values)
                      / temperature, dim=1)
    grid = torch.stack([dx.reshape(-1), dy.reshape(-1)], -1).to(score_map.dtype)
    xy = torch.stack([ix, iy], -1).to(score_map.dtype) + p @ grid
    score = bilinear_sample(score_map[..., None], xy[:, 1], xy[:, 0])[:, 0]
    return xy, torch.where(valid, score, torch.zeros_like(score)), valid


def aliked_keypoints(model: ALIKED, image, max_pts: int = 512,
                     det_thres: float = 0.2):
    """The extractor contract of ``sfm_tracks``: image (H, W) or (H, W, 3)
    in [0, 1] → (xy, score, valid) on the model's device."""
    dev = next(model.parameters()).device
    img = _as_image(image, dev)
    if img.dim() == 2:
        img = img[..., None].expand(*img.shape, 3)
    with torch.no_grad():
        _fmap, score = model(img[None])
    return dkd_detect(score[0], int(max_pts), float(np.float32(det_thres)))


# ---------------------------------------------------------------------------
# converter
# ---------------------------------------------------------------------------
def _np_of(t):
    try:
        return np.asarray(t.detach().cpu().numpy(), np.float32)
    except AttributeError:
        return np.asarray(t, np.float32)


def convert_aliked(state_dict, model_name: str = "aliked-n16"):
    """lightglue/ALIKED torch state dict → ``(backbone_variables,
    sddh_variables)``: skix's flax trees for :class:`ALIKED` (``params`` and
    ``batch_stats``) and for :class:`SDDH` (the ``desc_head.*`` weights)."""
    sd = {k: _np_of(v) for k, v in state_dict.items()}

    def conv_w(key):
        return sd[key].transpose(2, 3, 1, 0)     # OIHW → HWIO

    blocks: dict = {}
    bstats: dict = {}
    for bi, dcn in (("block1", False), ("block2", False),
                    ("block3", True), ("block4", True)):
        bp: dict = {}
        bs: dict = {}
        for ci in ("conv1", "conv2"):
            src = f"{bi}.{ci}"
            if dcn:
                bp[ci] = {"offset_conv": {
                    "kernel": conv_w(f"{src}.offset_conv.weight"),
                    "bias": sd[f"{src}.offset_conv.bias"]},
                    "regular_conv": conv_w(f"{src}.regular_conv.weight")}
            else:
                bp[ci] = {"kernel": conv_w(f"{src}.weight")}
            bname = "bn1" if ci == "conv1" else "bn2"
            bn = f"{bi}.{bname}"
            bp[bname] = {"scale": sd[f"{bn}.weight"], "bias": sd[f"{bn}.bias"]}
            bs[bname] = {"mean": sd[f"{bn}.running_mean"],
                         "var": sd[f"{bn}.running_var"]}
        if f"{bi}.downsample.weight" in sd:
            bp["downsample"] = {"kernel": conv_w(f"{bi}.downsample.weight"),
                                "bias": sd[f"{bi}.downsample.bias"]}
        blocks[bi] = bp
        bstats[bi] = bs
    for i in range(1, 5):
        blocks[f"conv{i}"] = {"kernel": conv_w(f"conv{i}.weight")}
    for li in (0, 2, 4, 6):
        blocks[f"score_head_{li}"] = {"kernel": conv_w(f"score_head.{li}.weight")}

    cfg = ALIKED_CFGS[model_name]
    sddh = {
        "offset_conv_0":
            sd["desc_head.offset_conv.0.weight"].transpose(2, 3, 1, 0),
        "offset_conv_0_bias": sd["desc_head.offset_conv.0.bias"],
        "offset_conv_2": sd["desc_head.offset_conv.2.weight"][:, :, 0, 0].T,
        "offset_conv_2_bias": sd["desc_head.offset_conv.2.bias"],
        "sf_conv": sd["desc_head.sf_conv.weight"][:, :, 0, 0].T,
        # convM (dim, dim·M, 1, 1): torch flattens (C, M) channel-major per
        # sample position; the head reshapes (M, C)
        "convM": sd["desc_head.convM.weight"][:, :, 0, 0]
            .reshape(-1, cfg["dim"], cfg["M"])
            .transpose(2, 1, 0).reshape(cfg["M"] * cfg["dim"], -1),
    }
    return {"params": blocks, "batch_stats": bstats}, {"params": sddh}


def reference_aliked_spec(model_name: str = "aliked-n16") -> dict:
    """Shapes of the lightglue ALIKED state-dict layout (for converter
    tests on random weights)."""
    cfg = ALIKED_CFGS[model_name]
    c = [3, cfg["c1"], cfg["c2"], cfg["c3"], cfg["c4"]]
    dim, K, M = cfg["dim"], cfg["K"], cfg["M"]
    spec: dict = {}

    def bn(prefix, n):
        for s in ("weight", "bias", "running_mean", "running_var"):
            spec[f"{prefix}.{s}"] = (n,)

    spec["block1.conv1.weight"] = (c[1], 3, 3, 3)
    bn("block1.bn1", c[1])
    spec["block1.conv2.weight"] = (c[1], c[1], 3, 3)
    bn("block1.bn2", c[1])
    for bi, dcn in ((2, False), (3, True), (4, True)):
        ci, co = c[bi - 1], c[bi]
        for li, (cin, cout) in enumerate(((ci, co), (co, co)), start=1):
            pre = f"block{bi}.conv{li}"
            if dcn:
                spec[f"{pre}.offset_conv.weight"] = (18, cin, 3, 3)
                spec[f"{pre}.offset_conv.bias"] = (18,)
                spec[f"{pre}.regular_conv.weight"] = (cout, cin, 3, 3)
            else:
                spec[f"{pre}.weight"] = (cout, cin, 3, 3)
            bn(f"block{bi}.bn{li}", cout)
        spec[f"block{bi}.downsample.weight"] = (co, ci, 1, 1)
        spec[f"block{bi}.downsample.bias"] = (co,)
    for i in range(1, 5):
        spec[f"conv{i}.weight"] = (dim // 4, c[i], 1, 1)
    spec["score_head.0.weight"] = (8, dim, 1, 1)
    spec["score_head.2.weight"] = (4, 8, 3, 3)
    spec["score_head.4.weight"] = (4, 4, 3, 3)
    spec["score_head.6.weight"] = (1, 4, 3, 3)
    spec["desc_head.offset_conv.0.weight"] = (2 * M, dim, K, K)
    spec["desc_head.offset_conv.0.bias"] = (2 * M,)
    spec["desc_head.offset_conv.2.weight"] = (2 * M, 2 * M, 1, 1)
    spec["desc_head.offset_conv.2.bias"] = (2 * M,)
    spec["desc_head.sf_conv.weight"] = (dim, dim, 1, 1)
    spec["desc_head.convM.weight"] = (dim, dim * M, 1, 1)
    return spec
