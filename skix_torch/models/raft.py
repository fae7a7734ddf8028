"""RAFT-style optical flow, fixed-iteration recurrent refinement.

Port of ``skix/models/raft.py``: feature and context encoders at 1/8
resolution (:class:`BasicEncoder`, GroupNorm(8) residual blocks), the
all-pairs correlation pyramid as one batched product per pair, average-pooled
over the second frame (:func:`correlation_pyramid`), a (2r+1)² window looked
up around the current flow at every level (:func:`lookup_correlation`:
``map_coordinates`` order 1 with zeros outside, its four taps gathered
directly, each zero where it falls outside the volume), the ConvGRU update
block, and 8× convex upsampling of the 1/8 flow (:func:`convex_upsample`).
Channels-last, with skix's flax names (``fnet.res_0.conv1``,
``update_block.gru.convz`` …). Convolutions run in float32 (cuDNN's TF32
off) with cuDNN's algorithms timed per shape (its heuristic's FFT pick
for the update block is ~30× slower on an H100); the correlation product
is a float32 matmul.

At 1080p the 1/8 grid has 135 × 240 = 32 400 cells, so level 0 of one
pair's volume holds 32 400² floats (4.2 GB).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models.layers import Conv, GroupNorm
from skix_torch.utils.device import full_float32_convs


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(cin, features, 3, stride)
        self.norm1 = GroupNorm(8, features)
        self.conv2 = Conv(features, features, 3)
        self.norm2 = GroupNorm(8, features)
        self.project = stride != 1 or cin != features
        if self.project:
            self.downsample = Conv(cin, features, 1, stride)
            self.norm3 = GroupNorm(8, features)

    def forward(self, x):
        h = F.relu(self.norm1(self.conv1(x)))
        h = F.relu(self.norm2(self.conv2(h)))
        if self.project:
            x = self.norm3(self.downsample(x))
        return F.relu(x + h)


_ENCODER = ((64, 1), (64, 1), (96, 2), (96, 1), (128, 2), (128, 1))


class BasicEncoder(nn.Module):
    """Conv encoder → 1/8 resolution features."""

    def __init__(self, out_dim: int = 256):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 2)
        self.norm1 = GroupNorm(8, 64)
        cin = 64
        for i, (feat, stride) in enumerate(_ENCODER):
            setattr(self, f"res_{i}", ResidualBlock(cin, feat, stride))
            cin = feat
        self.conv_out = Conv(cin, out_dim, 1)

    def forward(self, x):
        h = F.relu(self.norm1(self.conv1(x)))
        for i in range(len(_ENCODER)):
            h = getattr(self, f"res_{i}")(h)
        return self.conv_out(h)


def correlation_pyramid(f1, f2, num_levels: int = 4):
    """All-pairs correlation: ``f1, f2 (B, h, w, C)`` → list of ``(B, h, w,
    h_l, w_l)`` volumes (average-pooled 2×2 over the second frame)."""
    B, h, w, C = f1.shape
    corr = torch.bmm(f1.reshape(B, h * w, C),
                     f2.reshape(B, h * w, C).transpose(1, 2))
    corr = corr / math.sqrt(C)
    pyramid = [corr.reshape(B, h, w, h, w)]
    cur = corr.reshape(B * h * w, 1, h, w)
    for _ in range(num_levels - 1):
        cur = F.avg_pool2d(cur, 2, 2)
        pyramid.append(cur.reshape(B, h, w, cur.shape[2], cur.shape[3]))
    return pyramid


def lookup_correlation(pyramid, coords, radius: int = 4):
    """Sample each level in a (2r+1)² window around ``coords (B, h, w, 2)``
    (x, y at 1/8 resolution) → ``(B, h, w, L·(2r+1)²)``: jax's
    ``map_coordinates(order=1, mode="constant", cval=0)``, the four taps
    summed in its order, a tap outside the volume contributing zero."""
    B, h, w, _ = coords.shape
    r = radius
    d = torch.arange(-r, r + 1, dtype=coords.dtype, device=coords.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    delta = torch.stack([dx, dy], -1).reshape(-1, 2)          # (W2, 2) x, y
    out = []
    for lvl, corr in enumerate(pyramid):
        Hl, Wl = corr.shape[3], corr.shape[4]
        pos = (coords * 0.5 ** lvl)[:, :, :, None, :] + delta
        pos = pos.reshape(B * h * w, -1, 2)
        vol = corr.reshape(B * h * w, Hl * Wl)
        py, px = pos[..., 1], pos[..., 0]
        y0, x0 = torch.floor(py), torch.floor(px)
        wy1, wx1 = py - y0, px - x0
        wy0, wx0 = 1 - wy1, 1 - wx1
        y0, x0 = y0.to(torch.long), x0.to(torch.long)
        acc = None
        for yi, wy in ((y0, wy0), (y0 + 1, wy1)):
            for xi, wx in ((x0, wx0), (x0 + 1, wx1)):
                ok = (yi >= 0) & (yi < Hl) & (xi >= 0) & (xi < Wl)
                idx = (yi.clamp(0, Hl - 1) * Wl + xi.clamp(0, Wl - 1))
                v = torch.gather(vol, 1, idx)
                term = (wy * wx) * torch.where(ok, v, torch.zeros_like(v))
                acc = term if acc is None else acc + term
        out.append(acc.reshape(B, h, w, -1))
    return torch.cat(out, -1)


class ConvGRU(nn.Module):
    def __init__(self, hidden: int, cin: int):
        super().__init__()
        self.convz = Conv(hidden + cin, hidden, 3)
        self.convr = Conv(hidden + cin, hidden, 3)
        self.convq = Conv(hidden + cin, hidden, 3)

    def forward(self, h, x):
        hx = torch.cat([h, x], -1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], -1)))
        return (1 - z) * h + z * q


class UpdateBlock(nn.Module):
    def __init__(self, hidden: int = 128, corr_dim: int = 4 * 81,
                 context: int = 128):
        super().__init__()
        self.corr_conv1 = Conv(corr_dim, 192, 1)
        self.corr_conv2 = Conv(192, 192, 3)
        self.flow_conv1 = Conv(2, 128, 7)
        self.flow_conv2 = Conv(128, 64, 3)
        self.motion_conv = Conv(192 + 64, 126, 3)
        self.gru = ConvGRU(hidden, context + 128)
        self.flow_head1 = Conv(hidden, 256, 3)
        self.flow_head2 = Conv(256, 2, 3)
        self.mask_head1 = Conv(hidden, 256, 3)
        self.mask_head2 = Conv(256, 64 * 9, 1)

    def forward(self, net, inp, corr_feat, flow):
        c = F.relu(self.corr_conv2(F.relu(self.corr_conv1(corr_feat))))
        f = F.relu(self.flow_conv2(F.relu(self.flow_conv1(flow))))
        motion = F.relu(self.motion_conv(torch.cat([c, f], -1)))
        motion = torch.cat([motion, flow], -1)
        net = self.gru(net, torch.cat([inp, motion], -1))
        dflow = self.flow_head2(F.relu(self.flow_head1(net)))
        mask = self.mask_head2(F.relu(self.mask_head1(net))) * 0.25
        return net, dflow, mask


def convex_upsample(flow, mask):
    """8× convex-combination upsampling: ``flow (B, h, w, 2)``, ``mask (B, h,
    w, 64·9)`` → ``(B, 8h, 8w, 2)``."""
    B, h, w, _ = flow.shape
    mask = torch.softmax(mask.reshape(B, h, w, 8, 8, 9), -1)
    fp = F.pad(flow * 8.0, (0, 0, 1, 1, 1, 1))
    neigh = torch.stack([fp[:, i:i + h, j:j + w] for i in range(3)
                         for j in range(3)], -2)             # (B, h, w, 9, 2)
    up = torch.einsum("bhwijk,bhwkc->bhwijc", mask, neigh)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(B, h * 8, w * 8, 2)


class RAFT(nn.Module):
    """Optical flow between image pairs: images (B, H, W, 3) in [0, 1], H
    and W multiples of 8 → (B, H, W, 2) flow."""

    def __init__(self, hidden: int = 128, context: int = 128,
                 corr_levels: int = 4, corr_radius: int = 4,
                 iters: int = 12):
        super().__init__()
        self.hidden, self.context = hidden, context
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.iters = iters
        self.fnet = BasicEncoder(256)
        self.cnet = BasicEncoder(hidden + context)
        self.update_block = UpdateBlock(
            hidden, corr_levels * (2 * corr_radius + 1) ** 2, context)

    def forward(self, image1, image2):
        # cuDNN's heuristic picks an FFT for the update block's convs that
        # launches a tiny GEMM per frequency bin: time the algorithms
        with full_float32_convs(benchmark=True):
            return self._forward(image1, image2)

    def _forward(self, image1, image2):
        B = image1.shape[0]
        x1 = image1 * 2.0 - 1.0
        x2 = image2 * 2.0 - 1.0
        fmap = self.fnet(torch.cat([x1, x2], 0))
        f1, f2 = fmap[:B], fmap[B:]
        ctx = self.cnet(x1)
        net = torch.tanh(ctx[..., :self.hidden])
        inp = F.relu(ctx[..., self.hidden:])
        pyramid = correlation_pyramid(f1, f2, self.corr_levels)
        del fmap, f1, f2
        h, w = net.shape[1], net.shape[2]
        dev = image1.device
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                             device=dev),
                                torch.arange(w, dtype=torch.float32,
                                             device=dev), indexing="ij")
        coords0 = torch.stack([gx, gy], -1)[None].expand(B, h, w, 2)
        flow = torch.zeros((B, h, w, 2), device=dev)
        mask = None
        for _ in range(self.iters):
            corr_feat = lookup_correlation(pyramid, coords0 + flow,
                                           self.corr_radius)
            net, dflow, mask = self.update_block(net, inp, corr_feat, flow)
            flow = flow + dflow
        return convex_upsample(flow, mask)


@torch.no_grad()
def compute_flow_sequence(model: RAFT, frames_u8, chunk_size: int = 2,
                          device=None):
    """Whole-clip flow: ``frames (T, H, W, 3) uint8`` → ``(T−1, 2, H, W)
    float32``; frames are zero-padded to multiples of 8."""
    dev = torch.device(device) if device else next(model.parameters()).device
    frames = frames_u8
    T, H, W = frames.shape[:3]
    ph, pw = (-H) % 8, (-W) % 8
    outs = []
    for s in range(0, T - 1, chunk_size):
        e = min(s + chunk_size, T - 1)
        clip = torch.as_tensor(frames[s:e + 1], device=dev
                               ).to(torch.float32) / 255.0
        if ph or pw:
            clip = F.pad(clip, (0, 0, 0, pw, 0, ph))
        flow = model(clip[:-1], clip[1:])[:, :H, :W, :]
        outs.append(flow.permute(0, 3, 1, 2).cpu().numpy())
    return (np.concatenate(outs, axis=0) if outs
            else np.zeros((0, 2, H, W), np.float32))
