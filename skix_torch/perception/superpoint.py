"""SuperPoint learned keypoint extractor (magicleap/lightglue layout).

Port of ``skix/perception/superpoint.py``: a VGG-style shared encoder,
the detector head (65-way cell softmax, dustbin dropped, 8×8
depth-to-space) and the descriptor head (256-d, L2-normalized); lightglue's
``simple_nms`` (two suppression-refill iterations); a fixed ``max_pts``
top-k of the score map, ties to the lowest flat index. The convolutions
run in float32 with cuDNN's TF32 off. ``convert_superpoint`` reads the
public ``superpoint_v1.pth`` state-dict layout into skix's flax tree, which
``skix_torch.convert`` loads into :class:`SuperPoint`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models.layers import Conv, init_like_flax
from skix_torch.perception.sfm_tracks import _as_image, top_k
from skix_torch.utils.device import full_float32_convs

_PLAN = (("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3),
         ("conv2a", 64, 64, 3), ("conv2b", 64, 64, 3),
         ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3),
         ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3),
         ("convPa", 128, 256, 3), ("convPb", 256, 65, 1),
         ("convDa", 128, 256, 3), ("convDb", 256, 256, 1))
_CONV_NAMES = tuple(p[0] for p in _PLAN)
_GRAY = np.array([0.299, 0.587, 0.114], np.float32)


class SuperPoint(nn.Module):
    """image ``(B, H, W, 1|3)`` in [0, 1] → (scores ``(B, H', W')``,
    descriptors ``(B, H'/8, W'/8, 256)`` L2-normalized); H' and W' are H
    and W after three 2×2 pools and the depth-to-space (multiples of 8).
    RGB becomes grayscale with the weights (0.299, 0.587, 0.114)."""

    def __init__(self):
        super().__init__()
        for name, cin, cout, k in _PLAN:
            setattr(self, name, Conv(cin, cout, k))

    def init_weights(self, generator=None) -> "SuperPoint":
        return init_like_flax(self, generator)

    def forward(self, x):
        if x.shape[-1] == 3:
            x = x @ torch.as_tensor(_GRAY, device=x.device)[:, None]

        def block(h, a, b):
            return F.relu(getattr(self, b)(F.relu(getattr(self, a)(h))))

        def pool(h):
            return F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)

        with full_float32_convs():
            h = pool(block(x, "conv1a", "conv1b"))
            h = pool(block(h, "conv2a", "conv2b"))
            h = pool(block(h, "conv3a", "conv3b"))
            h = block(h, "conv4a", "conv4b")
            logits = self.convPb(F.relu(self.convPa(h)))
            d = self.convDb(F.relu(self.convDa(h)))
        p = torch.softmax(logits, dim=-1)[..., :-1]
        B, gh, gw, _ = p.shape
        scores = p.reshape(B, gh, gw, 8, 8).permute(0, 1, 3, 2, 4).reshape(
            B, gh * 8, gw * 8)
        return scores, d / torch.linalg.norm(d, dim=-1, keepdim=True)


def _max_pool_same(s: torch.Tensor, r: int) -> torch.Tensor:
    """(k×k, stride 1) max over ``s (H, W)``, −inf outside."""
    return F.max_pool2d(s[None, None], 2 * r + 1, 1, r)[0, 0]


def simple_nms(scores: torch.Tensor, nms_radius: int = 4) -> torch.Tensor:
    """lightglue ``simple_nms`` on a (H, W) score map: keep local maxima,
    with two suppression-refill iterations."""
    zeros = torch.zeros_like(scores)
    max_mask = scores == _max_pool_same(scores, nms_radius)
    for _ in range(2):
        supp_mask = _max_pool_same(max_mask.to(scores.dtype), nms_radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == _max_pool_same(supp_scores, nms_radius)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def superpoint_keypoints(model: SuperPoint, image, max_pts: int = 512,
                         det_thres: float = 0.005, nms_radius: int = 4):
    """``image`` (H, W) or (H, W, 3) in [0, 1] → ``(xy (max_pts, 2),
    score (max_pts,), valid (max_pts,))`` on the model's device, (x, y)
    pixels by decreasing score (the extractor contract of
    ``sfm_tracks.shi_tomasi_keypoints``); a 4-px border is removed."""
    dev = next(model.parameters()).device
    img = _as_image(image, dev)
    if img.dim() == 2:
        img = img[..., None]
    with torch.no_grad():
        scores, _ = model(img[None])
    s = simple_nms(scores[0], nms_radius)
    H, W = s.shape
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    interior = (xx >= 4) & (xx < W - 4) & (yy >= 4) & (yy < H - 4)
    masked = torch.where((s > det_thres) & interior, s,
                         torch.full_like(s, -float("inf")))
    top, idx = top_k(masked.reshape(-1), max_pts)
    valid = top > -float("inf")
    xy = torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)
    return xy, torch.where(valid, top, torch.zeros_like(top)), valid


def sample_descriptors(descriptors: torch.Tensor, xy, stride: int = 8):
    """lightglue ``sample_descriptors``: bilinear samples of ``descriptors
    (gh, gw, C)`` at pixel keypoints ``xy (N, 2)`` on the align-corners grid
    ``(xy − s/2 + 0.5) · (g−1)/(g·s − s/2 − 0.5)``, L2-renormalized."""
    gh, gw, _ = descriptors.shape
    s = float(stride)
    k = torch.as_tensor(xy, dtype=torch.float32,
                        device=descriptors.device) - s / 2 + 0.5
    gx = torch.clamp(k[:, 0] * (gw - 1) / (gw * s - s / 2 - 0.5), 0.0, gw - 1.0)
    gy = torch.clamp(k[:, 1] * (gh - 1) / (gh * s - s / 2 - 0.5), 0.0, gh - 1.0)
    x0 = torch.clamp(torch.floor(gx).long(), 0, gw - 2)
    y0 = torch.clamp(torch.floor(gy).long(), 0, gh - 2)
    fx, fy = gx - x0, gy - y0
    d = (descriptors[y0, x0] * ((1 - fx) * (1 - fy))[:, None]
         + descriptors[y0, x0 + 1] * (fx * (1 - fy))[:, None]
         + descriptors[y0 + 1, x0] * ((1 - fx) * fy)[:, None]
         + descriptors[y0 + 1, x0 + 1] * (fx * fy)[:, None])
    return d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-12)


def convert_superpoint(state_dict, prefix: str = "") -> dict:
    """torch SuperPoint ``state_dict`` (magicleap ``SuperPointNet`` or
    lightglue ``SuperPoint``: conv1a..convDb, each ``.weight`` (O, I, kh, kw)
    and ``.bias``) → skix's flax variables ``{"params": ...}`` (numpy)."""
    def np_of(t):
        return np.asarray(t.detach().cpu().numpy()
                          if hasattr(t, "detach") else t)

    sd = {k[len(prefix):] if prefix and k.startswith(prefix) else k: v
          for k, v in state_dict.items()}
    return {"params": {name: {
        "kernel": np_of(sd[f"{name}.weight"]).transpose(2, 3, 1, 0),
        "bias": np_of(sd[f"{name}.bias"])} for name in _CONV_NAMES}}


def reference_superpoint_spec() -> dict:
    """The reference state dict's entries → shapes (torch order)."""
    spec = {}
    for name, cin, cout, k in _PLAN:
        spec[f"{name}.weight"] = (cout, cin, k, k)
        spec[f"{name}.bias"] = (cout,)
    return spec
