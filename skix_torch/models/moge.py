"""MoGe-2-shaped monocular geometry model → camera intrinsics (FOV).

Port of ``skix/models/moge.py``: a DINOv2 ViT-L/14 trunk
(``skix_torch.models.layers.VisionTransformer``, register tokens and
LayerScale; its attention is K1 on the card) tapped at four blocks, a
fusion head emitting an affine-invariant point map and a validity mask,
and :func:`recover_focal_shift`, a fixed 48-step golden-section search over
the z-shift with the closed-form optimal focal per shift.
:class:`MoGeFovEstimator` keeps the reference's ``run_moge`` semantics:
per-frame pixel intrinsics with fx overridden by the vertical focal.

:func:`convert_moge_backbone` maps a real MoGe-2 checkpoint's trunk through
the DINOv2 converter (``models.vggt_convert.convert_dinov2_backbone``); the
head's tensors are left to a per-layer map, as in skix.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models.layers import (Conv, ConvTranspose, VisionTransformer,
                                      init_like_flax)
from skix_torch.utils.device import constant, full_float32_convs
from skix_torch.utils.image import resize

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class MoGePointModel(nn.Module):
    """Image ``(B, H, W, 3)`` in [0, 1] → (points ``(B, H, W, 3)``
    affine-invariant, mask ``(B, H, W)`` logits); H and W divisible by
    ``patch_size``. ``num_patches`` sizes the trunk's position table; its
    forward takes a table resampled to another grid in its place."""

    def __init__(self, patch_size: int = 14, embed_dim: int = 1024,
                 depth: int = 24, num_heads: int = 16,
                 taps: Sequence[int] = (5, 11, 17, 23), features: int = 256,
                 num_patches: int = 1):
        super().__init__()
        self.patch_size = patch_size
        self.taps = tuple(taps)
        self.backbone = VisionTransformer(
            patch_size=patch_size, embed_dim=embed_dim, depth=depth,
            num_heads=num_heads, taps=self.taps, num_patches=num_patches)
        # one projection per tapped block (a block named twice taps once)
        n_taps = sum(1 for i in range(depth) if i in set(self.taps))
        for i in range(n_taps):
            setattr(self, f"project_{i}", Conv(embed_dim, features, 1))
        for i in range(2):
            setattr(self, f"fuse_{i}_a", Conv(features, features, 3))
            setattr(self, f"fuse_{i}_b", Conv(features, features, 3))
        self.up1 = ConvTranspose(features, features // 2, 2)
        self.up2 = ConvTranspose(features // 2, features // 4, 2)
        self.points_out = Conv(features // 4, 3, 1)
        self.mask_out = Conv(features // 4, 1, 1)

    def init_weights(self, generator=None):
        init_like_flax(self, generator)
        self.backbone.init_weights(generator)
        return self

    def forward(self, images, pos_embed=None):
        B, H, W, _ = images.shape
        mean = constant(_IMAGENET_MEAN, images.device)
        std = constant(_IMAGENET_STD, images.device)
        _, tap_tokens = self.backbone((images - mean) / std, pos_embed)
        gh, gw = H // self.patch_size, W // self.patch_size
        with full_float32_convs():
            feats = [getattr(self, f"project_{i}")(
                t.reshape(B, gh, gw, t.shape[-1]))
                for i, t in enumerate(tap_tokens)]
            h = sum(feats) / len(feats)
            for i in range(2):
                r = getattr(self, f"fuse_{i}_a")(F.relu(h))
                r = getattr(self, f"fuse_{i}_b")(F.relu(r))
                h = h + r
            h = F.relu(self.up1(h))
            h = F.relu(self.up2(h))
            pts = self.points_out(h)
            msk = self.mask_out(h)[..., 0]
        pts = resize(pts, (B, H, W, 3), "bilinear")
        msk = resize(msk, (B, H, W), "bilinear")
        # z is a depth-like positive quantity up to the affine shift
        z = torch.exp(torch.clamp(pts[..., 2], -8, 8))
        return torch.cat([pts[..., :2], z[..., None]], dim=-1), msk


def image_uv(h: int, w: int, device=None):
    """Normalized pixel coordinates ``(v, w)`` grids, principal point at 0:
    u spans ±0.5·W/diag, v ±0.5·H/diag (the MoGe focal convention)."""
    diag = float(np.hypot(h, w))
    u = (torch.arange(w, dtype=torch.float32, device=device) + 0.5
         - w / 2) / diag
    v = (torch.arange(h, dtype=torch.float32, device=device) + 0.5
         - h / 2) / diag
    return torch.meshgrid(u, v, indexing="xy")


def recover_focal_shift(points, mask=None, iters: int = 48):
    """Affine-invariant point maps ``(B, H, W, 3)`` → (focal, shift), each
    ``(B,)`` (skix's per-map search, batched).

    Solves min over (f, dz) of Σ w·[(f·x/(z+dz) − u)² + (f·y/(z+dz) − v)²]
    on the diagonal-normalized pixel grid: the optimal f per dz is closed-form
    (clamped to ≥ 1e-3), and dz is searched by ``iters`` golden-section
    steps over (−min z + 1e-4, 4·max(max z, 1)). An empty mask falls back
    to uniform weights. ``focal`` is diagonal-normalized: f_px = focal ·
    √(H² + W²)."""
    H, W = points.shape[1:3]
    u, v = image_uv(H, W, points.device)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    w = torch.ones_like(z) if mask is None else mask.to(torch.float32)
    dims = (-2, -1)

    def total(t):
        return t.sum(dim=dims)

    def per_row(t):
        return t[:, None, None]

    w = torch.where(per_row(total(w) > 0), w, torch.ones_like(w))
    w = w / per_row(torch.clamp(total(w), min=1.0))
    zmin = torch.amin(torch.where(w > 0, z, float("inf")), dim=dims)
    zmax = torch.amax(torch.where(w > 0, z, float("-inf")), dim=dims)
    lo = -zmin + 1e-4
    hi = 4.0 * torch.clamp(zmax, min=1.0)

    def residual(dz):
        iz = 1.0 / (z + per_row(dz))
        a1, a2 = x * iz, y * iz
        num = total(w * (a1 * u + a2 * v))
        den = total(w * (a1 * a1 + a2 * a2)) + 1e-12
        f = torch.clamp(num / den, min=1e-3)
        r = w * ((per_row(f) * a1 - u) ** 2 + (per_row(f) * a2 - v) ** 2)
        return total(r), f

    gr = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    for _ in range(iters):
        c = b - gr * (b - a)
        d = a + gr * (b - a)
        fc, _ = residual(c)
        fd, _ = residual(d)
        smaller_c = fc < fd
        a, b = torch.where(smaller_c, a, c), torch.where(smaller_c, d, b)
    dz = (a + b) / 2.0
    _, f = residual(dz)
    return f, dz


def resize_pos_embed(pos: torch.Tensor, src_grid: tuple,
                     dst_grid: tuple) -> torch.Tensor:
    """``(1, P+1, D)`` ViT position table → another patch grid: the cls row
    kept, the patch rows resampled bilinearly on the 2-D grid (jax's
    ``resize``, antialiased when shrinking)."""
    sh, sw = src_grid
    dh, dw = dst_grid
    D = pos.shape[-1]
    grid = resize(pos[:, 1:].reshape(1, sh, sw, D), (1, dh, dw, D),
                  "bilinear")
    return torch.cat([pos[:, :1], grid.reshape(1, dh * dw, D)], dim=1)


class MoGeFovEstimator:
    """Frames → per-frame 3×3 pixel intrinsics, fx OVERRIDDEN by the
    vertical focal (the reference's ``run_moge``).

    Without a ``state_dict`` the model is initialized lazily, at the first
    clip's padded grid, from a ``torch.Generator`` on ``device`` seeded with
    0. The position table is input-size dependent: the model keeps
    its base table (the checkpoint's grid, ``grid`` or square) and each other
    grid gets a bilinear resample of it, cached per grid, so one estimator
    serves clips of any resolution."""

    def __init__(self, model: MoGePointModel, state_dict=None, grid=None,
                 device="cuda"):
        self.device = torch.device(device)
        self.model = model
        self._grid = grid
        self._cache: dict = {}
        self._ready = state_dict is not None
        if state_dict is not None:
            pos = state_dict["backbone.pos_embed"]
            if grid is None:
                P = pos.shape[1] - 1
                g = int(round(P ** 0.5))
                if g * g != P:
                    raise ValueError(
                        "non-square pos_embed: pass grid=(gh, gw) explicitly")
                self._grid = (g, g)
            self._resize_table(pos.shape[1] - 1)
            model.load_state_dict(dict(state_dict))
        self.model.to(self.device).eval()

    def _resize_table(self, num_patches: int) -> None:
        bb = self.model.backbone
        bb.pos_embed = nn.Parameter(bb.pos_embed.new_zeros(
            (1, num_patches + 1, bb.pos_embed.shape[-1])))

    def _pos_embed_for(self, gh: int, gw: int):
        """The position table of grid (gh, gw), or None for the base grid."""
        if not self._ready:
            self._resize_table(gh * gw)
            self.model.to(self.device)
            self.model.init_weights(
                torch.Generator(device=self.device).manual_seed(0))
            self._grid, self._ready = (gh, gw), True
        if (gh, gw) == self._grid:
            return None
        if (gh, gw) not in self._cache:
            # always resampled from the base table, never a resample of one
            self._cache[(gh, gw)] = resize_pos_embed(
                self.model.backbone.pos_embed.detach(), self._grid, (gh, gw))
        return self._cache[(gh, gw)]

    @torch.no_grad()
    def intrinsics_for_clip(self, frames_u8: np.ndarray,
                            batch_size: int = 4) -> np.ndarray:
        T, H, W = frames_u8.shape[:3]
        ps = self.model.patch_size
        ph, pw = (-H) % ps, (-W) % ps
        pos = self._pos_embed_for((H + ph) // ps, (W + pw) // ps)
        Ks = []
        for s in range(0, T, batch_size):
            e = min(s + batch_size, T)
            chunk = torch.from_numpy(np.ascontiguousarray(
                frames_u8[s:e])).to(self.device).to(torch.float32) / 255.0
            chunk = F.pad(chunk, (0, 0, 0, pw, 0, ph,
                                  0, batch_size - (e - s)))
            pts, msk = self.model(chunk, pos)
            f, _ = recover_focal_shift(pts, torch.sigmoid(msk) > 0.5)
            f_px = f.cpu().numpy() * float(np.hypot(H + ph, W + pw))
            for i in range(e - s):
                v_focal = f_px[i]          # fx := fy (reference override)
                Ks.append(np.array([[v_focal, 0, W / 2],
                                    [0, v_focal, H / 2],
                                    [0, 0, 1]], np.float32))
        return np.stack(Ks)


def convert_moge_backbone(state_dict, depth: int = 24,
                          prefix: str = "backbone.") -> dict:
    """Real MoGe-2 checkpoint → the trunk's ``VisionTransformer`` tree
    (skix's layout; ``convert.flax_to_state_dict`` of ``{"params": tree}``
    loads it into ``MoGePointModel.backbone``): the MoGe backbone is a
    DINOv2 ``DinoVisionTransformer``."""
    from skix_torch.models.vggt_convert import convert_dinov2_backbone

    return convert_dinov2_backbone(state_dict, depth, prefix=prefix)
