"""VGGT multi-view transformer: aggregator, camera head and DPT heads.

Port of ``skix/models/vggt.py``. The aggregator alternates frame attention
(within each view, ``(B·S, P, C)``) and global attention (across the views,
``(B, S·P, C)``); camera and register tokens take a first-view/other-view
split; the 2D rope (frequency 100) is applied inside the attention kernel
from tables, with positions (0, 0) for the special tokens and grid + 1 for
the patches; qk-norm bounds the logits, so attention runs in fixed-max
mode (bound 12). The patch embed is a strided convolution (``"conv"``) or
the DINOv2-shaped ``VisionTransformer`` (``"vit"``, no rope, online max).
The camera head refines the 9-D pose encoding [t(3), quat(4), fov_h,
fov_w] over four adaLN-modulated iterations. The DPT heads (depth, point
map; the track head's feature extractor with ``feature_only``) read four
float32 taps of the aggregator and run float32 convolutions, with cuDNN's
TF32 off (``utils.device.full_float32_convs``).

Images come feature-last, ``(B, S, H, W, 3)`` in [0, 1], as in skix.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.geometry.rotations import quat_to_matrix
from skix_torch.models.layers import (Block, Conv, ConvTranspose, Dense,
                                      LayerNorm, Mlp, PatchEmbed,
                                      VisionTransformer, init_like_flax,
                                      make_grid_positions)
from skix_torch.ops.attention import rope_2d_tables
from skix_torch.utils.device import constant, full_float32_convs
from skix_torch.utils.image import resize

_RESNET_MEAN = (0.485, 0.456, 0.406)
_RESNET_STD = (0.229, 0.224, 0.225)


# --------------------------------------------------------------------------
# pose encoding
# --------------------------------------------------------------------------
def pose_encoding_to_extri_intri(pose_enc: torch.Tensor, image_size_hw):
    """``(..., 9)`` [T(3), quat(4), fov_h, fov_w] → ``extrinsics (..., 3, 4)``,
    ``intrinsics (..., 3, 3)``."""
    T = pose_enc[..., :3]
    quat = pose_enc[..., 3:7]
    quat = quat / (torch.linalg.norm(quat, dim=-1, keepdim=True) + 1e-9)
    R = quat_to_matrix(quat)
    extrinsics = torch.cat([R, T[..., None]], dim=-1)
    H, W = image_size_hw
    fy = (H / 2.0) / torch.tan(torch.clamp(pose_enc[..., 7] / 2.0, min=1e-4))
    fx = (W / 2.0) / torch.tan(torch.clamp(pose_enc[..., 8] / 2.0, min=1e-4))
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    K = torch.stack([
        torch.stack([fx, zeros, torch.full_like(fx, W / 2.0)], -1),
        torch.stack([zeros, fy, torch.full_like(fy, H / 2.0)], -1),
        torch.stack([zeros, zeros, ones], -1),
    ], dim=-2)
    return extrinsics, K


def activate_head_output(x: torch.Tensor, activation: str) -> torch.Tensor:
    """Dense-head value activations (reference heads/head_act.py)."""
    if activation == "linear":
        return x
    if activation == "relu":
        return F.relu(x)
    if activation in ("exp", "expp0"):
        return torch.exp(x)
    if activation == "inv_log":
        return torch.sign(x) * torch.expm1(torch.abs(x))
    if activation == "expp1":
        return torch.exp(x) + 1.0
    raise ValueError(activation)


def activate_pose(pose_enc, trans_act="linear", quat_act="linear",
                  fl_act="relu"):
    return torch.cat([activate_head_output(pose_enc[..., :3], trans_act),
                      activate_head_output(pose_enc[..., 3:7], quat_act),
                      activate_head_output(pose_enc[..., 7:], fl_act)], dim=-1)


# --------------------------------------------------------------------------
# Aggregator
# --------------------------------------------------------------------------
class Aggregator(nn.Module):
    """Alternating frame/global attention over multi-view token sets:
    ``images (B, S, H, W, 3)`` → per-layer tokens ``(B, S, P, 2C)``
    (frame ‖ global, float32) for ``output_layers`` (None → every layer),
    and ``patch_start_idx``."""

    def __init__(self, img_size: int = 518, patch_size: int = 14,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, num_register_tokens: int = 4,
                 qk_norm: bool = True, rope_freq: float = 100.0,
                 init_values: float = 0.01, patch_embed_kind: str = "conv",
                 output_layers: Optional[Sequence[int]] = None,
                 dtype: torch.dtype = torch.float32,
                 attn_fixed_max: Optional[float] = 12.0):
        super().__init__()
        self.img_size = img_size
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.num_register_tokens = num_register_tokens
        self.rope_freq = rope_freq
        self.init_values = init_values
        self.output_layers = output_layers
        self.dtype = dtype
        if patch_embed_kind == "conv":
            self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype)
        elif patch_embed_kind == "vit":
            # skix sizes the position table from the input's patch grid;
            # the aggregator's input is img_size square
            self.patch_embed = VisionTransformer(
                patch_size=patch_size, embed_dim=embed_dim, depth=depth,
                num_heads=num_heads, num_register_tokens=num_register_tokens,
                num_patches=(img_size // patch_size) ** 2, dtype=dtype)
        else:
            raise ValueError(f"patch_embed_kind {patch_embed_kind!r}: "
                             "'conv' or 'vit'")
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, embed_dim))
        self.register_token = nn.Parameter(
            torch.zeros(1, 2, num_register_tokens, embed_dim))
        kw = dict(mlp_ratio=mlp_ratio, qk_norm=qk_norm,
                  init_values=init_values, dtype=dtype,
                  attn_fixed_max=attn_fixed_max if qk_norm else None)
        for i in range(depth):
            self.add_module(f"frame_block_{i}", Block(embed_dim, num_heads, **kw))
            self.add_module(f"global_block_{i}", Block(embed_dim, num_heads, **kw))

    @property
    def patch_start_idx(self) -> int:
        return 1 + self.num_register_tokens

    def init_weights(self, generator=None) -> "Aggregator":
        init_like_flax(self, generator)
        with torch.no_grad():
            self.camera_token.normal_(0.0, 1e-6, generator=generator)
            self.register_token.normal_(0.0, 1e-6, generator=generator)
            for m in self.modules():
                if hasattr(m, "gamma"):
                    m.gamma.fill_(self.init_values)
        if isinstance(self.patch_embed, VisionTransformer):
            self.patch_embed.init_weights(generator)
        return self

    def _expand_special(self, tok, B, S):
        X = tok.shape[2]
        first = tok[:, 0:1].expand(B, 1, X, self.embed_dim)
        rest = tok[:, 1:2].expand(B, S - 1, X, self.embed_dim)
        return torch.cat([first, rest], dim=1).reshape(B * S, X, self.embed_dim)

    def forward(self, images):
        B, S, H, W, _ = images.shape
        dev = images.device
        mean = torch.tensor(_RESNET_MEAN, dtype=torch.float32, device=dev)
        std = torch.tensor(_RESNET_STD, dtype=torch.float32, device=dev)
        x = ((images - mean) / std).reshape(B * S, H, W, 3).to(self.dtype)
        patch_tokens = self.patch_embed(x)

        tokens = torch.cat([
            self._expand_special(self.camera_token, B, S).to(self.dtype),
            self._expand_special(self.register_token, B, S).to(self.dtype),
            patch_tokens], dim=1)
        P = tokens.shape[1]

        # rope positions: special tokens at (0, 0), patches at grid + 1;
        # the global layout repeats the frame positions per view
        gh, gw = H // self.patch_size, W // self.patch_size
        pos_frame = np.concatenate(
            [np.zeros((self.patch_start_idx, 2), np.int32),
             make_grid_positions(gh, gw) + 1], axis=0)
        pos_frame = torch.as_tensor(pos_frame, device=dev)
        hd = self.embed_dim // self.num_heads
        rope_frame = rope_2d_tables(pos_frame, hd, self.rope_freq)
        rope_global = rope_2d_tables(pos_frame.repeat(S, 1), hd,
                                     self.rope_freq)

        want = (set(self.output_layers) if self.output_layers is not None
                else None)
        outputs = []
        for i in range(self.depth):
            tokens = getattr(self, f"frame_block_{i}")(tokens, rope_frame)
            frame_inter = tokens.reshape(B, S, P, self.embed_dim)
            tokens_g = tokens.reshape(B, S * P, self.embed_dim)
            tokens_g = getattr(self, f"global_block_{i}")(tokens_g, rope_global)
            tokens = tokens_g.reshape(B * S, P, self.embed_dim)
            global_inter = tokens.reshape(B, S, P, self.embed_dim)
            if want is None or i in want:
                outputs.append(torch.cat([frame_inter, global_inter],
                                         dim=-1).to(torch.float32))
        return outputs, self.patch_start_idx


# --------------------------------------------------------------------------
# Camera head
# --------------------------------------------------------------------------
class CameraHead(nn.Module):
    """adaLN-modulated trunk, iterative refinement of the 9-D pose encoding:
    ``camera_tokens (B, S, C_in)`` → list of ``(B, S, 9)`` predictions (one
    per iteration; the last is final)."""

    def __init__(self, dim_in: int = 2048, trunk_depth: int = 4,
                 num_heads: int = 16, mlp_ratio: float = 4.0,
                 init_values: float = 0.01, num_iterations: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_iterations = num_iterations
        self.init_values = init_values
        self.token_norm = LayerNorm(dim_in, 1e-5)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, 9))
        self.embed_pose = Dense(9, dim_in)
        self.poseLN_modulation = Dense(dim_in, 3 * dim_in)
        self.trunk_depth = trunk_depth
        for i in range(trunk_depth):
            self.add_module(f"trunk_{i}", Block(dim_in, num_heads, mlp_ratio,
                                                init_values=init_values,
                                                dtype=dtype))
        self.trunk_norm = LayerNorm(dim_in, 1e-5)
        self.adaln_norm = LayerNorm(dim_in, 1e-6, use_scale=False,
                                    use_bias=False)
        self.pose_branch = Mlp(dim_in, dim_in // 2, out_features=9)

    def init_weights(self, generator=None) -> "CameraHead":
        init_like_flax(self, generator)
        with torch.no_grad():
            self.empty_pose_tokens.zero_()
            for m in self.modules():
                if hasattr(m, "gamma"):
                    m.gamma.fill_(self.init_values)
        return self

    def forward(self, camera_tokens):
        B, S, _ = camera_tokens.shape
        x = self.token_norm(camera_tokens)
        pred = None
        preds = []
        for _ in range(self.num_iterations):
            if pred is None:
                inp = self.embed_pose(self.empty_pose_tokens.expand(B, S, 9))
            else:
                inp = self.embed_pose(pred.detach())
            shift, scale, gate = self.poseLN_modulation(F.silu(inp)).chunk(3, dim=-1)
            h = gate * (self.adaln_norm(x) * (1 + scale) + shift) + x
            for i in range(self.trunk_depth):
                h = getattr(self, f"trunk_{i}")(h)
            delta = self.pose_branch(self.trunk_norm(h))
            pred = delta if pred is None else pred + delta
            preds.append(activate_pose(pred))
        return preds


# --------------------------------------------------------------------------
# DPT head (dense prediction)
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=64)
def _align_corners_weights(n1: int, n2: int) -> np.ndarray:
    """``(n2, n1)`` float32 weights of a torch ``align_corners=True``
    bilinear resize along one axis: output ``i`` samples source ``i·(n1−1)/
    (n2−1)`` from its two neighbours, as skix's two gathers."""
    src = np.zeros(1) if n2 == 1 else np.arange(n2) * (n1 - 1) / (n2 - 1)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, n1 - 1)
    i1 = np.minimum(i0 + 1, n1 - 1)
    w = (src - i0).astype(np.float32)
    m = np.zeros((n2, n1), np.float32)
    np.add.at(m, (np.arange(n2), i0), np.float32(1) - w)
    np.add.at(m, (np.arange(n2), i1), w)
    return m


def _resize_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Separable bilinear resize of ``x (..., H, W, C)`` with torch's
    ``align_corners=True`` semantics, as two products with the axes' weight
    matrices (copied to the device once per size pair)."""
    H, W = x.shape[-3], x.shape[-2]
    wy = constant(_align_corners_weights(H, int(out_hw[0])), x.device)
    wx = constant(_align_corners_weights(W, int(out_hw[1])), x.device)
    x = torch.einsum("yh,...hwc->...ywc", wy, x)
    return torch.einsum("xw,...ywc->...yxc", wx, x)


class _FusionBlock(nn.Module):
    """The DPT FeatureFusionBlock: residual add → res_unit2 → align-corners
    resize to the next level's size (``out_size``; ×2 when None) →
    ``out_conv``. Two dialects differ in the residual skip, as in skix:
    VGGT's (the default), whose in-place ReLU makes the skip add
    ``relu(h)``; and HF transformers' DPT (``hf=True``, the depth model's;
    skix's ``preact_residual`` and ``align_residual`` together), whose skip
    adds the pre-activation ``h`` and which resizes a residual of another
    size to the hidden state's (jax's half-pixel bilinear, torch's
    ``align_corners=False``) before the add."""

    def __init__(self, features: int, has_residual: bool = True,
                 hf: bool = False):
        super().__init__()
        units = ("res_unit1", "res_unit2") if has_residual else ("res_unit2",)
        for u in units:
            setattr(self, f"{u}_conv1", Conv(features, features, 3))
            setattr(self, f"{u}_conv2", Conv(features, features, 3))
        self.has_residual = has_residual
        self.hf = hf
        self.out_conv = Conv(features, features, 1)

    def _res_unit(self, h, name):
        a = F.relu(h)
        out = F.relu(getattr(self, f"{name}_conv1")(a))
        return (h if self.hf else a) + getattr(self, f"{name}_conv2")(out)

    def forward(self, x, res=None, out_size=None):
        if self.has_residual and res is not None:
            if self.hf and res.shape[1:3] != x.shape[1:3]:
                res = resize(res, (res.shape[0], *x.shape[1:3],
                                   res.shape[-1]), "bilinear")
            x = x + self._res_unit(res, "res_unit1")
        x = self._res_unit(x, "res_unit2")
        H, W = x.shape[1], x.shape[2]
        x = _resize_align_corners(
            x, out_size if out_size is not None else (H * 2, W * 2))
        return self.out_conv(x)


class DPTHead(nn.Module):
    """Dense prediction over 4 aggregator taps: ``taps`` (4 × ``(B, S, P,
    dim_in)`` float32) → ``(pred (B, S, H, W, output_dim − 1), conf (B, S,
    H, W))``; with ``feature_only`` (the track head's feature extractor)
    ``(B, S, H/down_ratio, W/down_ratio, features)`` maps."""

    def __init__(self, dim_in: int = 2048, patch_size: int = 14,
                 output_dim: int = 4, features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 activation: str = "inv_log", conf_activation: str = "expp1",
                 feature_only: bool = False, down_ratio: int = 1):
        super().__init__()
        self.patch_size = patch_size
        self.output_dim = output_dim
        self.activation = activation
        self.conf_activation = conf_activation
        self.feature_only = feature_only
        self.down_ratio = down_ratio
        oc = tuple(out_channels)
        for i in range(4):
            setattr(self, f"norm_{i}", LayerNorm(dim_in, 1e-5))
            setattr(self, f"project_{i}", Conv(dim_in, oc[i], 1))
            setattr(self, f"scratch_{i}", Conv(oc[i], features, 3, bias=False))
        self.resize_0 = ConvTranspose(oc[0], oc[0], 4)
        self.resize_1 = ConvTranspose(oc[1], oc[1], 2)
        self.resize_3 = Conv(oc[3], oc[3], 3, stride=2)
        self.refine4 = _FusionBlock(features, has_residual=False)
        self.refine3 = _FusionBlock(features)
        self.refine2 = _FusionBlock(features)
        self.refine1 = _FusionBlock(features)
        if feature_only:
            self.out_conv1 = Conv(features, features, 3)
        else:
            self.out_conv1 = Conv(features, features // 2, 3)
            self.out_conv2a = Conv(features // 2, 32, 3)
            self.out_conv2b = Conv(32, output_dim, 1)

    def forward(self, taps, images_hw, patch_start_idx: int):
        H, W = images_hw
        gh, gw = H // self.patch_size, W // self.patch_size
        B, S = taps[0].shape[:2]
        with full_float32_convs():
            feats = []
            for i, t in enumerate(taps):
                x = getattr(self, f"norm_{i}")(t[:, :, patch_start_idx:, :])
                x = x.reshape(B * S, gh, gw, x.shape[-1])
                x = getattr(self, f"project_{i}")(x)
                if i != 2:
                    x = getattr(self, f"resize_{i}")(x)
                feats.append(getattr(self, f"scratch_{i}")(x))
            f4 = self.refine4(feats[3], out_size=feats[2].shape[1:3])
            f3 = self.refine3(f4, feats[2], out_size=feats[1].shape[1:3])
            f2 = self.refine2(f3, feats[1], out_size=feats[0].shape[1:3])
            f1 = self.refine1(f2, feats[0])
            if self.feature_only:
                h = _resize_align_corners(
                    self.out_conv1(f1),
                    (H // self.down_ratio, W // self.down_ratio))
                return h.reshape(B, S, *h.shape[1:])
            h = _resize_align_corners(self.out_conv1(f1), (H, W))
            h = self.out_conv2b(F.relu(self.out_conv2a(h)))
        h = h.reshape(B, S, H, W, self.output_dim)
        return (activate_head_output(h[..., :-1], self.activation),
                activate_head_output(h[..., -1], self.conf_activation))


# --------------------------------------------------------------------------
# Full model
# --------------------------------------------------------------------------
class VGGT(nn.Module):
    """Aggregator + camera head + depth and point DPT heads: ``images (B,
    S, H, W, 3)`` in [0, 1] → ``{"pose_enc", "pose_enc_list"}``, with
    ``"depth"``/``"depth_conf"`` and ``"world_points"``/
    ``"world_points_conf"`` where the heads are on (skix's defaults),
    ``"tokens"`` ``(B, S, gh, gw, 2E)`` with ``return_tokens`` and the four
    tap tensors (special tokens included) with ``return_taps``."""

    def __init__(self, img_size: int = 518, patch_size: int = 14,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 enable_depth: bool = True, enable_point: bool = True,
                 intermediate_layer_idx: Sequence[int] = (4, 11, 17, 23),
                 patch_embed_kind: str = "conv", return_tokens: bool = False,
                 return_taps: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = depth
        self.patch_size = patch_size
        self.return_tokens = return_tokens
        self.return_taps = return_taps
        self.intermediate_layer_idx = tuple(intermediate_layer_idx)
        needed = sorted(set(self.intermediate_layer_idx) | {depth - 1})
        self._layer_of = {L: i for i, L in enumerate(needed)}
        self.aggregator = Aggregator(img_size=img_size, patch_size=patch_size,
                                     embed_dim=embed_dim, depth=depth,
                                     num_heads=num_heads,
                                     patch_embed_kind=patch_embed_kind,
                                     output_layers=needed, dtype=dtype)
        self.camera_head = CameraHead(dim_in=2 * embed_dim, dtype=dtype)
        kw = dict(dim_in=2 * embed_dim, patch_size=patch_size,
                  conf_activation="expp1")
        self.depth_head = (DPTHead(output_dim=2, activation="exp", **kw)
                           if enable_depth else None)
        self.point_head = (DPTHead(output_dim=4, activation="inv_log", **kw)
                           if enable_point else None)

    def init_weights(self, generator=None) -> "VGGT":
        self.aggregator.init_weights(generator)
        self.camera_head.init_weights(generator)
        for head in (self.depth_head, self.point_head):
            if head is not None:
                init_like_flax(head, generator)
        return self

    def forward(self, images):
        B, S, H, W, _ = images.shape
        outputs, patch_start = self.aggregator(images)
        last = outputs[self._layer_of[self.depth - 1]]
        cam_preds = self.camera_head(last[:, :, 0, :])
        result = {"pose_enc": cam_preds[-1], "pose_enc_list": cam_preds}
        taps = [outputs[self._layer_of[L]] for L in self.intermediate_layer_idx]
        if self.depth_head is not None:
            result["depth"], result["depth_conf"] = self.depth_head(
                taps, (H, W), patch_start)
        if self.point_head is not None:
            result["world_points"], result["world_points_conf"] = \
                self.point_head(taps, (H, W), patch_start)
        if self.return_tokens:
            gh, gw = H // self.patch_size, W // self.patch_size
            result["tokens"] = last[:, :, patch_start:, :].reshape(
                B, S, gh, gw, last.shape[-1])
        if self.return_taps:
            result["taps"] = tuple(taps)
            result["patch_start_idx"] = patch_start
        return result


def unproject_depth_to_points(depth, extrinsics, intrinsics):
    """Depth map ``(..., H, W)`` + cameras → world points ``(..., H, W, 3)``
    at integer pixel coordinates (the reference's convention):
    world = Rᵀ (cam − t)."""
    H, W = depth.shape[-2:]
    ys = torch.arange(H, dtype=torch.float32, device=depth.device)
    xs = torch.arange(W, dtype=torch.float32, device=depth.device)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    fx = intrinsics[..., 0, 0][..., None, None]
    fy = intrinsics[..., 1, 1][..., None, None]
    cx = intrinsics[..., 0, 2][..., None, None]
    cy = intrinsics[..., 1, 2][..., None, None]
    cam_pts = torch.stack([(grid_x - cx) / fx * depth,
                           (grid_y - cy) / fy * depth, depth], dim=-1)
    R = extrinsics[..., :3, :3]
    t = extrinsics[..., :3, 3]
    return torch.einsum("...ji,...hwj->...hwi", R,
                        cam_pts - t[..., None, None, :])
