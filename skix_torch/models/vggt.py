"""VGGT multi-view transformer: aggregator + camera head.

Port of ``skix/models/vggt.py``. The aggregator alternates frame attention
(within each view, ``(B·S, P, C)``) and global attention (across the views,
``(B, S·P, C)``); camera and register tokens take a first-view/other-view
split; the 2D rope (frequency 100) is applied inside the attention kernel
from tables, with positions (0, 0) for the special tokens and grid + 1 for
the patches; qk-norm bounds the logits, so attention runs in fixed-max
mode (bound 12). The camera head refines the 9-D pose encoding
[t(3), quat(4), fov_h, fov_w] over four adaLN-modulated iterations.

Images come feature-last, ``(B, S, H, W, 3)`` in [0, 1], as in skix. The
DPT depth and point heads, and the ``tokens``/``taps`` outputs, come with
the sfm slice of the port: asking for them raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.geometry.rotations import quat_to_matrix
from skix_torch.models.layers import (Block, Dense, LayerNorm, Mlp,
                                      PatchEmbed, init_like_flax,
                                      make_grid_positions)
from skix_torch.ops.attention import rope_2d_tables

_RESNET_MEAN = (0.485, 0.456, 0.406)
_RESNET_STD = (0.229, 0.224, 0.225)
_SFM_SLICE = "the sfm slice of the port (DPT heads, tokens and taps)"


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
                 init_values: float = 0.01,
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
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype)
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
# Full model
# --------------------------------------------------------------------------
class VGGT(nn.Module):
    """Aggregator + camera head: ``images (B, S, H, W, 3)`` in [0, 1] →
    ``{"pose_enc": (B, S, 9), "pose_enc_list": [...]}``."""

    def __init__(self, img_size: int = 518, patch_size: int = 14,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 enable_depth: bool = False, enable_point: bool = False,
                 intermediate_layer_idx: Sequence[int] = (4, 11, 17, 23),
                 patch_embed_kind: str = "conv", return_tokens: bool = False,
                 return_taps: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if enable_depth or enable_point or return_tokens or return_taps:
            raise NotImplementedError(
                f"VGGT depth/point heads, tokens and taps come with {_SFM_SLICE}")
        if patch_embed_kind != "conv":
            raise NotImplementedError(
                "patch_embed_kind='vit' (the DINOv2-style backbone) is not "
                "ported yet; 'conv' is the default")
        self.depth = depth
        self.intermediate_layer_idx = tuple(intermediate_layer_idx)
        needed = sorted(set(self.intermediate_layer_idx) | {depth - 1})
        self._layer_of_last = needed.index(depth - 1)
        self.aggregator = Aggregator(img_size=img_size, patch_size=patch_size,
                                     embed_dim=embed_dim, depth=depth,
                                     num_heads=num_heads,
                                     output_layers=needed, dtype=dtype)
        self.camera_head = CameraHead(dim_in=2 * embed_dim, dtype=dtype)

    def init_weights(self, generator=None) -> "VGGT":
        self.aggregator.init_weights(generator)
        self.camera_head.init_weights(generator)
        return self

    def forward(self, images):
        outputs, _ = self.aggregator(images)
        last = outputs[self._layer_of_last]
        cam_preds = self.camera_head(last[:, :, 0, :])
        return {"pose_enc": cam_preds[-1], "pose_enc_list": cam_preds}
