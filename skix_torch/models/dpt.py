"""Monocular depth estimation (DPT family), the prepare_dataset depth task.

Port of ``skix/models/dpt.py``. A ViT/16 backbone with a cls token and a
learned position table (:class:`DPTBackbone`) on the port's ``layers.Block``,
whose attention runs through ``flash_attention`` (K1 on the card); four
taps → the DPT reassemble (readout ``project``: the cls token concatenated
onto every patch token, Dense + GELU; 1×1 projection; ×4 and ×2
ConvTranspose, identity, and a 3×3 stride-2 conv with symmetric padding)
→ HF DPT's fusion blocks (pre-activation residual skips, mismatched
residuals resized to the hidden size) → the relu head, whose ×2 upsample
is align-corners bilinear → a torch-exact bicubic resize back to the
input size (:func:`_resize_bicubic_torch`: Keys a = −0.75, clamped taps,
which ``jax.image.resize`` would not give). Convolutions run in float32
(cuDNN's TF32 off). :func:`convert_hf_dpt_checkpoint` maps HuggingFace's
``DPTForDepthEstimation`` (Intel/dpt-large) state dict onto the port's
``state_dict``.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models.layers import (Block, Conv, ConvTranspose, Dense,
                                      PatchEmbed, init_like_flax)
from skix_torch.models.vggt import _FusionBlock, _resize_align_corners
from skix_torch.utils.device import constant, full_float32_convs

_MEAN = np.array([0.5, 0.5, 0.5], np.float32)
_STD = np.array([0.5, 0.5, 0.5], np.float32)


class DPTBackbone(nn.Module):
    """ViT with a cls token and a learned position table, returning the
    tapped blocks' outputs (float32; a tap index may repeat)."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 1024,
                 depth: int = 24, num_heads: int = 16,
                 taps: Sequence[int] = (5, 11, 17, 23), num_patches: int = 1):
        super().__init__()
        self.depth, self.taps = depth, tuple(taps)
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches + 1,
                                                  embed_dim))
        for i in range(depth):
            setattr(self, f"block_{i}", Block(embed_dim, num_heads, 4.0))

    def forward(self, images):
        x = self.patch_embed(images)
        B, _, C = x.shape
        x = torch.cat([self.cls_token.expand(B, 1, C), x], 1) + self.pos_embed
        outs, want = {}, set(self.taps)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
            if i in want:
                outs[i] = x.to(torch.float32)
        return [outs[t] for t in self.taps]


class MonocularDepth(nn.Module):
    """DPT monocular depth: image (B, H, W, 3) in [0, 1] (H, W multiples of
    the patch) → (B, H, W) depth. The position table is sized for
    ``image_hw`` (the frame the stage crops to)."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 1024,
                 depth: int = 24, num_heads: int = 16,
                 taps: Sequence[int] = (5, 11, 17, 23), features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 readout: str = "project", image_hw=(384, 384)):
        super().__init__()
        if readout not in ("project", "ignore"):
            raise ValueError(f"readout {readout!r}: project or ignore")
        self.patch_size, self.embed_dim = patch_size, embed_dim
        self.readout = readout
        gh, gw = image_hw[0] // patch_size, image_hw[1] // patch_size
        self.backbone = DPTBackbone(patch_size, embed_dim, depth, num_heads,
                                    taps, gh * gw)
        oc = tuple(out_channels)
        for i in range(4):
            if readout == "project":
                setattr(self, f"readout_{i}", Dense(2 * embed_dim, embed_dim))
            setattr(self, f"project_{i}", Conv(embed_dim, oc[i], 1))
            setattr(self, f"scratch_{i}", Conv(oc[i], features, 3,
                                               bias=False))
        self.resize_0 = ConvTranspose(oc[0], oc[0], 4)
        self.resize_1 = ConvTranspose(oc[1], oc[1], 2)
        # torch Conv2d(k=3, s=2, p=1): symmetric padding (flax SAME would
        # pad (0, 1) on even inputs)
        self.resize_3 = Conv(oc[3], oc[3], 3, stride=2, padding=1)
        self.refine4 = _FusionBlock(features, has_residual=False, hf=True)
        self.refine3 = _FusionBlock(features, hf=True)
        self.refine2 = _FusionBlock(features, hf=True)
        self.refine1 = _FusionBlock(features, hf=True)
        self.head_conv1 = Conv(features, features // 2, 3)
        self.head_conv2 = Conv(features // 2, 32, 3)
        self.head_conv3 = Conv(32, 1, 1)

    def init_weights(self, generator=None):
        """flax's initializers: LeCun-normal kernels, zero biases and cls
        token, the position table N(0, 0.02²)."""
        init_like_flax(self, generator)
        with torch.no_grad():
            self.backbone.cls_token.zero_()
            self.backbone.pos_embed.normal_(0.0, 0.02, generator=generator)
        return self

    def forward(self, images):
        B, H, W, _ = images.shape
        dev = images.device
        x = (images - constant(_MEAN, dev)) / constant(_STD, dev)
        taps = self.backbone(x)
        gh, gw = H // self.patch_size, W // self.patch_size
        with full_float32_convs():
            feats = []
            for i, t in enumerate(taps):
                h = t[:, 1:, :]
                if self.readout == "project":
                    cls_tok = t[:, :1, :].expand_as(h)
                    h = F.gelu(getattr(self, f"readout_{i}")(
                        torch.cat([h, cls_tok], -1)))
                h = getattr(self, f"project_{i}")(
                    h.reshape(B, gh, gw, self.embed_dim))
                if i != 2:
                    h = getattr(self, f"resize_{i}")(h)
                feats.append(getattr(self, f"scratch_{i}")(h))
            f4 = self.refine4(feats[3])
            f3 = self.refine3(f4, feats[2])
            f2 = self.refine2(f3, feats[1])
            f1 = self.refine1(f2, feats[0])
            h = self.head_conv1(f1)
            h = _resize_align_corners(h, (h.shape[1] * 2, h.shape[2] * 2))
            h = F.relu(self.head_conv2(h))
            h = F.relu(self.head_conv3(h))[..., 0]
        return _resize_bicubic_torch(h, (H, W))


@functools.lru_cache(maxsize=32)
def _bicubic_taps(n1: int, n2: int):
    """(n2, 4) source indices and float32 weights of torch's bicubic resize
    (half-pixel mapping, Keys a = −0.75, indices clamped to the border)."""
    src = (np.arange(n2) + 0.5) * (n1 / n2) - 0.5
    t0 = np.floor(src).astype(np.int64)
    frac = (src - t0).astype(np.float64)
    a = -0.75
    offs = np.array([-1, 0, 1, 2])
    xs = np.abs(frac[:, None] - offs[None, :])
    w = np.where(
        xs <= 1.0, (a + 2) * xs ** 3 - (a + 3) * xs ** 2 + 1.0,
        np.where(xs < 2.0, a * xs ** 3 - 5 * a * xs ** 2 + 8 * a * xs - 4 * a,
                 0.0))
    idx = np.clip(t0[:, None] + offs[None, :], 0, n1 - 1)
    return idx, w.astype(np.float32)


def _resize_bicubic_torch(x, out_hw):
    """Separable bicubic resize of ``x (..., H, W)`` with torch
    ``interpolate(mode="bicubic", align_corners=False)`` semantics."""
    H, W = x.shape[-2], x.shape[-1]
    iy, wy = _bicubic_taps(H, int(out_hw[0]))
    ix, wx = _bicubic_taps(W, int(out_hw[1]))
    dev = x.device
    a = torch.einsum("...hkw,hk->...hw", x[..., constant(iy, dev), :],
                     constant(wy, dev))
    return torch.einsum("...hwk,wk->...hw", a[..., constant(ix, dev)],
                        constant(wx, dev))


@torch.no_grad()
def estimate_depth_batched(model: MonocularDepth, frames_u8,
                           batch_size: int = 8, device=None):
    """Chunked whole-clip depth: ``frames (T, H, W, 3) uint8`` → ``(T, 1,
    H, W) float32``; the last chunk is zero-padded to ``batch_size``, so
    every forward has the same shape."""
    dev = torch.device(device) if device else next(model.parameters()).device
    T = frames_u8.shape[0]
    outs = []
    for s in range(0, T, batch_size):
        chunk = torch.as_tensor(frames_u8[s:s + batch_size],
                                device=dev).to(torch.float32) / 255.0
        n = chunk.shape[0]
        if n < batch_size:
            chunk = F.pad(chunk, (0, 0, 0, 0, 0, 0, 0, batch_size - n))
        outs.append(model(chunk)[:n].cpu().numpy())
    depth = np.concatenate(outs, axis=0)[:T]
    return depth[:, None, :, :]


def convert_hf_dpt_checkpoint(state_dict, depth: int = 24) -> dict:
    """HuggingFace ``DPTForDepthEstimation`` (Intel/dpt-large) state dict →
    the ``state_dict`` of :class:`MonocularDepth` with ``depth`` blocks,
    through skix's flax layout (q, k, v fused into ``attn.qkv``; a
    ConvTranspose kernel flipped in space there, and back where the port's
    ``ConvTranspose`` applies it; HF fusion layer 0 fuses the deepest tap,
    ``refine4``)."""
    from skix_torch.convert import flax_to_state_dict

    def np_of(t):
        return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                          else t, np.float32)

    def lin(prefix):
        return {"kernel": np_of(state_dict[f"{prefix}.weight"]).T,
                "bias": np_of(state_dict[f"{prefix}.bias"])}

    def conv(prefix, transpose=False):
        w = np_of(state_dict[f"{prefix}.weight"])
        w = (w.transpose(2, 3, 1, 0) if not transpose
             else np.ascontiguousarray(w.transpose(2, 3, 0, 1)[::-1, ::-1]))
        out = {"kernel": w}
        if f"{prefix}.bias" in state_dict:
            out["bias"] = np_of(state_dict[f"{prefix}.bias"])
        return out

    def ln(prefix):
        return {"scale": np_of(state_dict[f"{prefix}.weight"]),
                "bias": np_of(state_dict[f"{prefix}.bias"])}

    p: dict = {"backbone": {}}
    bb = p["backbone"]
    bb["cls_token"] = np_of(state_dict["dpt.embeddings.cls_token"])
    bb["pos_embed"] = np_of(state_dict["dpt.embeddings.position_embeddings"])
    bb["patch_embed"] = {"proj": conv(
        "dpt.embeddings.patch_embeddings.projection")}
    for i in range(depth):
        pref = f"dpt.encoder.layer.{i}"
        q, k, v = (lin(f"{pref}.attention.attention.{n}")
                   for n in ("query", "key", "value"))
        bb[f"block_{i}"] = {
            "norm1": ln(f"{pref}.layernorm_before"),
            "attn": {"qkv": {
                "kernel": np.concatenate([q["kernel"], k["kernel"],
                                          v["kernel"]], axis=1),
                "bias": np.concatenate([q["bias"], k["bias"], v["bias"]])},
                "proj": lin(f"{pref}.attention.output.dense")},
            "norm2": ln(f"{pref}.layernorm_after"),
            "mlp": {"fc1": lin(f"{pref}.intermediate.dense"),
                    "fc2": lin(f"{pref}.output.dense")},
        }
    for i in range(4):
        ro = f"neck.reassemble_stage.readout_projects.{i}.0"
        if f"{ro}.weight" in state_dict:
            p[f"readout_{i}"] = lin(ro)
        p[f"project_{i}"] = conv(
            f"neck.reassemble_stage.layers.{i}.projection")
        if i != 2:
            p[f"resize_{i}"] = conv(
                f"neck.reassemble_stage.layers.{i}.resize", transpose=(i < 2))
        p[f"scratch_{i}"] = conv(f"neck.convs.{i}")
    for i, name in enumerate(["refine4", "refine3", "refine2", "refine1"]):
        pref = f"neck.fusion_stage.layers.{i}"
        blk = {"out_conv": conv(f"{pref}.projection")}
        for ours, theirs in (("res_unit1", "residual_layer1"),
                             ("res_unit2", "residual_layer2")):
            key1 = f"{pref}.{theirs}.convolution1"
            if f"{key1}.weight" in state_dict:
                blk[f"{ours}_conv1"] = conv(key1)
                blk[f"{ours}_conv2"] = conv(f"{pref}.{theirs}.convolution2")
        p[name] = blk
    p["head_conv1"] = conv("head.head.0")
    p["head_conv2"] = conv("head.head.2")
    p["head_conv3"] = conv("head.head.4")
    return flax_to_state_dict({"params": p})
