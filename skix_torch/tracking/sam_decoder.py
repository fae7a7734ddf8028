"""SAM-2-style promptable mask decoder.

Port of ``skix/tracking/sam_decoder.py`` (the reference's
``sam3/sam/mask_decoder.py`` with its two-way transformer): output tokens
[object score, IoU, 1 single-mask + 3 multimask] ‖ prompt tokens, a
two-way transformer (token self-attention → token→image cross-attention →
MLP → image→token cross-attention, post-norm), 4× learned upscaling of the
image features (optionally fused with high-resolution skips through
``conv_s0``/``conv_s1``), per-mask hypernetwork MLPs whose inner product
with the upscaled features gives the mask logits, and SAM-2's dynamic
single-versus-multimask choice by stability score.

The decoder's attention is a plain einsum and softmax, as in skix (its
sequences are a few tokens against the feature grid): no kernel launch.
:func:`convert_sam_mask_decoder` loads a reference state dict.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models.layers import (Conv, ConvTranspose, Dense, LayerNorm,
                                      init_like_flax)


class _Attn(nn.Module):
    """Multi-head attention with the reference's optional downsampling of
    the inner width (``dim // downsample_rate``)."""

    def __init__(self, dim: int, num_heads: int = 8, downsample_rate: int = 1):
        super().__init__()
        ci = dim // downsample_rate
        self.num_heads = num_heads
        self.q, self.k, self.v = (Dense(dim, ci) for _ in range(3))
        self.out = Dense(ci, dim)

    def forward(self, q, k, v):
        B, Lq = q.shape[:2]
        H = self.num_heads
        qh = self.q(q).reshape(B, Lq, H, -1)
        kh = self.k(k).reshape(B, k.shape[1], H, -1)
        vh = self.v(v).reshape(B, v.shape[1], H, -1)
        s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(qh.shape[-1])
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vh)
        return self.out(out.reshape(B, Lq, -1))


class _SamMlp(nn.Module):
    """Linear stack with ReLU between layers, optional sigmoid output."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 3, sigmoid_output: bool = False):
        super().__init__()
        self.num_layers, self.sigmoid_output = num_layers, sigmoid_output
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            self.add_module(f"fc{i}", Dense(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


class TwoWayBlock(nn.Module):
    """Token self-attention → token→image cross-attention → MLP →
    image→token cross-attention (post-norm, LayerNorm eps 1e-5, ReLU MLP of
    width ``mlp_dim``). With ``skip_first_pe`` (the first block) the
    self-attention output replaces the tokens, with no residual."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_dim: int = 2048,
                 skip_first_pe: bool = False):
        super().__init__()
        self.skip_first_pe = skip_first_pe
        self.self_attn = _Attn(dim, num_heads)
        self.cross_t2i = _Attn(dim, num_heads, 2)
        self.cross_i2t = _Attn(dim, num_heads, 2)
        self.mlp_fc1 = Dense(dim, mlp_dim)
        self.mlp_fc2 = Dense(mlp_dim, dim)
        for i in range(1, 5):
            self.add_module(f"norm{i}", LayerNorm(dim, 1e-5))

    def forward(self, tokens, token_pe, img, img_pe):
        if self.skip_first_pe:
            tokens = self.self_attn(tokens, tokens, tokens)
        else:
            q = tokens + token_pe
            tokens = tokens + self.self_attn(q, q, tokens)
        tokens = self.norm1(tokens)
        q = tokens + token_pe
        k = img + img_pe
        tokens = self.norm2(tokens + self.cross_t2i(q, k, img))
        h = self.mlp_fc2(F.relu(self.mlp_fc1(tokens)))
        tokens = self.norm3(tokens + h)
        q = tokens + token_pe
        img = self.norm4(img + self.cross_i2t(k, q, tokens))
        return tokens, img


class SamDecoderOutputs(NamedTuple):
    mask_logits: torch.Tensor      # (B, 4h, 4w) the selected mask
    all_mask_logits: torch.Tensor  # (B, 4, 4h, 4w) single + 3 multimask
    iou_pred: torch.Tensor         # (B, 4)
    obj_score: torch.Tensor        # (B,) objectness logit
    mask_token: torch.Tensor       # (B, C) single-mask token


class SamMaskDecoder(nn.Module):
    """Image embeddings + prompt tokens → multimask logits at 4× the feature
    resolution, IoU predictions and the object score.

    ``high_res``: the model has ``conv_s0``/``conv_s1``, the projections of
    the high-resolution skips (skix creates them only when its ``init`` had
    ``high_res_feats``)."""

    def __init__(self, transformer_dim: int = 64, num_heads: int = 8,
                 depth: int = 2, mlp_dim: int = 2048, num_multimask: int = 3,
                 iou_hidden_dim: int = 256, iou_sigmoid: bool = True,
                 stability_delta: float = 0.05,
                 stability_thresh: float = 0.98,
                 dynamic_multimask: bool = True, high_res: bool = False):
        super().__init__()
        C = transformer_dim
        n_mask = 1 + num_multimask
        self.depth, self.n_mask = depth, n_mask
        self.stability_delta = stability_delta
        self.stability_thresh = stability_thresh
        self.dynamic_multimask = dynamic_multimask
        self.obj_score_token = nn.Parameter(torch.zeros(1, 1, C))
        self.iou_token = nn.Parameter(torch.zeros(1, 1, C))
        self.mask_tokens = nn.Parameter(torch.zeros(1, n_mask, C))
        for i in range(depth):
            self.add_module(f"block_{i}", TwoWayBlock(
                C, num_heads, mlp_dim, skip_first_pe=(i == 0)))
        self.final_t2i = _Attn(C, num_heads, 2)
        self.norm_final = LayerNorm(C, 1e-5)
        self.obj_score_head = _SamMlp(C, C, 1, 3)
        self.iou_head = _SamMlp(C, iou_hidden_dim, n_mask, 3,
                                sigmoid_output=iou_sigmoid)
        self.upscale1 = ConvTranspose(C, C // 4, 2)
        self.upscale_norm = LayerNorm(C // 4, 1e-6)
        self.upscale2 = ConvTranspose(C // 4, C // 8, 2)
        if high_res:
            self.conv_s0 = Conv(C, C // 8, 1)
            self.conv_s1 = Conv(C, C // 4, 1)
        for i in range(n_mask):
            self.add_module(f"hyper_{i}", _SamMlp(C, C, C // 8, 3))

    def init_weights(self, generator=None):
        """Random weights in flax's init distributions: kernels LeCun-normal,
        biases 0, norms 1/0, the output tokens normal(0.02)."""
        init_like_flax(self, generator)
        with torch.no_grad():
            for p in (self.obj_score_token, self.iou_token, self.mask_tokens):
                p.normal_(0.0, 0.02, generator=generator)
        return self

    def forward(self, image_embed, image_pe=None, prompt_tokens=None,
                multimask_output: bool = False,
                high_res_feats=None) -> SamDecoderOutputs:
        """``image_embed (B, h, w, C)``; ``image_pe (1, h, w, C)`` (default
        the sine-cosine map); ``prompt_tokens (B, P, C)`` embedded sparse
        prompts; ``high_res_feats`` optional ``(feat_4x (B, 4h, 4w, C),
        feat_2x (B, 2h, 2w, C))`` backbone skips."""
        B, h, w, C = image_embed.shape
        parts = [self.obj_score_token.expand(B, 1, C),
                 self.iou_token.expand(B, 1, C),
                 self.mask_tokens.expand(B, self.n_mask, C)]
        if prompt_tokens is not None:
            parts.append(prompt_tokens)
        tokens = torch.cat(parts, 1)
        # the original token embeddings are the tokens' positional encoding
        # at every block
        token_pe = tokens
        if image_pe is None:
            from skix_torch.tracking.vitdet import sincos_position_map

            image_pe = torch.as_tensor(sincos_position_map(h, w, C),
                                       device=image_embed.device)[None]
        img = image_embed.reshape(B, h * w, C)
        pe = image_pe.reshape(1, h * w, C).expand(B, h * w, C)
        for i in range(self.depth):
            block = getattr(self, f"block_{i}")
            tokens, img = block(tokens, token_pe, img, pe)
        q = tokens + token_pe
        tokens = self.norm_final(tokens + self.final_t2i(q, img + pe, img))

        obj_score = self.obj_score_head(tokens[:, 0])[..., 0]
        iou_pred = self.iou_head(tokens[:, 1])
        mask_tokens_out = tokens[:, 2:2 + self.n_mask]

        up = self.upscale1(img.reshape(B, h, w, C))
        if high_res_feats is not None:
            f4x, f2x = high_res_feats
            up = up + self.conv_s1(f2x)
        up = F.gelu(self.upscale_norm(up))
        up = self.upscale2(up)
        if high_res_feats is not None:
            up = up + self.conv_s0(f4x)
        up = F.gelu(up)                                 # (B, 4h, 4w, C/8)
        hyper = torch.stack([getattr(self, f"hyper_{i}")(mask_tokens_out[:, i])
                             for i in range(self.n_mask)], 1)
        masks = torch.einsum("bnc,bhwc->bnhw", hyper, up)

        # multimask: the best IoU of tokens 1..3 (first on ties); single:
        # token 0, or the best multimask when token 0 is not stable
        flat = masks.reshape(B, self.n_mask, -1)
        area_i = (flat > self.stability_delta).sum(-1).to(torch.float32)
        area_u = (flat > -self.stability_delta).sum(-1).to(torch.float32)
        stability = torch.where(area_u > 0,
                                area_i / torch.clamp(area_u, min=1.0), 1.0)
        best_multi = torch.argmax(iou_pred[:, 1:], dim=-1) + 1
        if multimask_output:
            sel = best_multi
        elif self.dynamic_multimask:
            sel = torch.where(stability[:, 0] >= self.stability_thresh,
                              torch.zeros_like(best_multi), best_multi)
        else:
            sel = torch.zeros_like(best_multi)
        selected = torch.take_along_dim(masks, sel[:, None, None, None],
                                        dim=1)[:, 0]
        return SamDecoderOutputs(mask_logits=selected, all_mask_logits=masks,
                                 iou_pred=iou_pred, obj_score=obj_score,
                                 mask_token=mask_tokens_out[:, 0])


# --------------------------------------------------------------------------
# converter of the reference state dict (the keys skix's converter reads)
# --------------------------------------------------------------------------
def _t(x) -> torch.Tensor:
    return torch.as_tensor(x.detach().cpu() if hasattr(x, "detach") else x,
                           dtype=torch.float32)


def convert_sam_mask_decoder(sd, depth: int = 2) -> dict[str, torch.Tensor]:
    """The reference ``sam3/sam/mask_decoder.py`` ``MaskDecoder`` state dict
    → a :class:`SamMaskDecoder` ``state_dict`` (build it with
    ``high_res=True`` when ``sd`` has ``conv_s0``). A ``ConvTranspose2d``
    weight (in, out, kh, kw) is stored (out, in, kh, kw) flipped in space,
    since the port's ``ConvTranspose`` applies flax's unflipped kernel."""
    out: dict[str, torch.Tensor] = {}

    def copy(dst, src):
        for leaf in ("weight", "bias"):
            out[f"{dst}.{leaf}"] = _t(sd[f"{src}.{leaf}"])

    def attn(dst, src):
        for a, b in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                     ("out", "out_proj")):
            copy(f"{dst}.{a}", f"{src}.{b}")

    def mlp3(dst, src):
        for i in range(3):
            copy(f"{dst}.fc{i}", f"{src}.layers.{i}")

    for name in ("obj_score_token", "iou_token", "mask_tokens"):
        out[name] = _t(sd[f"{name}.weight"])[None]
    copy("norm_final", "transformer.norm_final_attn")
    attn("final_t2i", "transformer.final_attn_token_to_image")
    mlp3("obj_score_head", "pred_obj_score_head")
    mlp3("iou_head", "iou_prediction_head")
    for dst, src in (("upscale1", "output_upscaling.0"),
                     ("upscale2", "output_upscaling.3")):
        out[f"{dst}.weight"] = _t(sd[f"{src}.weight"]).permute(
            1, 0, 2, 3).flip(2, 3).contiguous()
        out[f"{dst}.bias"] = _t(sd[f"{src}.bias"])
    copy("upscale_norm", "output_upscaling.1")
    for i in range(depth):
        p = f"transformer.layers.{i}"
        attn(f"block_{i}.self_attn", f"{p}.self_attn")
        attn(f"block_{i}.cross_t2i", f"{p}.cross_attn_token_to_image")
        attn(f"block_{i}.cross_i2t", f"{p}.cross_attn_image_to_token")
        copy(f"block_{i}.mlp_fc1", f"{p}.mlp.lin1")
        copy(f"block_{i}.mlp_fc2", f"{p}.mlp.lin2")
        for n in range(1, 5):
            copy(f"block_{i}.norm{n}", f"{p}.norm{n}")
    for i in range(sd["mask_tokens.weight"].shape[0]):
        mlp3(f"hyper_{i}", f"output_hypernetworks_mlps.{i}")
    if "conv_s0.weight" in sd:
        copy("conv_s0", "conv_s0")
        copy("conv_s1", "conv_s1")
    return out
