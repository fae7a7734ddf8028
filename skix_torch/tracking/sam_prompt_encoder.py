"""SAM prompt encoder and the SAM-1-style interactive image predictor.

Port of ``skix/tracking/sam_prompt_encoder.py``:

- :class:`SamPromptEncoder` (the reference's ``sam3/sam/prompt_encoder.py``
  ``PromptEncoder``): random-Fourier positional encoding, four point-type
  embeddings (negative, positive, box corner 1, box corner 2), the
  not-a-point embedding where ``label == -1``, the mask-downscaling convs
  for a dense mask prompt and the learned no-mask embedding otherwise;
- :class:`InteractiveSegmenter`: the frame trunk
  (:class:`skix_torch.tracking.memory_tracker.ImageEncoder`, ``conv`` or
  ``vitdet``), the prompt encoder and
  :class:`skix_torch.tracking.sam_decoder.SamMaskDecoder`;
- :class:`SamImagePredictor` (the reference's ``sam1_task_predictor.py``):
  ``set_image`` encodes a frame once, ``predict`` decodes masks and IoU
  predictions for clicks and a box from the cached embedding.

Prompts have a fixed number of slots, ``-1``-labelled slots padding them,
as in skix. Every module carries its weights; the device follows them.
:func:`convert_sam_prompt_encoder` loads a reference state dict.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models.layers import Conv, LayerNorm, init_like_flax
from skix_torch.utils.image import resize


class RandomPositionEmbedding(nn.Module):
    """Random spatial-frequency positional encoding; the Gaussian matrix
    ``(2, num_pos_feats)`` is a parameter."""

    def __init__(self, num_pos_feats: int = 64):
        super().__init__()
        self.gaussian_matrix = nn.Parameter(torch.zeros(2, num_pos_feats))

    def forward(self, coords01):
        """``coords01 (..., 2)`` in [0, 1] → ``(..., 2·num_pos_feats)``."""
        c = (2.0 * coords01 - 1.0) @ self.gaussian_matrix
        c = 2.0 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def grid(self, h: int, w: int):
        """The dense encoding of an ``(h, w)`` feature grid: cell centres
        ``((j + 0.5)/w, (i + 0.5)/h)`` → ``(h, w, C)``."""
        dev = self.gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        return self(torch.stack(torch.meshgrid(xs, ys, indexing="xy"), -1))


class SamPromptEncoder(nn.Module):
    """Point, box and mask prompts → (sparse tokens, dense embedding, dense
    positional encoding)."""

    def __init__(self, embed_dim: int = 64, mask_in_chans: int = 16,
                 input_image_size: int = 512):
        super().__init__()
        self.embed_dim = embed_dim
        self.input_image_size = input_image_size
        self.pe = RandomPositionEmbedding(embed_dim // 2)
        self.point_embeddings = nn.Parameter(torch.zeros(4, embed_dim))
        self.not_a_point_embed = nn.Parameter(torch.zeros(embed_dim))
        self.no_mask_embed = nn.Parameter(torch.zeros(embed_dim))
        cin = 1
        for i, ch in enumerate((mask_in_chans // 4, mask_in_chans)):
            self.add_module(f"mask_down_{i}", Conv(cin, ch, 2, stride=2))
            self.add_module(f"mask_norm_{i}", LayerNorm(ch, 1e-6))
            cin = ch
        self.mask_proj = Conv(mask_in_chans, embed_dim, 1)

    def init_weights(self, generator=None):
        """flax's init distributions: convs LeCun-normal, the Gaussian
        matrix and the embeddings normal(1)."""
        init_like_flax(self, generator)
        with torch.no_grad():
            for p in (self.pe.gaussian_matrix, self.point_embeddings,
                      self.not_a_point_embed, self.no_mask_embed):
                p.normal_(0.0, 1.0, generator=generator)
        return self

    def forward(self, feat_hw, points=None, labels=None, boxes=None,
                masks=None):
        """``points (B, P, 2)`` model pixels, ``labels (B, P)`` (−1 pads);
        ``boxes (B, 4)`` xyxy model pixels; ``masks (B, 4h, 4w, 1)``
        logits."""
        h, w = feat_hw
        C = self.embed_dim
        size = float(self.input_image_size)
        sparse = []
        if points is not None:
            emb = self.pe((points + 0.5) / size)
            lab = labels[..., None]
            emb = torch.where(lab == -1, self.not_a_point_embed, emb)
            for t, type_embed in enumerate(self.point_embeddings):
                emb = torch.where(lab == t, emb + type_embed, emb)
            sparse.append(emb)
        if boxes is not None:
            corners = (boxes.reshape(-1, 2, 2) + 0.5) / size
            sparse.append(self.pe(corners) + self.point_embeddings[2:4])
        if sparse:
            sparse = torch.cat(sparse, 1)
        else:
            B = masks.shape[0] if masks is not None else 1
            sparse = torch.zeros((B, 0, C), device=self.no_mask_embed.device)
        if masks is not None:
            m = masks
            for i in range(2):
                m = getattr(self, f"mask_down_{i}")(m)
                m = F.gelu(getattr(self, f"mask_norm_{i}")(m))
            dense = self.mask_proj(m)
        else:
            dense = self.no_mask_embed.expand(sparse.shape[0], h, w, C)
        return sparse, dense, self.pe.grid(h, w)


def convert_sam_prompt_encoder(sd) -> dict[str, torch.Tensor]:
    """The reference ``sam3/sam/prompt_encoder.py`` state dict → a
    :class:`SamPromptEncoder` ``state_dict``."""
    def t(x):
        return torch.as_tensor(x.detach().cpu() if hasattr(x, "detach") else x,
                               dtype=torch.float32)

    out = {"pe.gaussian_matrix":
           t(sd["pe_layer.positional_encoding_gaussian_matrix"]),
           "point_embeddings": torch.cat(
               [t(sd[f"point_embeddings.{i}.weight"]) for i in range(4)], 0),
           "not_a_point_embed": t(sd["not_a_point_embed.weight"])[0],
           "no_mask_embed": t(sd["no_mask_embed.weight"])[0]}
    for dst, src in (("mask_down_0", "0"), ("mask_norm_0", "1"),
                     ("mask_down_1", "3"), ("mask_norm_1", "4"),
                     ("mask_proj", "6")):
        for leaf in ("weight", "bias"):
            out[f"{dst}.{leaf}"] = t(sd[f"mask_downscaling.{src}.{leaf}"])
    return out


class InteractiveSegmenter(nn.Module):
    """Trunk encode + prompt encode + SAM decode (the model stack behind
    the interactive image predictor; a ``vitdet`` trunk is ViT-Det 1024 ×
    32, as skix's)."""

    def __init__(self, features: int = 64, trunk: str = "conv",
                 img_size: int = 512, num_heads: int = 8):
        super().__init__()
        from skix_torch.tracking.memory_tracker import ImageEncoder
        from skix_torch.tracking.sam_decoder import SamMaskDecoder

        self.img_size = img_size
        self.encoder = ImageEncoder(features, trunk)
        self.prompt_encoder = SamPromptEncoder(features,
                                               input_image_size=img_size)
        self.decoder = SamMaskDecoder(transformer_dim=features,
                                      num_heads=num_heads)

    def init_weights(self, generator=None):
        """Random weights in flax's init distributions (a ``vitdet``
        trunk's position table normal(0.02))."""
        init_like_flax(self, generator)
        self.prompt_encoder.init_weights(generator)
        self.decoder.init_weights(generator)
        if self.encoder.trunk == "vitdet":
            with torch.no_grad():
                self.encoder.vitdet.pos_embed.normal_(0.0, 0.02,
                                                      generator=generator)
        return self

    def encode_image(self, image):
        """``image (B, H, W, 3)`` in [0, 1] → ``(B, h, w, C)``."""
        return self.encoder(image)

    def predict_from_embedding(self, feats, points, labels, boxes=None,
                               mask_in=None, multimask_output: bool = True):
        h, w = feats.shape[1], feats.shape[2]
        sparse, dense, img_pe = self.prompt_encoder((h, w), points, labels,
                                                    boxes, mask_in)
        return self.decoder(feats + dense, image_pe=img_pe[None],
                            prompt_tokens=sparse,
                            multimask_output=multimask_output)

    def forward(self, image, points, labels):
        return self.predict_from_embedding(self.encode_image(image), points,
                                           labels)


class SamImagePredictor:
    """The reference's interactive API: ``set_image`` → repeated
    ``predict`` calls against the cached embedding → ``reset_predictor``.
    """

    def __init__(self, model: InteractiveSegmenter, max_points: int = 8):
        self.model = model
        self.max_points = int(max_points)
        self.device = next(model.parameters()).device
        self._feats = None
        self._orig_hw = None

    @torch.no_grad()
    def set_image(self, image: np.ndarray) -> None:
        """``image (H, W, 3)`` uint8 or float; resized to the model square
        (jax's antialiased bilinear)."""
        img = np.asarray(image)
        self._orig_hw = img.shape[:2]
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        s = self.model.img_size
        x = resize(torch.as_tensor(img, dtype=torch.float32,
                                   device=self.device), (s, s, 3))
        self._feats = self.model.encode_image(x[None])

    def get_image_embedding(self):
        if self._feats is None:
            raise RuntimeError("call set_image first")
        return self._feats

    @torch.no_grad()
    def predict(self, point_coords, point_labels, box=None,
                multimask_output: bool = True):
        """``point_coords (P, 2)`` in original-image pixels, ``point_labels
        (P,)`` 1 = foreground / 0 = background (None: box only); ``box``
        optional (4,) xyxy in original pixels. Returns (masks (M, H, W) bool
        at the original size, iou_pred (M,), the low-resolution logits)."""
        if self._feats is None:
            raise RuntimeError("call set_image first")
        H, W = self._orig_hw
        s = self.model.img_size
        if point_coords is None:
            point_coords = np.zeros((0, 2), np.float32)
            point_labels = np.zeros((0,), np.int32)
        pts = np.asarray(point_coords, np.float32).reshape(-1, 2).copy()
        if len(pts):
            pts[:, 0] *= s / W
            pts[:, 1] *= s / H
        lab = np.asarray(point_labels, np.int32).reshape(-1)
        pad = self.max_points - len(lab)
        if pad < 0:
            raise ValueError(f"at most {self.max_points} points")
        pts = np.pad(pts, ((0, pad), (0, 0)))
        lab = np.pad(lab, (0, pad), constant_values=-1)
        boxes = None
        if box is not None:
            bx = np.asarray(box, np.float32).reshape(4).copy()
            bx[0::2] *= s / W
            bx[1::2] *= s / H
            boxes = torch.as_tensor(bx, device=self.device)[None]
        out = self.model.predict_from_embedding(
            self._feats, torch.as_tensor(pts, device=self.device)[None],
            torch.as_tensor(lab, device=self.device)[None], boxes,
            multimask_output=bool(multimask_output))
        logits = (out.all_mask_logits if multimask_output
                  else out.mask_logits[:, None])
        masks = (resize(logits, (*logits.shape[:2], H, W))[0] > 0.0
                 ).cpu().numpy()
        return masks, out.iou_pred[0].cpu().numpy(), logits[0].cpu().numpy()

    def reset_predictor(self) -> None:
        self._feats = None
        self._orig_hw = None
