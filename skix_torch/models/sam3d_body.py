"""SAM-3D-Body-family single-image 3D human estimator.

Port of ``skix/models/sam3d_body.py``: the top-down crop pipeline →
backbone (``vit_hmr``, the DINOv2-shaped ``dino`` or the DINOv3 trunk
``dinov3*``) → mask-prompt conditioning → promptable cross-attention
decoder with learnable init tokens → MHR parametric body head
(``skix_torch.models.mhr``) and perspective camera head, plus the hand
decoder branch with the wrist-angle refinement, and the batched estimator
that writes the per-frame outputs of ``prepare_side_results``.

Submodules carry skix's flax names, so ``skix_torch.convert`` maps a skix
variables tree onto the model leaf by leaf. The backbones' self-attention
runs through ``flash_attention`` (K1 on the card, at every sequence length:
skix's switch to plain XLA below its 1024 block is a TPU tiling choice);
the decoder's cross-attention is plain torch, as skix computes it outside
any Pallas kernel. The crop is ``jax.image.scale_and_translate(...,
"linear")`` with per-frame weight matrices
(``skix_torch.utils.image.scale_and_translate``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skix_torch.models import mhr
from skix_torch.models.layers import (Block, Conv, Dense, LayerNorm, Mlp,
                                      PatchConv, PatchEmbed, VisionTransformer,
                                      init_like_flax)
from skix_torch.utils.device import constant
from skix_torch.utils.image import scale_and_translate

MHR70_PARENTS = mhr.MHR70_PARENTS

# MHR-70 keypoint ids: wrists and hand chains
RIGHT_WRIST, LEFT_WRIST = 41, 62
RIGHT_HAND_KPTS = np.arange(21, 41)
LEFT_HAND_KPTS = np.arange(42, 62)
_WRISTS = np.array([LEFT_WRIST, RIGHT_WRIST])
# the head's identity global rot6d, and the body params it keeps (hands off)
_ROT6D_IDENTITY = np.array([1.0, 0, 0, 0, 1, 0], np.float32)
_BODY_KEEP = 1.0 - mhr.MHR_PARAM_HAND_MASK.astype(np.float32)


# --------------------------------------------------------------------------
# crop pipeline
# --------------------------------------------------------------------------
def bbox_center_scale(bbox_xyxy: torch.Tensor, padding: float = 1.25):
    """bbox ``(..., 4)`` → (center ``(..., 2)``, scale ``(..., 2)``): the
    square of the padded longer side."""
    b = bbox_xyxy
    c = torch.stack([(b[..., 0] + b[..., 2]) * 0.5,
                     (b[..., 1] + b[..., 3]) * 0.5], dim=-1)
    s = torch.stack([b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]],
                    dim=-1) * padding
    side = torch.amax(s, dim=-1, keepdim=True)
    return c, side.expand(s.shape)


def crop_resize(frames: torch.Tensor, centers: torch.Tensor,
                scales: torch.Tensor, out_size: int) -> torch.Tensor:
    """Affine crops of a batch: ``frames (B, H, W, C)`` float32, ``centers``
    and ``scales`` ``(B, 2)`` → ``(B, out, out, C)``, each row skix's
    ``crop_resize`` (``scale_and_translate`` with method linear)."""
    sx = out_size / scales[:, 0]
    sy = out_size / scales[:, 1]
    tx = out_size / 2.0 - centers[:, 0] * sx
    ty = out_size / 2.0 - centers[:, 1] * sy
    return scale_and_translate(frames, (out_size, out_size),
                               torch.stack([sy, sx], -1),
                               torch.stack([ty, tx], -1))


def crop_to_image_coords(pts_crop, center, scale, out_size: int):
    """Inverse of the crop mapping for 2D points ``(..., 2)`` (center and
    scale broadcast against them)."""
    return (pts_crop - out_size / 2.0) * (scale / out_size) + center


# --------------------------------------------------------------------------
# MHR head
# --------------------------------------------------------------------------
class MHRHeadOutputs(NamedTuple):
    keypoints_3d: torch.Tensor   # (B, 70, 3) meters, root-relative, y/z flip
    vertices: torch.Tensor       # (B, V, 3)
    joint_rots: torch.Tensor     # (B, J, 3, 3) world joint rotations
    global_rot: torch.Tensor     # (B, 3) euler zyx
    body_pose: torch.Tensor      # (B, 133) model params (hands/jaw zeroed)
    shape: torch.Tensor          # (B, 45)
    scale: torch.Tensor          # (B, 28)
    hand: torch.Tensor           # (B, 108) PCA params (left ‖ right)
    pred_pose_raw: torch.Tensor  # (B, 6 + 260) rot6d + cont pose


class MHRHead(nn.Module):
    """Pose token → the prediction (6 global rot6d + 260 body cont + 45
    shape + 28 scale + 2 × 54 hand PCA + 72 face) → MHR FK.
    ``rig_name``/``buffers_name`` name registered assets
    (``skix_torch.models.mhr`` registries)."""

    num_shape, num_scale, num_hand, body_cont = 45, 28, 54, 260
    npose = 6 + body_cont + num_shape + num_scale + 2 * num_hand + 72

    def __init__(self, input_dim: int = 256, rig_name: str = "default",
                 buffers_name: str = "default"):
        super().__init__()
        self.rig_name, self.buffers_name = rig_name, buffers_name
        self.proj_fc1 = Dense(input_dim, input_dim // 8)
        self.proj_fc2 = Dense(input_dim // 8, self.npose)

    def forward(self, x, hand_override=None):
        B = x.shape[0]
        dev = x.device
        rig = mhr.get_rig(self.rig_name)
        bufs = mhr.get_buffers(self.buffers_name)
        pred = self.proj_fc2(F.gelu(self.proj_fc1(x)))
        # zero-pose init: identity global rot6d + zero-pose body cont
        zero_cont = mhr.model_params_to_cont_body(x.new_zeros(133))
        pred = pred + torch.cat([constant(_ROT6D_IDENTITY, dev), zero_cont,
                                 x.new_zeros(self.npose - 6 - self.body_cont)])

        c = 6
        grot6 = pred[:, :c]
        grot_mat = mhr.rot6d_to_matrix_cols(grot6)
        global_rot = mhr.matrix_to_euler_zyx(grot_mat)
        rig_rot = (global_rot if rig.root_euler_order == "zyx"
                   else mhr.matrix_to_euler_xyz(grot_mat))
        body_cont = pred[:, c:c + self.body_cont]
        c += self.body_cont
        body_pose = mhr.cont_to_model_params_body(body_cont)
        # zero hands + jaw
        body_pose = body_pose * constant(_BODY_KEEP, x.device)
        body_pose[:, -3:] = 0.0
        shape = pred[:, c:c + self.num_shape]
        c += self.num_shape
        scale = pred[:, c:c + self.num_scale]
        c += self.num_scale
        hand = pred[:, c:c + 2 * self.num_hand]
        if hand_override is not None:
            hand = hand_override

        model_params = mhr.assemble_model_params(
            x.new_zeros((B, 3)), rig_rot, body_pose, hand, scale,
            constant(bufs.scale_mean, dev), constant(bufs.scale_comps, dev),
            hand_pose_mean=constant(bufs.hand_pose_mean, dev),
            hand_pose_comps=constant(bufs.hand_pose_comps, dev),
            hand_joint_idxs_left=constant(bufs.hand_joint_idxs_left, dev),
            hand_joint_idxs_right=constant(bufs.hand_joint_idxs_right, dev))
        out = mhr.rig_forward(rig, model_params)
        kpts = mhr.mhr_output_transform(out["keypoints"][..., :70, :])
        verts = mhr.mhr_output_transform(out["verts"])
        return MHRHeadOutputs(
            keypoints_3d=kpts, vertices=verts, joint_rots=out["joint_rots"],
            global_rot=global_rot, body_pose=body_pose, shape=shape,
            scale=scale, hand=hand,
            pred_pose_raw=torch.cat([grot6, body_cont], dim=-1))


# --------------------------------------------------------------------------
# decoder machinery
# --------------------------------------------------------------------------
class PromptEncoder(nn.Module):
    """Keypoint-prompt tokens: (x, y, label) → embed; invalid slots zero."""

    def __init__(self, embed_dim: int = 256):
        super().__init__()
        self.point_proj = Dense(3, embed_dim)
        self.label_embed = nn.Parameter(torch.zeros(2, embed_dim))

    def forward(self, prompts, prompt_valid):
        h = self.point_proj(prompts)
        lab = self.label_embed[torch.clamp(prompts[..., 2].to(torch.int32),
                                           0, 1).long()]
        h = h + lab
        return torch.where(prompt_valid[..., None], h, torch.zeros_like(h)), \
            prompt_valid


class MaskDownscaler(nn.Module):
    """SAM-style mask downscaling: Conv(1→4, k4 s4) → LayerNorm(C) →
    GELU → Conv(4→16, k4 s4) → LayerNorm(C) → GELU → Conv(16→embed, k1);
    16× down, channels-last; LayerNorm eps 1e-6, exact (erf) GELU."""

    def __init__(self, embed_dim: int = 384, mask_in_chans: int = 16):
        super().__init__()
        self.conv0 = PatchConv(1, mask_in_chans // 4, 4)
        self.ln0 = LayerNorm(mask_in_chans // 4, 1e-6)
        self.conv1 = PatchConv(mask_in_chans // 4, mask_in_chans, 4)
        self.ln1 = LayerNorm(mask_in_chans, 1e-6)
        self.conv2 = Conv(mask_in_chans, embed_dim, 1)

    def forward(self, mask):
        h = F.gelu(self.ln0(self.conv0(mask.to(torch.float32))))
        h = F.gelu(self.ln1(self.conv1(h)))
        return self.conv2(h)


def convert_mask_downscaling(sd, prefix: str = "mask_downscaling."):
    """Torch ``mask_downscaling`` Sequential state dict (numpy values) →
    skix's flax params for the mask encoder (Conv2d OIHW → HWIO; LayerNorm2d
    scale/bias 1:1); ``skix_torch.convert`` maps them onto
    :class:`MaskDownscaler`."""
    def conv(i):
        w = np.asarray(sd[f"{prefix}{i}.weight"])
        return {"kernel": np.transpose(w, (2, 3, 1, 0)),
                "bias": np.asarray(sd[f"{prefix}{i}.bias"])}

    def ln(i):
        return {"scale": np.asarray(sd[f"{prefix}{i}.weight"]),
                "bias": np.asarray(sd[f"{prefix}{i}.bias"])}

    return {"conv0": conv(0), "ln0": ln(1), "conv1": conv(3),
            "ln1": ln(4), "conv2": conv(6)}


class _MultiHeadDotProductAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (DenseGeneral ``query``,
    ``key``, ``value``, ``out``; q scaled by 1/√head_dim; f32 softmax)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = Dense(dim, dim)
        self.key = Dense(dim, dim)
        self.value = Dense(dim, dim)
        self.out = Dense(dim, dim)

    def forward(self, x_q, x_kv):
        B, Nq, C = x_q.shape
        Nk = x_kv.shape[1]
        H = self.num_heads
        hd = C // H
        q = self.query(x_q).reshape(B, Nq, H, hd) / math.sqrt(hd)
        k = self.key(x_kv).reshape(B, Nk, H, hd)
        v = self.value(x_kv).reshape(B, Nk, H, hd)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.out(o.reshape(B, Nq, C))


class CrossAttnBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.norm_q = LayerNorm(dim, 1e-6)
        self.norm_kv = LayerNorm(dim, 1e-6)
        self.cross_attn = _MultiHeadDotProductAttention(dim, num_heads)
        self.norm_mlp = LayerNorm(dim, 1e-6)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, q_tokens, kv_tokens):
        q_tokens = q_tokens + self.cross_attn(self.norm_q(q_tokens),
                                              self.norm_kv(kv_tokens))
        return q_tokens + self.mlp(self.norm_mlp(q_tokens))


class SAM3DBodyOutputs(NamedTuple):
    mhr: MHRHeadOutputs
    cam_t: torch.Tensor          # (B, 3) perspective translation
    joints_3d: torch.Tensor      # (B, 70, 3) camera-frame (root at cam_t)
    joints_2d_crop: torch.Tensor  # (B, 70, 2) in crop pixels
    vertices_3d: torch.Tensor    # (B, V, 3) camera-frame mesh


class SAM3DBody(nn.Module):
    """Backbone → promptable decoder → MHR head + camera head, with a
    hand-decoder branch. ``backbone``: ``"vit_hmr"`` (patch embed, learned
    positions, ``depth`` blocks), ``"dino"`` (the DINOv2-shaped
    :class:`VisionTransformer`), bare ``"dinov3"`` (:class:`Dinov3Trunk` at
    this module's widths and the ``backbone_*`` fields) or a name of
    ``DINOV3_VARIANTS``, whose published depth and heads it takes (its
    width must equal ``embed_dim``)."""

    def __init__(self, crop_size: int = 256, patch_size: int = 16,
                 embed_dim: int = 384, depth: int = 8, num_heads: int = 6,
                 decoder_depth: int = 4, decoder_dim: int = 256,
                 focal_length: float = 5000.0, rig_name: str = "default",
                 backbone: str = "vit_hmr", backbone_registers: int = 4,
                 backbone_ffn: str = "mlp", backbone_mlp_ratio: float = 4.0,
                 backbone_ffn_hidden: Optional[int] = None,
                 backbone_rope_min: Optional[float] = None,
                 backbone_rope_max: Optional[float] = None):
        super().__init__()
        self.crop_size, self.patch_size = crop_size, patch_size
        self.embed_dim, self.depth = embed_dim, depth
        self.decoder_depth, self.decoder_dim = decoder_depth, decoder_dim
        self.focal_length = focal_length
        self.backbone = backbone
        P = (crop_size // patch_size) ** 2
        if backbone.startswith("dinov3"):
            from skix_torch.models.dinov3 import DINOV3_VARIANTS, Dinov3Trunk

            kw = dict(patch_size=patch_size, embed_dim=embed_dim, depth=depth,
                      num_heads=num_heads,
                      n_storage_tokens=backbone_registers, ffn=backbone_ffn,
                      ffn_hidden=backbone_ffn_hidden,
                      mlp_ratio=backbone_mlp_ratio)
            if backbone_rope_min is not None:
                kw.update(rope_base=None, rope_min_period=backbone_rope_min,
                          rope_max_period=backbone_rope_max)
            if backbone in DINOV3_VARIANTS:
                var = dict(DINOV3_VARIANTS[backbone])
                if var["embed_dim"] != embed_dim:
                    raise ValueError(
                        f"{backbone} is a {var['embed_dim']}-dim trunk; set "
                        f"SAM3DBody embed_dim to match (got {embed_dim})")
                kw.update(var)
            elif backbone != "dinov3":
                raise ValueError(
                    f"unknown dinov3 variant {backbone!r}; known: "
                    f"{sorted(DINOV3_VARIANTS)} or bare 'dinov3'")
            self.dino_backbone = Dinov3Trunk(**kw)
        elif backbone.startswith("dino"):
            self.dino_backbone = VisionTransformer(
                patch_size=patch_size, embed_dim=embed_dim, depth=depth,
                num_heads=num_heads, num_register_tokens=backbone_registers,
                num_patches=P)
        else:
            self.patch_embed = PatchEmbed(patch_size, embed_dim)
            self.pos_embed = nn.Parameter(torch.zeros(1, P, embed_dim))
            for i in range(depth):
                setattr(self, f"block_{i}", Block(embed_dim, num_heads, 4.0))
            self.backbone_norm = LayerNorm(embed_dim, 1e-6)
        self.mask_prompt = MaskDownscaler(embed_dim)
        self.no_mask_embed = nn.Parameter(torch.zeros(embed_dim))
        self.kv_proj = Dense(embed_dim, decoder_dim)
        self.init_tokens = nn.Parameter(torch.zeros(1, 2, decoder_dim))
        self.hand_init_tokens = nn.Parameter(torch.zeros(1, 2, decoder_dim))
        self.prompt_encoder = PromptEncoder(decoder_dim)
        for i in range(decoder_depth):
            setattr(self, f"decoder_{i}", CrossAttnBlock(decoder_dim, 8))
        self.decoder_norm = LayerNorm(decoder_dim, 1e-6)
        self.head_pose = MHRHead(decoder_dim, rig_name=rig_name)
        self.head_hand = MHRHead(decoder_dim, rig_name=rig_name)
        self.camera_head = Mlp(decoder_dim, decoder_dim, 3)

    def init_weights(self, generator=None):
        """flax's initializers (skix's smoke-mode random init, in
        distribution): LeCun-normal kernels, zero biases, unit LayerNorms,
        N(0, 0.02²) tokens and tables, the backbones' own token and
        LayerScale rules."""
        init_like_flax(self, generator)
        with torch.no_grad():
            for p in (self.no_mask_embed, self.init_tokens,
                      self.hand_init_tokens, self.prompt_encoder.label_embed,
                      getattr(self, "pos_embed", None)):
                if p is not None:
                    p.normal_(0.0, 0.02, generator=generator)
        if hasattr(self, "dino_backbone"):
            self.dino_backbone.init_weights(generator)
        return self

    def _backbone(self, x):
        if hasattr(self, "dino_backbone"):
            return self.dino_backbone(x)
        tokens = self.patch_embed(x) + self.pos_embed
        for i in range(self.depth):
            tokens = getattr(self, f"block_{i}")(tokens)
        return self.backbone_norm(tokens)

    def forward(self, crops, prompts=None, prompt_valid=None,
                decoder_type: str = "body", hand_override=None, mask=None,
                mask_score=None) -> SAM3DBodyOutputs:
        """``crops (B, S, S, 3)`` in [0, 1] → :class:`SAM3DBodyOutputs`.

        ``decoder_type="hand"`` runs the hand-decoder queries (same
        backbone, their own init tokens and head). ``mask (B, S, S, 1)``, a
        crop-aligned person mask, and ``mask_score (B,)`` condition the
        image tokens: ``where(score > 0, score·emb, no_mask_embed)`` is
        added to them; a given mask defaults to score 1, no mask to score 0
        (every row then takes ``no_mask_embed``, and the mask encoder's
        output is not needed)."""
        B = crops.shape[0]
        tokens = self._backbone((crops - 0.5) / 0.5)

        if mask is None:
            gated = self.no_mask_embed.expand(B, 1, self.embed_dim)
        else:
            if mask_score is None:
                mask_score = crops.new_ones((B,))
            memb = self.mask_prompt(mask).reshape(B, -1, self.embed_dim)
            score = mask_score[:, None, None]
            gated = torch.where(score > 0, score * memb,
                                self.no_mask_embed[None, None, :])
        kv = self.kv_proj(tokens + gated)
        init = self.init_tokens if decoder_type == "body" \
            else self.hand_init_tokens
        q = init.expand(B, 2, self.decoder_dim)
        if prompts is not None:
            pe, _ = self.prompt_encoder(prompts, prompt_valid)
            kv = torch.cat([kv, pe], dim=1)
        for i in range(self.decoder_depth):
            q = getattr(self, f"decoder_{i}")(q, kv)
        q = self.decoder_norm(q)
        pose_tok, cam_tok = q[:, 0], q[:, 1]

        head = self.head_pose if decoder_type == "body" else self.head_hand
        mhr_out = head(pose_tok, hand_override=hand_override)

        cam = self.camera_head(cam_tok)
        cam_t = torch.stack([cam[..., 0], cam[..., 1],
                             2.0 * torch.exp(cam[..., 2] * 0.5) + 0.5], dim=-1)
        joints_cam = mhr_out.keypoints_3d + cam_t[:, None, :]
        verts_cam = mhr_out.vertices + cam_t[:, None, :]
        z = torch.clamp(joints_cam[..., 2:3], min=1e-3)
        joints_2d = (joints_cam[..., :2] / z * self.focal_length
                     + self.crop_size / 2.0)
        return SAM3DBodyOutputs(mhr=mhr_out, cam_t=cam_t,
                                joints_3d=joints_cam,
                                joints_2d_crop=joints_2d,
                                vertices_3d=verts_cam)


# --------------------------------------------------------------------------
# hand refinement
# --------------------------------------------------------------------------
def hand_boxes_from_keypoints(joints_2d, pad: float = 1.6,
                              min_side: float = 24.0):
    """Square hand boxes around the predicted hand keypoints: ``joints_2d
    (B, 70, 2)`` → (left_xyxy (B, 4), right_xyxy (B, 4))."""

    def box(kpts, wrist):
        pts = torch.cat([kpts, wrist[:, None]], dim=1)
        lo = torch.amin(pts, dim=1)
        hi = torch.amax(pts, dim=1)
        cen = 0.5 * (lo + hi)
        side = torch.clamp(torch.amax(hi - lo, dim=-1), min=min_side) * pad
        return torch.cat([cen - side[:, None] / 2, cen + side[:, None] / 2],
                         dim=-1)

    dev = joints_2d.device
    left = box(joints_2d[:, constant(LEFT_HAND_KPTS, dev)],
               joints_2d[:, LEFT_WRIST])
    right = box(joints_2d[:, constant(RIGHT_HAND_KPTS, dev)],
                joints_2d[:, RIGHT_WRIST])
    return left, right


def wrist_angle_gate(body_rots, hand_rots, wrist_joints=None,
                     thresh: float = 1.4):
    """Accept the hand branch's pose only where its global wrist rotation is
    within ``thresh`` rad of the body branch's: (B, 2) bool for (left,
    right); ``wrist_joints`` (left, right) defaults to MHR-70's wrists."""
    dev = body_rots.device
    idx = (constant(_WRISTS, dev) if wrist_joints is None
           else torch.as_tensor(wrist_joints, device=dev))
    diff = mhr.rotation_angle_difference(body_rots[:, idx], hand_rots[:, idx])
    return diff < thresh


def refine_hands_params(body_hand, hand_branch_hand, accept_left,
                        accept_right):
    """Hand PCA params: the hand branch's where accepted, else the body's."""
    nh = mhr.NUM_HAND_CONT
    left = torch.where(accept_left[:, None], hand_branch_hand[:, :nh],
                       body_hand[:, :nh])
    right = torch.where(accept_right[:, None], hand_branch_hand[:, nh:],
                        body_hand[:, nh:])
    return torch.cat([left, right], dim=-1)


# --------------------------------------------------------------------------
# estimator (top-down crop pipeline, batched)
# --------------------------------------------------------------------------
# parameters a checkpoint may lack: skix grafts the hand decoder and the
# mask encoder from a fresh init when either is missing; the prompt
# encoder exists only in trees that were called with prompts
_GRAFT_TRIGGERS = ("hand_init_tokens", "mask_prompt.")
_ALWAYS_GRAFTABLE = ("prompt_encoder.",)


class SAM3DBodyEstimator:
    """Frames + per-frame bboxes → per-frame MHR-70 outputs, batched over
    the clip. ``inference_type="full"`` adds the hand branch with the
    wrist-angle and box-size gates; ``"body"`` is body only.

    The model gets the seeded init of :meth:`SAM3DBody.init_weights` (a
    ``torch.Generator`` on ``device`` seeded with 0); a
    ``state_dict`` (the port's names, e.g. ``convert.flax_to_state_dict`` of
    a skix checkpoint) then replaces it. A state dict without the hand
    decoder or the mask encoder keeps the init's (skix grafts them from its
    own init, so the numbers of those branches differ); any other missing
    parameter raises."""

    thresh_wrist_angle = 1.4
    hand_box_min_px = 64.0

    def __init__(self, model: SAM3DBody, state_dict=None, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.model.init_weights(
            torch.Generator(device=self.device).manual_seed(0))
        if state_dict is not None:
            missing, _ = self.model.load_state_dict(dict(state_dict),
                                                    strict=False)
            graft = any(k.startswith(_GRAFT_TRIGGERS) for k in missing)
            bad = [k for k in missing if not graft
                   and not k.startswith(_ALWAYS_GRAFTABLE)]
            if bad:
                raise KeyError(f"SAM3DBody checkpoint lacks {len(bad)} "
                               f"parameters, e.g. {bad[:5]}")

    def _forward_batch(self, frames, centers, scales, full: bool,
                       masks=None, mask_scores=None):
        size = self.model.crop_size
        model = self.model
        crops = crop_resize(frames, centers, scales, size)
        mask_crops = None
        if masks is not None:
            # the person mask takes the image's affine; it conditions the
            # body passes, the hand crops run unconditioned
            mask_crops = crop_resize(masks, centers, scales, size)
        out = model(crops, mask=mask_crops, mask_score=mask_scores)
        if full:
            # hand branch on hand-centered crops cut from the ORIGINAL frames;
            # the box-size gate measures original-image pixels
            lbox, rbox = hand_boxes_from_keypoints(out.joints_2d_crop)

            def run_hand(box_crop):
                tl = crop_to_image_coords(box_crop[:, :2], centers, scales,
                                          size)
                br = crop_to_image_coords(box_crop[:, 2:], centers, scales,
                                          size)
                c, s = bbox_center_scale(torch.cat([tl, br], dim=-1),
                                         padding=0.9)
                hc = crop_resize(frames, c, s, size)
                return model(hc, decoder_type="hand"), s[:, 0]

            lout, lside = run_hand(lbox)
            rout, rside = run_hand(rbox)
            gate = wrist_angle_gate(out.mhr.joint_rots, lout.mhr.joint_rots,
                                    thresh=self.thresh_wrist_angle)
            gate_r = wrist_angle_gate(out.mhr.joint_rots, rout.mhr.joint_rots,
                                      thresh=self.thresh_wrist_angle)
            ok_l = gate[:, 0] & (lside > self.hand_box_min_px)
            ok_r = gate_r[:, 1] & (rside > self.hand_box_min_px)
            nh = mhr.NUM_HAND_CONT
            branch_hand = torch.cat([lout.mhr.hand[:, :nh],
                                     rout.mhr.hand[:, nh:]], dim=-1)
            hand = refine_hands_params(out.mhr.hand, branch_hand, ok_l, ok_r)
            out = model(crops, hand_override=hand, mask=mask_crops,
                        mask_score=mask_scores)
        k2 = crop_to_image_coords(out.joints_2d_crop, centers[:, None],
                                  scales[:, None], size)
        return out, k2

    @torch.no_grad()
    def process_clip(self, frames_u8: np.ndarray, bboxes_xyxy: np.ndarray,
                     batch_size: int = 8, image_focal=None,
                     inference_type: str = "body", masks=None,
                     mask_scores=None) -> list:
        """``frames (T, H, W, 3) uint8``, ``bboxes (T, 4)`` → per-frame
        output dicts (the npz schema, mesh vertices included).

        ``image_focal``: None (crop focal × scale), a scalar, or a per-frame
        ``(T,)`` array; the camera translation is re-expressed under it
        (tz scaled by the focal ratio) so the saved focal and ``pred_cam_t``
        reproject alike. ``masks``: per-frame person masks ``(T, H, W)``,
        ``(T, 1, H, W)`` or ``(T, H, W, 1)``, score 1 unless ``mask_scores
        (T,)`` says otherwise. A short last batch is padded with zero frames
        of scale 1. One device→host copy per batch."""
        T = frames_u8.shape[0]
        dev = self.device
        masks_f = scores_f = None
        if masks is not None:
            m = np.asarray(masks)
            if m.ndim == 4 and m.shape[1] == 1:      # (T,1,H,W) contract
                m = m[:, 0]
            if m.ndim == 4:                           # (T,H,W,1)
                m = m[..., 0]
            masks_f = (m > 0).astype(np.float32)[..., None]
            scores_f = (np.ones((T,), np.float32) if mask_scores is None
                        else np.broadcast_to(
                            np.asarray(mask_scores, np.float32).reshape(-1),
                            (T,)).astype(np.float32))
        focal_arr = None
        if image_focal is not None:
            focal_arr = np.broadcast_to(
                np.asarray(image_focal, np.float32).reshape(-1), (T,))
        centers, scales = bbox_center_scale(torch.as_tensor(
            np.asarray(bboxes_xyxy, np.float32), device=dev))
        full = inference_type == "full"
        results = []
        for s in range(0, T, batch_size):
            e = min(s + batch_size, T)
            n = e - s
            pad = batch_size - n
            fr = torch.from_numpy(np.ascontiguousarray(frames_u8[s:e])).to(
                dev).to(torch.float32) / 255.0
            c, sc = centers[s:e], scales[s:e]
            mk = sf = None
            if masks_f is not None:
                mk = torch.from_numpy(masks_f[s:e]).to(dev)
                sf = torch.from_numpy(scores_f[s:e]).to(dev)
            if pad:
                fr = F.pad(fr, (0, 0, 0, 0, 0, 0, 0, pad))
                c = F.pad(c, (0, 0, 0, pad))
                sc = F.pad(sc, (0, 0, 0, pad), value=1.0)
                if mk is not None:
                    mk = F.pad(mk, (0, 0, 0, 0, 0, 0, 0, pad))
                    sf = F.pad(sf, (0, pad))
            out, k2 = self._forward_batch(fr, c, sc, full, mk, sf)
            host = _to_host({
                "cam_t": out.cam_t, "j3": out.joints_3d,
                "v3": out.vertices_3d, "k2": k2, "rots": out.mhr.joint_rots,
                "body": out.mhr.body_pose, "hand": out.mhr.hand,
                "scale": out.mhr.scale, "shape": out.mhr.shape, "sc": sc})
            # focal in original-image pixels (crop focal × scale ratio)
            f_img = (host["sc"][:n, 0] / self.model.crop_size
                     * self.model.focal_length)
            for i in range(n):
                cam_t = host["cam_t"][i]
                j3 = host["j3"][i]
                v3 = host["v3"][i]
                if focal_arr is not None:
                    ratio = (float(focal_arr[s + i])
                             / max(float(f_img[i]), 1e-6))
                    delta = np.array([0.0, 0.0, cam_t[2] * (ratio - 1.0)],
                                     np.float32)
                    cam_t = cam_t + delta
                    j3 = j3 + delta
                    v3 = v3 + delta
                results.append({
                    "pred_keypoints_2d": host["k2"][i],
                    "pred_keypoints_3d": j3,
                    "pred_vertices": v3,
                    "pred_cam_t": cam_t,
                    "focal_length": np.asarray(
                        focal_arr[s + i] if focal_arr is not None
                        else f_img[i]),
                    "bbox": np.asarray(bboxes_xyxy[s + i]),
                    "pred_global_rots": host["rots"][i],
                    "body_pose_params": host["body"][i],
                    "hand_pose_params": host["hand"][i],
                    "scale_params": host["scale"][i],
                    "shape_params": host["shape"][i],
                })
        return results


def _to_host(tensors: dict) -> dict:
    """float32 tensors of one device → numpy arrays of the same shapes, in
    one device→host copy (flattened and concatenated on the device)."""
    names = list(tensors)
    flat = torch.cat([tensors[k].reshape(-1).to(torch.float32)
                      for k in names]).cpu().numpy()
    out, o = {}, 0
    for k in names:
        n = tensors[k].numel()
        out[k] = flat[o:o + n].reshape(tuple(tensors[k].shape))
        o += n
    return out


def select_closest_person(outputs: Sequence[dict],
                          previous_person: Optional[dict] = None,
                          continuity_weight: float = 0.5) -> Optional[dict]:
    """Athlete pick among candidates: nearest camera depth, biased toward
    temporal continuity with the previous frame's pick."""
    if not outputs:
        return None
    scores = []
    for out in outputs:
        cam_t = np.asarray(out.get("pred_cam_t", [np.inf] * 3)).reshape(-1)
        depth = float(cam_t[2]) if cam_t.size >= 3 and np.isfinite(cam_t[2]) \
            else np.inf
        cont = 0.0
        if previous_person is not None:
            prev_t = np.asarray(previous_person.get("pred_cam_t",
                                                    cam_t)).reshape(-1)
            cont = float(np.linalg.norm(cam_t[:3] - prev_t[:3]))
        scores.append(depth + continuity_weight * cont)
    return outputs[int(np.argmin(scores))]
