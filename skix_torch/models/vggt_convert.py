"""VGGT reference checkpoint → the port's modules.

Port of ``skix/models/vggt_convert.py``, numpy only: maps the reference/
Meta VGGT state-dict names (aggregator, camera head, DPT heads, the DINOv2
patch-embed tower, the track head) onto skix's flax variables tree, the
same tree skix's converters build; ``skix_torch.convert.flax_to_state_dict``
turns that tree into the port module's ``state_dict`` (:func:`load_vggt`,
:func:`load_track_head`).
"""

from __future__ import annotations

import numpy as np

__all__ = ["convert_vggt_reference_state_dict", "convert_vggt_full",
           "convert_track_head", "convert_dinov2_backbone", "load_vggt",
           "load_track_head"]


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _lin(sd, prefix):
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _ln(sd, prefix):
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def _conv(sd, prefix):
    out = {"kernel": _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _block(sd, prefix):
    """Reference Block (layers/block.py) → the ``Block`` tree."""
    blk = {
        "norm1": _ln(sd, f"{prefix}.norm1"),
        "attn": {
            "qkv": _lin(sd, f"{prefix}.attn.qkv"),
            "proj": _lin(sd, f"{prefix}.attn.proj"),
        },
        "norm2": _ln(sd, f"{prefix}.norm2"),
        "mlp": {"fc1": _lin(sd, f"{prefix}.mlp.fc1"),
                "fc2": _lin(sd, f"{prefix}.mlp.fc2")},
    }
    if f"{prefix}.attn.q_norm.weight" in sd:
        blk["attn"]["q_norm"] = _ln(sd, f"{prefix}.attn.q_norm")
        blk["attn"]["k_norm"] = _ln(sd, f"{prefix}.attn.k_norm")
    if f"{prefix}.ls1.gamma" in sd:
        blk["ls1"] = {"gamma": _np(sd[f"{prefix}.ls1.gamma"])}
        blk["ls2"] = {"gamma": _np(sd[f"{prefix}.ls2.gamma"])}
    return blk


def convert_aggregator(sd, depth: int, prefix: str = "") -> dict:
    p: dict = {}
    p["camera_token"] = _np(sd[f"{prefix}camera_token"])
    p["register_token"] = _np(sd[f"{prefix}register_token"])
    if f"{prefix}patch_embed.proj.weight" in sd:
        p["patch_embed"] = {"proj": _conv(sd, f"{prefix}patch_embed.proj")}
    for i in range(depth):
        p[f"frame_block_{i}"] = _block(sd, f"{prefix}frame_blocks.{i}")
        p[f"global_block_{i}"] = _block(sd, f"{prefix}global_blocks.{i}")
    return p


def convert_camera_head(sd, trunk_depth: int, prefix: str = "camera_head.") -> dict:
    p: dict = {
        "token_norm": _ln(sd, f"{prefix}token_norm"),
        "trunk_norm": _ln(sd, f"{prefix}trunk_norm"),
        "empty_pose_tokens": _np(sd[f"{prefix}empty_pose_tokens"]),
        "embed_pose": _lin(sd, f"{prefix}embed_pose"),
        # reference poseLN_modulation = Sequential(SiLU, Linear) → index 1
        "poseLN_modulation": _lin(sd, f"{prefix}poseLN_modulation.1"),
        "pose_branch": {"fc1": _lin(sd, f"{prefix}pose_branch.fc1"),
                        "fc2": _lin(sd, f"{prefix}pose_branch.fc2")},
    }
    for i in range(trunk_depth):
        p[f"trunk_{i}"] = _block(sd, f"{prefix}trunk.{i}")
    return p


def convert_dinov2_backbone(sd, depth: int, prefix: str = "") -> dict:
    """DINOv2 ``DinoVisionTransformer`` state dict (the real VGGT-1B patch
    embed, reference layers/vision_transformer.py:42 with registers) →
    the ``VisionTransformer`` tree (VGGT's ``vit`` patch embed, SAM3DBody's
    ``dino`` backbone, MoGe's trunk)."""
    p: dict = {
        "cls_token": _np(sd[f"{prefix}cls_token"]),
        "register_tokens": _np(sd[f"{prefix}register_tokens"]),
        "pos_embed": _np(sd[f"{prefix}pos_embed"]),
        "patch_embed": {"proj": _conv(sd, f"{prefix}patch_embed.proj")},
        "norm": _ln(sd, f"{prefix}norm"),
    }
    for i in range(depth):
        p[f"block_{i}"] = _block(sd, f"{prefix}blocks.{i}")
    return p


def _convert_dpt(sd, head: str, feature_only: bool = False) -> dict:
    """One reference DPTHead (dpt_head.py) → the ``DPTHead`` tree. The
    reference shares one pre-projection LayerNorm across taps
    (dpt_head.py:66) which maps onto each per-tap ``norm_{i}`` here.
    ``feature_only`` heads (the track feature extractor) have no
    output_conv2."""
    hp: dict = {}
    for i in range(4):
        hp[f"norm_{i}"] = _ln(sd, f"{head}.norm")
        hp[f"project_{i}"] = _conv(sd, f"{head}.projects.{i}")
        if i != 2:
            key = f"{head}.resize_layers.{i}"
            w = _np(sd[f"{key}.weight"])
            if i < 2:
                # torch ConvTranspose2d (in, out, kh, kw) → flax
                # (kh, kw, in, out) SPATIALLY FLIPPED (lax.conv_transpose
                # does not mirror the kernel; torch does)
                hp[f"resize_{i}"] = {
                    "kernel": w.transpose(2, 3, 0, 1)[::-1, ::-1].copy()}
            else:
                hp[f"resize_{i}"] = {"kernel": w.transpose(2, 3, 1, 0)}
            if f"{key}.bias" in sd:
                hp[f"resize_{i}"]["bias"] = _np(sd[f"{key}.bias"])
        hp[f"scratch_{i}"] = _conv(sd, f"{head}.scratch.layer{i + 1}_rn")
    for j, name in ((4, "refine4"), (3, "refine3"), (2, "refine2"),
                    (1, "refine1")):
        pref = f"{head}.scratch.refinenet{j}"
        blk = {"out_conv": _conv(sd, f"{pref}.out_conv")}
        for ours, theirs in (("res_unit1", "resConfUnit1"),
                             ("res_unit2", "resConfUnit2")):
            if f"{pref}.{theirs}.conv1.weight" in sd:
                blk[f"{ours}_conv1"] = _conv(sd, f"{pref}.{theirs}.conv1")
                blk[f"{ours}_conv2"] = _conv(sd, f"{pref}.{theirs}.conv2")
        hp[name] = blk
    hp["out_conv1"] = _conv(sd, f"{head}.scratch.output_conv1")
    if not feature_only:
        hp["out_conv2a"] = _conv(sd, f"{head}.scratch.output_conv2.0")
        hp["out_conv2b"] = _conv(sd, f"{head}.scratch.output_conv2.2")
    return hp


def _mha(sd, prefix):
    """torch nn.MultiheadAttention → ``TorchMHA`` (packed layout kept)."""
    return {
        "in_proj_weight": _np(sd[f"{prefix}.in_proj_weight"]),
        "in_proj_bias": _np(sd[f"{prefix}.in_proj_bias"]),
        "out_proj": _lin(sd, f"{prefix}.out_proj"),
    }


def _attn_block(sd, prefix):
    return {
        "norm1": _ln(sd, f"{prefix}.norm1"),
        "norm2": _ln(sd, f"{prefix}.norm2"),
        "attn": _mha(sd, f"{prefix}.attn"),
        "mlp": {"fc1": _lin(sd, f"{prefix}.mlp.fc1"),
                "fc2": _lin(sd, f"{prefix}.mlp.fc2")},
    }


def _cross_attn_block(sd, prefix):
    return {
        "norm1": _ln(sd, f"{prefix}.norm1"),
        "norm_context": _ln(sd, f"{prefix}.norm_context"),
        "norm2": _ln(sd, f"{prefix}.norm2"),
        "cross_attn": _mha(sd, f"{prefix}.cross_attn"),
        "mlp": {"fc1": _lin(sd, f"{prefix}.mlp.fc1"),
                "fc2": _lin(sd, f"{prefix}.mlp.fc2")},
    }


def convert_track_head(sd, prefix: str = "track_head.",
                       space_depth: int = 6, time_depth: int = 6) -> dict:
    """Reference TrackHead (track_head.py + track_modules/) → the
    ``TrackHead`` tree."""
    t = f"{prefix}tracker."
    uf: dict = {
        "input_norm": _ln(sd, f"{t}updateformer.input_norm"),
        "input_transform": _lin(sd, f"{t}updateformer.input_transform"),
        "output_norm": _ln(sd, f"{t}updateformer.output_norm"),
        "flow_head": _lin(sd, f"{t}updateformer.flow_head"),
        "virual_tracks": _np(sd[f"{t}updateformer.virual_tracks"]),
    }
    for i in range(time_depth):
        uf[f"time_blocks_{i}"] = _attn_block(
            sd, f"{t}updateformer.time_blocks.{i}")
    for j in range(space_depth):
        uf[f"space_virtual_blocks_{j}"] = _attn_block(
            sd, f"{t}updateformer.space_virtual_blocks.{j}")
        uf[f"space_point2virtual_blocks_{j}"] = _cross_attn_block(
            sd, f"{t}updateformer.space_point2virtual_blocks.{j}")
        uf[f"space_virtual2point_blocks_{j}"] = _cross_attn_block(
            sd, f"{t}updateformer.space_virtual2point_blocks.{j}")
    tracker: dict = {
        "corr_mlp": {"fc1": _lin(sd, f"{t}corr_mlp.fc1"),
                     "fc2": _lin(sd, f"{t}corr_mlp.fc2")},
        "query_ref_token": _np(sd[f"{t}query_ref_token"]),
        "updateformer": uf,
        "fmap_norm": _ln(sd, f"{t}fmap_norm"),
        "ffeat_norm": {"scale": _np(sd[f"{t}ffeat_norm.weight"]),
                       "bias": _np(sd[f"{t}ffeat_norm.bias"])},
        "ffeat_updater": _lin(sd, f"{t}ffeat_updater.0"),
        "vis_predictor": _lin(sd, f"{t}vis_predictor.0"),
    }
    if f"{t}conf_predictor.0.weight" in sd:
        tracker["conf_predictor"] = _lin(sd, f"{t}conf_predictor.0")
    return {
        "feature_extractor": _convert_dpt(
            sd, f"{prefix}feature_extractor", feature_only=True),
        "tracker": tracker,
    }


def convert_vggt_reference_state_dict(sd, depth: int = 24,
                                      trunk_depth: int = 4) -> dict:
    """Full-model conversion for ``VGGT`` (conv patch-embed configuration):
    ``{"params": tree}``. The track head converts separately
    (:func:`convert_track_head`, :func:`convert_vggt_full`)."""
    params: dict = {
        "aggregator": convert_aggregator(sd, depth, "aggregator."),
        "camera_head": convert_camera_head(sd, trunk_depth, "camera_head."),
    }
    for head in ("depth_head", "point_head"):
        if f"{head}.scratch.refinenet1.out_conv.weight" not in sd and \
           f"{head}.projects.0.weight" not in sd:
            continue
        params[head] = _convert_dpt(sd, head)
    return {"params": params}


def convert_vggt_full(sd, depth: int = 24, trunk_depth: int = 4):
    """A complete VGGT-1B state dict (aggregator, camera/depth/point heads,
    track head) → ``(vggt_variables, track_head_variables)``; every
    ``track_head.*`` key lands in the second tree (None without one)."""
    vggt_vars = convert_vggt_reference_state_dict(sd, depth, trunk_depth)
    track_vars = None
    if any(k.startswith("track_head.") for k in sd):
        track_vars = {"params": convert_track_head(sd)}
    return vggt_vars, track_vars


def load_vggt(model, sd, trunk_depth: int = 4) -> list:
    """Load a reference-layout VGGT state dict into the port's ``VGGT``
    (its ``depth`` from the model); returns the keys the model does not
    have (``load_into``)."""
    from skix_torch.convert import flax_to_state_dict, load_into

    return load_into(model, flax_to_state_dict(
        convert_vggt_reference_state_dict(sd, model.depth, trunk_depth)))


def load_track_head(head, sd, prefix: str = "track_head.") -> list:
    """Load a reference-layout track-head state dict into the port's
    ``TrackHead``."""
    from skix_torch.convert import flax_to_state_dict, load_into

    return load_into(head, flax_to_state_dict(
        {"params": convert_track_head(sd, prefix=prefix)}))
