"""skix_torch's reference-checkpoint converters against skix's.

Each converter reads a random state dict in the reference (Meta VGGT,
DINOv2, VGGSfM track head) layout, made here from the port module's own
parameter list by the reference's names; the port's tree must equal
skix's leaf for leaf, and load into the port's module through
``skix_torch.convert``. A VGGT with the DINOv2 patch embed, loaded from a
converted reference state dict, then matches skix's on the same tree (f32
1e-4; bf16 6e-2, a few bf16 steps); ``convert_moge_backbone`` goes through
the same DINOv2 seam.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_parity import close_scaled, jit0

from skix_torch.convert import flax_to_state_dict, flatten_tree, load_into

rng = np.random.default_rng(4242)
SIZE, EMBED, HEADS = 28, 32, 2

# the port's parameter names → the reference's, in order
_BLOCKS = [(r"frame_block_(\d+)", r"frame_blocks.\1"),
           (r"global_block_(\d+)", r"global_blocks.\1"),
           (r"(?<!\w)block_(\d+)", r"blocks.\1"),
           (r"trunk_(\d+)", r"trunk.\1"),
           (r"poseLN_modulation", "poseLN_modulation.1")]
_DPT = [(r"norm_\d", "norm"), (r"project_(\d)", r"projects.\1"),
        (r"resize_(\d)", r"resize_layers.\1"),
        (r"scratch_(\d)", lambda m: f"scratch.layer{int(m[1]) + 1}_rn"),
        (r"refine(\d)\.res_unit(\d)_conv(\d)",
         r"scratch.refinenet\1.resConfUnit\2.conv\3"),
        (r"refine(\d)\.out_conv", r"scratch.refinenet\1.out_conv"),
        (r"out_conv1", "scratch.output_conv1"),
        (r"out_conv2a", "scratch.output_conv2.0"),
        (r"out_conv2b", "scratch.output_conv2.2")]
_TRACKER = [(r"(time_blocks|space_virtual_blocks|space_point2virtual_blocks"
             r"|space_virtual2point_blocks)_(\d+)", r"\1.\2"),
            (r"(ffeat_updater|vis_predictor|conf_predictor)\.", r"\1.0.")]


def _reference_name(key: str) -> str:
    rules = list(_BLOCKS)
    if "tracker." in key:
        rules += _TRACKER
    elif re.search(r"(depth_head|point_head|feature_extractor)\.", key):
        rules += _DPT
    for pat, rep in rules:
        key = re.sub(pat, rep, key)
    return key


def reference_state_dict(module, prefix=""):
    """A random state dict of ``module``'s parameters under the reference's
    names (a ConvTranspose weight in torch's (in, out, kh, kw) order; the
    DPT's per-tap norms are one shared reference norm)."""
    sd = {}
    for key, p in module.state_dict().items():
        name = prefix + _reference_name(key)
        shape = tuple(p.shape)
        if re.search(r"resize_layers\.[01]\.weight$", name):
            shape = (shape[1], shape[0], *shape[2:])
        if name not in sd:
            a = rng.normal(size=shape) / np.sqrt(max(1, np.prod(shape[1:])))
            if name.endswith(("norm.weight", "norm1.weight", "norm2.weight")):
                a = 1.0 + 0.05 * a
            sd[name] = torch.as_tensor(a.astype(np.float32))
    return sd


def _same_tree(got, want):
    g, w = flatten_tree(got), flatten_tree(jax.tree.map(np.asarray, want))
    assert g.keys() == w.keys()
    for k in g:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _vggt(**kw):
    from skix_torch.models.vggt import VGGT

    return VGGT(img_size=SIZE, embed_dim=EMBED, depth=2, num_heads=HEADS,
                intermediate_layer_idx=(0, 1, 1, 1), **kw)


def test_convert_vggt_full_and_parts():
    """``convert_aggregator``, ``convert_camera_head``, ``_convert_dpt``
    (both heads) and ``convert_track_head`` through ``convert_vggt_full``
    on one VGGT-1B-layout state dict (aggregator, camera, depth and point
    heads, track head): trees equal to skix's, every leaf loaded."""
    from skix.models import vggt_convert as S
    from skix_torch.models import vggt_convert as T
    from skix_torch.models.track_head import TrackHead

    model = _vggt()
    head = TrackHead(dim_in=2 * EMBED, features=16, hidden_size=32,
                     img_hw=(SIZE, SIZE))
    sd = reference_state_dict(model)
    sd.update(reference_state_dict(head, "track_head."))
    got_v, got_t = T.convert_vggt_full(sd, depth=2)
    want_v, want_t = S.convert_vggt_full(sd, depth=2)
    _same_tree(got_v, want_v)
    _same_tree(got_t, want_t)
    assert load_into(model, flax_to_state_dict(got_v)) == []
    assert load_into(head, flax_to_state_dict(got_t)) == []
    assert T.load_vggt(_vggt(), sd) == []
    assert T.load_track_head(TrackHead(dim_in=2 * EMBED, features=16,
                                       hidden_size=32, img_hw=(SIZE, SIZE)),
                             sd) == []
    # the parts on their own prefixes
    _same_tree(T.convert_camera_head(sd, 4), S.convert_camera_head(sd, 4))
    _same_tree(T.convert_track_head(sd), S.convert_track_head(sd))
    no_heads = {k: v for k, v in sd.items()
                if not k.startswith(("depth_head", "point_head", "track_head"))}
    _same_tree(T.convert_vggt_reference_state_dict(no_heads, 2),
               S.convert_vggt_reference_state_dict(no_heads, 2))
    assert T.convert_vggt_full(no_heads, 2)[1] is None


@pytest.mark.parametrize("dtype,tol", [
    ("float32", 1e-4),
    # bf16 rounds at other places in the two frameworks (dense layers,
    # GELU, the residual stream): a few bf16 steps of the O(1) outputs
    ("bfloat16", 6e-2),
])
def test_vggt_vit_patch_embed_from_a_reference_state_dict(dtype, tol):
    """``patch_embed_kind="vit"`` (the DINOv2 patch embed, no rope, online
    max): the aggregator and the DINOv2 tower converted from one reference
    state dict (``convert_aggregator`` + ``convert_dinov2_backbone``), the
    port's model against skix's on the same tree."""
    from skix.models.vggt import VGGT as SkixVGGT
    from skix.models import vggt_convert as S
    from skix_torch.models import vggt_convert as T

    kw = dict(img_size=SIZE, embed_dim=EMBED, depth=2, num_heads=HEADS,
              intermediate_layer_idx=(0, 1, 1, 1), patch_embed_kind="vit",
              enable_depth=False, enable_point=False)
    model = _vggt(**{k: v for k, v in kw.items()
                     if k not in ("img_size", "embed_dim", "depth",
                                  "num_heads", "intermediate_layer_idx")},
                  dtype=getattr(torch, dtype))
    sd = reference_state_dict(model)
    tree = {"aggregator": T.convert_aggregator(sd, 2, "aggregator."),
            "camera_head": T.convert_camera_head(sd, 4)}
    tree["aggregator"]["patch_embed"] = T.convert_dinov2_backbone(
        sd, 2, "aggregator.patch_embed.")
    _same_tree(tree["aggregator"]["patch_embed"],
               S.convert_dinov2_backbone(sd, 2, "aggregator.patch_embed."))
    variables = {"params": tree}
    assert load_into(model, flax_to_state_dict(variables)) == []
    imgs = rng.random((1, 2, SIZE, SIZE, 3)).astype(np.float32)
    want = jit0(SkixVGGT(**kw, dtype=getattr(jnp, dtype)).apply)(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(imgs))
    with torch.no_grad():
        got = model.eval()(torch.as_tensor(imgs))
    for g, w in zip(got["pose_enc_list"], want["pose_enc_list"]):
        close_scaled(g, w, tol)


def test_convert_moge_backbone():
    """A MoGe-2 checkpoint's trunk (``backbone.*``, a DINOv2 tower) through
    the DINOv2 seam: skix's tree, loaded into the port's MoGe trunk."""
    from skix.models.moge import convert_moge_backbone as skix_moge
    from skix_torch.models.moge import MoGePointModel, convert_moge_backbone

    model = MoGePointModel(patch_size=14, embed_dim=EMBED, depth=2,
                           num_heads=HEADS, num_patches=4)
    sd = reference_state_dict(model.backbone, "backbone.")
    tree = convert_moge_backbone(sd, depth=2)
    _same_tree(tree, skix_moge(sd, depth=2))
    assert load_into(model.backbone, flax_to_state_dict({"params": tree})) == []
