"""skix_torch's VGGT modules against skix's, on the CPU at a tiny width.

Each flax module gets random variables (``_torch_parity``), which
``skix_torch.convert`` turns into the torch module's ``state_dict``; both
see the same numpy inputs. float32 unless a test says otherwise. skix's
modules run jitted (XLA compiles each once; op by op they take several
times as long on the CPU), and the full VGGT's variables are drawn once
for the file.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_parity import jit0, random_variables

from skix_torch.convert import flax_to_state_dict, load_into

EMBED, HEADS, SIZE = 32, 2, 28
rng = np.random.default_rng(2024)


def _port(module, variables):
    extra = load_into(module, flax_to_state_dict(variables))
    return module.eval(), extra


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol)


def _positions(n_tokens, gh, gw):
    from skix.models.layers import make_grid_positions

    return np.concatenate([np.zeros((5, 2), np.int32),
                           make_grid_positions(gh, gw) + 1])[:n_tokens]


@pytest.mark.parametrize("qk_norm,fixed_max,rope", [
    (True, 12.0, True),      # aggregator block
    (False, None, False),    # camera-head trunk block
])
def test_block(qk_norm, fixed_max, rope):
    from skix.models.layers import Block as SkixBlock
    from skix_torch.models.layers import Block
    from skix_torch.ops.attention import rope_2d_tables

    B, N = 2, 9
    x = rng.normal(size=(B, N, EMBED)).astype(np.float32)
    pos = np.broadcast_to(_positions(N, 2, 2), (B, N, 2))
    sblk = SkixBlock(HEADS, qk_norm=qk_norm, init_values=0.01,
                     rope_freq=100.0 if rope else -1.0, rope_tables=rope,
                     attn_fixed_max=fixed_max)
    v = random_variables(sblk, rng, jnp.asarray(x), jnp.asarray(pos))
    want = jit0(sblk.apply)(v, jnp.asarray(x), jnp.asarray(pos))
    blk, extra = _port(Block(EMBED, HEADS, qk_norm=qk_norm, init_values=0.01,
                             attn_fixed_max=fixed_max), v)
    assert extra == []
    tables = (rope_2d_tables(torch.tensor(pos[0]), EMBED // HEADS, 100.0)
              if rope else None)
    with torch.no_grad():
        got = blk(torch.as_tensor(x), tables)
    _close(got, want)


def test_patch_embed_and_layer_norm():
    from skix.models.layers import PatchEmbed as SkixPatchEmbed
    from skix_torch.models.layers import LayerNorm, PatchEmbed
    import flax.linen as fnn

    x = rng.random((2, SIZE, SIZE, 3)).astype(np.float32)
    spe = SkixPatchEmbed(14, EMBED)
    v = random_variables(spe, rng, jnp.asarray(x))
    pe, _ = _port(PatchEmbed(14, EMBED), v)
    with torch.no_grad():
        _close(pe(torch.as_tensor(x)), spe.apply(v, jnp.asarray(x)), atol=1e-5)

    # a common offset, where flax's E[x²] − E[x]² and a two-pass
    # variance part ways
    h = (rng.normal(size=(4, EMBED)) + 3.0).astype(np.float32)
    sln = fnn.LayerNorm(epsilon=1e-6)
    lv = random_variables(sln, rng, jnp.asarray(h))
    ln, _ = _port(LayerNorm(EMBED, 1e-6), lv)
    with torch.no_grad():
        _close(ln(torch.as_tensor(h)), sln.apply(lv, jnp.asarray(h)), atol=1e-5)


def test_aggregator():
    from skix.models.vggt import Aggregator as SkixAggregator
    from skix_torch.models.vggt import Aggregator

    imgs = rng.random((1, 2, SIZE, SIZE, 3)).astype(np.float32)
    sagg = SkixAggregator(img_size=SIZE, embed_dim=EMBED, depth=2,
                          num_heads=HEADS, output_layers=(0, 1))
    v = random_variables(sagg, rng, jnp.asarray(imgs))
    want, idx = jit0(sagg.apply)(v, jnp.asarray(imgs))
    agg, extra = _port(Aggregator(img_size=SIZE, embed_dim=EMBED, depth=2,
                                  num_heads=HEADS, output_layers=(0, 1)), v)
    assert extra == []
    with torch.no_grad():
        got, got_idx = agg(torch.as_tensor(imgs))
    assert got_idx == int(idx) == 5 and len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 2, 5 + 4, 2 * EMBED)
        _close(g, w)


def test_camera_head():
    from skix.models.vggt import CameraHead as SkixCameraHead
    from skix_torch.models.vggt import CameraHead

    tok = rng.normal(size=(1, 2, 2 * EMBED)).astype(np.float32)
    shead = SkixCameraHead(dim_in=2 * EMBED, num_heads=HEADS)
    v = random_variables(shead, rng, jnp.asarray(tok))
    want = jit0(shead.apply)(v, jnp.asarray(tok))
    head, _ = _port(CameraHead(dim_in=2 * EMBED, num_heads=HEADS), v)
    with torch.no_grad():
        got = head(torch.as_tensor(tok))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(g, w)


VGGT_KW = dict(img_size=SIZE, embed_dim=EMBED, depth=2, num_heads=HEADS,
               intermediate_layer_idx=(0, 0, 1, 1))


@pytest.fixture(scope="module")
def vggt_variables():
    """skix's full VGGT (with the DPT heads, whose leaves go unused) and
    its random variables, with the images both dtypes see."""
    from skix.models.vggt import VGGT as SkixVGGT

    imgs = np.random.default_rng(7).random((1, 2, SIZE, SIZE, 3)).astype(
        np.float32)
    full = SkixVGGT(**VGGT_KW)
    return full, random_variables(full, rng, jnp.asarray(imgs)), imgs


@pytest.mark.parametrize("dtype,atol", [
    ("float32", 1e-4),
    # bf16 rounds at other places in the two frameworks (dense layers,
    # GELU, the residual stream): a few bf16 steps of the O(1) outputs
    ("bfloat16", 6e-2),
])
def test_vggt_pose_enc(vggt_variables, dtype, atol):
    from skix.models.vggt import pose_encoding_to_extri_intri as skix_p2e
    from skix_torch.models.vggt import VGGT, pose_encoding_to_extri_intri

    kw = VGGT_KW
    full, v, imgs = vggt_variables
    smodel = full.clone(enable_depth=False, enable_point=False,
                        dtype=getattr(jnp, dtype))
    want = jit0(smodel.apply)(v, jnp.asarray(imgs))
    model, extra = _port(VGGT(**kw, enable_depth=False, enable_point=False,
                              dtype=getattr(torch, dtype)), v)
    assert extra and all(k.split(".")[0] in ("depth_head", "point_head")
                         for k in extra)
    with torch.no_grad():
        got = model(torch.as_tensor(imgs))
    _close(got["pose_enc"], want["pose_enc"], atol)
    for g, w in zip(got["pose_enc_list"], want["pose_enc_list"]):
        _close(g, w, atol)
    if dtype == "float32":
        e, K = pose_encoding_to_extri_intri(got["pose_enc"], (SIZE, SIZE))
        se, sK = skix_p2e(want["pose_enc"], (SIZE, SIZE))
        _close(e, se)
        np.testing.assert_allclose(K.numpy(), np.asarray(sK), rtol=1e-4)


def test_vggt_heads_of_the_sfm_slice_raise():
    """Since the sfm slice the heads are built (skix's defaults: both on);
    only an unknown patch embed raises."""
    from skix_torch.models.vggt import VGGT

    model = VGGT(img_size=SIZE, embed_dim=EMBED, depth=1, num_heads=HEADS,
                 intermediate_layer_idx=(0, 0, 0, 0))
    assert model.depth_head is not None and model.point_head is not None
    with pytest.raises(ValueError, match="patch_embed_kind"):
        VGGT(img_size=SIZE, embed_dim=EMBED, depth=1, num_heads=HEADS,
             patch_embed_kind="hiera")


@pytest.mark.parametrize("hw,size", [((56, 56), 28), ((60, 90), 518),
                                     ((700, 120), 518)])
def test_preprocess_frames_matches_jax_resize(hw, size):
    """jax.image.resize's bilinear antialiases when it shrinks: the port
    builds the same weight matrices (downsampling, upsampling, mixed) and
    applies them as two products. Held against the float64 product of
    those weights at 1e-6; jax's own float32 product on the CPU lands up to
    1.3e-5 from it at 518 px, hence the looser bound between the two."""
    from skix.pipelines.vggt import preprocess_frames as skix_pre
    from skix_torch.pipelines.vggt import _resize_weights, preprocess_frames

    frames = rng.integers(0, 255, (2, *hw, 3)).astype(np.uint8)
    got = preprocess_frames(frames, size, device="cpu").numpy()
    exact = np.einsum("shwc,hy->sywc", frames / 255.0,
                      _resize_weights(hw[0], size).astype(np.float64))
    exact = np.einsum("sywc,wx->syxc", exact,
                      _resize_weights(hw[1], size).astype(np.float64))
    _close(got, exact, atol=1e-6)
    _close(got, skix_pre(frames, size), atol=2e-5)


def test_convert_rules_and_npz_round_trip(tmp_path):
    from skix.pipelines.videopose3d import save_checkpoint
    from skix_torch.pipelines.videopose3d import load_checkpoint

    dense = rng.normal(size=(3, 5)).astype(np.float32)
    conv = rng.normal(size=(2, 2, 3, 4)).astype(np.float32)
    tree = {"params": {"a": {"kernel": dense, "bias": np.zeros(5, np.float32)},
                       "norm": {"scale": np.ones(5, np.float32)},
                       "proj": {"kernel": conv},
                       "ls1": {"gamma": np.full(5, 0.01, np.float32)}}}
    sd = flax_to_state_dict(tree)
    np.testing.assert_array_equal(sd["a.weight"].numpy(), dense.T)
    np.testing.assert_array_equal(sd["proj.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
    assert set(sd) == {"a.weight", "a.bias", "norm.weight", "proj.weight",
                       "ls1.gamma"}
    save_checkpoint(str(tmp_path / "c.npz"), tree)
    from_npz = flax_to_state_dict(tmp_path / "c.npz")
    from_tree = flax_to_state_dict(load_checkpoint(tmp_path / "c.npz"))
    for k in sd:
        np.testing.assert_array_equal(from_npz[k].numpy(), sd[k].numpy())
        np.testing.assert_array_equal(from_tree[k].numpy(), sd[k].numpy())
