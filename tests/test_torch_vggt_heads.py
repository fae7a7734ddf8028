"""skix_torch's DPT heads and the rest of VGGT against skix's, on the CPU at
a tiny width.

Each flax module gets random variables (``_torch_parity``), which
``skix_torch.convert`` turns into the torch module's ``state_dict``; both
see the same numpy inputs, float32 unless a test says otherwise. skix's
modules run jitted, and the full models' variables are drawn once for the
file. Limits: 1e-4 absolute on O(1) outputs, relative to the largest
element where that exceeds 1 (the DPT activations ``exp`` and
``inv_log`` reach tens).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_parity import close_scaled, jit0, random_variables

from skix_torch.convert import flax_to_state_dict, load_into

EMBED, HEADS, SIZE, S = 32, 2, 28, 2
rng = np.random.default_rng(909)
IMGS = rng.random((1, S, SIZE, SIZE, 3)).astype(np.float32)


def _port(module, variables):
    assert load_into(module, flax_to_state_dict(variables)) == []
    return module.eval()


@pytest.mark.parametrize("hw,out", [((5, 7), (9, 4)), ((2, 2), (8, 8)),
                                    ((6, 3), (1, 3))])
def test_resize_align_corners(hw, out):
    from skix.models.vggt import _resize_align_corners as skix_resize
    from skix_torch.models.vggt import _resize_align_corners

    x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    want = skix_resize(jnp.asarray(x), out)
    got = _resize_align_corners(torch.as_tensor(x), out)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


DPT_KW = dict(dim_in=2 * EMBED, patch_size=14, features=16,
              out_channels=(8, 16, 32, 32))


@pytest.mark.parametrize("feature_only", [False, True])
def test_dpt_head(feature_only):
    """A regular head (point map + confidence) and the track head's
    feature extractor (``feature_only``, ``down_ratio`` 2), on taps of a
    3 × 3 patch grid (42 px; the fusion sizes 12 → 6 → 3 → 2 are odd)."""
    from skix.models.vggt import DPTHead as SkixDPT
    from skix_torch.models.vggt import DPTHead

    hw, psi = (42, 42), 5
    taps = [rng.normal(size=(1, S, psi + 9, 2 * EMBED)).astype(np.float32)
            for _ in range(4)]
    kw = dict(DPT_KW, feature_only=feature_only,
              down_ratio=2 if feature_only else 1)
    shead = SkixDPT(**kw)
    jt = [jnp.asarray(t) for t in taps]
    v = random_variables(shead, rng, jt, images_hw=hw, patch_start_idx=psi)
    want = jax.jit(shead.apply, static_argnums=(2, 3))(v, jt, hw, psi)
    head = _port(DPTHead(**kw), v)
    with torch.no_grad():
        got = head([torch.as_tensor(t) for t in taps], hw, psi)
    if feature_only:
        assert got.shape == want.shape == (1, S, 21, 21, 16)
        close_scaled(got, want, 1e-4)
    else:
        for g, w in zip(got, want):
            assert g.shape == w.shape
            close_scaled(g, w, 1e-4)


VGGT_KW = dict(img_size=SIZE, embed_dim=EMBED, depth=2, num_heads=HEADS,
               intermediate_layer_idx=(0, 1, 1, 1))


@pytest.fixture(scope="module")
def vggt_pair():
    """skix's VGGT with skix's defaults (both DPT heads), tokens and taps;
    its random variables; its outputs on IMGS; the port's model carrying
    the same variables."""
    from skix.models.vggt import VGGT as SkixVGGT
    from skix_torch.models.vggt import VGGT

    kw = dict(VGGT_KW, return_tokens=True, return_taps=True)
    smodel = SkixVGGT(**kw)
    v = random_variables(smodel, rng, jnp.asarray(IMGS))
    want = jit0(smodel.apply)(v, jnp.asarray(IMGS))
    return want, _port(VGGT(**kw), v)


@pytest.mark.parametrize("key", ["pose_enc", "depth", "depth_conf",
                                 "world_points", "world_points_conf",
                                 "tokens", "taps"])
def test_vggt_with_heads_tokens_and_taps(vggt_pair, key):
    want, model = vggt_pair
    with torch.no_grad():
        got = model(torch.as_tensor(IMGS))
    assert set(got) == set(want)
    assert got["patch_start_idx"] == int(want["patch_start_idx"]) == 5
    g, w = got[key], want[key]
    if key == "taps":
        assert len(g) == len(w) == 4
        for a, b in zip(g, w):
            assert a.dtype == torch.float32 and a.shape == b.shape
            close_scaled(a, b, 1e-4)
    else:
        assert g.shape == w.shape
        close_scaled(g, w, 1e-4)


def test_vision_transformer_bf16_taps():
    from skix.models.layers import VisionTransformer as SkixViT
    from skix_torch.models.layers import VisionTransformer

    x = rng.random((2, SIZE, SIZE, 3)).astype(np.float32)
    kw = dict(patch_size=14, embed_dim=EMBED, depth=2, num_heads=HEADS,
              num_register_tokens=2, taps=(0, 1))
    v = random_variables(SkixViT(**kw), rng, jnp.asarray(x))
    out, taps = jit0(SkixViT(**kw, dtype=jnp.bfloat16).apply)(
        v, jnp.asarray(x))
    model = _port(VisionTransformer(**kw, num_patches=4,
                                    dtype=torch.bfloat16), v)
    with torch.no_grad():
        gout, gtaps = model(torch.as_tensor(x))
    assert gout.dtype == torch.bfloat16 and out.dtype == jnp.bfloat16
    close_scaled(gout.float(), np.asarray(out, np.float32), 6e-2)
    for g, w in zip(gtaps, taps):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        close_scaled(g, w, 6e-2)


def test_unproject_depth_to_points():
    from skix.models.vggt import unproject_depth_to_points as skix_unproject
    from skix_torch.models.vggt import unproject_depth_to_points

    depth = rng.uniform(1, 5, (2, 3, 6, 7)).astype(np.float32)
    extr = np.concatenate([np.linalg.qr(rng.normal(size=(2, 3, 3, 3)))[0],
                           rng.normal(size=(2, 3, 3, 1))], -1).astype(
                               np.float32)
    K = np.tile(np.array([[50.0, 0, 3.5], [0, 40.0, 3.0], [0, 0, 1]],
                         np.float32), (2, 3, 1, 1))
    want = skix_unproject(jnp.asarray(depth), jnp.asarray(extr),
                          jnp.asarray(K))
    got = unproject_depth_to_points(torch.as_tensor(depth),
                                    torch.as_tensor(extr), torch.as_tensor(K))
    close_scaled(got, want, 1e-5)


def test_preprocess_frames_defaults_to_the_card():
    """``preprocess_frames`` runs on the card unless the caller asks for the
    CPU: without a card its default raises, as ``resolve_device`` does."""
    from skix_torch.pipelines.vggt import preprocess_frames

    frames = rng.integers(0, 255, (2, 30, 30, 3)).astype(np.uint8)
    assert preprocess_frames(frames, SIZE, device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert preprocess_frames(frames, SIZE).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        preprocess_frames(frames, SIZE)
