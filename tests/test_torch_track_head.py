"""skix_torch's track head against skix's, on the CPU at a tiny width.

The samplers, the embeddings and the position table; ``TorchMHA`` with a
key mask; ``EfficientUpdateFormer`` with chunk pads (``valid``); the
correlation pyramid; ``BaseTrackerPredictor`` and the whole ``TrackHead``
(DPT feature extractor and tracker). Weights are skix's random variables
carried over by ``skix_torch.convert``; inputs are seeded numpy. float32;
limits 1e-5 on the samplers and 1e-4 (relative to the largest element
where that exceeds 1: pixel coordinates) on the networks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_parity import close_scaled, jit0, random_variables

from skix_torch.convert import flax_to_state_dict, load_into

rng = np.random.default_rng(3131)


def _port(module, variables):
    assert load_into(module, flax_to_state_dict(variables)) == []
    return module.eval()


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_bilinear_sample(padding):
    from skix.models.track_head import bilinear_sample as skix_bs
    from skix_torch.models.track_head import bilinear_sample

    fmap = rng.normal(size=(5, 6, 3)).astype(np.float32)
    xy = rng.uniform(-2, 8, (4, 7, 2)).astype(np.float32)
    xy[0, :2] = [[0.0, 0.0], [5.0, 4.0]]          # exact corners
    want = skix_bs(jnp.asarray(fmap), jnp.asarray(xy), padding)
    got = bilinear_sample(torch.as_tensor(fmap), torch.as_tensor(xy), padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("hw", [(7, 9), (1, 5), (4, 1)])
def test_bilinear_zero_maps(hw):
    from skix.models.track_head import _bilinear_zero_maps as skix_zm
    from skix_torch.models.track_head import _bilinear_zero_maps

    maps = rng.normal(size=(2, 3, *hw)).astype(np.float32)
    xy = rng.uniform(-2, 10, (2, 3, 11, 2)).astype(np.float32)
    want = skix_zm(jnp.asarray(maps), jnp.asarray(xy))
    got = _bilinear_zero_maps(torch.as_tensor(maps), torch.as_tensor(xy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_embeddings_and_position_table():
    from skix.models.track_head import get_2d_embedding as skix_emb
    from skix.models.track_head import sincos_pos_embed_2d as skix_table
    from skix_torch.models.track_head import (get_2d_embedding,
                                              sincos_pos_embed_2d)

    xy = rng.normal(size=(3, 4, 2)).astype(np.float32) * 20
    np.testing.assert_allclose(
        get_2d_embedding(torch.as_tensor(xy), 16).numpy(),
        np.asarray(skix_emb(jnp.asarray(xy), 16)), atol=1e-5)
    np.testing.assert_array_equal(sincos_pos_embed_2d(52, 3, 4),
                                  skix_table(52, 3, 4))


def test_torch_mha_key_mask():
    from skix.models.track_head import TorchMHA as SkixMHA
    from skix_torch.models.track_head import TorchMHA

    q = rng.normal(size=(2, 5, 16)).astype(np.float32)
    kv = rng.normal(size=(2, 7, 16)).astype(np.float32)
    mask = np.ones((2, 7), bool)
    mask[0, 4:] = False
    mask[1, 0] = False
    smha = SkixMHA(16, 4)
    v = random_variables(smha, rng, jnp.asarray(q), jnp.asarray(kv),
                         jnp.asarray(kv))
    want = smha.apply(v, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                      jnp.asarray(mask))
    mha = _port(TorchMHA(16, 4), v)
    with torch.no_grad():
        got = mha(torch.as_tensor(q), torch.as_tensor(kv),
                  torch.as_tensor(kv), torch.as_tensor(mask))
    close_scaled(got, want, 1e-5)


def test_update_former_with_pads():
    """Pads masked by ``valid`` leave the real tracks as skix's; the two
    agree with the pads too."""
    from skix.models.track_head import EfficientUpdateFormer as SkixUF
    from skix_torch.models.track_head import EfficientUpdateFormer

    kw = dict(space_depth=2, time_depth=2, input_dim=20, hidden_size=16,
              num_heads=2, output_dim=6, num_virtual_tracks=4)
    x = rng.normal(size=(1, 6, 3, 20)).astype(np.float32)
    valid = np.arange(6)[None] < 4
    suf = SkixUF(**kw)
    v = random_variables(suf, rng, jnp.asarray(x))
    want = jit0(suf.apply)(v, jnp.asarray(x), jnp.asarray(valid))
    uf = _port(EfficientUpdateFormer(**kw), v)
    with torch.no_grad():
        got = uf(torch.as_tensor(x), torch.as_tensor(valid))
        exact = uf(torch.as_tensor(x[:, :4]))
    close_scaled(got, want, 1e-4)
    close_scaled(got[:, :4], exact, 1e-5)


def test_corr_pyramid_sample():
    from skix.models.track_head import corr_pyramid_sample as skix_corr
    from skix_torch.models.track_head import corr_pyramid_sample

    fm = rng.normal(size=(1, 2, 9, 11, 8)).astype(np.float32)
    tgt = rng.normal(size=(1, 2, 5, 8)).astype(np.float32)
    coords = rng.uniform(-1, 10, (1, 2, 5, 2)).astype(np.float32)
    want = skix_corr(jnp.asarray(fm), jnp.asarray(tgt), jnp.asarray(coords),
                     3, 2)
    got = corr_pyramid_sample(torch.as_tensor(fm), torch.as_tensor(tgt),
                              torch.as_tensor(coords), 3, 2)
    close_scaled(got, want, 1e-5)


TINY = dict(features=16, iters=2, corr_levels=3, corr_radius=2,
            hidden_size=32)


@pytest.fixture(scope="module")
def head_pair():
    """skix's TrackHead at a tiny width, its random variables and jitted
    apply; the port's head carrying them; taps of a 3 × 4 patch grid."""
    from skix.models.track_head import TrackHead as SkixHead
    from skix_torch.models.track_head import TrackHead

    S, H, W = 3, 42, 56
    taps = tuple(rng.normal(size=(1, S, 5 + 12, 24)).astype(np.float32)
                 for _ in range(4))
    kw = dict(TINY, dim_in=24, patch_size=14, img_hw=(H, W),
              patch_start_idx=5)
    shead = SkixHead(**kw)
    q = np.zeros((1, 8, 2), np.float32)
    v = random_variables(shead, rng, tuple(jnp.asarray(t) for t in taps),
                         jnp.asarray(q))
    return jit0(shead.apply), v, _port(TrackHead(**kw), v), taps, (H, W)


def test_track_head_with_pads(head_pair):
    """The whole head on 5 real queries padded to 8, pads masked out of
    the space attention; frame 0 pinned to the queries."""
    apply, v, head, taps, (H, W) = head_pair
    q = np.zeros((1, 8, 2), np.float32)
    q[0, :5] = rng.uniform(0, 1, (5, 2)) * [W - 1, H - 1]
    qv = np.arange(8)[None] < 5
    coords, vis, conf = apply(v, tuple(jnp.asarray(t) for t in taps),
                              jnp.asarray(q), jnp.asarray(qv))
    with torch.no_grad():
        gc, gv, gconf = head(tuple(torch.as_tensor(t) for t in taps),
                             torch.as_tensor(q), torch.as_tensor(qv))
    assert len(gc) == len(coords) == 2
    for g, w in zip(gc, coords):
        close_scaled(g, w, 1e-4)
    close_scaled(gv, vis, 1e-4)
    close_scaled(gconf, conf, 1e-4)
    np.testing.assert_allclose(gc[-1][0, 0].numpy(), q[0], atol=1e-5)


def test_track_points_and_split_halves(head_pair):
    """``track_points`` is ``forward``'s last iteration; ``features`` then
    ``track`` is ``forward``."""
    from skix_torch.models.track_head import track_points

    _apply, _v, head, taps, (H, W) = head_pair
    q = torch.as_tensor(rng.uniform(0, 1, (1, 4, 2)) * [W - 1, H - 1],
                        dtype=torch.float32)
    tt = tuple(torch.as_tensor(t) for t in taps)
    with torch.no_grad():
        res = track_points(head, tt, q)
        coords, vis, _ = head.track(head.features(tt), q)
    assert res.tracks.shape == (1, 3, 4, 2) and res.visibility.shape == (1, 3, 4)
    torch.testing.assert_close(res.tracks, coords[-1], rtol=0, atol=0)
    torch.testing.assert_close(res.visibility, vis, rtol=0, atol=0)


def test_track_head_init_weights_is_seeded():
    from skix_torch.models.track_head import TrackHead

    def draw():
        head = TrackHead(dim_in=24, patch_size=14, img_hw=(42, 56), **TINY)
        return head.init_weights(torch.Generator().manual_seed(0))

    a, b = draw().state_dict(), draw().state_dict()
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    w = a["tracker.updateformer.flow_head.weight"]
    assert 0 < float(w.abs().max()) <= 2 * 0.001 / 0.8796 + 1e-9
