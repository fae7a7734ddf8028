"""skix_torch's MoGe FOV estimator against skix's, on the CPU at a tiny width.

The point model (the DINOv2-shaped trunk with its taps, the fusion head,
the transposed-convolution upsampling, the bilinear resize), also through
the estimator at two resolutions, at 1e-4; the focal of
``recover_focal_shift`` at 1e-4 relative and its shift at 1e-4 on
synthetic perspective maps; the pixel grid and the resampled position
table at 1e-6. skix's applies are jitted (its estimator shares one compiled
apply per model configuration).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_parity import close_scaled, jit0, random_variables

from skix.models import moge as S
from skix_torch.convert import flax_to_state_dict
from skix_torch.models import moge as P

rng = np.random.default_rng(1414)
TINY = dict(patch_size=14, embed_dim=32, depth=2, num_heads=2,
            taps=(0, 0, 1, 1), features=32)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _pointmap(H, W, f_true, dz_true, seed):
    """Points whose projection with (f_true, dz_true) lands on the pixel
    grid (skix's oracle), with 1 % noise."""
    r = np.random.default_rng(seed)
    u, v = [np.asarray(t) for t in S.image_uv(H, W)]
    z = 1.0 + 2.0 * r.random((H, W)).astype(np.float32)
    pts = np.stack([u * z / f_true, v * z / f_true, z - dz_true], -1)
    return (pts * (1 + 0.01 * r.normal(size=pts.shape))).astype(np.float32)


def test_image_uv():
    for a, b in zip(P.image_uv(24, 32), S.image_uv(24, 32)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7,
                                   rtol=0)


@pytest.mark.parametrize("mask", ["none", "band", "empty"])
def test_recover_focal_shift_batched(mask):
    """The port's batched search against skix's vmapped one: no mask, a
    mask that drops a corrupted band, an all-False mask (uniform
    fallback)."""
    pts = np.stack([_pointmap(20, 28, 0.6 + 0.2 * i, 0.1 * i, i)
                    for i in range(3)])
    m = np.ones(pts.shape[:3], bool)
    if mask == "band":
        pts[:, :5] = 1e3
        m[:, :5] = False
    elif mask == "empty":
        m[:] = False
    f, dz = jit0(jax.vmap(S.recover_focal_shift))(
        jnp.asarray(pts), None if mask == "none" else jnp.asarray(m))
    gf, gdz = P.recover_focal_shift(_t(pts), None if mask == "none"
                                    else torch.tensor(m))
    np.testing.assert_allclose(gf.numpy(), np.asarray(f), rtol=1e-4)
    np.testing.assert_allclose(gdz.numpy(), np.asarray(dz), rtol=0,
                               atol=1e-4)


def test_resize_pos_embed():
    pos = rng.normal(size=(1, 1 + 4 * 6, 16)).astype(np.float32)
    for dst in ((2, 3), (7, 9)):
        want = S.resize_pos_embed(jnp.asarray(pos), (4, 6), dst)
        close_scaled(P.resize_pos_embed(_t(pos), (4, 6), dst), want, 1e-6)


_SKIX = {}


def _skix_model():
    """skix's tiny MoGePointModel and random variables at a 2 × 3 grid."""
    if not _SKIX:
        smod = S.MoGePointModel(**TINY)
        v = random_variables(smod, rng, jnp.zeros((1, 28, 42, 3)))
        _SKIX.update(smod=smod, v=v)
    return _SKIX["smod"], _SKIX["v"]


def test_point_model_matches_skix():
    from skix.utils.jitapply import apply_model

    smod, v = _skix_model()
    x = rng.random((2, 28, 42, 3)).astype(np.float32)
    pts, msk = apply_model(smod, None, v, jnp.asarray(x))
    model = P.MoGePointModel(num_patches=6, **TINY)
    model.load_state_dict(flax_to_state_dict(v))
    with torch.no_grad():
        gpts, gmsk = model.eval()(_t(x))
    assert gpts.shape == (2, 28, 42, 3) and gmsk.shape == (2, 28, 42)
    close_scaled(gpts, pts, 1e-4)
    close_scaled(gmsk, msk, 1e-4)


def test_estimator_matches_skix_at_two_resolutions():
    """The estimator's point maps at the variables' grid and at another
    (the position table resampled, cached per grid; frames padded to the
    patch and the batch) against skix's at 1e-4, and its intrinsics: fx =
    fy = the vertical focal that ``recover_focal_shift`` finds on those
    maps, the principal point at the frame's center. The focal itself is
    held to skix's on the synthetic maps above: on a random model's maps
    the search is ill-conditioned (the same maps give focals 1.5e-4 apart
    through the two libraries' sums)."""
    from skix.utils.jitapply import apply_model

    smod, v = _skix_model()
    est_s = S.MoGeFovEstimator(smod, v, grid=(2, 3))
    est_p = P.MoGeFovEstimator(P.MoGePointModel(**TINY),
                               flax_to_state_dict(v), grid=(2, 3),
                               device="cpu")
    for shape in ((5, 28, 42, 3), (3, 40, 30, 3)):
        frames = rng.integers(0, 255, shape, dtype=np.uint8)
        T, H, W = shape[:3]
        Hp, Wp = H + (-H) % 14, W + (-W) % 14
        x = np.zeros((4, Hp, Wp, 3), np.float32)
        x[:min(T, 4), :H, :W] = frames[:4] / np.float32(255.0)
        pts, msk = apply_model(smod, None, est_s._variables_for(Hp, Wp),
                               jnp.asarray(x))
        with torch.no_grad():
            gpts, gmsk = est_p.model(_t(x), est_p._pos_embed_for(
                Hp // 14, Wp // 14))
        close_scaled(gpts, pts, 1e-4)
        close_scaled(gmsk, msk, 1e-4)
        K = est_p.intrinsics_for_clip(frames)
        f, _ = P.recover_focal_shift(gpts, torch.sigmoid(gmsk) > 0.5)
        np.testing.assert_allclose(K[:4, 1, 1], f.numpy()[:min(T, 4)]
                                   * np.hypot(Hp, Wp), rtol=1e-6)
        np.testing.assert_array_equal(K[:, 0, 0], K[:, 1, 1])
        np.testing.assert_array_equal(K[:, :2, 2], [[W / 2, H / 2]] * T)
        assert K.shape == est_s.intrinsics_for_clip(frames).shape
    assert list(est_p._cache) == [(3, 3)]


def test_lazy_seeded_init():
    """Without weights the estimator initializes at the first clip's padded
    grid from its seed: finite positive focals, the same on a rerun."""
    frames = rng.integers(0, 255, (2, 30, 30, 3), dtype=np.uint8)
    Ks = [P.MoGeFovEstimator(P.MoGePointModel(**TINY), device="cpu")
          .intrinsics_for_clip(frames) for _ in range(2)]
    np.testing.assert_array_equal(Ks[0], Ks[1])
    assert np.isfinite(Ks[0]).all() and (Ks[0][:, 1, 1] > 0).all()
