"""skix_torch's DPT depth model and RAFT flow against skix's, on the CPU at
skix's test widths (depth: embed 32, 4 blocks of 2 heads, features 16;
RAFT: hidden 32, context 32, the stage's 3 levels of radius 3).

The depth model runs on an 80 × 96 frame, a 5 × 6 patch grid whose odd
row count makes the fusion blocks resize their residuals (HF DPT's
``align_residual``; the pre-activation skips are HF's too) before the
torch-exact bicubic resize back. Each port model draws its weights
(``_torch_parity.port_variables``) and hands skix the same values; skix
runs jitted, once per model. Limits 1e-4, relative to the largest element
where that exceeds 1; the correlation lookups 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from _torch_parity import close_scaled, compile_once, port_variables

from skix.models import dpt as JD
from skix.models import raft as JR
from skix_torch.models import dpt as PD
from skix_torch.models import raft as PR

rng = np.random.default_rng(31)
DEPTH_KW = dict(patch_size=16, embed_dim=32, depth=4, num_heads=2,
                taps=(0, 1, 2, 3), features=16, out_channels=(8, 16, 24, 24))
FLOW_KW = dict(hidden=32, context=32, corr_levels=3, corr_radius=3, iters=2)


def _shifted_pair(B, H, W, shift=(2, 3)):
    base = rng.random((B, H + 8, W + 8, 3)).astype(np.float32)
    a = base[:, 4:4 + H, 4:4 + W]
    b = base[:, 4 + shift[0]:4 + shift[0] + H, 4 + shift[1]:4 + shift[1] + W]
    return np.ascontiguousarray(a), np.ascontiguousarray(b)


def test_monocular_depth_matches_skix():
    imgs = rng.random((2, 80, 96, 3)).astype(np.float32)
    model = PD.MonocularDepth(image_hw=(80, 96), **DEPTH_KW)
    v = port_variables(model, seed=11)
    jm = JD.MonocularDepth(**DEPTH_KW)
    x = jnp.asarray(imgs)
    want = compile_once(jm.apply, v, x)(v, x)
    with torch.no_grad():
        got = model.eval()(torch.as_tensor(imgs))
    assert got.shape == (2, 80, 96)
    assert float(np.abs(np.asarray(want)).max()) > 1e-3   # not vacuous
    close_scaled(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("src,dst", [((5, 6), (80, 96)), ((9, 4), (7, 13))])
def test_bicubic_resize_matches_skix(src, dst):
    x = rng.normal(size=(2, *src)).astype(np.float32)
    want = compile_once(lambda a: JD._resize_bicubic_torch(a, dst), x)(x)
    got = PD._resize_bicubic_torch(torch.as_tensor(x), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_raft_flow_matches_skix():
    a, b = _shifted_pair(2, 32, 40)
    model = PR.RAFT(**FLOW_KW)
    v = port_variables(model, seed=13)
    jm = JR.RAFT(**FLOW_KW)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    want = compile_once(jm.apply, v, ja, jb)(v, ja, jb)
    with torch.no_grad():
        got = model.eval()(torch.as_tensor(a), torch.as_tensor(b))
    assert got.shape == (2, 32, 40, 2)
    close_scaled(got.numpy(), want, 1e-4)


def test_correlation_lookup_matches_skix():
    """The pyramid and its windowed lookup, with coordinates that fall
    outside the volume on every side (each tap zero there)."""
    f1 = rng.normal(size=(1, 5, 6, 8)).astype(np.float32)
    f2 = rng.normal(size=(1, 5, 6, 8)).astype(np.float32)
    coords = rng.uniform(-3, 9, size=(1, 5, 6, 2)).astype(np.float32)

    def ref(f1, f2, c):
        pyr = JR.correlation_pyramid(f1, f2, 3)
        return pyr, JR.lookup_correlation(pyr, c, 2)

    want_pyr, want = compile_once(ref, f1, f2, coords)(f1, f2, coords)
    pyr = PR.correlation_pyramid(torch.as_tensor(f1), torch.as_tensor(f2), 3)
    for g, w in zip(pyr, want_pyr):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    got = PR.lookup_correlation(pyr, torch.as_tensor(coords), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
