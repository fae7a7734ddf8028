"""The rope styles of skix_torch.ops.attention against skix's.

skix's kernels take the rope's rotation as a signed permutation R in three
styles (``skix/ops/attention.py:88-123``): ``"half"``, ``"interleaved"``
(the SAM3 ViT-Det rope) and ``("segments", axes)`` (the MMDiT 3D rope).
The port applies R by index: the plain versions gather, the CUDA kernels
compute rotate-half's partner and read one int32 code per column for the
other styles. Held here on the CPU:

- the port's partner/sign tables and kernel codes are skix's R;
- the plain K1 and K2 with the interleaved and segmented styles against
  skix's interpret-mode kernels (K1 at (1, 2, 64, 32) and ragged 77, K2
  single-tile 16): f32 sums in other orders, 3e-5 as the rotate-half
  tests of ``tests/test_torch_attention.py``;
- the plain K3/K4/K5 with the interleaved style against ``jax.grad`` of
  skix's interpret-mode kernels: 5e-5, as ``tests/test_torch_attention_
  backward.py``;
- the tables the port builds are pair-symmetric, so the backward's
  un-rotation is the exact gradient.

The CUDA kernels are held against these plain versions on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import jit0

from skix.ops import attention as SA
from skix_torch.ops import attention as A

AXES = (8, 12, 8)            # sums to 28 of D = 32: a tail of 4 untouched
STYLES = ["half", "interleaved", ("segments", AXES)]
FWD_ATOL, BWD_ATOL = 3e-5, 5e-5


def _qkv(shape, seed):
    r = np.random.default_rng(seed)
    return tuple(r.normal(size=shape).astype(np.float32) for _ in range(3))


def _tables(style, S, D, seed=0):
    """The same tables on both sides, built by each package's builder from
    the same numpy positions or angles; returns (skix's, the port's)."""
    r = np.random.default_rng(seed)
    if style == "interleaved":
        angles = r.uniform(0, 3, (S, D // 2)).astype(np.float32)
        sk = SA.interleaved_rope_tables(jnp.asarray(angles))
        pt = A.interleaved_rope_tables(torch.as_tensor(angles))
    else:
        pos = r.integers(0, 12, (S, 3))
        sk = SA.rope_3d_tables(jnp.asarray(pos, jnp.float32), D, AXES)
        pt = A.rope_3d_tables(torch.as_tensor(pos), D, AXES)
    return [np.asarray(t) for t in sk], pt


@pytest.mark.parametrize("style", STYLES, ids=["half", "interleaved",
                                               "segments"])
def test_rotation_tables_equal_skix_matrices(style):
    """partner/sign (the plain versions) and the kernels' int32 codes
    sign·(partner + 1) are skix's R; Rᵀ = −R."""
    D = 32
    R = SA._rot_matrix(D, style)
    np.testing.assert_array_equal(A.rot_matrix(D, style), R)
    partner, sign = A.rotation_table(D, A._style_key(style))
    x = np.random.default_rng(1).normal(size=(5, D)).astype(np.float32)
    np.testing.assert_array_equal(x[:, partner] * sign, x @ R)
    np.testing.assert_array_equal(
        A.rotate(torch.as_tensor(x), style).numpy(), x @ R)
    codes = A._rotation_codes(D, A._style_key(style),
                              torch.device("cpu")).numpy()
    assert codes.dtype == np.int32
    decoded = np.zeros((D, D), np.float32)
    for j, c in enumerate(codes):
        if c:
            decoded[abs(c) - 1, j] = np.sign(c)
    np.testing.assert_array_equal(decoded, R)
    np.testing.assert_array_equal(R.T, -R)


@pytest.mark.parametrize("style", STYLES[1:], ids=["interleaved",
                                                   "segments"])
def test_tables_match_skix_and_are_pair_symmetric(style):
    """The port's table builders give skix's tables, and sin[s, j] ==
    sin[s, partner(j)] for every rotated column: the condition under which
    x∘cos − rot(x)∘sin is the rope's exact gradient."""
    (s_cos, s_sin), (cos, sin) = _tables(style, 64, 32)
    np.testing.assert_allclose(cos.numpy(), s_cos, atol=1e-6, rtol=0)
    np.testing.assert_allclose(sin.numpy(), s_sin, atol=1e-6, rtol=0)
    partner, sign = A.rotation_table(32, A._style_key(style))
    rotated = sign != 0
    np.testing.assert_array_equal(sin.numpy()[:, rotated],
                                  sin.numpy()[:, partner[rotated]])
    np.testing.assert_array_equal(sin.numpy()[:, ~rotated], 0.0)


FWD_CASES = [
    # (B, H, S, D, block): K1 over 2 tiles, K1 ragged, K2 single-tile
    (1, 2, 64, 32, 32),
    (1, 2, 77, 32, 32),
    (2, 2, 16, 32, 16),
]


@pytest.mark.parametrize("style", STYLES[1:], ids=["interleaved",
                                                   "segments"])
@pytest.mark.parametrize("case", FWD_CASES, ids=["k1", "k1_ragged", "k2"])
def test_plain_forward_matches_skix_kernel(case, style):
    B, H, S, D, blk = case
    q, k, v = _qkv((B, H, S, D), 3)
    (s_cos, s_sin), (cos, sin) = _tables(style, S, D, seed=4)
    want = np.asarray(SA.flash_attention(
        *map(jnp.asarray, (q, k, v)), block_q=blk, block_k_major=blk,
        block_k=blk, interpret=True, rope_cos=jnp.asarray(s_cos),
        rope_sin=jnp.asarray(s_sin), rope_rotate=style))
    assert A.is_single_tile(S, S, blk, blk, blk) is (S == blk)
    with torch.no_grad():
        got = A.flash_attention(*map(torch.as_tensor, (q, k, v)),
                                rope_cos=cos, rope_sin=sin,
                                rope_rotate=style, block_q=blk,
                                block_k_major=blk, block_k=blk).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("case", [(1, 2, 64, 32, 32), (2, 2, 16, 32, 16)],
                         ids=["k3_k4", "k5"])
def test_plain_backward_interleaved_matches_skix_kernels(case):
    """dq, dk, dv of the port's Function on the CPU (plain K3/K4, or plain
    K5 where the blocks make the sequence one tile) against jax.grad of
    skix's interpret-mode kernels, interleaved rope."""
    B, H, S, D, blk = case
    q, k, v = _qkv((B, H, S, D), 5)
    (s_cos, s_sin), (cos, sin) = _tables("interleaved", S, D, seed=6)
    kw = dict(block_q=blk, block_k_major=blk, block_k=blk)

    def f(q, k, v):
        return jnp.sum(jnp.sin(SA.flash_attention(
            q, k, v, interpret=True, rope_cos=jnp.asarray(s_cos),
            rope_sin=jnp.asarray(s_sin), rope_rotate="interleaved", **kw)))

    want = jit0(jax.grad(f, argnums=(0, 1, 2)))(*map(jnp.asarray,
                                                         (q, k, v)))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    loss = torch.sin(A.flash_attention(*leaves, rope_cos=cos, rope_sin=sin,
                                       rope_rotate="interleaved",
                                       **kw)).sum()
    got = torch.autograd.grad(loss, leaves)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BWD_ATOL,
                                   rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("style", STYLES[1:], ids=["interleaved",
                                                   "segments"])
@pytest.mark.parametrize("single", [False, True])
def test_function_backward_equals_autograd_of_plain_forward(style, single):
    """The hand-written backward (un-rotation x∘cos − rot(x)∘sin at the
    store) equals torch autograd through the plain forward for the
    pair-symmetric tables of each style."""
    S, D = 36, 32
    q, k, v = (torch.as_tensor(x) for x in _qkv((2, 2, S, D), 7))
    _, (cos, sin) = _tables(style, S, D, seed=8)
    blocks = dict(block_q=S, block_k_major=S, block_k=S) if single else {}
    kw = dict(rope_cos=cos, rope_sin=sin, rope_rotate=style)
    g_out = torch.as_tensor(np.random.default_rng(9).normal(
        size=q.shape).astype(np.float32))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(A.flash_attention(*leaves, **kw, **blocks),
                              leaves, g_out)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(A.attention_reference(
        *leaves, 1 / math.sqrt(D), **kw), leaves, g_out)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def test_unknown_style_raises():
    q = torch.zeros(1, 1, 4, 32)
    cos = sin = torch.zeros(4, 32)
    with pytest.raises(ValueError, match="rope_rotate"):
        A.flash_attention(q, q, q, rope_cos=cos, rope_sin=sin,
                          rope_rotate="quarter")
