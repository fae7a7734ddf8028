"""skix_torch.ops.attention against skix.ops.attention.

On the CPU the port's ``flash_attention`` runs its plain version; it is held
against the skix Pallas kernels run through the interpreter, on the
``TestPallasKernelInterpret`` shapes of ``tests/test_ops.py`` (ragged S,
cross attention, D 16/32/64), with fixed-max and fused rope on and off.
The CUDA kernel itself is held against the plain version on the card in
``tests/test_torch_cuda.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import jit0

from skix.ops.attention import flash_attention as skix_flash_attention
from skix.ops.attention import flash_attention_with_lse as skix_with_lse
from skix.ops.attention import rope_2d_tables as skix_rope_tables
from skix.ops.attention import rotate_half_matrix as skix_rotate_half_matrix
from skix_torch.ops import attention as A

# skix's kernels through the interpreter, each signature compiled once
# (_CHEAP): run op by op, the interpreter's grid loop costs ~2x more
_BLOCKS = ("block_q", "block_k_major", "block_k", "interpret")
_skix_kernel = jit0(skix_flash_attention, static_argnames=_BLOCKS + (
    "fixed_max",))
_skix_kernel_lse = jit0(skix_with_lse, static_argnames=_BLOCKS + (
    "sm_scale",))

CASES = [
    # (B, H, Sq, Sk, D, block_q, block_k_major, block_k) — tests/test_ops.py
    (2, 3, 64, 64, 16, 16, 32, 16),
    (1, 2, 100, 72, 32, 32, 32, 16),
    (2, 2, 128, 128, 64, 64, 64, 32),
    (1, 2, 64, 64, 64, 64, 64, 64),
    (1, 4, 72, 80, 32, 24, 24, 24),
    (2, 8, 48, 48, 32, 48, 48, 48),
    (1, 4, 40, 72, 32, 40, 72, 72),
]
ROPE_CASES = [c for c in CASES if c[2] == c[3]]


def _positions(n):
    ys, xs = np.meshgrid(np.arange(8), np.arange(16), indexing="ij")
    grid = np.stack([ys.ravel(), xs.ravel()], -1) + 1
    return np.concatenate([np.zeros((5, 2), np.int64), grid])[:n]


def _inputs(case, seed, layer_norm=False):
    B, H, Sq, Sk, D = case[:5]
    r = np.random.default_rng(seed)
    q = r.normal(size=(B, H, Sq, D)).astype(np.float32)
    k = r.normal(size=(B, H, Sk, D)).astype(np.float32)
    v = r.normal(size=(B, H, Sk, D)).astype(np.float32)
    if layer_norm:  # qk-normed inputs, as fixed-max mode assumes
        q = (q - q.mean(-1, keepdims=True)) / q.std(-1, keepdims=True)
        k = (k - k.mean(-1, keepdims=True)) / k.std(-1, keepdims=True)
    return q, k, v


def _skix(q, k, v, case, **kw):
    bq, bkm, bk = case[5:]
    return np.asarray(_skix_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=bq,
        block_k_major=bkm, block_k=bk, interpret=True, **kw), np.float32)


def _torch(q, k, v, **kw):
    with torch.no_grad():
        return A.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                                 torch.as_tensor(v), **kw).float().numpy()


@pytest.mark.parametrize("fixed_max", [None, 8.0])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_skix_kernel(case, fixed_max):
    q, k, v = _inputs(case, 7, layer_norm=fixed_max is not None)
    np.testing.assert_allclose(_torch(q, k, v, fixed_max=fixed_max),
                               _skix(q, k, v, case, fixed_max=fixed_max),
                               atol=3e-5)


@pytest.mark.parametrize("fixed_max", [None, 12.0])
@pytest.mark.parametrize("case", ROPE_CASES)
def test_plain_fused_rope_matches_skix_kernel(case, fixed_max):
    q, k, v = _inputs(case, 11, layer_norm=fixed_max is not None)
    pos = _positions(case[2])
    cos, sin = (np.array(t) for t in skix_rope_tables(
        jnp.asarray(pos), case[4], 100.0))
    t_cos, t_sin = A.rope_2d_tables(torch.as_tensor(pos), case[4], 100.0)
    np.testing.assert_allclose(t_cos.numpy(), cos, atol=1e-6)
    np.testing.assert_allclose(t_sin.numpy(), sin, atol=1e-6)
    want = _skix(q, k, v, case, fixed_max=fixed_max,
                 rope_cos=jnp.asarray(cos), rope_sin=jnp.asarray(sin))
    got = _torch(q, k, v, fixed_max=fixed_max, rope_cos=torch.as_tensor(cos),
                 rope_sin=torch.as_tensor(sin))
    np.testing.assert_allclose(got, want, atol=3e-5)


def test_plain_bfloat16_matches_skix_kernel():
    """bf16 inputs with fixed max and rope, the VGGT mode: the plain version
    rounds where the kernel rounds, so the outputs differ by at most one
    bf16 step (2⁻⁸ relative) where f32 sums in another order tip a
    rounding."""
    case = (1, 2, 128, 128, 64, 64, 64, 32)
    q, k, v = _inputs(case, 3, layer_norm=True)
    pos = _positions(128)
    cos, sin = (np.array(t) for t in skix_rope_tables(jnp.asarray(pos), 64,
                                                        100.0))
    want = _skix(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                 jnp.asarray(v, jnp.bfloat16), case, fixed_max=12.0,
                 rope_cos=jnp.asarray(cos), rope_sin=jnp.asarray(sin))
    bf = [torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v)]
    with torch.no_grad():
        got = A.flash_attention(*bf, fixed_max=12.0,
                                rope_cos=torch.as_tensor(cos),
                                rope_sin=torch.as_tensor(sin)).float().numpy()
    np.testing.assert_allclose(got, want, atol=2 ** -8 * np.abs(want).max())


def test_rotate_half_by_index_equals_matrix():
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(3, 64)),
                        dtype=torch.float32)
    R = skix_rotate_half_matrix(64)
    np.testing.assert_array_equal(A.rotate_half_matrix(64), R)
    np.testing.assert_array_equal(A.rotate_half(x).numpy(), x.numpy() @ R)


def test_fused_rope_equals_explicit_rope():
    """The tables path equals roping q and k first (rope_2d), then plain
    softmax attention: the kernel's fused rope changes no result."""
    from skix_torch.models.layers import rope_2d

    case = (1, 2, 48, 48, 32)
    q, k, v = (torch.as_tensor(x) for x in _inputs(case, 5))
    pos = torch.as_tensor(_positions(48))
    cos, sin = A.rope_2d_tables(pos, 32, 100.0)
    fused = A.flash_attention(q, k, v, rope_cos=cos, rope_sin=sin)
    qr, kr = rope_2d(q, pos[None], 100.0), rope_2d(k, pos[None], 100.0)
    s = qr @ kr.transpose(-1, -2) / math.sqrt(32)
    want = torch.softmax(s, dim=-1) @ v
    np.testing.assert_allclose(fused.numpy(), want.numpy(), atol=3e-5)


def test_cpu_wrapper_launches_nothing():
    A.LAUNCHES.clear()
    q = torch.zeros(1, 1, 4, 64)
    A.flash_attention(q, q, q)
    assert A.LAUNCHES["flash_fwd"] == 0


# --------------------------------------------------------------------------
# K2 (single tile) and K1's lse output
# --------------------------------------------------------------------------
WINDOW_CASES = [
    # (B, H, S, D): ViT-Det window layouts at test widths
    (2, 4, 16, 32),
    (9, 2, 36, 64),
]


@pytest.mark.parametrize("fixed_max", [None, 8.0])
@pytest.mark.parametrize("case", WINDOW_CASES)
def test_plain_single_tile_matches_skix_kernel(case, fixed_max):
    """The plain K2 against skix's ``_fwd_kernel_single_tile`` through the
    interpreter (block_q = block_k_major = block_k = S: skix's dispatcher
    picks the single-tile kernel), with window rope tables."""
    from skix_torch.models.layers import make_grid_positions

    B, H, S, D = case
    assert A.is_single_tile(S, S, S, S, S)
    q, k, v = _inputs((B, H, S, S, D), 13, layer_norm=fixed_max is not None)
    side = int(math.isqrt(S))
    pos = make_grid_positions(side, side)
    cos, sin = (np.array(t) for t in skix_rope_tables(jnp.asarray(pos), D,
                                                        100.0))
    want = _skix(q, k, v, (B, H, S, S, D, S, S, S), fixed_max=fixed_max,
                 rope_cos=jnp.asarray(cos), rope_sin=jnp.asarray(sin))
    got = _torch(q, k, v, fixed_max=fixed_max, rope_cos=torch.as_tensor(cos),
                 rope_sin=torch.as_tensor(sin), block_q=S, block_k_major=S,
                 block_k=S)
    np.testing.assert_allclose(got, want, atol=3e-5)


@pytest.mark.parametrize("S,Sk,blocks,single", [
    (576, 576, (576, 576, 576), True),      # ViT-Det window
    (5184, 5184, (576, 576, 576), False),   # fusion encoder: 9 tiles
    (40, 72, (40, 72, 72), True),
    (40, 72, (40, 72, 24), True),           # block_k divides the major tile
    (64, 64, (64, 64, 48), False),          # major tile cut to 48: 2 tiles
    (64, 64, (1024, 1024, 1024), True),     # blocks clipped to S
    (100, 100, (1024, 1024, 1024), False),  # clipped to 104: padding
    (64, 64, (None, None, None), False),    # the port's default: K1
])
def test_single_tile_dispatch_matches_skix(S, Sk, blocks, single):
    """``is_single_tile`` picks K2 exactly where skix's ``_flash_forward``
    (``skix/ops/attention.py:441-464``) picks ``_fwd_kernel_single_tile``."""
    assert A.is_single_tile(S, Sk, *blocks) is single


LSE_CASES = [
    # (B, H, Sq, Sk, D, block_q, block_k_major, block_k): ragged on both
    # axes, as the tracker's 15876 × 63504 is
    (2, 1, 40, 72, 64, 16, 32, 16),
    (1, 2, 64, 64, 32, 32, 32, 32),
]


@pytest.mark.parametrize("shared_q", [False, True])
@pytest.mark.parametrize("case", LSE_CASES)
def test_plain_lse_matches_skix_kernel(case, shared_q):
    """``flash_attention_with_lse`` (plain K1 with its base-2 lse) against
    skix's K1 run with residuals through the interpreter, sm_scale 1 as the
    memory tracker calls it; ``shared_q``: one q for every batch row, the
    tracker's first layer (batch stride 0)."""
    B, H, Sq, Sk, D, bq, bkm, bk = case
    q, k, v = _inputs(case, 17)
    q = q * 0.25
    if shared_q:
        q = np.broadcast_to(q[:1], q.shape)
    want_o, want_l = _skix_kernel_lse(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), sm_scale=1.0,
                                      block_q=bq, block_k_major=bkm,
                                      block_k=bk, interpret=True)
    tq = torch.as_tensor(np.array(q[:1])).expand(q.shape) if shared_q else \
        torch.as_tensor(np.array(q))
    got_o, got_l = A.flash_attention_with_lse(tq, torch.as_tensor(k),
                                              torch.as_tensor(v), 1.0)
    assert got_l.shape == (B, H, Sq) and got_l.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=3e-5)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=3e-5)


def test_cpu_lse_launches_nothing():
    A.LAUNCHES.clear()
    q = torch.zeros(1, 1, 4, 32)
    out, lse = A.flash_attention_with_lse(q, q, q)
    assert not A.LAUNCHES and out.shape == q.shape and lse.shape == (1, 1, 4)
