"""The arithmetic of the tensor-core attention backward (K3, K4 and K5,
``skix_torch/ops/csrc/flash_bwd_tc.cuh``), emulated on the CPU in plain
torch and held against skix's attention gradients.

The card's float32 path is split-TF32, as in the forward
(``tests/test_torch_attention_tc.py``): each operand becomes hi = tf32(x)
plus lo = tf32(x − hi), each product the three tf32 passes lo·hi + hi·lo +
hi·hi summed in f32. The backward's long sums (dK and dV over every q row,
dQ over every key) are formed tile by tile: each 64-row tile's product
fresh, added to the f32 total. This emulation of both roles decides that
three passes with per-tile sums are enough: dq, dk and dv stay within 1e-5
of skix relative to each gradient's largest element, the tolerance the
card is held to, also over 5184 rows (the ViT-Det global blocks). The
emulation is this file's own; no path of the port runs it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jit0

from skix.ops.attention import flash_attention as skix_flash_attention
from skix.ops.attention import rope_2d_tables as skix_rope_tables
from skix_torch.ops import attention as A

_LOG2E = math.log2(math.e)
BN = 64


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to tf32 (10 mantissa bits), to nearest with ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, passes: int = 3):
    """a @ b as the card forms it in float32: split-TF32, the three passes
    lo·hi + hi·lo + hi·hi (or hi·hi alone with ``passes`` 1); f32 sums."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def emulate_backward(q, k, v, do, lse, di, sm_scale, rope=None, passes=3,
                     q_sel=slice(None), k_sel=slice(None)):
    """The core's backward on (B, H, S, D) f32 tensors: q and k roped (no
    rounding in f32), q_s = q_r·(sm_scale·log2e); each role forms its own S
    and dP as split products, p = exp2(s − lse), dS = p∘(dP − di); the
    dK/dV role (keys ``k_sel``) sums over every q row and the dQ role (q
    rows ``q_sel``) over every key, in BN-row tiles, each tile's product
    fresh and added in f32; dq and dk times sm_scale, un-rotated with rope.
    Returns (dq[q_sel], dk[k_sel], dv[k_sel])."""
    scale_log2 = float(np.float32(sm_scale * _LOG2E))
    scale = float(np.float32(sm_scale))
    if rope is not None:
        cos, sin = rope
        qr = q * cos + A.rotate_half(q) * sin
        kr = k * cos + A.rotate_half(k) * sin
    else:
        qr, kr = q, k
    mm = (lambda a, b: product(a, b, passes))
    qs = qr * scale_log2

    def p_ds(rows, keys):
        p = torch.exp2(mm(qs[..., rows, :], kr[..., keys, :].transpose(-1, -2))
                       - lse[..., rows, None])
        dp = mm(do[..., rows, :], v[..., keys, :].transpose(-1, -2))
        return p, p * (dp - di[..., rows, None])

    p, ds = p_ds(slice(None), k_sel)           # the dK/dV role
    dk = dv = 0.0
    for q0 in range(0, q.shape[2], BN):
        rows = slice(q0, q0 + BN)
        dv = dv + mm(p[..., rows, :].transpose(-1, -2), do[..., rows, :])
        dk = dk + mm(ds[..., rows, :].transpose(-1, -2), qr[..., rows, :])
    _, ds = p_ds(q_sel, slice(None))           # the dQ role
    dq = 0.0
    for k0 in range(0, k.shape[2], BN):
        keys = slice(k0, k0 + BN)
        dq = dq + mm(ds[..., keys], kr[..., keys, :])
    dq, dk = dq * scale, dk * scale
    if rope is not None:
        dq = dq * cos[q_sel] - A.rotate_half(dq) * sin[q_sel]
        dk = dk * cos[k_sel] - A.rotate_half(dk) * sin[k_sel]
    return dq, dk, dv


def _inputs(seed, B, H, S, D):
    r = np.random.default_rng(seed)
    return [r.normal(size=(B, H, S, D)).astype(np.float32) for _ in range(4)]


def _lse_di(q, k, v, do, sm, rope=None):
    """The forward's lse and di = Σ o·dO, from the port's plain K1."""
    cos, sin = rope if rope is not None else (None, None)
    o, lse = A.attention_reference(q, k, v, sm, rope_cos=cos, rope_sin=sin,
                                   return_lse=True)
    return lse, (o * do).sum(-1)


def _skix_grads(q, k, v, do, **kw):
    def f(q, k, v):
        return skix_flash_attention(q, k, v, **kw)

    vjp = jit0(lambda q, k, v, do: jax.vjp(f, q, k, v)[1](do))
    return [np.asarray(g) for g in vjp(*map(jnp.asarray, (q, k, v, do)))]


def _assert_within(got, want, rel):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = np.abs(g.numpy() - w).max()
        assert err <= rel * np.abs(w).max(), (name, err, np.abs(w).max())


def test_split_tf32_backward_with_rope_matches_skix_kernels():
    """Both roles, tiles of 64 rows, the rotate-half rope, against jax.vjp
    of skix's interpret-mode Pallas backward (K3 and K4) on the same
    inputs: within 1e-5 of each gradient's largest element."""
    B, H, S, D = 1, 2, 128, 64
    q, k, v, do = _inputs(1, B, H, S, D)
    pos = np.random.default_rng(2).integers(0, 24, size=(S, 2))
    cos, sin = (np.array(t) for t in skix_rope_tables(jnp.asarray(pos), D,
                                                       100.0))
    want = _skix_grads(q, k, v, do, rope_cos=cos, rope_sin=sin, block_q=64,
                       block_k_major=64, block_k=64, interpret=True)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    rope = (torch.from_numpy(cos), torch.from_numpy(sin))
    lse, di = _lse_di(qt, kt, vt, dot, D ** -0.5, rope)
    got = emulate_backward(qt, kt, vt, dot, lse, di, D ** -0.5, rope)
    _assert_within(got, want, 1e-5)


# 64 keys whose dK and dV sum over all 5184 q rows, and 64 q rows whose dQ
# sums over all 5184 keys: one CTA of each role
ROWS = slice(2560, 2624)


@pytest.fixture(scope="module")
def long_call():
    """One head over 5184 rows (the ViT-Det global blocks' sequence), and
    skix's gradients from its plain XLA path, at ROWS."""
    B, H, S, D = 1, 1, 5184, 64
    q, k, v, do = _inputs(3, B, H, S, D)
    dq, dk, dv = _skix_grads(q, k, v, do)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    lse, di = _lse_di(qt, kt, vt, dot, D ** -0.5)
    return ((qt, kt, vt, dot, lse, di, D ** -0.5),
            [x[:, :, ROWS] for x in (dq, dk, dv)])


@pytest.mark.parametrize("passes,holds", [(3, True), (1, False)])
def test_tile_sums_over_5184_rows(long_call, passes, holds):
    """Three passes with per-tile sums hold 1e-5 of each gradient's largest
    element over 5184 rows: the arithmetic that ships. One tf32 pass
    (hi·hi) does not: the reason the card pays for three."""
    args, want = long_call
    got = emulate_backward(*args, passes=passes, q_sel=ROWS, k_sel=ROWS)
    worst = max(np.abs(g.numpy() - w).max() / np.abs(w).max()
                for g, w in zip(got, want))
    assert (worst <= 1e-5) == holds, worst
