"""The arithmetic of the tensor-core attention forward (K1 and K2,
``skix_torch/ops/csrc/flash_tc.cuh``), emulated on the CPU in plain torch and
held against skix's attention.

The card's float32 path is split-TF32: each operand becomes hi = tf32(x)
(``cvt.rna.tf32.f32``: round to nearest, ties away, on the int32 view) plus
lo = tf32(x − hi), and each product the three tf32 passes lo·hi + hi·lo +
hi·hi summed in f32, over 64-key tiles with the online base-2 softmax and p
rounded to v's type before P·V. This emulation decides that three passes
are enough: o and lse stay within 1e-5 of skix, the tolerance the card is
held to, also at a key count shaped like the memory tracker's (its lse is
divided by 1 − r, r up to 1 − 1e-6). The emulation is this file's own; no
path of the port runs it.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skix.ops.attention import flash_attention as skix_flash_attention
from skix.ops.attention import flash_attention_with_lse as skix_with_lse
from skix.ops.attention import rope_2d_tables as skix_rope_tables
from skix_torch.ops import attention as A

_LOG2E = math.log2(math.e)
BK = 64


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to tf32 (10 mantissa bits), to nearest with ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the card forms it in float32: split-TF32, the three passes
    lo·hi + hi·lo + hi·hi; f32 sums."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def emulate(q, k, v, sm_scale, rope=None, bf16=False):
    """The core's forward on (B, H, S, D) f32 tensors: rope and scale with
    the TPU kernel's roundings (bf16: q, k, v and p rounded to bf16 and the
    products exact in f32, as one bf16 wgmma forms them), 64-key tiles,
    online base-2 softmax; returns (o, lse)."""
    rnd = (lambda x: x.to(torch.bfloat16).float()) if bf16 else (lambda x: x)
    if rope is not None:
        cos, sin = rope
        qf = q * cos + A.rotate_half(q) * sin
        kf = rnd(k * cos + A.rotate_half(k) * sin)
    else:
        qf, kf = q, k
    qf = rnd(qf * float(np.float32(sm_scale * _LOG2E)))
    mm = (lambda a, b: a @ b) if bf16 else product
    v = rnd(v)
    B, H, Sq, D = q.shape
    m = torch.full((B, H, Sq, 1), -math.inf)
    l = torch.zeros((B, H, Sq, 1))
    o = torch.zeros((B, H, Sq, D))
    for k0 in range(0, k.shape[2], BK):
        s = mm(qf, kf[:, :, k0:k0 + BK].transpose(-1, -2))
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - mn)
        p = torch.exp2(s - mn)
        l = alpha * l + p.sum(-1, keepdim=True)
        o = alpha * o + mm(rnd(p), v[:, :, k0:k0 + BK])
        m = mn
    return o / l, (m + torch.log2(l))[..., 0]


def _rng_inputs(seed, B, H, Sq, Sk, D, q_scale=1.0):
    r = np.random.default_rng(seed)
    q = (r.normal(size=(B, H, Sq, D)) * q_scale).astype(np.float32)
    k = r.normal(size=(B, H, Sk, D)).astype(np.float32)
    v = r.normal(size=(B, H, Sk, D)).astype(np.float32)
    return q, k, v


@pytest.fixture(scope="module")
def tracker_call():
    """The memory tracker's call (q scaled by 1/8, sm_scale 1, lse out) at
    4096 keys, and skix's (o, lse) for it."""
    q, k, v = _rng_inputs(0, 2, 1, 64, 4096, 64, q_scale=0.125)
    o_ref, lse_ref = skix_with_lse(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), 1.0)
    return (q, k, v), np.asarray(o_ref), np.asarray(lse_ref)


def test_split_tf32_holds_at_the_trackers_key_count(tracker_call):
    """Three passes stay within 1e-5 of skix in o and lse: the split that
    ships."""
    (q, k, v), o_ref, lse_ref = tracker_call
    o, lse = emulate(*(torch.from_numpy(x) for x in (q, k, v)), 1.0)
    np.testing.assert_allclose(o.numpy(), o_ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-5, rtol=0)


def test_single_tf32_pass_is_not_enough(tracker_call):
    """One tf32 pass (hi·hi) misses 1e-5 at the same call: the reason the
    card pays for three."""
    (q, k, v), o_ref, _ = tracker_call
    qt, kt, vt = (tf32(torch.from_numpy(x)) for x in (q, k, v))
    s = (qt @ kt.transpose(-1, -2)) * _LOG2E
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    o = (tf32(p) @ vt) / p.sum(-1, keepdim=True)
    assert np.abs(o.numpy() - o_ref).max() > 1e-5


def test_split_tf32_with_rope_matches_skix():
    """A window-like call with the rotate-half rope against skix's
    flash_attention (its XLA path on the CPU), within 1e-5."""
    B, H, S, D = 1, 2, 128, 64
    q, k, v = _rng_inputs(1, B, H, S, S, D)
    r = np.random.default_rng(2)
    pos = r.integers(0, 24, size=(S, 2))
    cos, sin = skix_rope_tables(jnp.asarray(pos), D, 100.0)
    ref = np.asarray(skix_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), rope_cos=cos,
        rope_sin=sin))
    o, _ = emulate(*(torch.from_numpy(x) for x in (q, k, v)), D ** -0.5,
                   rope=(torch.from_numpy(np.array(cos)),
                         torch.from_numpy(np.array(sin))))
    np.testing.assert_allclose(o.numpy(), ref, atol=1e-5, rtol=0)


def test_bf16_tile_order_matches_skix():
    """The bf16 path (one bf16 product per tile, p rounded to bf16) against
    skix's flash_attention on bf16 inputs, within 4e-3 (a bf16 output
    step)."""
    B, H, S, D = 1, 2, 192, 64
    q, k, v = _rng_inputs(3, B, H, S, S, D)
    qb, kb, vb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(skix_flash_attention(qb, kb, vb), np.float32)
    as_bf = (lambda x: torch.from_numpy(x).to(torch.bfloat16).float())
    o, _ = emulate(as_bf(q), as_bf(k), as_bf(v), D ** -0.5, bf16=True)
    np.testing.assert_allclose(o.to(torch.bfloat16).float().numpy(), ref,
                               atol=4e-3, rtol=0)
