"""The port's attention backward against skix's backward kernels.

On the CPU ``skix_torch.ops.attention.flash_attention`` is a
``torch.autograd.Function`` whose backward runs the plain K3/K4
(``attention_backward_reference``) or, where the forward took the
single-tile kernel, the plain K5 (``attention_backward_single_tile_
reference``). They are held against ``jax.grad`` of skix's
``flash_attention(..., interpret=True)``, whose VJP runs the Pallas backward
kernels through the interpreter, on the ``TestPallasKernelInterpret`` shapes
of ``tests/test_ops.py`` (ragged S, cross attention, D 16/32/64), with rope.
Both sides sum in f32 in other orders: 5e-5. The CUDA kernels are held
against the plain versions on the card in ``tests/test_torch_cuda.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import jit0

from skix.ops.attention import flash_attention as skix_flash_attention
from skix.ops.attention import rope_2d_tables as skix_rope_tables
from skix_torch.ops import attention as A

ATOL = 5e-5
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


def _inputs(case, seed):
    B, H, Sq, Sk, D = case[:5]
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, H, Sq, D)).astype(np.float32),
            r.normal(size=(B, H, Sk, D)).astype(np.float32),
            r.normal(size=(B, H, Sk, D)).astype(np.float32))


def _rope(S, D):
    side = math.isqrt(S)
    ys, xs = np.meshgrid(np.arange(side), np.arange(S // side), indexing="ij")
    pos = np.stack([ys.ravel(), xs.ravel()], -1)
    return (np.array(t) for t in skix_rope_tables(jnp.asarray(pos), D, 100.0))


def _skix_grads(q, k, v, case, **kw):
    bq, bkm, bk = case[5:]

    def f(q, k, v):
        return jnp.sum(jnp.sin(skix_flash_attention(
            q, k, v, block_q=bq, block_k_major=bkm, block_k=bk,
            interpret=True, **kw)))

    g = jit0(jax.grad(f, argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    return [np.asarray(x, np.float32) for x in g]


def _port_grads(q, k, v, **kw):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    loss = torch.sin(A.flash_attention(qt, kt, vt, **kw)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, (qt, kt, vt))]


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_skix_kernels(case):
    """dq, dk, dv of the port's Function on the CPU (plain K3/K4, or plain
    K5 where the blocks make the sequence one tile) against jax.grad of
    skix's interpret-mode kernels at the same blocks."""
    q, k, v = _inputs(case, 11)
    want = _skix_grads(q, k, v, case)
    got = _port_grads(q, k, v, block_q=case[5], block_k_major=case[6],
                      block_k=case[7])
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("case", [
    (1, 2, 64, 64, 32, 32, 32, 32),       # K3/K4 with rope, two tiles
    (2, 2, 36, 36, 64, 36, 36, 36),       # K5 with window rope: one tile
    (1, 2, 100, 100, 32, 32, 32, 32),     # ragged, rope
])
def test_plain_backward_with_rope_matches_skix_kernels(case):
    """The fused rope: q and k roped inside the kernels, dq and dk
    un-rotated at the store (pair-symmetric rope_2d tables)."""
    q, k, v = _inputs(case, 13)
    cos, sin = _rope(case[2], case[4])
    want = _skix_grads(q, k, v, case, rope_cos=jnp.asarray(cos),
                       rope_sin=jnp.asarray(sin))
    got = _port_grads(q, k, v, rope_cos=torch.as_tensor(cos),
                      rope_sin=torch.as_tensor(sin), block_q=case[5],
                      block_k_major=case[6], block_k=case[7])
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("fixed_max,rope,single", [
    (None, False, False), (8.0, True, False), (None, True, True),
    (8.0, False, True)])
def test_function_matches_autograd_of_plain_forward(fixed_max, rope, single):
    """The Function's hand-written backward equals torch autograd through
    the plain forward (f32: the roundings are identities), fixed-max and
    rope included."""
    case = (2, 2, 36, 36, 32)
    q, k, v = (torch.as_tensor(x) for x in _inputs(case, 17))
    if fixed_max is not None:
        q = torch.nn.functional.layer_norm(q, (32,))
        k = torch.nn.functional.layer_norm(k, (32,))
    cos = sin = None
    if rope:
        cos, sin = (torch.as_tensor(t) for t in _rope(36, 32))
    blocks = dict(block_q=36, block_k_major=36, block_k=36) if single else {}
    kw = dict(fixed_max=fixed_max, rope_cos=cos, rope_sin=sin)
    g_out = torch.as_tensor(np.random.default_rng(3).normal(
        size=q.shape).astype(np.float32))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(A.flash_attention(*leaves, **kw, **blocks),
                              leaves, g_out)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(A.attention_reference(
        *leaves, 1 / math.sqrt(32), **kw), leaves, g_out)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def test_single_tile_backward_is_k3_k4_arithmetic():
    """Plain K5 and plain K3/K4 compute one function: K5 exists for the
    single-tile shape, not for other numbers."""
    q, k, v = (torch.as_tensor(x) for x in _inputs((3, 2, 16, 16, 32), 5))
    o, lse = A.attention_reference(q, k, v, return_lse=True)
    do = torch.ones_like(o)
    di = (o * do).sum(-1)
    a = A.attention_backward_reference(q, k, v, do, lse, di)
    b = A.attention_backward_single_tile_reference(q, k, v, do, lse, di)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=0, rtol=0)


def test_cpu_backward_launches_nothing():
    A.LAUNCHES.clear()
    q = torch.zeros(1, 1, 4, 64, requires_grad=True)
    A.flash_attention(q, q, q).sum().backward()
    assert not A.LAUNCHES and q.grad.shape == q.shape
