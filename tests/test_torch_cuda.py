"""The CUDA kernels of skix_torch on the card, against their plain PyTorch
versions. Needs an NVIDIA GPU and imports no JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py

Without a card every test skips.
"""

import math

import numpy as np
import pytest
import torch

from skix_torch.ops import attention as A


def _positions(n):
    ys, xs = np.meshgrid(np.arange(8), np.arange(16), indexing="ij")
    grid = np.stack([ys.ravel(), xs.ravel()], -1) + 1
    return np.concatenate([np.zeros((5, 2), np.int64), grid])[:n]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,fixed_max,rope,atol", [
    ((2, 16, 1374, 64), torch.bfloat16, 12.0, True, 2e-3),
    ((1, 16, 2748, 64), torch.bfloat16, 12.0, True, 2e-3),
    ((1, 16, 2, 128), torch.bfloat16, None, False, 2e-3),
    ((2, 3, 100, 64), torch.float32, None, True, 1e-5),
    ((1, 2, 77, 128), torch.float32, 8.0, False, 1e-5),
    ((1, 8, 5184, 32), torch.float32, None, False, 1e-5),   # fusion encoder
    ((2, 3, 100, 32), torch.bfloat16, None, True, 4e-3),
])
def test_cuda_kernel_matches_plain(cuda, shape, dtype, fixed_max, rope, atol):
    """K1 on the card against its plain version on the same inputs (bf16:
    the outputs round to bf16 after f32 sums taken in another order, a
    step of 2⁻⁸ relative; f32: the sum order alone)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    B, H, S, D = shape
    q, k, v = (torch.randn(shape, generator=g, device=cuda) for _ in range(3))
    if fixed_max is not None:
        q = torch.nn.functional.layer_norm(q, (D,))
        k = torch.nn.functional.layer_norm(k, (D,))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    cos = sin = None
    if rope:
        pos = torch.as_tensor(np.resize(_positions(133), (S, 2)), device=cuda)
        cos, sin = A.rope_2d_tables(pos, D, 100.0)
    before = A.LAUNCHES["flash_fwd"]
    with torch.no_grad():
        out = A.flash_attention(q, k, v, fixed_max=fixed_max, rope_cos=cos,
                                rope_sin=sin)
        torch.cuda.synchronize()
        ref = A.attention_reference(q, k, v, 1 / math.sqrt(D), fixed_max,
                                    cos, sin)
    assert A.LAUNCHES["flash_fwd"] == before + 1
    assert out.dtype == dtype and out.shape == shape
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("single", [False, True])
def test_cuda_autograd_launches_forward_and_backward(cuda, single):
    """A CUDA call that needs a gradient runs the forward with its lse and
    the backward kernels: K1 then K3 + K4, or K2 then K5 where the blocks
    make the sequence one tile; the gradients equal the plain backward's
    on the same inputs."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn((2, 2, 64, 64), generator=g, device=cuda)
               .requires_grad_() for _ in range(3))
    do = torch.randn((2, 2, 64, 64), generator=g, device=cuda)
    blocks = dict(block_q=64, block_k_major=64, block_k=64) if single else {}
    before = dict(A.LAUNCHES)
    out = A.flash_attention(q, k, v, **blocks)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    want = (("flash_fwd_single_tile_lse", "flash_bwd_single_tile") if single
            else ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq"))
    for name in want:
        assert A.LAUNCHES[name] == before.get(name, 0) + 1, name
    with torch.no_grad():
        o, lse = A.attention_reference(q, k, v, return_lse=True)
        ref = A.attention_backward_reference(q, k, v, do, lse,
                                             (o * do).sum(-1))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def _backward_case(cuda, shape_q, Sk, dtype, rope, fixed_max, single):
    B, H, Sq, D = shape_q
    q, k, v = _qkv(cuda, shape_q, (B, H, Sk, D), dtype, seed=7)
    do = _qkv(cuda, shape_q, shape_q, dtype, seed=8)[0]
    if fixed_max is not None:
        q = torch.nn.functional.layer_norm(q, (D,))
        k = torch.nn.functional.layer_norm(k, (D,))
    cos = sin = None
    if rope:
        pos = torch.as_tensor(np.resize(_positions(133), (Sq, 2)), device=cuda)
        cos, sin = A.rope_2d_tables(pos, D, 100.0)
    sm = 1 / math.sqrt(D)
    fwd = "flash_fwd_single_tile" if single else "flash_fwd"
    kernels = (("flash_bwd_single_tile",) if single
               else ("flash_bwd_dkv", "flash_bwd_dq"))
    with torch.no_grad():
        o, lse = A._launch(fwd, q, k, v, sm, fixed_max, cos, sin, True)
        di = (o.float() * do.float()).sum(-1)
        before = dict(A.LAUNCHES)
        got = A._launch_backward(kernels, q, k, v, do, lse, di, sm, cos, sin)
        torch.cuda.synchronize()
        ref = A.attention_backward_reference(q, k, v, do, lse, di, sm, cos,
                                             sin)
    for name in kernels:
        assert A.LAUNCHES[name] == before.get(name, 0) + 1
    return got, ref


@pytest.mark.cuda
@pytest.mark.parametrize("shape_q,Sk,dtype,rope,fixed_max", [
    ((2, 4, 5184, 64), 5184, torch.float32, True, None),   # ViT-Det global
    ((2, 8, 5184, 32), 5184, torch.float32, False, None),  # fusion encoder
    ((2, 3, 1000, 64), 1000, torch.float32, True, None),   # ragged
    ((1, 2, 77, 128), 130, torch.float32, False, None),    # cross, D = 128
    ((2, 4, 1374, 64), 1374, torch.bfloat16, True, 12.0),  # VGGT frame
])
def test_cuda_backward_matches_plain(cuda, shape_q, Sk, dtype, rope,
                                     fixed_max):
    """K3 and K4 against the plain K3/K4 on the same inputs and lse: f32
    sums in another order (relative 1e-5 of each gradient's largest
    element); bf16: p, dS and the output round to bf16 (2e-2 relative)."""
    got, ref = _backward_case(cuda, shape_q, Sk, dtype, rope, fixed_max,
                              False)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, ref):
        assert a.dtype == dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=tol * b.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("shape_q,dtype,rope,fixed_max", [
    ((9, 16, 576, 64), torch.float32, True, None),   # ViT-Det windows
    ((2, 2, 77, 32), torch.float32, True, 8.0),      # ragged
    ((2, 4, 576, 64), torch.bfloat16, True, None),
    ((3, 2, 16, 32), torch.float32, True, None),     # the tiny detector
])
def test_cuda_single_tile_backward_matches_plain(cuda, shape_q, dtype, rope,
                                                 fixed_max):
    """K5 (one launch: dK/dV CTAs and dQ CTAs) against the plain K5."""
    got, ref = _backward_case(cuda, shape_q, shape_q[2], dtype, rope,
                              fixed_max, True)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=tol * b.float().abs().max().item())


def _qkv(cuda, shape_q, shape_k, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(shape_q, generator=g, device=cuda)
    k = torch.randn(shape_k, generator=g, device=cuda)
    v = torch.randn(shape_k, generator=g, device=cuda)
    return q.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape_q,shape_k,dtype,fixed_max,rope,atol", [
    ((9, 16, 576, 64), (9, 16, 576, 64), torch.float32, None, True, 1e-5),
    ((2, 4, 576, 64), (2, 4, 576, 64), torch.bfloat16, None, True, 4e-3),
    ((3, 2, 16, 32), (3, 2, 16, 32), torch.float32, None, True, 1e-5),
    ((1, 4, 40, 32), (1, 4, 72, 32), torch.float32, 8.0, False, 1e-5),
    ((2, 2, 100, 128), (2, 2, 100, 128), torch.float32, None, False, 1e-5),
])
def test_cuda_single_tile_matches_plain(cuda, shape_q, shape_k, dtype,
                                        fixed_max, rope, atol):
    """K2, where skix's dispatcher picks it (the blocks tile each sequence
    once), against the plain single-tile version; its lse against the
    plain lse (f32 sums in another order: ≤ 1e-5)."""
    q, k, v = _qkv(cuda, shape_q, shape_k, dtype)
    if fixed_max is not None:
        q = torch.nn.functional.layer_norm(q, (q.shape[-1],))
        k = torch.nn.functional.layer_norm(k, (k.shape[-1],))
    Sq, Sk, D = shape_q[2], shape_k[2], shape_q[3]
    cos = sin = None
    if rope:
        from skix_torch.models.layers import make_grid_positions

        side = int(math.isqrt(Sq))
        pos = torch.as_tensor(make_grid_positions(side, side), device=cuda)
        cos, sin = A.rope_2d_tables(pos, D, 100.0)
    before = dict(A.LAUNCHES)
    with torch.no_grad():
        out = A.flash_attention(q, k, v, fixed_max=fixed_max, rope_cos=cos,
                                rope_sin=sin, block_q=Sq, block_k_major=Sk,
                                block_k=Sk)
        o2, lse = A._launch("flash_fwd_single_tile", q, k, v,
                            1 / math.sqrt(D), fixed_max, cos, sin, True)
        torch.cuda.synchronize()
        ref, ref_lse = A.attention_single_tile_reference(
            q, k, v, 1 / math.sqrt(D), fixed_max, cos, sin, return_lse=True)
    assert A.LAUNCHES["flash_fwd_single_tile"] == \
        before.get("flash_fwd_single_tile", 0) + 1
    assert A.LAUNCHES["flash_fwd"] == before.get("flash_fwd", 0)
    assert out.dtype == dtype and out.shape == shape_q
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    torch.testing.assert_close(o2, out, atol=0, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape_q,Sk,dtype", [
    ((4, 1, 1000, 64), 4100, torch.float32),   # ragged on both axes
    ((2, 2, 77, 32), 130, torch.float32),
    ((2, 2, 77, 128), 130, torch.bfloat16),
])
def test_cuda_lse_matches_plain(cuda, shape_q, Sk, dtype):
    """K1 with its base-2 lse output against the plain version, with a q
    shared by every batch row (batch stride 0), as the memory tracker's
    first layer passes it. The lse feeds a correction that divides by
    1 − r, so it is held to 1e-5, not only the output."""
    B, H, Sq, D = shape_q
    q, k, v = _qkv(cuda, (1, H, Sq, D), (B, H, Sk, D), dtype, seed=3)
    q = q.expand(B, H, Sq, D)
    before = A.LAUNCHES["flash_fwd_lse"]
    with torch.no_grad():
        out, lse = A.flash_attention_with_lse(q, k, v, sm_scale=1.0)
        torch.cuda.synchronize()
        ref, ref_lse = A.attention_reference(q, k, v, 1.0, return_lse=True)
    assert A.LAUNCHES["flash_fwd_lse"] == before + 1
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    # bf16: one bf16 step (2⁻⁷ relative) at the largest |o|, as sm_scale 1
    # on unit-normal inputs makes the softmax nearly one-hot (|o| up to 4)
    atol = (2 ** -7 * ref.float().abs().max().item()
            if dtype == torch.bfloat16 else 1e-5)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5 if dtype ==
                               torch.float32 else 1e-3, rtol=0)
