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
def test_cuda_kernel_refuses_gradients(cuda):
    q = torch.zeros(1, 1, 8, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        A.flash_attention(q, q, q)


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
