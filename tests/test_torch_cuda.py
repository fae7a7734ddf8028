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
