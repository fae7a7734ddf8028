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
    ((1, 2, 300, 128), 300, torch.bfloat16, True, None),   # D = 128 bf16
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
    ((2, 2, 128, 128), torch.bfloat16, True, None),  # D = 128 bf16
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,single", [
    ((9, 16, 576, 64), True),     # ViT-Det windows: K5
    ((2, 4, 5184, 64), False),    # ViT-Det global blocks: K3 + K4
])
def test_cuda_backward_is_deterministic(cuda, shape, single):
    """The backward kernels use no atomics (each gradient element is
    written once, by one CTA): two launches on the same inputs give
    bitwise equal dq, dk and dv."""
    q, k, v = _qkv(cuda, shape, shape, torch.float32, seed=11)
    do = _qkv(cuda, shape, shape, torch.float32, seed=12)[0]
    pos = torch.as_tensor(np.resize(_positions(133), (shape[2], 2)),
                          device=cuda)
    cos, sin = A.rope_2d_tables(pos, shape[3], 100.0)
    sm = 1 / math.sqrt(shape[3])
    fwd = "flash_fwd_single_tile" if single else "flash_fwd"
    with torch.no_grad():
        o, lse = A._launch(fwd, q, k, v, sm, None, cos, sin, True)
        di = (o * do).sum(-1)
        runs = [A._launch_backward(A._BACKWARD_OF[fwd], q, k, v, do, lse, di,
                                   sm, cos, sin) for _ in range(2)]
        torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


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


def _style_tables(cuda, style, S, D):
    """Tables of each rope style: the sam3 axial angles (interleaved) or
    random 3D positions (segments, axes (8, 12, 8) of D = 32)."""
    if style == "interleaved":
        from skix_torch.tracking.vitdet import axial_rope_angles

        side = math.isqrt(S)
        gh, gw = (side, side) if side * side == S else (1, S)
        return A.interleaved_rope_tables(torch.as_tensor(
            axial_rope_angles(gh, gw, D), device=cuda))
    g = torch.Generator(device=cuda).manual_seed(6)
    return A.rope_3d_tables(torch.randint(0, 12, (S, 3), generator=g,
                                          device=cuda), D, style[1])


STYLE_CASES = [
    # (shape, dtype, style, single tile)
    ((1, 16, 5184, 64), torch.float32, "interleaved", False),  # global
    ((9, 16, 576, 64), torch.float32, "interleaved", True),    # windows
    ((2, 3, 1000, 64), torch.float32, "interleaved", False),   # ragged
    ((2, 4, 576, 64), torch.bfloat16, "interleaved", True),
    ((1, 2, 64, 32), torch.float32, ("segments", (8, 12, 8)), False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,style,single", STYLE_CASES)
def test_cuda_rope_styles_match_plain(cuda, shape, dtype, style, single):
    """K1 or K2 with the interleaved or segmented rope, its lse, and its
    backward (K3 + K4, or K5) against the plain versions on the same
    inputs; the launches are counted under the style."""
    B, H, S, D = shape
    q, k, v = _qkv(cuda, shape, shape, dtype, seed=9)
    do = _qkv(cuda, shape, shape, dtype, seed=10)[0]
    cos, sin = _style_tables(cuda, style, S, D)
    sm = 1 / math.sqrt(D)
    fwd = "flash_fwd_single_tile" if single else "flash_fwd"
    kernels = A._BACKWARD_OF[fwd]
    before = dict(A.LAUNCHES_BY_STYLE)
    with torch.no_grad():
        o, lse = A._launch(fwd, q, k, v, sm, None, cos, sin, True, style)
        di = (o.float() * do.float()).sum(-1)
        got = A._launch_backward(kernels, q, k, v, do, lse, di, sm, cos, sin,
                                 style)
        torch.cuda.synchronize()
        ref, ref_lse = A.attention_reference(q, k, v, sm, None, cos, sin,
                                             True, style)
        ref_g = A.attention_backward_reference(q, k, v, do, lse, di, sm, cos,
                                               sin, style)
    name = A.style_name(style)
    for key in (fwd + "_lse", *kernels):
        assert A.LAUNCHES_BY_STYLE[f"{key}/{name}"] == \
            before.get(f"{key}/{name}", 0) + 1
    f32 = dtype == torch.float32
    torch.testing.assert_close(o.float(), ref.float(), rtol=0,
                               atol=1e-5 if f32 else 4e-3)
    if f32:
        torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)
    for a, b in zip(got, ref_g):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=(
            1e-5 if f32 else 2e-2) * b.float().abs().max().item())


@pytest.mark.cuda
def test_cuda_vitdet_sam3_matches_cpu(cuda):
    """The sam3 ViT-Det trunk (interleaved rope through K2 and K1) on the
    card against the same weights on the CPU (plain versions)."""
    from skix_torch.tracking.vitdet import ViTDetBackbone

    kw = dict(img_size=112, patch_size=14, embed_dim=64, depth=2,
              num_heads=2, mlp_ratio=4.0, window_size=4,
              global_att_blocks=(1,), rope_style="sam3",
              pretrain_img_size=56)
    cpu = ViTDetBackbone(**kw)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in cpu.parameters():
            p.normal_(0.0, 0.1, generator=g)
    card = ViTDetBackbone(**kw).to(cuda)
    card.load_state_dict(cpu.state_dict())
    img = torch.randn((1, 112, 112, 3), generator=g)
    before = dict(A.LAUNCHES_BY_STYLE)
    with torch.no_grad():
        want = cpu(img)
        got = card(img.to(cuda))
    assert A.LAUNCHES_BY_STYLE["flash_fwd_single_tile/interleaved"] == \
        before.get("flash_fwd_single_tile/interleaved", 0) + 1
    assert A.LAUNCHES_BY_STYLE["flash_fwd/interleaved"] == \
        before.get("flash_fwd/interleaved", 0) + 1
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape_q,Sk,dtype,layout", [
    ((2, 3, 130, 64), 70, torch.float32, "token_major"),  # ragged q and k tiles
    ((3, 2, 65, 32), 200, torch.bfloat16, "shared_q"),    # q of batch stride 0
    ((1, 2, 33, 128), 97, torch.float32, "offset_view"),  # a view 8 B off
    ((1, 2, 129, 128), 129, torch.bfloat16, "token_major"),
])
def test_cuda_tensor_core_layouts_match_plain(cuda, shape_q, Sk, dtype,
                                              layout):
    """The wgmma core (K1) on the layouts the paths hand it: q and k tiles
    cut off mid-tile, token-major (B, S, H, D) views, a q shared by every
    batch row, and a view whose base is not 16-byte aligned (copied by the
    wrapper); f32 within 1e-5, bf16 within 4e-3 of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(7)
    B, H, Sq, D = shape_q

    def make(S, rows=B):
        if layout == "token_major":
            return torch.randn((rows, S, H, D), generator=g,
                               device=cuda).to(dtype).transpose(1, 2)
        if layout == "offset_view":
            flat = torch.randn(rows * H * S * D + 2, generator=g, device=cuda)
            return flat[2:].view(rows, H, S, D).to(dtype) if dtype != \
                torch.float32 else flat[2:].view(rows, H, S, D)
        return torch.randn((rows, H, S, D), generator=g,
                           device=cuda).to(dtype)

    q = make(Sq, 1).expand(B, H, Sq, D) if layout == "shared_q" else make(Sq)
    k, v = make(Sk), make(Sk)
    with torch.no_grad():
        out, lse = A._launch("flash_fwd", q, k, v, D ** -0.5, None, None,
                             None, True)
        torch.cuda.synchronize()
        ref, ref_lse = A.attention_reference(q, k, v, D ** -0.5,
                                             return_lse=True)
    atol = 1e-5 if dtype == torch.float32 else 4e-3
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,dtype", [
    ("full", "float32"), ("norope", "float32"), ("fixedmax", "float32"),
    ("nosoftmax", "float32"), ("scoresonly", "float32"),
    ("p_bf16", "float32"), ("heads2", "float32"), ("full", "bfloat16"),
    ("kv_other_major", "bfloat16"), ("heads2", "bfloat16"),
    ("nosoftmax", "bfloat16"), ("scoresonly", "bfloat16"),
])
def test_cuda_window_probe_variants_match_plain(cuda, variant, dtype):
    """Each of K2's probe variants against its plain version, at two
    windows of 4 heads (the probes' tolerances, window_probe.tolerance)."""
    from skix_torch.ops import window_probe as W

    g = torch.Generator(device=cuda).manual_seed(3)
    shape = (2, 5, 576, 64)     # an odd head count: heads2's last CTA
    q, k, v, cos, sin, style = W._inputs(dtype, True, g, shape)
    with torch.no_grad():
        got = W.launch(variant, q, k, v, cos, sin, style, 0.125)
        torch.cuda.synchronize()
        ref = W.plain(variant, q, k, v, cos, sin, style, 0.125)
    scale = max(1.0, ref.float().abs().max().item())
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= W.tolerance(variant, dtype) * scale


@pytest.mark.cuda
def test_cuda_f32_lse_at_large_logits_is_no_further_from_float64(cuda):
    """test_cuda_lse_matches_plain's f32 case (sm_scale 1 on unit-normal
    inputs: logits near 50) against the same function evaluated in
    float64 after the plain version's rounding of the scaled q: the
    split-TF32 kernel is no further from it than the plain f32 version,
    in o and in the lse. Prints the four distances."""
    B, H, Sq, D, Sk = 4, 1, 1000, 64, 4100
    q, k, v = _qkv(cuda, (1, H, Sq, D), (B, H, Sk, D), torch.float32, seed=3)
    q = q.expand(B, H, Sq, D)
    with torch.no_grad():
        out, lse = A.flash_attention_with_lse(q, k, v, sm_scale=1.0)
        ref, ref_lse = A.attention_reference(q, k, v, 1.0, return_lse=True)
        qs = (q * float(np.float32(math.log2(math.e)))).double()
        s = qs @ k.double().transpose(-1, -2)
        m = s.amax(-1, keepdim=True)
        p = torch.exp2(s - m)
        l = p.sum(-1, keepdim=True)
        o64, lse64 = p @ v.double() / l, (m + torch.log2(l))[..., 0]
    dist = {name: (x.double() - y).abs().max().item() for name, x, y in (
        ("kernel_o", out, o64), ("plain_o", ref, o64),
        ("kernel_lse", lse, lse64), ("plain_lse", ref_lse, lse64))}
    print(dist)
    assert dist["kernel_o"] <= dist["plain_o"]
    assert dist["kernel_lse"] <= dist["plain_lse"]


@pytest.mark.cuda
def test_cuda_lifter_matches_cpu(cuda):
    """The temporal lifter at the published width (channels 1024, widths
    3×5, 243 frames) on the card, cuDNN's TF32 off inside its forward,
    against the CPU on the same seeded weights and input: float32 sums in
    another order only."""
    from skix_torch.models.videopose3d import TemporalLifter, infer_sequence
    from skix_torch.pipelines.videopose3d import init_lifter

    model = init_lifter(TemporalLifter(channels=1024)).eval()
    x = torch.randn(300, 17, 2, generator=torch.Generator().manual_seed(0))
    want = infer_sequence(model, x)
    got = infer_sequence(model.to(cuda), x.to(cuda)).cpu()
    assert torch.backends.cudnn.allow_tf32    # the global flag is untouched
    assert got.shape == (300, 17, 3)
    err = (got - want).abs().max().item()
    assert err < 1e-4, err


@pytest.mark.cuda
def test_cuda_batched_ransac_matches_cpu(cuda):
    """The kpt route's batched RANSAC on the card against the CPU with the
    same draws (ransac_samples draws on the CPU): 900 frames × 256
    hypotheses, the same inliers, R and t within 1e-4."""
    from skix_torch.geometry.epipolar import estimate_relative_pose

    g = np.random.default_rng(3)
    T, N = 900, 17
    K = torch.tensor([[1116.93, 0.0, 955.77], [0.0, 1117.33, 538.91],
                      [0.0, 0.0, 1.0]])
    z = g.uniform(6.0, 16.0, size=(T, N, 1))
    X = np.concatenate([g.uniform(-0.8, 0.8, size=(T, N, 2)) * z, z], -1)
    c, s = np.cos(0.35), np.sin(0.35)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    Xb = X @ R.T + np.array([-6.0, 0.2, 1.0])
    kn = K.numpy().astype(np.float64)
    a = (X[..., :2] / X[..., 2:] * kn[[0, 1], [0, 1]] + kn[:2, 2]
         + g.normal(size=(T, N, 2)) * 0.2).astype(np.float32)
    b = (Xb[..., :2] / Xb[..., 2:] * kn[[0, 1], [0, 1]] + kn[:2, 2]
         + g.normal(size=(T, N, 2)) * 0.2).astype(np.float32)
    outs = [estimate_relative_pose(
        torch.tensor(a, device=dev), torch.tensor(b, device=dev),
        K.to(dev), generator=torch.Generator().manual_seed(0))
        for dev in ("cpu", cuda)]
    want, got = outs
    assert torch.equal(got.inliers.cpu(), want.inliers)
    assert (got.R.cpu() - want.R).abs().max().item() < 1e-4
    assert (got.t.cpu() - want.t).abs().max().item() < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rope", [
    ((8, 6, 256, 64), False),      # run_all's vit_hmr side backbone
    ((8, 20, 1029, 64), True),     # DINOv3 ViT-H+/16 at crop 512
    ((4, 16, 10769, 64), False),   # MoGe ViT-L/14 on padded 1080p frames
])
def test_cuda_side_view_shapes_match_plain(cuda, shape, rope):
    """K1 at the side-view path's shapes against the plain version, float32
    (the sum order alone: 1e-5). The DINOv3 case ropes with the trunk's
    tables: identity rows (cos 1, sin 0) for its 5 prefix tokens, its axial
    angles on the 32² patch rows, rotate-half over the whole head (the
    one-segment style); the rope pass leaves the prefix rows of q (times
    sm_scale·log2e) and k as they are. MoGe's plain version runs a batch row
    at a time (a 7.4 GB score matrix each)."""
    from skix_torch.models.dinov3 import (dinov3_rope_periods,
                                          rope_tables_with_prefix)

    B, H, S, D = shape
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn(shape, generator=g, device=cuda) for _ in range(3))
    kw = {}
    if rope:
        cos, sin = rope_tables_with_prefix(torch.as_tensor(
            dinov3_rope_periods(D), device=cuda), 32, 32, 5)
        assert torch.equal(cos[:5], torch.ones_like(cos[:5]))
        assert torch.equal(sin[:5], torch.zeros_like(sin[:5]))
        kw = dict(rope_cos=cos, rope_sin=sin, rope_rotate=("segments", (D,)))
        qr = A._rope_pass(q, cos, sin, A._rotation_codes(
            D, ("segments", (D,)), q.device), None)
        torch.testing.assert_close(qr[:, :, :5], q[:, :, :5], rtol=0, atol=0)
    before = A.LAUNCHES["flash_fwd"]
    with torch.no_grad():
        out = A.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert A.LAUNCHES["flash_fwd"] == before + 1
        ref = torch.cat([A.attention_reference(
            q[b:b + 1], k[b:b + 1], v[b:b + 1], 1 / math.sqrt(D), **kw)
            for b in range(B)])
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,rope", [
    ((1, 16, 41220, 64), True),    # single mode (S = 30): global blocks
    ((30, 16, 1374, 64), True),    # single mode: frame blocks
    ((1, 16, 30, 128), False),     # single mode: camera trunk
    ((1, 16, 10992, 64), True),    # sfm mode (S = 8): global blocks
    ((8, 16, 1374, 64), True),     # sfm mode: frame blocks
    ((1, 16, 8, 128), False),      # sfm mode: camera trunk
    ((8, 16, 1374, 64), False),    # the DINOv2 patch embed (vit)
])
def test_cuda_vggt_cli_shapes_match_plain(cuda, shape, rope):
    """K1 at the vggt CLI's shapes (VGGT-1B, bf16) against the plain
    version: the aggregator's blocks qk-normed, in fixed-max mode (bound 12)
    with the 2D rope of the VGGT layout (5 special tokens at (0, 0), the
    37 × 37 grid + 1, repeated per frame in the global layout); the camera
    trunk and the DINOv2 trunk with no rope and an online max. bf16: the
    outputs round to bf16 after f32 sums taken in another order (4e-3, and
    one bf16 step, up to 2⁻⁷ of the value, where that is larger: the camera
    trunk's few-token averages reach 2-3).
    The plain version runs a head at a time at the largest shape (a 6.8 GB
    score matrix each)."""
    B, H, S, D = shape
    g = torch.Generator(device=cuda).manual_seed(13)
    q, k, v = (torch.randn(shape, generator=g, device=cuda) for _ in range(3))
    kw = {}
    if rope:
        q = torch.nn.functional.layer_norm(q, (D,))
        k = torch.nn.functional.layer_norm(k, (D,))
        ys, xs = np.meshgrid(np.arange(37), np.arange(37), indexing="ij")
        frame = np.concatenate([np.zeros((5, 2), np.int64),
                                np.stack([ys.ravel(), xs.ravel()], -1) + 1])
        pos = torch.as_tensor(np.tile(frame, (S // len(frame), 1)),
                              device=cuda)
        cos, sin = A.rope_2d_tables(pos, D, 100.0)
        kw = dict(fixed_max=12.0, rope_cos=cos, rope_sin=sin)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    before = A.LAUNCHES["flash_fwd"]
    with torch.no_grad():
        out = A.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert A.LAUNCHES["flash_fwd"] == before + 1
        ref = torch.cat([torch.cat([A.attention_reference(
            q[b:b + 1, h:h + 1], k[b:b + 1, h:h + 1], v[b:b + 1, h:h + 1],
            1 / math.sqrt(D), **kw) for h in range(H)], 1)
            for b in range(B)])
    assert out.dtype == torch.bfloat16 and out.shape == shape
    torch.testing.assert_close(out.float(), ref.float(), atol=4e-3,
                               rtol=2 ** -7)
