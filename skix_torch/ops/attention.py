"""Flash attention forward for Hopper, with its plain PyTorch version.

Port of ``skix/ops/attention.py``. The TPU kernel K1 (``_fwd_kernel``,
``skix/ops/attention.py:184``) becomes the hand-written CUDA C++ kernel in
``skix_torch/ops/csrc/flash_fwd.cu``, built for ``sm_90a`` at first use
(``skix_torch.ops._build``) and bound with ``ctypes``.

:func:`flash_attention` is the public entry. On a CUDA tensor it launches
the kernel for every call, whatever the sequence length (the TPU package's
switch to XLA below S=1024 and its block-size rules are TPU tiling choices
and are not carried over), or raises: there is no fallback. On a CPU
tensor it runs :func:`attention_reference`, the plain version, which
repeats the kernel's arithmetic and roundings:

- rope in f32 (``x∘cos + rot(x)∘sin``), then q times ``sm_scale·log2e``,
  then both q and k rounded to the input dtype;
- scores in f32, softmax in base 2 (``exp2``), with a fixed bound in
  place of the row max when ``fixed_max`` is given;
- p rounded to v's dtype before P·V, row sums of the unrounded p, the
  division guarded at l == 0, the output cast to the input dtype.

The forward is inference-only: a CUDA call that needs a gradient raises.
The base-2 lse output and the backward (K3/K4) come with the SAM3 and
training slices.
"""

from __future__ import annotations

import collections
import ctypes
import math

import numpy as np
import torch

_LOG2E = math.log2(math.e)

# Launches of each kernel of this module, counted where the kernel is
# launched and nowhere else (chip_smoke.py reads and resets it).
LAUNCHES: collections.Counter = collections.Counter()

_KERNEL_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------------
# rotary embedding tables (rotate-half within each half of D)
# --------------------------------------------------------------------------
def rotate_half_matrix(d: int, num_halves: int = 2) -> np.ndarray:
    """Signed-permutation matrix R with ``x @ R == rotate_half(x)`` applied
    within each of ``num_halves`` contiguous D segments (the VGGT 2D-rope
    convention). The port applies R by index (:func:`rotate_half`); the
    matrix is kept to state the convention and to test it."""
    assert d % num_halves == 0
    m = d // num_halves
    assert m % 2 == 0
    R = np.zeros((d, d), np.float32)
    for h in range(num_halves):
        o = h * m
        for j in range(m // 2):
            R[o + j + m // 2, o + j] = -1.0   # y[j]      = -x[j + m/2]
            R[o + j, o + j + m // 2] = 1.0    # y[m/2 + j] = x[j]
    return R


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """``x @ rotate_half_matrix(D)`` by index: within each half of the last
    axis, ``y[j] = -x[j + m/2]`` and ``y[m/2 + j] = x[j]`` (exact)."""
    D = x.shape[-1]
    a, b, c, d = x.split(D // 4, dim=-1)
    return torch.cat([-b, a, -d, c], dim=-1)


def rope_2d_tables(pos: torch.Tensor, d: int, base_freq: float):
    """Full-width cos/sin tables for the 2D rope: ``pos (N, 2)`` integer
    (y, x) coords → ``(cos, sin)`` each (N, d) float32; the first d/2
    features carry the y rotation, the second the x rotation."""
    half = d // 2
    exponents = torch.arange(0, half, 2, dtype=torch.float32,
                             device=pos.device) / half
    inv_freq = 1.0 / (base_freq ** exponents)          # (d/4,)
    ay = pos[..., 0:1].to(torch.float32) * inv_freq    # (N, d/4)
    ax = pos[..., 1:2].to(torch.float32) * inv_freq
    angles = torch.cat([ay, ay, ax, ax], dim=-1)       # (N, d)
    return torch.cos(angles), torch.sin(angles)


def _rope_f32(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    xf = x.to(torch.float32)
    return xf * cos + rotate_half(xf) * sin


def apply_rope_tables(x, cos, sin):
    """Rope from tables, ``x (B, H, S, D)``, tables ``(S, D)``; computed in
    f32 and cast back to x's dtype."""
    return _rope_f32(x, cos, sin).to(x.dtype)


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------
def attention_reference(q, k, v, sm_scale: float | None = None,
                        fixed_max: float | None = None,
                        rope_cos=None, rope_sin=None):
    """Plain PyTorch K1, shapes ``(B, H, S, D)`` → ``(B, H, Sq, D)``, with
    f32 statistics and the kernel's roundings (module docstring)."""
    dt = q.dtype
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    scale_log2 = float(np.float32(sm_scale * _LOG2E))
    if rope_cos is not None:
        qf = _rope_f32(q, rope_cos, rope_sin)
        kf = _rope_f32(k, rope_cos, rope_sin).to(dt).to(torch.float32)
    else:
        qf = q.to(torch.float32)
        kf = k.to(torch.float32)
    qf = (qf * scale_log2).to(dt).to(torch.float32)
    s = torch.matmul(qf, kf.transpose(-1, -2))
    if fixed_max is not None:
        p = torch.exp2(s - float(np.float32(fixed_max * _LOG2E)))
    else:
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return (acc / torch.where(l == 0.0, torch.ones_like(l), l)).to(dt)


# --------------------------------------------------------------------------
# the CUDA kernel
# --------------------------------------------------------------------------
def _kernel_lib():
    from skix_torch.ops import _build

    lib = _build.load("flash_fwd")
    if not getattr(lib, "_skix_typed", False):
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        lib.skix_flash_fwd.argtypes = (
            [ptr] * 6 + [i32] * 6 + [i64] * 12 + [f32, i32, f32, ptr])
        lib.skix_flash_fwd.restype = i32
        lib.skix_cuda_error_string.argtypes = [i32]
        lib.skix_cuda_error_string.restype = ctypes.c_char_p
        lib._skix_typed = True
    return lib


def _flash_fwd_cuda(q, k, v, sm_scale, fixed_max, rope_cos, rope_sin):
    """Launch K1 on q's stream. Checks what the kernel takes and raises on
    anything else."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("the CUDA flash-attention forward has no backward "
                           "yet; call it under torch.no_grad()")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q, k, v must share one dtype of {list(_DTYPE_CODES)}"
                        f"; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, D)")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {_KERNEL_HEAD_DIMS}")
    if k.shape != (B, H, Sk, D) or v.shape != (B, H, Sk, D):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Sq == 0 or Sk == 0:
        raise ValueError("empty sequence")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    if (rope_cos is None) != (rope_sin is None):
        raise ValueError("rope_cos and rope_sin come together")
    if rope_cos is not None:
        if Sq != Sk:
            raise ValueError("fused rope needs self-attention (Sq == Sk)")
        rope_cos, rope_sin = (
            t.to(device=q.device, dtype=torch.float32).contiguous()
            for t in (rope_cos, rope_sin))
        if rope_cos.shape != (Sq, D) or rope_sin.shape != (Sq, D):
            raise ValueError(f"rope tables must be ({Sq}, {D})")
    # (B, Sq, H, D) storage seen as (B, H, Sq, D): the caller's
    # transpose back to token-major order is then free
    o = torch.empty((B, Sq, H, D), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lib = _kernel_lib()
    fixed = fixed_max is not None
    with torch.cuda.device(q.device):
        err = lib.skix_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            rope_cos.data_ptr() if rope_cos is not None else None,
            rope_sin.data_ptr() if rope_sin is not None else None,
            B, H, Sq, Sk, D, _DTYPE_CODES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], float(np.float32(sm_scale * _LOG2E)), int(fixed),
            float(np.float32(fixed_max * _LOG2E)) if fixed else 0.0,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_fwd launch failed: "
                           + lib.skix_cuda_error_string(err).decode())
    LAUNCHES["flash_fwd"] += 1
    return o


def flash_attention(q, k, v, sm_scale: float | None = None,
                    fixed_max: float | None = None,
                    rope_cos=None, rope_sin=None):
    """Multi-head attention, shapes ``(B, H, S, D)`` → ``(B, H, Sq, D)``.

    ``sm_scale`` defaults to 1/√D. ``fixed_max`` is a static bound on the
    logits (qk-normed models): the softmax then runs without a running
    max. ``rope_cos``/``rope_sin`` ((S, D) float32, see
    :func:`rope_2d_tables`) apply the rotate-half rope to q and k inside
    the kernel (self-attention, Sq == Sk).

    A CUDA tensor goes through the Hopper kernel (head dim 64 or 128,
    float32 or bfloat16); a CPU tensor through :func:`attention_reference`.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, sm_scale, fixed_max, rope_cos,
                               rope_sin)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, sm_scale, fixed_max, rope_cos,
                                   rope_sin)
    raise ValueError(f"no flash_attention for device {q.device}")
