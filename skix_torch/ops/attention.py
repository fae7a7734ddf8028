"""Flash attention forward for Hopper, with its plain PyTorch versions.

Port of ``skix/ops/attention.py``. Its two forward TPU kernels become
hand-written CUDA C++ kernels, built for ``sm_90a`` at first use
(``skix_torch.ops._build``) and bound with ``ctypes``:

- K1 (``_fwd_kernel``, ``skix/ops/attention.py:184``) →
  ``skix_torch/ops/csrc/flash_fwd.cu``: online softmax over kv tiles, with
  an optional base-2 log-partition output;
- K2 (``_fwd_kernel_single_tile``, ``:313``) →
  ``skix_torch/ops/csrc/flash_fwd_single_tile.cu``: the exact one-pass
  softmax that skix's dispatcher (``:459-464``) picks when the whole
  sequence is one tile.

:func:`flash_attention` is the public entry. It takes skix's
``block_q``/``block_k_major``/``block_k`` keywords: where skix would pick
K2 (the given blocks tile both sequences exactly once, no padding,
:func:`is_single_tile`) a CUDA tensor launches K2; everywhere else K1,
whatever the sequence length (skix's switch to XLA below its 1024 block is
a TPU tiling choice and is not carried over). A call the kernel cannot
take raises: there is no fallback. :func:`flash_attention_with_lse`
launches K1 with its lse output. On a CPU tensor the same entries run the
plain versions, :func:`attention_single_tile_reference` at K2's dispatch
and :func:`attention_reference` elsewhere, which repeat the kernels'
arithmetic and roundings:

- rope in f32 (``x∘cos + rot(x)∘sin``), then q times ``sm_scale·log2e``,
  then both q and k rounded to the input dtype;
- scores in f32, softmax in base 2 (``exp2``), with a fixed bound in
  place of the row max when ``fixed_max`` is given;
- p rounded to v's dtype before P·V, row sums of the unrounded p, the
  division guarded at l == 0, the output cast to the input dtype;
- lse = m + log2(l) in base 2 (0 where l == 0), m the row max or the fixed
  bound.

The forward is inference-only: a CUDA call that needs a gradient raises.
The backward (K3/K4/K5) comes with the training slice.
"""

from __future__ import annotations

import collections
import ctypes
import math

import numpy as np
import torch

_LOG2E = math.log2(math.e)

# Launches of each kernel of this module, counted where the kernel is
# launched and nowhere else (chip_smoke.py reads and resets it): K1 as
# "flash_fwd" and, with its lse output, "flash_fwd_lse"; K2 as
# "flash_fwd_single_tile".
LAUNCHES: collections.Counter = collections.Counter()

_KERNEL_HEAD_DIMS = (32, 64, 128)
_MAX_SMEM_PER_BLOCK = 232448     # H100: 227 KB of dynamic shared memory
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
# plain versions
# --------------------------------------------------------------------------
def attention_reference(q, k, v, sm_scale: float | None = None,
                        fixed_max: float | None = None,
                        rope_cos=None, rope_sin=None,
                        return_lse: bool = False):
    """Plain PyTorch K1, shapes ``(B, H, S, D)`` → ``(B, H, Sq, D)``, with
    f32 statistics and the kernel's roundings (module docstring); with
    ``return_lse`` also the base-2 lse ``(B, H, Sq)`` f32."""
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
        m = torch.full_like(s[..., :1], float(np.float32(fixed_max * _LOG2E)))
    else:
        m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    out = (acc / torch.where(l == 0.0, torch.ones_like(l), l)).to(dt)
    if not return_lse:
        return out
    lse = torch.where(l > 0.0, m + torch.log2(torch.where(l > 0.0, l, 1.0)),
                      torch.zeros_like(l))
    return out, lse[..., 0]


def attention_single_tile_reference(q, k, v, sm_scale: float | None = None,
                                    fixed_max: float | None = None,
                                    rope_cos=None, rope_sin=None,
                                    return_lse: bool = False):
    """Plain PyTorch K2: the exact one-pass softmax of a sequence that is
    one tile. Its arithmetic and roundings are K1's without the online
    rescaling, which the plain K1 never had: the whole score row is formed,
    its max taken, exp2, summed, p rounded to v's type before P·V. So it is
    :func:`attention_reference` on the same arguments."""
    return attention_reference(q, k, v, sm_scale, fixed_max, rope_cos,
                               rope_sin, return_lse)


def is_single_tile(Sq: int, Sk: int, block_q, block_k_major, block_k
                   ) -> bool:
    """Whether skix's dispatcher (``skix/ops/attention.py:441-464``) sends
    ``(Sq, Sk)`` with these blocks to the single-tile kernel: the blocks,
    clipped as skix clips them, tile each sequence exactly once."""
    if block_q is None or block_k_major is None or block_k is None:
        return False
    bq = min(block_q, -(-Sq // 8) * 8)
    bkm = min(block_k_major, -(-Sk // 8) * 8)
    bk = min(block_k, bkm)
    bkm = (bkm // bk) * bk
    return Sq == bq and Sk == bkm


# --------------------------------------------------------------------------
# the CUDA kernels
# --------------------------------------------------------------------------
_KERNELS = {  # wrapper name → (source, C entry, C error-string entry)
    "flash_fwd": ("flash_fwd", "skix_flash_fwd", "skix_cuda_error_string"),
    "flash_fwd_single_tile": ("flash_fwd_single_tile",
                              "skix_flash_fwd_single_tile",
                              "skix_single_tile_error_string"),
}


def _kernel_lib(source: str):
    from skix_torch.ops import _build

    lib = _build.load(source)
    if not getattr(lib, "_skix_typed", False):
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        for name, (src, entry, errs) in _KERNELS.items():
            if src != source:
                continue
            fn = getattr(lib, entry)
            fn.argtypes = [ptr] * 7 + [i32] * 6 + [i64] * 12 + [f32, i32, f32,
                                                                ptr]
            fn.restype = i32
            getattr(lib, errs).argtypes = [i32]
            getattr(lib, errs).restype = ctypes.c_char_p
        if source == "flash_fwd_single_tile":
            lib.skix_single_tile_smem_bytes.argtypes = [i32, i32]
            lib.skix_single_tile_smem_bytes.restype = i64
        lib._skix_typed = True
    return lib


def _check_args(q, k, v, rope_cos, rope_sin):
    """Validate what the kernels take; returns unit-stride q, k, v and the
    rope tables as f32 on q's device."""
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
    return q, k, v, rope_cos, rope_sin


def _launch(kernel: str, q, k, v, sm_scale, fixed_max, rope_cos, rope_sin,
            with_lse: bool):
    """Launch K1 (``flash_fwd``) or K2 (``flash_fwd_single_tile``) on q's
    stream; returns ``o`` or ``(o, lse)``. Raises on anything the kernel
    does not take and on a failed launch."""
    q, k, v, rope_cos, rope_sin = _check_args(q, k, v, rope_cos, rope_sin)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    source, entry, errs = _KERNELS[kernel]
    lib = _kernel_lib(source)
    if kernel == "flash_fwd_single_tile":
        need = lib.skix_single_tile_smem_bytes(Sk, D)
        if need > _MAX_SMEM_PER_BLOCK:
            raise ValueError(f"single-tile attention over Sk={Sk} keys needs "
                             f"{need} B of shared memory per block, more "
                             f"than the card's {_MAX_SMEM_PER_BLOCK}")
    # (B, Sq, H, D) storage seen as (B, H, Sq, D): the caller's
    # transpose back to token-major order is then free
    o = torch.empty((B, Sq, H, D), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    fixed = fixed_max is not None
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if with_lse else None,
            rope_cos.data_ptr() if rope_cos is not None else None,
            rope_sin.data_ptr() if rope_sin is not None else None,
            B, H, Sq, Sk, D, _DTYPE_CODES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], float(np.float32(sm_scale * _LOG2E)), int(fixed),
            float(np.float32(fixed_max * _LOG2E)) if fixed else 0.0,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           + getattr(lib, errs)(err).decode())
    LAUNCHES[kernel + ("_lse" if with_lse else "")] += 1
    return (o, lse) if with_lse else o


def flash_attention(q, k, v, sm_scale: float | None = None,
                    fixed_max: float | None = None,
                    rope_cos=None, rope_sin=None, block_q: int | None = None,
                    block_k_major: int | None = None,
                    block_k: int | None = None):
    """Multi-head attention, shapes ``(B, H, S, D)`` → ``(B, H, Sq, D)``.

    ``sm_scale`` defaults to 1/√D. ``fixed_max`` is a static bound on the
    logits (qk-normed models): the softmax then runs without a running
    max. ``rope_cos``/``rope_sin`` ((S, D) float32, see
    :func:`rope_2d_tables`) apply the rotate-half rope to q and k inside
    the kernel (self-attention, Sq == Sk). ``block_q``/``block_k_major``/
    ``block_k`` are skix's tile keywords; they choose K2 where skix would
    (:func:`is_single_tile`) and nothing else.

    A CUDA tensor goes through a Hopper kernel (head dim 32, 64 or 128,
    float32 or bfloat16); a CPU tensor through the plain versions.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    single = is_single_tile(q.shape[2], k.shape[2], block_q, block_k_major,
                            block_k)
    if q.device.type == "cuda":
        return _launch("flash_fwd_single_tile" if single else "flash_fwd",
                       q, k, v, sm_scale, fixed_max, rope_cos, rope_sin, False)
    if q.device.type == "cpu":
        plain = (attention_single_tile_reference if single
                 else attention_reference)
        return plain(q, k, v, sm_scale, fixed_max, rope_cos, rope_sin)
    raise ValueError(f"no flash_attention for device {q.device}")


def flash_attention_with_lse(q, k, v, sm_scale: float | None = None):
    """Forward-only attention returning ``(out, lse)``, ``lse (B, H, Sq)``
    f32 the base-2 log-partition ``log2 Σ_j exp(sm_scale·q_i·k_j)`` (skix
    ``flash_attention_with_lse``, ``skix/ops/attention.py:1032``). A CUDA
    tensor launches K1 with its lse output; a CPU tensor runs
    :func:`attention_reference` with ``return_lse``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _launch("flash_fwd", q, k, v, sm_scale, None, None, None, True)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, sm_scale, return_lse=True)
    raise ValueError(f"no flash_attention_with_lse for device {q.device}")
