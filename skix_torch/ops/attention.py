"""Flash attention on Hopper, forward and backward, with its plain PyTorch
versions.

Port of ``skix/ops/attention.py``. Its five TPU kernels become hand-written
CUDA C++ kernels, built for ``sm_90a`` at first use
(``skix_torch.ops._build``) and bound with ``ctypes``:

- K1 (``_fwd_kernel``, ``skix/ops/attention.py:184``) →
  ``skix_torch/ops/csrc/flash_fwd.cu``: online softmax over kv tiles, with
  an optional base-2 log-partition output;
- K2 (``_fwd_kernel_single_tile``, ``:313``) →
  ``skix_torch/ops/csrc/flash_fwd_single_tile.cu``: the kernel skix's
  dispatcher (``:459-464``) picks when the whole sequence is one tile;
  K1 and K2 share one tensor-core core, ``csrc/flash_tc.cuh`` (wgmma
  products, cp.async-fed tiles; float32 as split-TF32, three tf32
  products per f32 product), and K2 carries the compile-time variants
  that ``skix_torch.ops.window_probe`` times;
- K3 (``_bwd_dkv_kernel``, ``:558``) and K4 (``_bwd_dq_kernel``, ``:631``)
  → ``skix_torch/ops/csrc/flash_bwd.cu``: dK/dV per kv tile and dQ per q
  tile, two launches;
- K5 (``_bwd_kernel_single_tile``, ``:691``) →
  ``skix_torch/ops/csrc/flash_bwd_single_tile.cu``: dQ, dK and dV of a
  one-tile sequence in one launch; K3, K4 and K5 share one tensor-core
  core, ``csrc/flash_bwd_tc.cuh`` (a dK/dV role and a dQ role, wgmma
  products with p and dS fed from registers, float32 as split-TF32),
  after the same rope pass as the forward.

:func:`flash_attention` is the public entry, a ``torch.autograd.Function``
(the counterpart of skix's custom VJP ``_flash_attention``, ``:958-1029``).
It takes skix's ``block_q``/``block_k_major``/``block_k`` keywords: where
skix would pick K2 (the given blocks tile both sequences exactly once, no
padding, :func:`is_single_tile`) a CUDA tensor launches K2; everywhere else
K1, whatever the sequence length (skix's switch to XLA below its 1024 block
is a TPU tiling choice and is not carried over). When a gradient is needed
the forward also writes the lse and saves q, k, v, o, lse and the rope
tables; the backward computes di = Σ_d o·dO in f32 (as skix at ``:821``)
and launches K5 where the forward launched K2, K3 and K4 where it launched
K1. skix picks its single-tile backward by a TPU VMEM budget (``:827-844``),
a tiling choice that is not carried over: tying the backward to the
forward's kernel keeps K5 where its single-tile shape exists (the ViT-Det
windows). The rope tables get no gradient (skix hard-zeros them,
``:997-1001``). A call the kernels cannot take raises: there is no fallback.
:func:`flash_attention_with_lse` launches K1 with its lse output and is
forward-only, as in skix (``:1042-1043``).

On a CPU tensor the same entries run the plain versions, which repeat the
kernels' arithmetic and roundings (not torch autograd):
:func:`attention_single_tile_reference` at K2's dispatch and
:func:`attention_reference` elsewhere for the forward,
:func:`attention_backward_single_tile_reference` (K5) and
:func:`attention_backward_reference` (K3/K4) for the backward:

- rope in f32 (``x∘cos + rot(x)∘sin``, rot the signed permutation of the
  style: rotate-half, interleaved pairs or rotate-half per segment; the
  kernels apply rotate-half by index and take the other styles as one
  int32 code per column, sign·(partner + 1)), then q times
  ``sm_scale·log2e``,
  then both q and k rounded to the input dtype (the backward rounds the
  roped q and the scaled q separately, as its TPU kernels do);
- scores in f32, softmax in base 2 (``exp2``), with a fixed bound in
  place of the row max when ``fixed_max`` is given;
- p rounded to v's dtype before P·V, row sums of the unrounded p, the
  division guarded at l == 0, the output cast to the input dtype;
- lse = m + log2(l) in base 2 (0 where l == 0), m the row max or the fixed
  bound;
- backward: p = exp2(s − lse), dV = round(p)ᵀ·dO, dS = round(p∘(dO·Vᵀ −
  di)), dK = sm_scale·dSᵀ·q_r and dQ = sm_scale·dS·k_r, f32 sums; with
  rope dK and dQ are un-rotated as ``x∘cos − rot(x)∘sin``. That is the
  rope's true gradient only for a pair-symmetric sin table
  (``sin[s, j] == sin[s, partner(j)]``, skix's docstring ``:1089-1098``),
  which :func:`rope_2d_tables`, :func:`interleaved_rope_tables` and
  :func:`rope_3d_tables` build.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

_LOG2E = math.log2(math.e)

# Launches of each kernel of this module, counted where the kernel is
# launched and nowhere else (chip_smoke.py reads and resets it): K1 as
# "flash_fwd" and, with its lse output (training, or
# flash_attention_with_lse), "flash_fwd_lse"; K2 as "flash_fwd_single_tile"
# and "flash_fwd_single_tile_lse"; K3 as "flash_bwd_dkv", K4 as
# "flash_bwd_dq", K5 as "flash_bwd_single_tile". LAUNCHES_BY_STYLE counts
# the same launches under "<key>/<rope style>", the style one of "none",
# "half", "interleaved" and "segments"; LAUNCHES_BY_SHAPE under
# "<key>/<B>x<H>x<Sq>x<D>" (q's shape).
LAUNCHES: collections.Counter = collections.Counter()
LAUNCHES_BY_STYLE: collections.Counter = collections.Counter()
LAUNCHES_BY_SHAPE: collections.Counter = collections.Counter()

_KERNEL_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------------
# rotary embedding: the rotation styles and their tables
# --------------------------------------------------------------------------
def rotate_half_matrix(d: int, num_halves: int = 2) -> np.ndarray:
    """Signed-permutation matrix R with ``x @ R == rotate_half(x)`` applied
    within each of ``num_halves`` contiguous D segments (the VGGT 2D-rope
    convention). The port applies R by index (:func:`rotate`); the matrix
    is kept to state the convention and to test it."""
    assert d % num_halves == 0
    return segmented_rotate_half_matrix(d, (d // num_halves,) * num_halves)


def interleaved_rotate_matrix(d: int) -> np.ndarray:
    """Signed permutation of the interleaved-pair convention (the SAM3
    ViT-Det rope): ``y[2i] = -x[2i+1], y[2i+1] = x[2i]`` as ``x @ R``."""
    assert d % 2 == 0
    R = np.zeros((d, d), np.float32)
    for i in range(d // 2):
        R[2 * i + 1, 2 * i] = -1.0
        R[2 * i, 2 * i + 1] = 1.0
    return R


def segmented_rotate_half_matrix(d: int, segments) -> np.ndarray:
    """Rotate-half independently within contiguous segments of sizes
    ``segments`` (the MMDiT 3D-rope convention, one segment per (t, y, x)
    axis); features past ``sum(segments)`` are untouched (their table
    columns carry sin = 0)."""
    R = np.zeros((d, d), np.float32)
    o = 0
    for m in segments:
        assert m % 2 == 0 and o + m <= d
        for j in range(m // 2):
            R[o + j + m // 2, o + j] = -1.0   # y[j]      = -x[j + m/2]
            R[o + j, o + j + m // 2] = 1.0    # y[m/2 + j] = x[j]
        o += m
    return R


def _style_key(style):
    """A hashable rope style: ``"half"``, ``"interleaved"`` or
    ``("segments", (m0, m1, ...))``."""
    if style in ("half", "interleaved"):
        return style
    if isinstance(style, (tuple, list)) and len(style) == 2 \
            and style[0] == "segments":
        return ("segments", tuple(int(m) for m in style[1]))
    raise ValueError(f"unknown rope_rotate style: {style!r}")


def style_name(style) -> str:
    """``"half"``, ``"interleaved"`` or ``"segments"``: the launch-count
    label of a rope style."""
    return _style_key(style) if isinstance(style, str) else "segments"


def rot_matrix(d: int, style) -> np.ndarray:
    """The signed permutation R of ``style`` (``rot(x) = x @ R``)."""
    style = _style_key(style)
    if style == "half":
        return rotate_half_matrix(d)
    if style == "interleaved":
        return interleaved_rotate_matrix(d)
    return segmented_rotate_half_matrix(d, style[1])


@functools.lru_cache(maxsize=32)
def rotation_table(d: int, style) -> tuple[np.ndarray, np.ndarray]:
    """R of ``style`` by index: ``rot(x)[j] = sign[j] * x[partner[j]]``,
    ``partner`` (d,) int64 and ``sign`` (d,) float32 in {-1, 0, 1}; sign 0
    marks an untouched column (a segments tail), whose partner is itself.
    Every style's R is a signed permutation with Rᵀ = −R."""
    R = rot_matrix(d, _style_key(style))
    partner = np.arange(d)
    sign = np.zeros(d, np.float32)
    for j in range(d):
        (rows,) = np.nonzero(R[:, j])
        if len(rows):
            partner[j], sign[j] = rows[0], R[rows[0], j]
    return partner, sign


def rotate(x: torch.Tensor, style="half") -> torch.Tensor:
    """``x @ rot_matrix(D, style)`` by index along the last axis (exact)."""
    partner, sign = rotation_table(x.shape[-1], _style_key(style))
    return x[..., torch.as_tensor(partner, device=x.device)] \
        * torch.as_tensor(sign, device=x.device, dtype=x.dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """``x @ rotate_half_matrix(D)`` by index: within each half of the last
    axis, ``y[j] = -x[j + m/2]`` and ``y[m/2 + j] = x[j]`` (exact)."""
    return rotate(x, "half")


def rope_2d_tables(pos: torch.Tensor, d: int, base_freq: float):
    """Full-width cos/sin tables for the 2D rope: ``pos (N, 2)`` integer
    (y, x) coords → ``(cos, sin)`` each (N, d) float32; the first d/2
    features carry the y rotation, the second the x rotation. Style
    ``"half"``."""
    half = d // 2
    exponents = torch.arange(0, half, 2, dtype=torch.float32,
                             device=pos.device) / half
    inv_freq = 1.0 / (base_freq ** exponents)          # (d/4,)
    ay = pos[..., 0:1].to(torch.float32) * inv_freq    # (N, d/4)
    ax = pos[..., 1:2].to(torch.float32) * inv_freq
    angles = torch.cat([ay, ay, ax, ax], dim=-1)       # (N, d)
    return torch.cos(angles), torch.sin(angles)


def interleaved_rope_tables(angles: torch.Tensor):
    """Per-pair angles (N, D/2) → full-width (cos, sin) tables (N, D) for
    style ``"interleaved"``: both rows of a pair read one angle, so the sin
    table is pair-symmetric."""
    return (torch.repeat_interleave(torch.cos(angles), 2, dim=-1),
            torch.repeat_interleave(torch.sin(angles), 2, dim=-1))


def rope_3d_tables(pos: torch.Tensor, d: int, axes_dim,
                   base_freq: float = 10000.0):
    """Full-width cos/sin tables for the 3D rope (the MMDiT convention):
    ``pos (N, 3)`` (t, y, x) coords; segment ``i`` of width ``axes_dim[i]``
    rotates with axis ``i``'s positions (rotate-half within the segment);
    tail features stay untouched (cos 1, sin 0). Use with
    ``rope_rotate=("segments", tuple(axes_dim))``."""
    parts_c, parts_s = [], []
    for ax, m in enumerate(axes_dim):
        exponents = torch.arange(0, m, 2, dtype=torch.float32,
                                 device=pos.device) / m
        inv_freq = 1.0 / (base_freq ** exponents)      # (m/2,)
        ang = pos[..., ax:ax + 1].to(torch.float32) * inv_freq
        ang = torch.cat([ang, ang], dim=-1)            # (N, m)
        parts_c.append(torch.cos(ang))
        parts_s.append(torch.sin(ang))
    tail = d - sum(axes_dim)
    if tail:
        N = pos.shape[0]
        parts_c.append(torch.ones((N, tail), device=pos.device))
        parts_s.append(torch.zeros((N, tail), device=pos.device))
    return torch.cat(parts_c, dim=-1), torch.cat(parts_s, dim=-1)


class RopeTables(NamedTuple):
    """Rope tables with their rotation style, as models pass them to
    attention: ``cos``/``sin`` (S, D) float32 and ``rotate`` (``"half"``,
    ``"interleaved"`` or ``("segments", axes)``). A plain ``(cos, sin)``
    pair is style ``"half"``."""
    cos: torch.Tensor
    sin: torch.Tensor
    rotate: object = "half"


def _rope_f32(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
              style="half"):
    xf = x.to(torch.float32)
    return xf * cos + rotate(xf, style) * sin


def apply_rope_tables(x, cos, sin, rope_rotate="half"):
    """Rope from tables, ``x (B, H, S, D)``, tables ``(S, D)``; computed in
    f32 and cast back to x's dtype."""
    return _rope_f32(x, cos, sin, rope_rotate).to(x.dtype)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------
def attention_reference(q, k, v, sm_scale: float | None = None,
                        fixed_max: float | None = None,
                        rope_cos=None, rope_sin=None,
                        return_lse: bool = False, rope_rotate="half"):
    """Plain PyTorch K1, shapes ``(B, H, S, D)`` → ``(B, H, Sq, D)``, with
    f32 statistics and the kernel's roundings (module docstring); with
    ``return_lse`` also the base-2 lse ``(B, H, Sq)`` f32. ``rope_rotate``
    is the rope's style (:func:`rot_matrix`), applied by index."""
    dt = q.dtype
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    scale_log2 = float(np.float32(sm_scale * _LOG2E))
    if rope_cos is not None:
        qf = _rope_f32(q, rope_cos, rope_sin, rope_rotate)
        kf = _rope_f32(k, rope_cos, rope_sin, rope_rotate).to(dt).to(
            torch.float32)
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
                                    return_lse: bool = False,
                                    rope_rotate="half"):
    """Plain PyTorch K2: the exact one-pass softmax of a sequence that is
    one tile. Its arithmetic and roundings are K1's without the online
    rescaling, which the plain K1 never had: the whole score row is formed,
    its max taken, exp2, summed, p rounded to v's type before P·V. So it is
    :func:`attention_reference` on the same arguments."""
    return attention_reference(q, k, v, sm_scale, fixed_max, rope_cos,
                               rope_sin, return_lse, rope_rotate)


def attention_backward_reference(q, k, v, do, lse, di,
                                 sm_scale: float | None = None,
                                 rope_cos=None, rope_sin=None,
                                 rope_rotate="half"):
    """Plain PyTorch K3 + K4: ``(dq, dk, dv)`` of the attention whose
    forward wrote ``lse (B, H, Sq)`` (base 2), given the output gradient
    ``do`` (q's shape) and ``di = Σ_d o·do`` (B, H, Sq) f32. The whole
    (Sq, Sk) score matrix is formed at once, with the kernels' roundings
    (module docstring); gradients come back in the input dtypes."""
    dt = q.dtype
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    scale = float(np.float32(sm_scale))
    scale_log2 = float(np.float32(sm_scale * _LOG2E))
    if rope_cos is not None:
        qr = _rope_f32(q, rope_cos, rope_sin, rope_rotate).to(dt).to(
            torch.float32)
        kr = _rope_f32(k, rope_cos, rope_sin, rope_rotate).to(dt).to(
            torch.float32)
    else:
        qr, kr = q.to(torch.float32), k.to(torch.float32)
    qs = (qr * scale_log2).to(dt).to(torch.float32)
    p = torch.exp2(torch.matmul(qs, kr.transpose(-1, -2)) - lse[..., None])
    dof = do.to(dt).to(torch.float32)
    dv = torch.matmul(p.to(dt).to(torch.float32).transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.to(torch.float32).transpose(-1, -2))
    ds = (p * (dp - di[..., None])).to(dt).to(torch.float32)
    dq = torch.matmul(ds, kr) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qr) * scale
    if rope_cos is not None:
        dq = dq * rope_cos - rotate(dq, rope_rotate) * rope_sin
        dk = dk * rope_cos - rotate(dk, rope_rotate) * rope_sin
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


def attention_backward_single_tile_reference(q, k, v, do, lse, di,
                                             sm_scale: float | None = None,
                                             rope_cos=None, rope_sin=None,
                                             rope_rotate="half"):
    """Plain PyTorch K5: dQ, dK and dV of a one-tile sequence in one exact
    pass. K5's arithmetic and roundings are K3's and K4's on a single tile,
    so it is :func:`attention_backward_reference` on the same arguments."""
    return attention_backward_reference(q, k, v, do, lse, di, sm_scale,
                                        rope_cos, rope_sin, rope_rotate)


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
_FWD, _BWD = "fwd", "bwd"
_KERNELS = {  # LAUNCHES key → (source, C entry, C error-string entry, kind)
    "flash_fwd": ("flash_fwd", "skix_flash_fwd", "skix_cuda_error_string",
                  _FWD),
    "flash_fwd_single_tile": ("flash_fwd_single_tile",
                              "skix_flash_fwd_single_tile",
                              "skix_single_tile_error_string", _FWD),
    "flash_bwd_dkv": ("flash_bwd", "skix_flash_bwd_dkv",
                      "skix_flash_bwd_error_string", _BWD),
    "flash_bwd_dq": ("flash_bwd", "skix_flash_bwd_dq",
                     "skix_flash_bwd_error_string", _BWD),
    "flash_bwd_single_tile": ("flash_bwd_single_tile",
                              "skix_flash_bwd_single_tile",
                              "skix_bwd_single_tile_error_string", _BWD),
}
KERNEL_SOURCES = sorted({src for src, *_ in _KERNELS.values()})


def _kernel_lib(source: str):
    from skix_torch.ops import _build

    lib = _build.load(source)
    if not getattr(lib, "_skix_typed", False):
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        for name, (src, entry, errs, kind) in _KERNELS.items():
            if src != source:
                continue
            fn = getattr(lib, entry)
            if kind == _FWD:
                fn.argtypes = ([ptr] * 8 + [i32] * 6 + [i64] * 12
                               + [f32, i32, f32, ptr])
            else:
                fn.argtypes = [ptr] * 12 + [i32] * 6 + [ptr, f32, f32, ptr]
            fn.restype = i32
            getattr(lib, errs).argtypes = [i32]
            getattr(lib, errs).restype = ctypes.c_char_p
        if source == "flash_fwd":
            lib.skix_rope_rows.argtypes = ([ptr] * 5 + [i32] * 5 + [i64] * 3
                                           + [i32, f32, ptr])
            lib.skix_rope_rows.restype = i32
        lib._skix_typed = True
    return lib


@functools.lru_cache(maxsize=32)
def _rotation_codes(d: int, style, device: torch.device) -> torch.Tensor:
    """The kernels' form of :func:`rotation_table`: one int32 per column on
    ``device``, ``sign * (partner + 1)`` (0: the column is not rotated)."""
    partner, sign = rotation_table(d, style)
    codes = (sign * (partner + 1)).astype(np.int32)
    return torch.as_tensor(codes, device=device)


def _check_args(q, k, v, rope_cos, rope_sin, rope_rotate="half"):
    """Validate what the kernels take; returns unit-stride q, k, v, the
    rope tables as f32 on q's device and the rotation codes of the rope's
    style (None without rope, and for rotate-half, which the kernels
    apply by index, without a table read)."""
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
        style = _style_key(rope_rotate)
        return (q, k, v, rope_cos, rope_sin, None if style == "half"
                else _rotation_codes(D, style, q.device))
    return q, k, v, None, None, None


def _aligned16(x: torch.Tensor) -> torch.Tensor:
    """``x`` with a 16-byte-aligned base and (b, h, s) strides, as the
    kernels' 16-byte loads and cp.async need: a copy only where a
    view is misaligned (a stride 0 is aligned). The rope tables, contiguous
    (S, D) rows of D ≥ 32 floats, need an aligned base only."""
    item = x.element_size()
    if x.data_ptr() % 16 == 0 and all(s * item % 16 == 0
                                       for s in x.stride()[:3]):
        return x
    return x.contiguous() if not x.is_contiguous() else x.clone()


def _empty_like_heads(x):
    """An uninitialised (B, H, S, D) tensor stored as (B, S, H, D): the
    caller's transpose back to token-major order is then free."""
    B, H, S, D = x.shape
    return torch.empty((B, S, H, D), dtype=x.dtype,
                       device=x.device).transpose(1, 2)


def _count(key: str, rope_cos, rope_rotate, shape) -> None:
    LAUNCHES[key] += 1
    style = "none" if rope_cos is None else style_name(rope_rotate)
    LAUNCHES_BY_STYLE[f"{key}/{style}"] += 1
    LAUNCHES_BY_SHAPE[f"{key}/{'x'.join(map(str, shape))}"] += 1


def _rope_pass(x, cos, sin, rot, mul):
    """K1's and K2's rope pass (``skix_rope_rows``): ``x∘cos + rot(x)∘sin``
    in f32, times ``mul`` unless it is None, rounded to x's dtype, as a new
    contiguous (B, H, S, D) tensor: what the TPU kernels stage as the roped
    q (times sm_scale·log2e) and k."""
    lib = _kernel_lib("flash_fwd")
    B, H, S, D = x.shape
    out = torch.empty((B, H, S, D), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.skix_rope_rows(
            x.data_ptr(), out.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            rot.data_ptr() if rot is not None else None, B, H, S, D,
            _DTYPE_CODES[x.dtype], *x.stride()[:3], int(mul is not None),
            mul if mul is not None else 1.0,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("rope pass failed: "
                           + lib.skix_cuda_error_string(err).decode())
    return out


def _launch(kernel: str, q, k, v, sm_scale, fixed_max, rope_cos, rope_sin,
            with_lse: bool, rope_rotate="half"):
    """Launch K1 (``flash_fwd``) or K2 (``flash_fwd_single_tile``) on q's
    stream; returns ``o`` or ``(o, lse)``. With rope, the rope pass first
    ropes and rounds q (times sm_scale·log2e) and k once for the call, and
    the kernel scales q by 1. Raises on anything the kernel does not take
    and on a failed launch."""
    q, k, v, rope_cos, rope_sin, rot = _check_args(q, k, v, rope_cos,
                                                   rope_sin, rope_rotate)
    q, k, v = _aligned16(q), _aligned16(k), _aligned16(v)
    scale_log2 = float(np.float32(sm_scale * _LOG2E))
    if rope_cos is not None:
        rope_cos, rope_sin = (t if t.data_ptr() % 16 == 0 else t.clone()
                              for t in (rope_cos, rope_sin))
        q = _rope_pass(q, rope_cos, rope_sin, rot, scale_log2)
        k = _rope_pass(k, rope_cos, rope_sin, rot, None)
        scale_log2 = 1.0
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    source, entry, errs, _ = _KERNELS[kernel]
    lib = _kernel_lib(source)
    o = _empty_like_heads(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    fixed = fixed_max is not None
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if with_lse else None, None, None, None,
            B, H, Sq, Sk, D, _DTYPE_CODES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], scale_log2, int(fixed),
            float(np.float32(fixed_max * _LOG2E)) if fixed else 0.0,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           + getattr(lib, errs)(err).decode())
    _count(kernel + ("_lse" if with_lse else ""), rope_cos, rope_rotate,
           (B, H, Sq, D))
    return (o, lse) if with_lse else o


def _launch_backward(kernels, q, k, v, do, lse, di, sm_scale, rope_cos,
                     rope_sin, rope_rotate="half"):
    """Launch the backward kernels named in ``kernels`` (``flash_bwd_dkv``
    and ``flash_bwd_dq``, K3 and K4, one after the other; or
    ``flash_bwd_single_tile``, K5) on q's stream; returns ``(dq, dk, dv)``.
    ``lse`` and ``di`` are (B, H, Sq) f32. With rope, the forward's rope
    pass first ropes and rounds q and k once for the call; the kernels
    un-rotate dq and dk at their store. Raises on anything the kernels do
    not take and on a failed launch."""
    q, k, v, rope_cos, rope_sin, rot = _check_args(q, k, v, rope_cos,
                                                   rope_sin, rope_rotate)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    do = do.to(q.dtype)
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if do.stride(-1) != 1:
        do = do.contiguous()
    lse, di = (t.to(device=q.device, dtype=torch.float32).contiguous()
               for t in (lse, di))
    if lse.shape != (B, H, Sq) or di.shape != (B, H, Sq):
        raise ValueError(f"lse and di must be ({B}, {H}, {Sq})")
    dq, dk, dv = _empty_like_heads(q), _empty_like_heads(k), _empty_like_heads(v)
    q, k, v, do = (_aligned16(t) for t in (q, k, v, do))
    if rope_cos is not None:
        rope_cos, rope_sin = (t if t.data_ptr() % 16 == 0 else t.clone()
                              for t in (rope_cos, rope_sin))
        q = _rope_pass(q, rope_cos, rope_sin, rot, None)
        k = _rope_pass(k, rope_cos, rope_sin, rot, None)
    strides = (ctypes.c_longlong * 21)(*(
        s for t in (q, k, v, do, dq, dk, dv) for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    for kernel in kernels:
        source, entry, errs, _ = _KERNELS[kernel]
        lib = _kernel_lib(source)
        with torch.cuda.device(q.device):
            err = getattr(lib, entry)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(),
                rope_cos.data_ptr() if rope_cos is not None else None,
                rope_sin.data_ptr() if rope_sin is not None else None,
                rot.data_ptr() if rot is not None else None,
                B, H, Sq, Sk, D, _DTYPE_CODES[q.dtype], strides,
                float(np.float32(sm_scale)),
                float(np.float32(sm_scale * _LOG2E)), stream)
        if err != 0:
            raise RuntimeError(f"{kernel} launch failed: "
                               + getattr(lib, errs)(err).decode())
        _count(kernel, rope_cos, rope_rotate, (B, H, Sq, D))
    return dq, dk, dv


_BACKWARD_OF = {"flash_fwd": ("flash_bwd_dkv", "flash_bwd_dq"),
                "flash_fwd_single_tile": ("flash_bwd_single_tile",)}


class _FlashAttention(torch.autograd.Function):
    """Attention with the kernels' forward and backward (skix's custom VJP).
    ``single`` picks K2/K5 over K1/K3/K4 (:func:`is_single_tile`)."""

    @staticmethod
    def forward(ctx, q, k, v, rope_cos, rope_sin, sm_scale, fixed_max,
                single, rope_rotate):
        grad = any(ctx.needs_input_grad[:3])
        if q.device.type == "cuda":
            out = _launch("flash_fwd_single_tile" if single else "flash_fwd",
                          q, k, v, sm_scale, fixed_max, rope_cos, rope_sin,
                          grad, rope_rotate)
        elif q.device.type == "cpu":
            plain = (attention_single_tile_reference if single
                     else attention_reference)
            out = plain(q, k, v, sm_scale, fixed_max, rope_cos, rope_sin,
                        return_lse=grad, rope_rotate=rope_rotate)
        else:
            raise ValueError(f"no flash_attention for device {q.device}")
        if not grad:
            return out
        o, lse = out
        ctx.save_for_backward(q, k, v, o, lse, rope_cos, rope_sin)
        ctx.sm_scale, ctx.single = sm_scale, single
        ctx.rope_rotate = rope_rotate
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, rope_cos, rope_sin = ctx.saved_tensors
        # di = Σ_d o·do in f32, once, for both kernels (skix :821)
        di = (o.to(torch.float32) * do.to(torch.float32)).sum(-1)
        if q.device.type == "cuda":
            kernels = _BACKWARD_OF["flash_fwd_single_tile" if ctx.single
                                   else "flash_fwd"]
            dq, dk, dv = _launch_backward(kernels, q, k, v, do, lse, di,
                                          ctx.sm_scale, rope_cos, rope_sin,
                                          ctx.rope_rotate)
        else:
            plain = (attention_backward_single_tile_reference if ctx.single
                     else attention_backward_reference)
            dq, dk, dv = plain(q, k, v, do, lse, di, ctx.sm_scale, rope_cos,
                               rope_sin, ctx.rope_rotate)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, sm_scale: float | None = None,
                    fixed_max: float | None = None,
                    rope_cos=None, rope_sin=None, block_q: int | None = None,
                    block_k_major: int | None = None,
                    block_k: int | None = None, rope_rotate="half"):
    """Multi-head attention, shapes ``(B, H, S, D)`` → ``(B, H, Sq, D)``,
    differentiable in q, k and v.

    ``sm_scale`` defaults to 1/√D. ``fixed_max`` is a static bound on the
    logits (qk-normed models): the softmax then runs without a running
    max. ``rope_cos``/``rope_sin`` ((S, D) float32) apply the rope
    ``x∘cos + rot(x)∘sin`` to q and k inside the kernel (self-attention,
    Sq == Sk); they are constants, with no gradient. ``rope_rotate`` is
    rot's style, as in skix: ``"half"`` (:func:`rope_2d_tables`),
    ``"interleaved"`` (:func:`interleaved_rope_tables`) or ``("segments",
    axes)`` (:func:`rope_3d_tables`). The backward un-rotates dq and dk as
    ``x∘cos − rot(x)∘sin``, the exact gradient for a sin table that is
    pair-symmetric under the style, as those builders make it.
    ``block_q``/``block_k_major``/``block_k`` are skix's tile keywords;
    they choose K2 (and K5 in the backward) where skix would
    (:func:`is_single_tile`) and nothing else.

    A CUDA tensor goes through the Hopper kernels (head dim 32, 64 or 128,
    float32 or bfloat16); a CPU tensor through the plain versions.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    single = is_single_tile(q.shape[2], k.shape[2], block_q, block_k_major,
                            block_k)
    return _FlashAttention.apply(q, k, v, rope_cos, rope_sin, sm_scale,
                                 fixed_max, single, _style_key(rope_rotate))


def flash_attention_with_lse(q, k, v, sm_scale: float | None = None):
    """Forward-only attention returning ``(out, lse)``, ``lse (B, H, Sq)``
    f32 the base-2 log-partition ``log2 Σ_j exp(sm_scale·q_i·k_j)`` (skix
    ``flash_attention_with_lse``, ``skix/ops/attention.py:1032``). A CUDA
    tensor launches K1 with its lse output; a CPU tensor runs
    :func:`attention_reference` with ``return_lse``. No gradient flows
    through it, as in skix."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise RuntimeError("flash_attention_with_lse is forward-only (as "
                               "in skix); call it under torch.no_grad()")
        return _launch("flash_fwd", q, k, v, sm_scale, None, None, None, True)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, sm_scale, return_lse=True)
    raise ValueError(f"no flash_attention_with_lse for device {q.device}")
