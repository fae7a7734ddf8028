"""K2's probes on the card: the counterparts of the TPU timing probes of the
window-attention kernel, B1–B7.

    python3 -m skix_torch.ops.window_probe [--reps N] [--out FILE]

Each TPU script timed K2 with one piece deleted or changed. Here each
variant is one value of the compile-time ``Variant`` of K2
(``skix_torch/ops/csrc/flash_tc.cuh``), launched after K2's rope pass
through the C entry ``skix_window_probe`` of ``flash_fwd_single_tile.cu``
(``norope``: the production kernel without the rope pass) at the window
shape
(9, 16, 576, 64): in float32 with the rotate-half rope (the front path's
windows) and in bfloat16 with the interleaved rope (the scripts' own).
Every variant is first held against its plain version on the card
(:func:`plain`), then timed with CUDA events (warm, ``reps`` launches per
sample, the median of seven samples and their spread) beside its plain
version and its bound:

- B1 ``scripts/bench_window_decomp.py`` (where K2's time goes): ``full``,
  ``norope``, ``fixedmax``, ``nosoftmax`` (p = s), ``scoresonly`` (the
  score products and a store of their first D columns), ``p_bf16`` (f32
  path: p and v rounded to bf16, P·V one bf16 product: the half-width
  question of ``bf16exp``/``sbf16``). ``mxulsum``/``both`` took Σp through
  the matrix unit; on the card the row sum is a register reduction, and
  ``fixedmax``, which deletes the other reduction, answers it;
- B2 ``bench_window_decomp2.py`` (how the scores are fed): ``p_bf16``,
  ``kv_other_major`` (bf16: V read MN-major from its row-major tile, no
  transpose; tf32 takes K-major operands only), ``heads2`` (two heads per
  CTA), and the score products through ``torch.matmul`` as their floor;
- B3 ``bench_window_decomp3.py`` (in-kernel transposes): ``kv_other_major``
  with and without rope;
- B4, B5 ``bench_window_decomp4.py``, ``decomp5.py`` (all heads' scores in
  one block-diagonal product): ``heads2``;
- B6 ``bench_window_decomp6.py`` (the matrix unit's ceiling):
  ``scoresonly``, and ``torch.matmul`` of the batched (144, 576, 64)·(64,
  576) products and of one 4608³ product in f32 and bf16 (yardsticks, never
  called by the port);
- B7 ``bench_window_ktrans_ab.py`` (production against k transposed):
  ``full`` against ``kv_other_major``, in the order A B B A, three times,
  medians.

Needs an NVIDIA GPU; the plain versions also run on the CPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys

import numpy as np
import torch

from skix_torch.ops import attention as A

_LOG2E = math.log2(math.e)
SHAPE = (9, 16, 576, 64)
FIXED_MAX = 8.0                 # the TPU script's fixed bound
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
PEAK = {"tf32": 495e12, "bf16": 989e12, "f32": 67e12}
# the C entry's compile-time variants (flash_tc.cuh enum Variant); norope
# is full without the rope pass
VARIANTS = {"full": 0, "norope": 0, "fixedmax": 1, "nosoftmax": 2,
            "scoresonly": 3, "p_bf16": 4, "kv_other_major": 5, "heads2": 6}
# the TPU probes: row → (script, kernel line, pallas_call line, what it asked)
PROBES = {
    "B1": ("scripts/bench_window_decomp.py", 39, 121, "where K2's time goes"),
    "B2": ("scripts/bench_window_decomp2.py", 50, 118, "how the scores are fed"),
    "B3": ("scripts/bench_window_decomp3.py", 41, 137, "in-kernel transposes"),
    "B4": ("scripts/bench_window_decomp4.py", 55, 125,
           "all heads' scores in one block-diagonal product"),
    "B5": ("scripts/bench_window_decomp5.py", 59, 127,
           "the block-diagonal product, concat-built"),
    "B6": ("scripts/bench_window_decomp6.py", 34, 76, "the matrix unit's ceiling"),
    "B7": ("scripts/bench_window_ktrans_ab.py", 26, 60,
           "production against k transposed, interleaved A/B"),
}
# each row's runs on the card: (variant, dtype, rope)
RUNS = {
    "B1": [(v, "float32", True) for v in ("full", "norope", "fixedmax",
                                           "nosoftmax", "scoresonly",
                                           "p_bf16")]
          + [(v, "bfloat16", True) for v in ("full", "norope", "fixedmax",
                                              "nosoftmax", "scoresonly")],
    "B2": [("p_bf16", "float32", True), ("heads2", "float32", True),
           ("kv_other_major", "bfloat16", True), ("heads2", "bfloat16", True)],
    "B3": [("kv_other_major", "bfloat16", True),
           ("kv_other_major", "bfloat16", False), ("full", "bfloat16", False)],
    "B4": [("heads2", "float32", True), ("heads2", "bfloat16", True)],
    "B5": [("heads2", "float32", True), ("heads2", "bfloat16", True)],
    "B6": [("scoresonly", "float32", True), ("scoresonly", "bfloat16", True)],
}
# the variants that compute softmax attention (fixedmax too: its bound is
# never reached at these inputs), timed beside SDPA
ATTENTION = ("full", "norope", "fixedmax", "heads2", "kv_other_major")


def rope_tables(dtype: str, S: int, D: int, device):
    """The variant's rope: float32 rotate-half over the window's 24 × 24
    grid (the front path), bfloat16 the interleaved axial rope (the
    scripts'); returns ``(cos, sin, style)``."""
    from skix_torch.models.layers import make_grid_positions
    from skix_torch.tracking.vitdet import axial_rope_angles

    side = math.isqrt(S)
    if dtype == "float32":
        pos = torch.as_tensor(make_grid_positions(side, side), device=device)
        return (*A.rope_2d_tables(pos, D, 100.0), "half")
    ang = torch.as_tensor(axial_rope_angles(side, side, D), device=device)
    return (*A.interleaved_rope_tables(ang), "interleaved")


def _staged(q, k, cos, sin, style, sm_scale):
    """q and k as the kernel stages them: roped in f32, q times
    sm_scale·log2e, both rounded to the input type (as f32)."""
    dt = q.dtype
    scale_log2 = float(np.float32(sm_scale * _LOG2E))
    if cos is not None:
        qf = A.apply_rope_tables(q.float(), cos, sin, style)
        kf = A.apply_rope_tables(k.float(), cos, sin, style).to(dt).float()
    else:
        qf, kf = q.float(), k.float()
    return (qf * scale_log2).to(dt).float(), kf


def plain(variant: str, q, k, v, cos, sin, style, sm_scale: float):
    """The plain PyTorch version of one variant, on any device."""
    if variant == "norope":
        cos = sin = None
    if variant in ("full", "norope", "heads2", "kv_other_major", "fixedmax"):
        return A.attention_single_tile_reference(
            q, k, v, sm_scale, FIXED_MAX if variant == "fixedmax" else None,
            cos, sin, rope_rotate=style)
    qf, kf = _staged(q, k, cos, sin, style, sm_scale)
    s = torch.matmul(qf, kf.transpose(-1, -2))
    if variant == "scoresonly":
        return s[..., :q.shape[-1]].to(q.dtype)
    if variant == "nosoftmax":
        return torch.matmul(s.to(v.dtype).float(), v.float()).to(q.dtype)
    if variant == "p_bf16":
        m = s.amax(-1, keepdim=True)
        p = torch.exp2(s - m)
        acc = torch.matmul(p.to(torch.bfloat16).float(),
                           v.to(torch.bfloat16).float())
        return (acc / p.sum(-1, keepdim=True)).to(q.dtype)
    raise ValueError(f"unknown variant {variant!r}")


def tolerance(variant: str, dtype: str) -> float:
    """max |kernel − plain| allowed, relative to max(1, max |plain|): f32
    the sum order alone (K2's 1e-5); a bf16 p (p_bf16, and every bf16
    variant) a step of 2⁻⁸ relative in the terms, and for nosoftmax and
    scoresonly, whose outputs are unnormalised, one bf16 step of the output
    as well."""
    if dtype == "float32":
        return 4e-3 if variant == "p_bf16" else 1e-5
    return 8e-3 if variant in ("nosoftmax", "scoresonly") else 4e-3


def launch(variant: str, q, k, v, cos, sin, style, sm_scale: float):
    """K2 with one compile-time variant on q's stream, after K2's rope
    pass (but for norope); returns o."""
    lib = A._kernel_lib("flash_fwd_single_tile")
    fn = lib.skix_window_probe
    if not getattr(fn, "_skix_typed", False):
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        fn.argtypes = ([i32] + [ptr] * 8 + [i32] * 6 + [i64] * 12
                       + [f32, i32, f32, ptr])
        fn.restype = i32
        fn._skix_typed = True
    q, k, v, cos, sin, rot = A._check_args(q, k, v, cos, sin, style)
    scale_log2 = float(np.float32(sm_scale * _LOG2E))
    if cos is not None and variant != "norope":
        q = A._rope_pass(q, cos, sin, rot, scale_log2)
        k = A._rope_pass(k, cos, sin, rot, None)
        scale_log2 = 1.0
    B, H, Sq, D = q.shape
    o = torch.empty_like(q)
    err = fn(VARIANTS[variant], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             o.data_ptr(), None, None, None, None,
             B, H, Sq, k.shape[2], D, A._DTYPE_CODES[q.dtype],
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *o.stride()[:3], scale_log2,
             int(variant == "fixedmax"),
             float(np.float32(FIXED_MAX * _LOG2E)),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window probe {variant} launch failed: "
                           + lib.skix_single_tile_error_string(err).decode())
    return o


def bound_ms(variant: str, dtype: str, shape, rope: bool):
    """The least time of the variant's work: its products at the rate of
    the type it uses (f32: split-TF32, three tf32 products; p_bf16: P·V one
    bf16 product), against q, k, v (not for scoresonly), o and the rope
    tables read or written once; returns (ms, "bytes" | "operations")."""
    B, H, S, D = shape
    item = 4 if dtype == "float32" else 2
    prod = 2.0 * B * H * S * S * D
    rate = PEAK["tf32"] / 3 if dtype == "float32" else PEAK["bf16"]
    ops_ms = prod / rate * 1e3
    if variant == "p_bf16":
        ops_ms += prod / PEAK["bf16"] * 1e3
    elif variant != "scoresonly":
        ops_ms *= 2
    tensors = 3 if variant == "scoresonly" else 4
    nbytes = tensors * B * H * S * D * item + (2 * 4 * S * D if rope else 0)
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, b_ms), ("bytes" if b_ms >= ops_ms else "operations")


def cuda_samples(fn, reps: int, samples: int = 7) -> list[float]:
    """Per-launch ms of ``samples`` CUDA-event timings of ``reps`` launches
    each, after three warm launches."""
    for _ in range(3):
        fn()
    out = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return out


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _inputs(dtype: str, rope: bool, gen, shape=SHAPE):
    dev = torch.device("cuda")
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
               for _ in range(3))
    cos, sin, style = rope_tables(dtype, shape[2], shape[3], dev)
    if not rope:
        cos = sin = None
    return q, k, v, cos, sin, style


def check_and_time(row: str, variant: str, dtype: str, rope: bool, gen,
                   reps: int) -> dict:
    """Hold one variant against its plain version on the card, then time
    both; raises if they disagree."""
    q, k, v, cos, sin, style = _inputs(dtype, rope, gen)
    sm = SHAPE[3] ** -0.5
    with torch.no_grad():
        got = launch(variant, q, k, v, cos, sin, style, sm)
        torch.cuda.synchronize()
        ref = plain(variant, q, k, v, cos, sin, style, sm)
        err = (got.float() - ref.float()).abs().max().item()
        scale = max(1.0, ref.float().abs().max().item())
        samples = cuda_samples(lambda: launch(variant, q, k, v, cos, sin,
                                              style, sm), reps)
        plain_ms = _median(cuda_samples(lambda: plain(
            variant, q, k, v, cos, sin, style, sm), 1, 3))
        lib_ms = None
        if variant in ATTENTION:    # the same function: SDPA, pre-roped
            import torch.nn.functional as F

            rope = variant != "norope" and cos is not None
            qr, kr = ((A.apply_rope_tables(x, cos, sin, style) if rope else x)
                      .contiguous() for x in (q, k))
            lib_ms = _median(cuda_samples(
                lambda: F.scaled_dot_product_attention(qr, kr, v, scale=sm),
                reps))
    ms = _median(samples)
    bound, bound_by = bound_ms(variant, dtype, SHAPE,
                               rope and variant != "norope")
    tol = tolerance(variant, dtype)
    res = {"row": row, "variant": variant, "dtype": dtype,
           "rope": style if rope else "none", "ms": ms,
           "spread": (max(samples) - min(samples)) / ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by, "bound_share": bound / ms,
           "max_abs_err": err, "tol": tol * scale}
    if not (torch.isfinite(got).all() and err <= tol * scale):
        raise RuntimeError(f"window probe {row} {variant} {dtype}: max "
                           f"|kernel - plain| = {err} > {tol * scale}")
    return res


def matmul_yardsticks(reps: int) -> list[dict]:
    """torch.matmul of the windows' score products (B2's floor, B6's
    xla_nn) and of one 4608³ product (B6's xla_big), f32 and bf16."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = []
    B, H, S, D = SHAPE
    for dtype, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for name, a_shape, b_shape in (
                ("matmul_scores", (B * H, S, D), (B * H, D, S)),
                ("matmul_4608", (4608, 4608), (4608, 4608))):
            a = torch.randn(a_shape, generator=gen, device="cuda").to(dt)
            b = torch.randn(b_shape, generator=gen, device="cuda").to(dt)
            samples = cuda_samples(lambda: torch.matmul(a, b), reps)
            ms = _median(samples)
            ops = 2.0 * math.prod(a_shape) * b_shape[-1]
            peak = PEAK["f32"] if dtype == "float32" else PEAK["bf16"]
            out.append({"row": "B6", "variant": name, "dtype": dtype,
                        "ms": ms, "spread": (max(samples) - min(samples)) / ms,
                        "tflops": ops / ms / 1e9,
                        "bound_ms": ops / peak * 1e3,
                        "bound_share": ops / peak * 1e3 / ms})
    return out


def ab_full_vs_kv_other_major(gen, reps: int, rounds: int = 3) -> dict:
    """B7: ``full`` (A) against ``kv_other_major`` (B), bf16 with the
    interleaved rope, in the order A B B A, ``rounds`` times."""
    q, k, v, cos, sin, style = _inputs("bfloat16", True, gen)
    sm = SHAPE[3] ** -0.5
    times = {"full": [], "kv_other_major": []}
    with torch.no_grad():
        for _ in range(rounds):
            for variant in ("full", "kv_other_major", "kv_other_major",
                            "full"):
                times[variant].append(_median(cuda_samples(
                    lambda: launch(variant, q, k, v, cos, sin, style, sm),
                    reps, 3)))
    a, b = _median(times["full"]), _median(times["kv_other_major"])
    return {"row": "B7", "variant": "full_vs_kv_other_major",
            "dtype": "bfloat16", "full_ms": a, "kv_other_major_ms": b,
            "b_minus_a_pct": 100.0 * (b - a) / a, "full_runs": times["full"],
            "kv_other_major_runs": times["kv_other_major"]}


def run(reps: int = 20, say=print) -> list[dict]:
    """Every row's variants, checked and timed; ``say`` gets one line per
    result. Raises on the first disagreement."""
    if not torch.cuda.is_available():
        raise RuntimeError("the window probes run on an NVIDIA GPU")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for row, runs in RUNS.items():
        for variant, dtype, rope in runs:
            rows.append(check_and_time(row, variant, dtype, rope, gen, reps))
            say(rows[-1])
    for r in matmul_yardsticks(max(1, reps // 4)):
        rows.append(r)
        say(r)
    rows.append(ab_full_vs_kv_other_major(gen, reps))
    say(rows[-1])
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    def say(r):
        print("[window_probe] " + " ".join(
            f"{k}={json.dumps(v) if isinstance(v, list) else v}"
            for k, v in r.items()), flush=True)

    rows = run(args.reps, say)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0),
                       "rows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
