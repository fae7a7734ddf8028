"""Chip smoke test of skix_torch on one NVIDIA GPU (an H100 at full size).

    python3 chip_smoke.py

Phases, one line each (the last line is the JSON verdict):

1. device     the card's name and power limit (nvidia-smi);
2. build      every CUDA kernel of the main paths, from skix_torch/ops/csrc,
              one nvcc process per source, all started together;
3. kernel     each forward kernel against its plain PyTorch version on the
              card at the main paths' shapes, with its time (CUDA events),
              the plain version's, F.scaled_dot_product_attention's on the
              same pre-roped inputs (a yardstick only) and the bound of the
              card: K1 (flash_fwd) at the VGGT and SAM3 shapes, K1 with its
              lse output (flash_fwd_lse) at the memory tracker's shape and
              the training shapes, K2 (flash_fwd_single_tile, and with its
              lse) at the ViT-Det window shape, and a small ragged case of
              each;
   backward   each backward kernel against its plain version: K3 + K4
              (flash_bwd_dkv, flash_bwd_dq) at the ViT-Det global and
              fusion-encoder training shapes, K5 (flash_bwd_single_tile) at
              the window shape, ragged and bf16 cases; the yardstick is
              autograd through SDPA, its backward alone;
4. reference  the VGGT stage at a small width in float32 on the card
              (kernels) and on the CPU (plain versions), same weights, same
              records;
5. main       run_all's vggt stage at full VGGT-1B width (embed 1024, depth
              24, 16 heads, 518 px, bf16, seeded random weights) on two
              1080p records, launch counts reset just before and read just
              after; then the same run warm, and once under torch.profiler
              (device time by kernel, the device's idle share);
6. front_ref  the prepare_front_results stage at the tiny detector width in
              float32 on the card and on the CPU, same weights, same frames;
7. front      run_all's prepare_front_results stage at the full-size
              Sam3Detector (1008 px, ViT-Det 1024 x 32) and the default
              memory tracker, 4 frames of 720x1280, prompts person and snow,
              launch counts reset just before and read just after; then warm,
              and once under torch.profiler;
8. train_ref  one train_detector step of the tiny detector on the card and
              on the CPU from the same weights and batch: loss, gradients
              and updated parameters;
9. train      train_detector's CLI at configs/train_detector.yaml's
              defaults (preset full: the 482M-parameter Sam3Detector at
              1008 px, batch 4, DAC, IoU-aware BCE, AdamW + cosine) for 4
              steps on a synthetic COCO fixture written with OpenCV, launch
              counts reset just before and read just after (exactly 28 K2,
              28 K5, 10 K1, 10 K3 and 10 K4 per step); warm step time and
              its forward/backward/optimizer split, peak memory; then one
              warm step under torch.profiler;
10. kernels   one JSON object per kernel (and K1/K2 mode) of the paths.

cuDNN's TF32 is turned off in phase 4 (float32 convolutions, to compare
card and CPU) and stays off for the phases after it; matmuls keep
PyTorch's default (full float32). Any failed phase exits non-zero and
prints no verdict. Without a CUDA device, or without the skix_torch
package beside this file, it exits 1.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12,         # dense tensor-core bf16
                  "float32": 67e12}           # f32 outside the tensor cores
KERNELS = {  # name → (source, the TPU kernel it replaces)
    "flash_fwd": ("skix_torch/ops/csrc/flash_fwd.cu",
                  "skix/ops/attention.py:184"),
    "flash_fwd_lse": ("skix_torch/ops/csrc/flash_fwd.cu",
                      "skix/ops/attention.py:184"),
    "flash_fwd_single_tile": ("skix_torch/ops/csrc/flash_fwd_single_tile.cu",
                              "skix/ops/attention.py:313"),
    "flash_fwd_single_tile_lse": (
        "skix_torch/ops/csrc/flash_fwd_single_tile.cu",
        "skix/ops/attention.py:313"),
    "flash_bwd_dkv": ("skix_torch/ops/csrc/flash_bwd.cu",
                      "skix/ops/attention.py:558"),
    "flash_bwd_dq": ("skix_torch/ops/csrc/flash_bwd.cu",
                     "skix/ops/attention.py:631"),
    "flash_bwd_single_tile": ("skix_torch/ops/csrc/flash_bwd_single_tile.cu",
                              "skix/ops/attention.py:691"),
}

FULL = dict(vggt_img_size=518, vggt_embed_dim=1024, vggt_depth=24,
            vggt_num_heads=16, vggt_taps=[4, 11, 17, 23])
MAIN_T, MAIN_STRIDE, MAIN_HW = 8, 2, (1080, 1920)
# a two-view rig as pose encodings [t(3), quat(4), fov_h, fov_w]: view 1
# turned 0.3 rad about y and moved one unit along x
RIG_POSES = [[0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 1.0],
             [-1.0, 0.0, 0.1, math.cos(-0.15), 0.0, math.sin(-0.15), 0.0,
              1.0, 1.0]]
# the front path: frames, prompts, and launches per frame and prompt at the
# full-size Sam3Detector (32 ViT-Det blocks, 4 global) and default tracker
FRONT_T, FRONT_HW, FRONT_PROMPTS = 4, (720, 1280), ["person", "snow"]
FRONT_PER_FRAME = {"flash_fwd_single_tile": 28,   # window blocks
                   "flash_fwd": 4 + 6,            # global blocks + encoder
                   "flash_fwd_lse": 2}            # tracker memory attention
# the training path: steps, the fixture, and launches per step (forward
# with lse, backward) and per evaluation forward of the full-size detector
TRAIN_STEPS, TRAIN_IMAGES, TRAIN_HW = 4, 8, (480, 640)
TRAIN_PER_STEP = {"flash_fwd_single_tile_lse": 28, "flash_bwd_single_tile": 28,
                  "flash_fwd_lse": 4 + 6, "flash_bwd_dkv": 4 + 6,
                  "flash_bwd_dq": 4 + 6}
TRAIN_PER_EVAL = {"flash_fwd_single_tile": 28, "flash_fwd": 4 + 6}


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# --------------------------------------------------------------------------
# phase 3: the kernels against their plain versions
# --------------------------------------------------------------------------
def cuda_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after two warm-ups."""
    import torch

    fn()
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def attention_bound_ms(q, k, rope: bool, lse: bool):
    """The least time the card needs: each distinct input element read once
    (a q shared by every batch row counts once), o (and the lse) written
    once, the f32 rope tables read once, against 4·B·H·Sq·Sk·D operations
    (QKᵀ and P·V) at the peak rate of the input type; the larger of the
    two."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    item = q.element_size()
    q_rows = 1 if q.stride(0) == 0 else B
    nbytes = item * (q_rows * H * Sq * D + 2 * B * H * Sk * D + B * H * Sq * D)
    if rope:
        nbytes += 2 * 4 * Sq * D
    if lse:
        nbytes += 4 * B * H * Sq
    ops = 4.0 * B * H * Sq * Sk * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[str(q.dtype).split(".")[-1]] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def plain_chunked(q, k, v, kw, lse: bool, rows: int = 2048):
    """The plain version over (batch row, 2048 q rows) chunks: its (Sq, Sk)
    f32 score matrix would not fit the card at the tracker's shape (64 GB
    for 16 × 15876 × 63504). With rope (one table for q and k) the chunks
    are (batch row, 4 heads) over the whole sequence instead."""
    import torch

    from skix_torch.ops import attention as A

    if kw.get("rope_cos") is not None:
        heads = [A.attention_reference(q[b:b + 1, h:h + 4], k[b:b + 1, h:h + 4],
                                       v[b:b + 1, h:h + 4], return_lse=lse,
                                       **kw)
                 for b in range(q.shape[0]) for h in range(0, q.shape[1], 4)]
        nh = -(-q.shape[1] // 4)
        rows_of = [torch.cat([(r[0] if lse else r) for r in
                              heads[b * nh:(b + 1) * nh]], 1)
                   for b in range(q.shape[0])]
        out = torch.cat(rows_of)
        if not lse:
            return out
        return out, torch.cat([torch.cat([r[1] for r in
                                          heads[b * nh:(b + 1) * nh]], 1)
                               for b in range(q.shape[0])])

    outs, lses = [], []
    for b in range(q.shape[0]):
        o_b, l_b = [], []
        for i in range(0, q.shape[2], rows):
            r = A.attention_reference(q[b:b + 1, :, i:i + rows], k[b:b + 1],
                                      v[b:b + 1], return_lse=lse, **kw)
            o_b.append(r[0] if lse else r)
            if lse:
                l_b.append(r[1])
        outs.append(torch.cat(o_b, 2))
        if lse:
            lses.append(torch.cat(l_b, 2))
    out = torch.cat(outs)
    return (out, torch.cat(lses)) if lse else out


def check_kernel(case, gen):
    """One kernel-vs-plain case: ``(name, label, shape_q, Sk, dtype,
    fixed_max, rope, atol, shared_q, sm_scale)``. Launches are counted by
    the wrappers; the caller resets the counts before the main paths."""
    import torch
    import torch.nn.functional as F

    from skix_torch.models.layers import make_grid_positions
    from skix_torch.ops import attention as A

    name, label, shape, Sk, dtype, fixed_max, rope, atol, shared_q, scale = case
    B, H, Sq, D = shape
    dev = torch.device("cuda")
    q = torch.randn((1 if shared_q else B, H, Sq, D), generator=gen,
                    device=dev) * (scale or 1.0)
    k, v = (torch.randn((B, H, Sk, D), generator=gen, device=dev)
            for _ in range(2))
    if fixed_max is not None:           # qk-normed, as the aggregator's
        q = F.layer_norm(q, (D,))
        k = F.layer_norm(k, (D,))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    q = q.expand(B, H, Sq, D)
    cos = sin = None
    if rope:
        side = math.isqrt(Sq)
        if side * side == Sq:           # a ViT-Det grid or window
            pos = torch.as_tensor(make_grid_positions(side, side), device=dev)
        else:                           # the VGGT layout: specials + grid
            grid = torch.as_tensor(make_grid_positions(37, 37) + 1, device=dev)
            pos = torch.cat([torch.zeros(5, 2, dtype=grid.dtype, device=dev),
                             grid])
            pos = pos.repeat(-(-Sq // len(pos)), 1)[:Sq]
        cos, sin = A.rope_2d_tables(pos, D, 100.0)
    sm = 1.0 if scale else 1.0 / math.sqrt(D)
    kw = dict(sm_scale=sm, fixed_max=fixed_max, rope_cos=cos, rope_sin=sin)
    lse = name.endswith("_lse")
    if name == "flash_fwd_lse" and not rope:    # the memory tracker's call
        run = lambda: A.flash_attention_with_lse(q, k, v, sm)  # noqa: E731
    elif lse:   # the training forward: the wrapper the autograd Function calls
        run = lambda: A._launch(name[:-4], q, k, v, sm, fixed_max,  # noqa: E731
                                cos, sin, True)
    else:
        blocks = ({"block_q": Sq, "block_k_major": Sk, "block_k": Sk}
                  if name == "flash_fwd_single_tile" else {})
        run = lambda: A.flash_attention(q, k, v, **kw, **blocks)  # noqa: E731
    big = B * H * Sq * Sk > 2 ** 30
    plain = ((lambda: plain_chunked(q, k, v, kw, lse)) if big else
             (lambda: A.attention_reference(q, k, v, return_lse=lse, **kw)))
    with torch.no_grad():
        before = A.LAUNCHES[name]
        got = run()
        torch.cuda.synchronize()
        if A.LAUNCHES[name] != before + 1:
            fail(f"{name} {label}: the wrapper did not launch its kernel")
        ref = plain()
        out, ref_out = (got[0], ref[0]) if lse else (got, ref)
        err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (got[1] - ref[1]).abs().max().item() if lse else None
        finite = bool(torch.isfinite(out).all())
        slow = B * H * Sq * Sk * D > 2 ** 38
        ms = cuda_ms(run, 3 if slow else 20)
        plain_ms = cuda_ms(plain, 1 if slow else 5)
        qr = A.apply_rope_tables(q, cos, sin) if rope else q
        kr = A.apply_rope_tables(k, cos, sin) if rope else k
        qr, kr, vc = qr.contiguous(), kr.contiguous(), v.contiguous()
        try:
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qr, kr, vc, scale=sm), 3 if slow else 20)
        except RuntimeError as e:   # no fused SDPA backend took the call
            say("kernel", name=name, case=label, library_error=json.dumps(
                str(e)[:200]))
            lib_ms = None
    bound, bound_by = attention_bound_ms(q, k, rope, lse)
    row = {"name": name, "case": label, "shape_q": list(shape), "Sk": Sk,
           "dtype": str(dtype).split(".")[-1], "fixed_max": fixed_max,
           "rope": rope, "max_abs_err": err, "tol": atol, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
           "bound_by": bound_by}
    if lse:
        row["lse_max_abs_err"] = lse_err
    say("kernel", **row)
    if not finite or out.shape != q.shape or out.dtype != q.dtype:
        fail(f"{name} {label}: non-finite or misshapen output")
    if not err <= atol:
        fail(f"{name} {label}: max |kernel - plain| = {err} > {atol}")
    if lse and not lse_err <= 1e-5:
        fail(f"{name} {label}: max |lse - plain lse| = {lse_err} > 1e-5")
    return row


# every case: (kernel, label, shape_q, Sk, dtype, fixed_max, rope, atol,
# q shared by the batch rows, sm_scale 1 on a pre-scaled q). bf16
# tolerance: the output rounds to bf16 (a step of 2⁻⁸ relative) after f32
# sums taken in another order than the plain version's; f32: the order
# alone.
def kernel_cases():
    import torch

    bf, f32 = torch.bfloat16, torch.float32
    return [
        ("flash_fwd", "vggt_frame", (2, 16, 1374, 64), 1374, bf, 12.0, True,
         4e-3, False, None),
        ("flash_fwd", "vggt_global", (1, 16, 2748, 64), 2748, bf, 12.0, True,
         4e-3, False, None),
        ("flash_fwd", "vggt_camera_trunk", (1, 16, 2, 128), 2, bf, None,
         False, 4e-3, False, None),
        ("flash_fwd", "vitdet_global", (1, 16, 5184, 64), 5184, f32, None,
         True, 1e-5, False, None),
        ("flash_fwd", "fusion_encoder", (1, 8, 5184, 32), 5184, f32, None,
         False, 1e-5, False, None),
        ("flash_fwd", "ragged", (2, 3, 100, 64), 100, f32, None, True, 1e-5,
         False, None),
        ("flash_fwd_lse", "memory_tracker", (16, 1, 15876, 64), 63504, f32,
         None, False, 1e-5, True, 0.125),
        ("flash_fwd_lse", "ragged", (4, 1, 1000, 32), 4100, f32, None, False,
         1e-5, True, 0.125),
        ("flash_fwd_single_tile", "vitdet_window", (9, 16, 576, 64), 576, f32,
         None, True, 1e-5, False, None),
        ("flash_fwd_single_tile", "window_bf16", (2, 4, 576, 64), 576, bf,
         None, True, 4e-3, False, None),
        ("flash_fwd_single_tile", "ragged", (1, 4, 40, 32), 72, f32, 8.0,
         False, 1e-5, False, None),
        # the training forward (batch 4): K1 and K2 with their lse output
        ("flash_fwd_lse", "vitdet_global_train", (4, 16, 5184, 64), 5184,
         f32, None, True, 1e-5, False, None),
        ("flash_fwd_lse", "fusion_encoder_train", (4, 8, 5184, 32), 5184,
         f32, None, False, 1e-5, False, None),
        ("flash_fwd_single_tile_lse", "vitdet_window_train",
         (36, 16, 576, 64), 576, f32, None, True, 1e-5, False, None),
        ("flash_fwd_single_tile_lse", "ragged", (2, 2, 77, 32), 77, f32, 8.0,
         True, 1e-5, False, None),
    ]


# --------------------------------------------------------------------------
# phase 3b: the backward kernels against their plain versions
# --------------------------------------------------------------------------
# the forward kernel whose backward each case runs, and that backward
BWD_OF = {"flash_fwd": ("flash_bwd_dkv", "flash_bwd_dq"),
          "flash_fwd_single_tile": ("flash_bwd_single_tile",)}
# operations per B·H·Sq·Sk·D of each backward kernel: its matrix products
# (K3: s, dP, dV, dK; K4: s, dP, dQ; K5: all five)
BWD_OPS = {"flash_bwd_dkv": 8.0, "flash_bwd_dq": 6.0,
           "flash_bwd_single_tile": 10.0}


def backward_bound_ms(name, q, k):
    """The least time the card needs for one backward kernel: its inputs
    (q, k, v, dO, lse, di; the f32 rope tables) read once and its outputs
    written once, against its products at the input type's peak rate."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    item = q.element_size()
    outs = {"flash_bwd_dkv": 2 * Sk, "flash_bwd_dq": Sq,
            "flash_bwd_single_tile": Sq + 2 * Sk}[name]
    nbytes = (item * B * H * D * (2 * Sq + 2 * Sk + outs)
              + 2 * 4 * B * H * Sq)
    ops = BWD_OPS[name] * B * H * Sq * Sk * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[str(q.dtype).split(".")[-1]] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def plain_backward(q, k, v, do, lse, di, sm, cos, sin, heads: int = 4):
    """The plain K3/K4 (= plain K5) over (batch row, ``heads`` heads)
    chunks: at (4, 16, 5184, 64) one unchunked f32 score matrix is 6.9 GB,
    and the backward holds several."""
    import torch

    from skix_torch.ops import attention as A

    B, H = q.shape[:2]
    grads = [torch.empty_like(x) for x in (q, k, v)]
    for b in range(B):
        for h in range(0, H, heads):
            sl = (slice(b, b + 1), slice(h, h + heads))
            got = A.attention_backward_reference(
                q[sl], k[sl], v[sl], do[sl], lse[sl], di[sl], sm, cos, sin)
            for g, x in zip(grads, got):
                g[sl] = x
    return grads


def check_backward(case, gen):
    """One backward case: ``(forward kernel, label, shape_q, Sk, dtype,
    fixed_max, rope, tol)``. The forward kernel runs with its lse output,
    then its backward kernels (K3 and K4, or K5) through the wrapper the
    autograd Function calls, against the plain backward on the same
    inputs; each backward kernel is also timed alone. ``tol`` bounds
    max |kernel − plain| over dq, dk, dv relative to max |plain| of each."""
    import torch
    import torch.nn.functional as F

    from skix_torch.models.layers import make_grid_positions
    from skix_torch.ops import attention as A

    fwd, label, shape, Sk, dtype, fixed_max, rope, tol = case
    B, H, Sq, D = shape
    dev = torch.device("cuda")
    q = torch.randn((B, H, Sq, D), generator=gen, device=dev)
    k, v = (torch.randn((B, H, Sk, D), generator=gen, device=dev)
            for _ in range(2))
    do = torch.randn((B, H, Sq, D), generator=gen, device=dev)
    if fixed_max is not None:
        q = F.layer_norm(q, (D,))
        k = F.layer_norm(k, (D,))
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    cos = sin = None
    if rope:
        side = math.isqrt(Sq)
        if side * side == Sq:
            pos = torch.as_tensor(make_grid_positions(side, side), device=dev)
        else:
            grid = torch.as_tensor(make_grid_positions(37, 37) + 1, device=dev)
            pos = torch.cat([torch.zeros(5, 2, dtype=grid.dtype, device=dev),
                             grid]).repeat(-(-Sq // 1374), 1)[:Sq]
        cos, sin = A.rope_2d_tables(pos, D, 100.0)
    sm = 1.0 / math.sqrt(D)
    kernels = BWD_OF[fwd]
    with torch.no_grad():
        o, lse = A._launch(fwd, q, k, v, sm, fixed_max, cos, sin, True)
        di = (o.float() * do.float()).sum(-1)
        before = {n: A.LAUNCHES[n] for n in kernels}
        got = A._launch_backward(kernels, q, k, v, do, lse, di, sm, cos, sin)
        torch.cuda.synchronize()
        if any(A.LAUNCHES[n] != before[n] + 1 for n in kernels):
            fail(f"{kernels} {label}: the wrapper did not launch its kernels")
        big = B * H * Sq * Sk > 2 ** 28
        plain = ((lambda: plain_backward(q, k, v, do, lse, di, sm, cos, sin))
                 if big else (lambda: A.attention_backward_reference(
                     q, k, v, do, lse, di, sm, cos, sin)))
        ref = plain()
        errs = {f"d{n}": (g.float() - r.float()).abs().max().item()
                for n, g, r in zip("qkv", got, ref)}
        scales = {f"d{n}": r.float().abs().max().item()
                  for n, r in zip("qkv", ref)}
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        slow = B * H * Sq * Sk * D > 2 ** 38
        reps = 3 if slow else 10
        ms = {n: cuda_ms(lambda n=n: A._launch_backward(
            (n,), q, k, v, do, lse, di, sm, cos, sin), reps) for n in kernels}
        plain_ms = cuda_ms(plain, 1 if slow else 3)
    # the yardstick: autograd through SDPA on the pre-roped inputs, its
    # backward alone (the forward runs outside the timed region)
    qr = (A.apply_rope_tables(q, cos, sin) if rope else q).detach()
    kr = (A.apply_rope_tables(k, cos, sin) if rope else k).detach()
    leaves = [x.contiguous().requires_grad_() for x in (qr, kr, v)]
    out = None
    try:
        out = F.scaled_dot_product_attention(*leaves, scale=sm)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), reps)
    except RuntimeError as e:   # no fused SDPA backend took the call
        say("backward", case=label, library_error=json.dumps(str(e)[:200]))
        lib_ms = None
    del leaves, out
    rows = []
    for n in kernels:
        bound, bound_by = backward_bound_ms(n, q, k)
        row = {"name": n, "case": label, "shape_q": list(shape), "Sk": Sk,
               "dtype": str(dtype).split(".")[-1], "fixed_max": fixed_max,
               "rope": rope, "max_abs_err": max(errs.values()),
               "errs": errs, "grad_scale": scales, "tol": tol, "ms": ms[n],
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound, "bound_by": bound_by}
        say("backward", **{k_: (json.dumps(v_).replace(" ", "")
                                if isinstance(v_, dict) else v_)
                           for k_, v_ in row.items()})
        rows.append(row)
    if not finite:
        fail(f"{kernels} {label}: non-finite gradients")
    bad = [n for n in errs if not errs[n] <= tol * max(scales[n], 1e-30)]
    if bad:
        fail(f"{kernels} {label}: {bad} off by {errs} (scales {scales}, "
             f"tol {tol} relative)")
    return rows


# every backward case: (forward kernel, label, shape_q, Sk, dtype, fixed_max,
# rope, tol relative to max |plain gradient|). f32: the sum order alone
# (sums over up to 5184 rows); bf16: p, dS and the gradients round to bf16,
# and a sum taken in another order can tip one rounding of p or dS (a step
# of 2⁻⁸ relative).
def backward_cases():
    import torch

    bf, f32 = torch.bfloat16, torch.float32
    return [
        ("flash_fwd_single_tile", "vitdet_window", (36, 16, 576, 64), 576,
         f32, None, True, 1e-5),
        ("flash_fwd", "vitdet_global", (4, 16, 5184, 64), 5184, f32, None,
         True, 1e-5),
        ("flash_fwd", "fusion_encoder", (4, 8, 5184, 32), 5184, f32, None,
         False, 1e-5),
        ("flash_fwd", "ragged", (2, 3, 1000, 64), 1000, f32, None, True, 1e-5),
        ("flash_fwd", "ragged_cross_d128", (1, 2, 77, 128), 130, f32, None,
         False, 1e-5),
        ("flash_fwd_single_tile", "ragged", (2, 2, 77, 32), 77, f32, 8.0,
         True, 1e-5),
        ("flash_fwd", "vggt_frame_bf16", (2, 16, 1374, 64), 1374, bf, 12.0,
         True, 2e-2),
        ("flash_fwd_single_tile", "window_bf16", (2, 4, 576, 64), 576, bf,
         None, True, 2e-2),
    ]


# --------------------------------------------------------------------------
# records and weights
# --------------------------------------------------------------------------
def rig(img_size, hw):
    """K per view (at the video size), R_rel, t_rel of ``RIG_POSES``."""
    import numpy as np
    import torch

    from skix_torch.models.vggt import pose_encoding_to_extri_intri

    extr, K = pose_encoding_to_extri_intri(torch.tensor(RIG_POSES),
                                           (img_size, img_size))
    K = K.numpy().copy()
    K[:, 0] *= hw[1] / img_size
    K[:, 1] *= hw[0] / img_size
    R, t = extr[:, :, :3].numpy(), extr[:, :, 3].numpy()
    R_rel = R[1] @ R[0].T
    return K, R_rel, t[1] - R_rel @ t[0]


def write_records(root: Path, T: int, hw, img_size: int, seed: int):
    """Two pt records (person p01) with random uint8 frames and the COCO-17
    keypoints of a skeleton 4 units in front of the rig, 0.3 px noise."""
    import numpy as np

    from skix_torch.io.contracts import PTInfo, save_pt_info

    rng = np.random.default_rng(seed)
    K, R_rel, t_rel = rig(img_size, hw)
    X = (rng.normal(size=(1, 17, 3)) * 0.5
         + rng.normal(size=(T, 17, 3)).cumsum(0) * 0.02
         + np.array([0.0, 0.0, 4.0]))
    xa = X @ K[0].T
    xb = (X @ R_rel.T + t_rel) @ K[1].T
    obs = np.stack([xa[..., :2] / xa[..., 2:], xb[..., :2] / xb[..., 2:]])
    obs = obs + rng.normal(size=obs.shape) * 0.3
    for c, view in enumerate(("osmo_1", "osmo_2")):
        frames = rng.integers(0, 255, (T, *hw, 3), dtype=np.uint8)
        score = np.ones((T, 17), np.float32)
        save_pt_info(root / "p01" / f"{view}.npz", PTInfo(
            video_name=view, frame_count=T, img_shape=tuple(hw), fps=30.0,
            duration=T / 30.0, frames=frames,
            d2_keypoints=np.concatenate([obs[c].astype(np.float32),
                                         score[..., None]], -1),
            d2_keypoints_score=score))
    return X


def fit_rig_head(model, pair):
    """Zero the adaLN modulation and solve pose_branch.fc2 so that the
    model's pose encodings on ``pair`` are ``RIG_POSES``: the cameras are
    then well posed, and the comparison below measures the arithmetic,
    not the conditioning of random cameras."""
    import numpy as np
    import torch

    head = model.camera_head
    with torch.no_grad():
        head.poseLN_modulation.weight.zero_()
        head.poseLN_modulation.bias.zero_()
        seen = []
        hook = head.pose_branch.fc2.register_forward_hook(
            lambda m, inp, out: seen.append(inp[0][0].double().cpu().numpy()))
        model(pair[None])
        hook.remove()
        g = seen[-1]
        dg = g[1] - g[0]
        target = np.asarray(RIG_POSES, np.float64) / 4.0
        Wt = np.outer(target[1] - target[0], dg) / (dg @ dg)
        b = target[0] - Wt @ g[0]
        head.pose_branch.fc2.weight.copy_(torch.as_tensor(Wt, dtype=torch.float32))
        head.pose_branch.fc2.bias.copy_(torch.as_tensor(b, dtype=torch.float32))


# --------------------------------------------------------------------------
# phase 4: small-input reference, card against CPU
# --------------------------------------------------------------------------
def reference_phase(tmp: Path):
    import numpy as np
    import torch

    from skix_torch.config import config_from_mapping
    from skix_torch.pipelines import vggt as V

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    size, hw = 56, (112, 112)
    body = {"img_size": size, "embed_dim": 512, "depth": 2, "num_heads": 8,
            "intermediate_layer_idx": [0, 0, 1, 1], "dtype": "float32",
            "frame_stride": 30}
    cfg = config_from_mapping(body)
    root = tmp / "ref_pt"
    X_true = write_records(root, 6, hw, size, seed=5)
    recs = sorted((root / "p01").glob("*.npz"))

    cpu_model = V.load_or_init_variables(V.build_model(cfg, torch.device("cpu")), cfg)
    from skix_torch.io.contracts import load_pt_info

    frames = [load_pt_info(r).frames[0] for r in recs]
    pair = torch.cat([V.preprocess_frames(f[None], size) for f in frames])
    fit_rig_head(cpu_model, pair)
    gpu_model = V.build_model(cfg, torch.device("cuda"))
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.eval()

    out = {}
    for name, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        V.process_multi_view(model, recs[0], recs[1], tmp / f"ref_{name}", cfg)
        with np.load(tmp / f"ref_{name}" / "multi_view_refined.npz") as z:
            out[name] = {k: z[k] for k in z.files}
    a, b = out["cpu"], out["cuda"]
    # float32 on both sides; the card sums in another order (the kernel's
    # tiles, cuBLAS, its eigensolver), the LM probes are the same draws.
    # Limits on |card − CPU| / max(1, |CPU|), about 100× what an H100 gave
    tol = {"R": 1e-5, "t": 1e-5, "K": 1e-5, "K_right": 1e-5, "X3d": 1e-4,
           "initial_cost": 1e-5, "final_cost": 1e-5}
    diffs = {}
    for k in tol:
        scale = max(1.0, float(np.abs(a[k]).max()))
        diffs[k] = float(np.abs(a[k] - b[k]).max()) / scale
    err_truth = float(np.abs(b["X3d"] - X_true).max())
    say("reference", **{f"rel_{k}": v for k, v in diffs.items()},
        X3d_vs_truth=err_truth, tol=json.dumps(tol).replace(" ", ""))
    bad = [k for k, limit in tol.items() if not diffs[k] <= limit]
    if bad or not np.isfinite(b["X3d"]).all():
        fail(f"reference: card and CPU disagree on {bad}")
    if not err_truth < 0.5:
        fail(f"reference: X3d is {err_truth} from the rig's skeleton")


# --------------------------------------------------------------------------
# phase 5: the main path at full width
# --------------------------------------------------------------------------
def main_phase(tmp: Path, device: str = "cuda"):
    import numpy as np
    import torch

    from skix_torch.ops import attention as A
    from skix_torch.pipelines.run_all import main as run_all

    pt_root = tmp / "pt"
    t0 = time.perf_counter()
    write_records(pt_root, MAIN_T, MAIN_HW, FULL["vggt_img_size"], seed=11)
    setup_s = time.perf_counter() - t0
    work = tmp / "work"
    cfg = {"paths": {"pt_root": str(pt_root), "work_root": str(work),
                     "video_root": None, "sam3d_root": None},
           "stages": ["vggt"], "kpt_source": "detectron2",
           "vggt_frame_stride": MAIN_STRIDE, "vggt_checkpoint": None,
           "device": device, **FULL}
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    A.LAUNCHES.clear()
    t0 = time.perf_counter()
    run_all(cfg)
    if on_card:
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(A.LAUNCHES)

    out = work / "vggt" / "p01" / "multi_view_refined.npz"
    if not out.exists():
        fail(f"main path wrote no {out}")
    with np.load(out) as z:
        res = {k: z[k] for k in z.files}
    summary = json.loads((work / "vggt" / "vggt_summary.json").read_text())
    timing = json.loads((work / "pipeline_timing.json").read_text())
    pairs = len(range(0, MAIN_T, MAIN_STRIDE))
    per_pair = 2 * FULL["vggt_depth"] + 4 * 4   # aggregator + camera trunk
    spans = json.loads((work / "vggt" / "vggt_timing.json").read_text())
    say("main", stage_s=timing["vggt"]["total_s"], wall_s=round(wall_s, 3),
        records_setup_s=round(setup_s, 3),
        vggt_forward_ms_per_pair=spans["vggt_forward"]["mean_ms"],
        triangulate_ms=spans["triangulate"]["mean_ms"],
        bundle_adjust_ms=spans["bundle_adjust"]["mean_ms"],
        pairs=pairs, launches=json.dumps(launches).replace(" ", ""),
        expected_launches=pairs * per_pair,
        peak_mem_gib=(round(torch.cuda.max_memory_allocated() / 2 ** 30, 2)
                      if on_card else "not measured"),
        X3d_shape=list(res["X3d"].shape),
        initial_cost=float(res["initial_cost"]),
        final_cost=float(res["final_cost"]))
    if "p01" not in summary or summary["p01"]["vggt_pairs"] != pairs:
        fail(f"vggt summary {summary}")
    if res["X3d"].shape != (MAIN_T, 17, 3) or not np.isfinite(res["X3d"]).all():
        fail(f"X3d {res['X3d'].shape} not a finite ({MAIN_T}, 17, 3)")
    for k in ("R", "t", "K", "K_right"):
        if not np.isfinite(res[k]).all():
            fail(f"{k} not finite")
    if not float(res["final_cost"]) <= float(res["initial_cost"]):
        fail("bundle adjustment raised the cost")
    if launches.get("flash_fwd", 0) != pairs * per_pair:
        fail(f"flash_fwd launched {launches} times on the main path, "
             f"expected {pairs * per_pair}")
    return launches, cfg


# --------------------------------------------------------------------------
# phase 5b: the same run warm, then once more under the profiler
# --------------------------------------------------------------------------
def profile_phase(tmp: Path, cfg: dict):
    """A warm rerun of the main path (host clock, per-span means), then one
    under ``torch.profiler``: device time by kernel, and the device's idle
    share of the profiled wall time (one stream, so kernels do not
    overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from skix_torch.pipelines.run_all import main as run_all

    warm = dict(cfg, paths=dict(cfg["paths"], work_root=str(tmp / "warm")))
    t0 = time.perf_counter()
    run_all(warm)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    spans = json.loads((tmp / "warm" / "vggt" / "vggt_timing.json").read_text())
    say("warm", wall_s=round(wall_s, 3),
        **{f"{k}_ms_mean": v["mean_ms"] for k, v in spans.items()},
        **{f"{k}_s_total": v["total_s"] for k, v in spans.items()})

    prof_cfg = dict(cfg, paths=dict(cfg["paths"], work_root=str(tmp / "prof")))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_all(prof_cfg)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    flash_ms = sum(e.self_device_time_total for e in kernels
                   if "flash_fwd" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    say("profile", wall_ms=round(prof_wall_ms, 1),
        device_busy_ms=round(busy_ms, 2),
        device_idle_share=round(1.0 - busy_ms / prof_wall_ms, 4),
        flash_fwd_ms=round(flash_ms, 2), kernels_launched=sum(
            e.count for e in kernels))
    say("profile_top", kernels=json.dumps(
        [[e.key[:60], round(e.self_device_time_total / 1e3, 2), e.count]
         for e in top]).replace(" ", ""))


# --------------------------------------------------------------------------
# phase 6: the front stage at the tiny width, card against CPU
# --------------------------------------------------------------------------
def _front_predictor(device, det_state=None, trk_state=None):
    """The tiny Sam3Detector of skix's stage test with a tracker whose head
    dim is 64 (the test's features 16 / 2 heads give head dim 8, which the
    kernel does not take), seeded random weights or the given ones."""
    import torch

    from skix_torch.tracking.masklet import MaskletConfig
    from skix_torch.tracking.memory_tracker import MaskMemoryTracker
    from skix_torch.tracking.sam3_detector import Sam3Detector
    from skix_torch.tracking.session import VideoPredictor

    det = Sam3Detector.tiny().to(device)
    trk = MaskMemoryTracker(features=64, num_heads=1, mem_slots=3).to(device)
    if det_state is None:
        det.init_weights(torch.Generator(device=device).manual_seed(0))
        trk.init_weights(torch.Generator(device=device).manual_seed(1))
    else:
        det.load_state_dict(det_state)
        trk.load_state_dict(trk_state)
    cfg = MaskletConfig(max_objects=4, max_dets=6,
                        score_threshold_detection=0.0, new_det_thresh=0.0)
    return VideoPredictor(det.eval(), trk.eval(), masklet_cfg=cfg,
                          smoke_prompts=True)


def front_reference_phase(tmp: Path):
    import numpy as np

    from skix_torch.config import config_from_mapping
    from skix_torch.ops import attention as A
    from skix_torch.pipelines.prepare_front_results import process_frames

    frames = np.random.default_rng(7).integers(0, 255, (4, 48, 64, 3),
                                               dtype=np.uint8)
    cfg = config_from_mapping({"prompts": FRONT_PROMPTS, "save_mask_size": 24})
    cpu = _front_predictor("cpu")
    gpu = _front_predictor("cuda", cpu.detector.state_dict(),
                           cpu.tracker.state_dict())
    process_frames(cpu, frames, tmp / "front_ref_cpu", cfg)
    A.LAUNCHES.clear()
    process_frames(gpu, frames, tmp / "front_ref_cuda", cfg)
    launches = dict(A.LAUNCHES)
    worst = {}
    for f in sorted((tmp / "front_ref_cpu").glob("*.npy")):
        a, b = np.load(f), np.load(tmp / "front_ref_cuda" / f.name)
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"front_ref: {f.name} {a.shape}/{a.dtype} on the CPU, "
                 f"{b.shape}/{b.dtype} on the card")
        kind = f.stem.split("_", 1)[1]
        if a.dtype == bool and kind == "masks":
            worst[f.stem] = float((a == b).mean())
        elif a.dtype == bool or a.dtype.kind == "i":
            worst[f.stem] = int((a != b).sum())
        else:
            worst[f.stem] = float(np.abs(a - b).max())
    # limits: the lifecycle (active, ids, valid) exactly; scores 1e-4
    # (float32 sums in another order on each side); boxes within one pixel
    # of the 14×14 tracker grid in frame pixels; masks pixel by pixel
    box_tol = 64 / 14 + 1e-3
    bad = []
    for k, val in worst.items():
        kind = k.split("_", 1)[1]
        ok = (val >= 0.999 if kind == "masks"
              else val <= box_tol if kind == "bboxes"
              else val <= 1e-4 if kind in ("scores", "tracker_scores")
              else val == 0)
        if not ok:
            bad.append(k)
    say("front_ref", **{k: v for k, v in worst.items()},
        launches=json.dumps(launches).replace(" ", ""))
    if bad:
        fail(f"front_ref: card and CPU disagree on {bad}")
    want = {"flash_fwd_single_tile": 8, "flash_fwd": 8, "flash_fwd_lse": 16}
    if launches != want:
        fail(f"front_ref: launches {launches}, expected {want}")


# --------------------------------------------------------------------------
# phase 7: the front stage at full size, then warm, then profiled
# --------------------------------------------------------------------------
def _front_run(tmp: Path, work: Path, frames):
    """run_all's prepare_front_results stage on one front video, written
    with the port's write_video (OpenCV) on the first call; returns the
    stage's time from ``pipeline_timing.json``."""
    from skix_torch.pipelines.run_all import main as run_all

    video_root = tmp / "front_raw"
    if not video_root.exists():
        from skix_torch.io.video import write_video

        write_video(video_root / "p01" / "clip.mp4", frames, fps=10)
    run_all({"paths": {"pt_root": str(tmp), "work_root": str(work),
                       "video_root": str(video_root)},
             "stages": ["prepare_front_results"], "device": "cuda"})
    timing = json.loads((work / "pipeline_timing.json").read_text())
    return timing["prepare_front_results"]["total_s"]


def front_phase(tmp: Path):
    import numpy as np
    import torch

    from skix_torch.ops import attention as A

    frames = np.random.default_rng(3).integers(
        0, 255, (FRONT_T, *FRONT_HW, 3), dtype=np.uint8)
    work = tmp / "front_work"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    A.LAUNCHES.clear()
    t0 = time.perf_counter()
    stage_s = _front_run(tmp, work, frames)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(A.LAUNCHES)

    out = work / "front" / "p01"
    summary = work / "front" / "front_summary.json"
    if not summary.exists():
        fail(f"front: no {summary}")
    want = {"person_masks.npy": ((FRONT_T, 16, *FRONT_HW), bool),
            "person_bboxes.npy": ((FRONT_T, 4), np.float32)}
    for name, (shape, dtype) in want.items():
        if not (out / name).exists():
            fail(f"front: the stage wrote no {name} (its per-video errors "
                 "are logged, not raised)")
        a = np.load(out / name)
        if a.shape != shape or a.dtype != dtype:
            fail(f"front: {name} is {a.shape} {a.dtype}, not {shape} {dtype}")
        if a.dtype != bool and not np.isfinite(a).all():
            fail(f"front: {name} is not finite")
    for p in FRONT_PROMPTS[1:]:
        for kind in ("masks", "bboxes", "scores", "tracker_scores", "active",
                     "obj_ids"):
            if not (out / f"{p}_{kind}.npy").exists():
                fail(f"front: no {p}_{kind}.npy")
    spans = json.loads((work / "front" / "front_timing.json").read_text())
    n = FRONT_T * len(FRONT_PROMPTS)
    expected = {k: n * v for k, v in FRONT_PER_FRAME.items()}
    say("front", stage_s=round(stage_s, 3),
        wall_s=round(wall_s, 3),
        detector_ms_per_frame=spans["detector"]["mean_ms"],
        tracker_ms_per_frame=spans["tracker"]["mean_ms"],
        outputs_ms_per_frame=spans["outputs"]["mean_ms"], frames=n,
        launches=json.dumps(launches).replace(" ", ""),
        expected_launches=json.dumps(expected).replace(" ", ""),
        peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2),
        person_active_mean=float(np.load(out / "person_active.npy").mean()))
    if launches != expected:
        fail(f"front: launches {launches}, expected {expected}")
    return launches, frames


def front_profile_phase(tmp: Path, frames):
    """A warm rerun of the front stage, then one under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    stage_s = _front_run(tmp, tmp / "front_warm", frames)
    torch.cuda.synchronize()
    spans = json.loads((tmp / "front_warm" / "front" / "front_timing.json"
                        ).read_text())
    say("front_warm", stage_s=round(stage_s, 3),
        wall_s=round(time.perf_counter() - t0, 3),
        **{f"{k}_ms_mean": v["mean_ms"] for k, v in spans.items()})
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _front_run(tmp, tmp / "front_prof", frames)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    by_kernel = {name: sum(e.self_device_time_total for e in kernels
                           if name in e.key) / 1e3
                 for name in ("single_tile_kernel", "flash_fwd_kernel")}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    say("front_profile", wall_ms=round(prof_wall_ms, 1),
        device_busy_ms=round(busy_ms, 2),
        device_idle_share=round(1.0 - busy_ms / prof_wall_ms, 4),
        k2_ms=round(by_kernel["single_tile_kernel"], 2),
        k1_ms=round(by_kernel["flash_fwd_kernel"], 2),
        kernels_launched=sum(e.count for e in kernels))
    say("front_profile_top", kernels=json.dumps(
        [[e.key[:60], round(e.self_device_time_total / 1e3, 2), e.count]
         for e in top]).replace(" ", ""))


# --------------------------------------------------------------------------
# phase 8: one training step of the tiny detector, card against CPU
# --------------------------------------------------------------------------
def write_coco(root: Path, n: int, hw, seed: int) -> Path:
    """A COCO instances file of ``n`` images of ``hw`` pixels, each with 1–3
    objects (a bright random pentagon on noise, its polygon as the
    segmentation), written with OpenCV; returns the json path."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    (root / "img").mkdir(parents=True, exist_ok=True)
    H, W = hw
    images, anns = [], []
    for i in range(n):
        img = (rng.random((H, W, 3)) * 60).astype(np.uint8)
        for _ in range(int(rng.integers(1, 4))):
            c = rng.uniform(0.2, 0.8, 2) * (W, H)
            r = rng.uniform(0.06, 0.2) * min(H, W)
            ang = np.sort(rng.uniform(0, 2 * np.pi, 5))
            poly = np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)],
                            -1).round()
            cv2.fillPoly(img, [poly.astype(np.int32)],
                         tuple(int(x) for x in rng.integers(120, 255, 3)))
            (x0, y0), (x1, y1) = poly.min(0), poly.max(0)
            anns.append({"id": len(anns), "image_id": i, "category_id": 1,
                         "bbox": [float(x0), float(y0), float(x1 - x0),
                                  float(y1 - y0)], "iscrowd": 0,
                         "area": float((x1 - x0) * (y1 - y0)),
                         "segmentation": [poly.ravel().tolist()]})
        cv2.imwrite(str(root / "img" / f"{i}.png"), img)
        images.append({"id": i, "file_name": f"img/{i}.png", "width": W,
                       "height": H})
    path = root / "coco.json"
    path.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": [{"id": 1, "name": "skier"}]}))
    return path


def train_reference_phase(tmp: Path):
    """One step of train_detector's loss and optimizer, tiny preset, on the
    card and on the CPU from the same weights and the same collated batch.
    The tiny trunk's head dim is 32: its window blocks (16 tokens) launch
    K2 and K5, its global block K1, K3 and K4."""
    import torch

    from skix_torch.config import config_from_mapping
    from skix_torch.data import CocoDataset, CocoLoader
    from skix_torch.ops import attention as A
    from skix_torch.pipelines import train_detector as T

    torch.backends.cudnn.allow_tf32 = False
    root = tmp / "coco_ref"
    jp = write_coco(root, 4, (96, 128), seed=2)
    lr = 5e-4
    cfg = config_from_mapping({"preset": "tiny", "lr": lr,
                               "weight_decay": 1e-4, "grad_clip": 1.0,
                               "dac": True, "loss": {"cls": "iabce"}})
    batch = next(iter(CocoLoader(CocoDataset(jp, image_root=root),
                                 batch_size=4, image_size=112, max_objects=4,
                                 seed=0)))
    cpu = T.build_detector(cfg, "cpu")
    cpu.init_weights(torch.Generator().manual_seed(0))
    gpu = T.build_detector(cfg, "cuda")
    gpu.load_state_dict(cpu.state_dict())
    res = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        dev = next(model.parameters()).device
        opt = T.build_optimizer(cfg, model, 10)
        A.LAUNCHES.clear()
        loss, _, _ = T.make_loss_fn(model, cfg, 112)(T.batch_to(batch, dev))
        opt.zero_grad()
        loss.backward()
        launches = dict(A.LAUNCHES)
        grads = {n: (p.grad.detach().cpu().clone() if p.grad is not None
                     else torch.zeros(p.shape)) for n, p in
                 model.named_parameters()}
        opt.step()
        res[name] = (loss.item(), grads, launches,
                     {n: p.detach().cpu() for n, p in model.named_parameters()})
    (l_c, g_c, _, p_c), (l_g, g_g, launches, p_g) = res["cpu"], res["cuda"]
    # limits: f32 on both sides, sums in other orders (cuBLAS, the kernels,
    # MKL); each gradient leaf within 1e-4·max|g| + 1e-6 (g_err, the worst
    # leaf's error over its limit, ≤ 1); after Adam's first step (±lr where
    # the sign holds), lr/50 where |g| > 1e-5
    ratio = {n: ((g_g[n] - g_c[n]).abs().max()
                 / (1e-4 * g_c[n].abs().max() + 1e-6)).item() for n in g_c}
    worst = sorted(ratio, key=ratio.get)[::-1][:3]
    g_err = ratio[worst[0]]
    p_err = max(((p_g[n] - p_c[n]).abs()[g_c[n].abs() > 1e-5].max().item()
                 if (g_c[n].abs() > 1e-5).any() else 0.0) for n in p_c)
    loss_rel = abs(l_g - l_c) / abs(l_c)
    want = {"flash_fwd_single_tile_lse": 1, "flash_bwd_single_tile": 1,
            "flash_fwd_lse": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}
    say("train_ref", loss_cpu=l_c, loss_card=l_g, loss_rel=loss_rel,
        grad_err_over_limit=g_err, param_err=p_err,
        worst_leaves=json.dumps([[n, ratio[n], (g_g[n] - g_c[n]).abs().max()
                                  .item(), g_c[n].abs().max().item()]
                                 for n in worst]).replace(" ", ""),
        launches=json.dumps(launches).replace(" ", ""))
    if not (loss_rel <= 1e-5 and g_err <= 1.0 and p_err <= lr / 50):
        fail(f"train_ref: card and CPU disagree (loss {loss_rel}, grads "
             f"{g_err}, params {p_err})")
    if launches != want:
        fail(f"train_ref: launches {launches}, expected {want}")


# --------------------------------------------------------------------------
# phase 9: train_detector at full size, warm split, profiled
# --------------------------------------------------------------------------
def _train_argv(tmp: Path):
    """The CLI overrides of the training path: configs/train_detector.yaml
    as it is, on the synthetic fixture, for TRAIN_STEPS steps."""
    root = tmp / "coco_train"
    return root, [f"paths.checkpoint_dir={tmp / 'train_ckpt'}",
                  f"coco_json={root / 'coco.json'}", f"image_root={root}",
                  f"steps={TRAIN_STEPS}", "log_every=1"]


def train_phase(tmp: Path):
    import numpy as np
    import torch

    from skix_torch.config import load_config
    from skix_torch.convert import flax_leaf
    from skix_torch.ops import attention as A
    from skix_torch.pipelines import train_detector as T

    root, argv = _train_argv(tmp)
    t0 = time.perf_counter()
    write_coco(root, TRAIN_IMAGES, TRAIN_HW, seed=4)
    setup_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    A.LAUNCHES.clear()
    t0 = time.perf_counter()
    run = T.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(A.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    ckpt = tmp / "train_ckpt"
    res = json.loads((ckpt / "final_eval.json").read_text())
    npz = ckpt / f"sam3_detector_{TRAIN_STEPS:06d}.npz"
    if not npz.exists():
        fail(f"train: no {npz.name}")
    # the key set of the converted tree of the same model (names and
    # shapes, from the port's own state_dict, no data copied)
    want = {}
    for key, t in run.model.state_dict().items():
        parts = key.split(".")
        leaf, arr = flax_leaf(parts[-1], np.broadcast_to(np.float32(0),
                                                         tuple(t.shape)))
        want["/".join(["params", *parts[:-1], leaf])] = arr.shape
    with np.load(npz) as z:
        got = {k: z[k].shape for k in z.files}
    ckpt_mb = npz.stat().st_size / 2 ** 20
    npz.unlink()
    # the eval loader yields len(fixture) // batch batches (at most 8),
    # before and after training
    batch = int(load_config("train_detector", argv).batch_size)
    n_eval = 2 * min(8, TRAIN_IMAGES // batch)
    expected = {k: TRAIN_STEPS * v for k, v in TRAIN_PER_STEP.items()}
    expected.update({k: n_eval * v for k, v in TRAIN_PER_EVAL.items()})
    warm = run.steps[1:]
    split = {k: sum(s[k] for s in warm) / len(warm) * 1e3
             for k in ("data_s", "forward_s", "backward_s", "optimizer_s")}
    say("train", wall_s=round(wall_s, 3), fixture_setup_s=round(setup_s, 3),
        steps=TRAIN_STEPS, final_loss=res.get("final_loss"),
        ap_before=res.get("ap_before"), ap_after=res.get("ap_after"),
        warm_step_ms=sum(split.values()),
        **{f"warm_{k[:-2]}_ms": v for k, v in split.items()},
        first_step_ms=sum(run.steps[0].values()) * 1e3,
        peak_mem_gib=round(peak_gib, 2), checkpoint_mb=round(ckpt_mb, 1),
        checkpoint_leaves=len(got),
        launches=json.dumps(launches).replace(" ", ""),
        expected_launches=json.dumps(expected).replace(" ", ""))
    for k in ("final_loss", "ap_before", "ap_after"):
        if not (isinstance(res.get(k), float) and math.isfinite(res[k])):
            fail(f"train: final_eval.json {k} = {res.get(k)}")
    if got != want:
        fail(f"train: the checkpoint's keys/shapes differ from the model's "
             f"converted tree ({len(got)} vs {len(want)} leaves)")
    if launches != expected:
        fail(f"train: launches {launches}, expected {expected}")
    return run, launches


def train_profile_phase(tmp: Path, run):
    """One warm training step of the full-size detector (the main path's
    trained model, a fresh optimizer, one augmented batch) under
    ``torch.profiler``: device busy, idle share, top kernels, and the
    attention kernels' device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from skix_torch.config import load_config
    from skix_torch.data import CocoDataset, CocoLoader
    from skix_torch.pipelines import train_detector as T

    root, argv = _train_argv(tmp)
    cfg = load_config("train_detector", argv)
    model = run.model
    size = model.img_size
    loader = CocoLoader(CocoDataset(cfg.coco_json, image_root=root),
                        batch_size=int(cfg.batch_size), image_size=size,
                        max_objects=int(cfg.max_objects),
                        mask_stride=int(cfg.mask_stride), seed=1)
    batch = T.batch_to(next(iter(loader)), "cuda")
    loss_fn = T.make_loss_fn(model, cfg, size)
    opt = T.build_optimizer(cfg, model, TRAIN_STEPS)

    def step():
        loss, _, _ = loss_fn(batch)
        opt.zero_grad()
        loss.backward()
        opt.step()

    step()                      # the fresh optimizer's state, then warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3

    def kind(key):
        for name, tag in (("bwd_single_tile_kernel", "k5"),
                          ("single_tile_kernel", "k2"),
                          ("flash_bwd_dkv_kernel", "k3"),
                          ("flash_bwd_dq_kernel", "k4"),
                          ("flash_fwd_kernel", "k1")):
            if name in key:
                return tag
        return None

    by = {t: 0.0 for t in ("k1", "k2", "k3", "k4", "k5")}
    for e in kernels:
        t = kind(e.key)
        if t:
            by[t] += e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    say("train_profile", wall_ms=round(wall_ms, 1),
        device_busy_ms=round(busy_ms, 2),
        device_idle_share=round(1.0 - busy_ms / wall_ms, 4),
        **{f"{t}_ms": round(v, 2) for t, v in by.items()},
        **{f"{t}_share": round(v / busy_ms, 4) for t, v in by.items()},
        kernels_launched=sum(e.count for e in kernels))
    say("train_profile_top", kernels=json.dumps(
        [[e.key[:60], round(e.self_device_time_total / 1e3, 2), e.count]
         for e in top]).replace(" ", ""))


def main() -> int:
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    # the full-size training step peaks at ~74 GiB of the card's 79.1 GiB
    # (phase train): expandable segments keep the blocks that the earlier
    # phases freed from fragmenting what it needs
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    try:
        import torch

        import skix_torch
        from skix_torch.ops import _build
    except ImportError as e:
        fail(f"cannot import the port beside this script: {e}")
    if Path(skix_torch.__file__).resolve().parent.parent != here:
        fail(f"skix_torch was imported from {skix_torch.__file__}, not from "
             f"beside this script")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a card")

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(card, flush=True)
    say("device", kind=json.dumps(kind), count=count, torch=torch.__version__,
        cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    sources = sorted({Path(src).stem for src, _ in KERNELS.values()})
    _build.build(sources)
    for s in sources:
        regs = [ln.strip() for ln in _build.build_log(s).splitlines()
                if "registers" in ln or "spill" in ln]
        say("build", source=s, ptxas=json.dumps(regs).replace(" ", ""))
    say("build", seconds=round(time.perf_counter() - t0, 2))

    # 3. kernels against plain, at the main paths' shapes
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [check_kernel(c, gen) for c in kernel_cases()]
    torch.cuda.empty_cache()
    for c in backward_cases():
        rows += check_backward(c, gen)
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="skix_chip_smoke_") as tmpdir:
        tmp = Path(tmpdir)
        # 4. small-input reference, 5. the VGGT main path, warm, profiled
        reference_phase(tmp)
        vggt_launches, cfg = main_phase(tmp)
        profile_phase(tmp, cfg)
        # 6. the front stage, tiny, card against CPU
        front_reference_phase(tmp)
        # 7. the front main path, warm, profiled
        front_launches, frames = front_phase(tmp)
        front_profile_phase(tmp, frames)
        torch.cuda.empty_cache()
        # 8. one training step, tiny, card against CPU
        train_reference_phase(tmp)
        # 9. the training main path at full size, profiled
        train_run, train_launches = train_phase(tmp)
        train_profile_phase(tmp, train_run)
        del train_run

    # 10. kernels line: per kernel (K1 and K2 per mode) its launches on
    # each main path, and the times of its case at the path's largest
    # shape; every case checked above passed its tolerance
    headline = {"flash_fwd": "vggt_global", "flash_fwd_lse": "memory_tracker",
                "flash_fwd_single_tile": "vitdet_window",
                "flash_fwd_single_tile_lse": "vitdet_window_train",
                "flash_bwd_dkv": "vitdet_global",
                "flash_bwd_dq": "vitdet_global",
                "flash_bwd_single_tile": "vitdet_window"}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        mine = [r for r in rows if r["name"] == name]
        h = next(r for r in mine if r["case"] == headline[name])
        by_path = {"vggt": vggt_launches.get(name, 0),
                   "front": front_launches.get(name, 0),
                   "train": train_launches.get(name, 0)}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": h["ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"], "library_ms": h["library_ms"],
            "case": h["case"], "shape_q": h["shape_q"], "Sk": h["Sk"],
            "dtype": h["dtype"],
            "checks": [{k: r.get(k) for k in (
                "case", "shape_q", "Sk", "dtype", "max_abs_err", "errs",
                "grad_scale", "lse_max_abs_err", "tol", "ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by")} for r in mine]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
