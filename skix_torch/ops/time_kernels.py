"""Time K1–K5 at the main paths' shapes (the memory tracker's K1-lse, the
interleaved, rotate-half and rope-free rows of the forward and the
backward), in the ``skix_torch`` of any checkout, to compare two commits
on one card.

    python3 skix_torch/ops/time_kernels.py --tree DIR --out FILE [--reps N]
    python3 skix_torch/ops/time_kernels.py --compare A1 B1 B2 A2

The first form imports ``skix_torch`` from the checkout DIR (any commit
that has K3–K5 and the interleaved rope), builds its four kernel sources
there and writes one JSON
object, case → CUDA-event median in ms, to FILE. It launches the kernels
through the private ``_launch``/``_launch_backward`` of DIR's
``ops/attention.py``, whose positional arguments every such commit shares,
so both commits time the same launches. Run it on two checkouts in the
order A, B, B, A in one machine session: only times from one session
compare (clocks and power limits differ between cards and runs). The
second form prints, per case, the mean of the two A runs, the mean of the
two B runs, B − A in per cent, and each side's spread between its runs.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

# (name, (B, H, Sq, D), Sk, dtype, fixed max, rope style, kernels); the
# tracker's q is one row shared by the batch (stride 0), pre-scaled by 1/8
TRACKER = "k1_lse_memory_tracker"
CASES = (
    (TRACKER, (16, 1, 15876, 64), 63504, "f32", None, None, "fwd_lse"),
    ("k1_vitdet_global_i", (1, 16, 5184, 64), 5184, "f32", None,
     "interleaved", "fwd"),
    ("k1_lse_vitdet_global_i", (4, 16, 5184, 64), 5184, "f32", None,
     "interleaved", "fwd_lse"),
    ("k2_windows_i", (9, 16, 576, 64), 576, "f32", None, "interleaved",
     "single"),
    ("k2_lse_windows_i", (36, 16, 576, 64), 576, "f32", None, "interleaved",
     "single_lse"),
    ("k1_vggt_frame_h", (2, 16, 1374, 64), 1374, "bf16", 12.0, "half", "fwd"),
    ("k1_vggt_global_h", (1, 16, 2748, 64), 2748, "bf16", 12.0, "half",
     "fwd"),
    ("k1_camera_trunk", (1, 16, 2, 128), 2, "bf16", None, None, "fwd"),
    ("k1_vitdet_global_h", (1, 16, 5184, 64), 5184, "f32", None, "half",
     "fwd"),
    ("k1_fusion", (1, 8, 5184, 32), 5184, "f32", None, None, "fwd"),
    ("k1_lse_vitdet_global_h", (4, 16, 5184, 64), 5184, "f32", None, "half",
     "fwd_lse"),
    ("k1_lse_fusion", (4, 8, 5184, 32), 5184, "f32", None, None, "fwd_lse"),
    ("k2_windows_h", (9, 16, 576, 64), 576, "f32", None, "half", "single"),
    ("k2_lse_windows_h", (36, 16, 576, 64), 576, "f32", None, "half",
     "single_lse"),
    ("k3_vitdet_global_h", (4, 16, 5184, 64), 5184, "f32", None, "half",
     "dkv"),
    ("k4_vitdet_global_h", (4, 16, 5184, 64), 5184, "f32", None, "half",
     "dq"),
    ("k5_windows_h", (36, 16, 576, 64), 576, "f32", None, "half",
     "bwd_single"),
    ("k3_fusion", (4, 8, 5184, 32), 5184, "f32", None, None, "dkv"),
    ("k4_fusion", (4, 8, 5184, 32), 5184, "f32", None, None, "dq"),
    ("k3_vitdet_global_i", (4, 16, 5184, 64), 5184, "f32", None,
     "interleaved", "dkv"),
    ("k4_vitdet_global_i", (4, 16, 5184, 64), 5184, "f32", None,
     "interleaved", "dq"),
    ("k5_windows_i", (36, 16, 576, 64), 576, "f32", None, "interleaved",
     "bwd_single"),
)


def _cuda_ms(fn, reps: int) -> float:
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


def time_tree(tree: str, reps: int) -> dict:
    sys.path.insert(0, tree)
    import torch

    from skix_torch.ops import _build
    from skix_torch.ops import attention as A

    if not Path(A.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"imported {A.__file__}, not from {tree}")
    _build.build(A.KERNEL_SOURCES)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, (B, H, S, D), Sk, dt, fixed, rope, kind in CASES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32

        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        k, v = rand(B, H, Sk, D), rand(B, H, Sk, D)
        if name == TRACKER:
            q = (rand(1, H, S, D) * 0.125).expand(B, H, S, D)
        else:
            q = rand(B, H, S, D)
        do = rand(B, H, S, D)
        cos = sin = None
        if rope:
            ang = torch.rand((S, D // 2), generator=gen, device="cuda") * 6.3
            if rope == "half":
                cos = torch.cat([ang.cos(), ang.cos()], -1)
                sin = torch.cat([ang.sin(), ang.sin()], -1)
            else:
                cos, sin = A.interleaved_rope_tables(ang)
        scale = 1.0 if name == TRACKER else D ** -0.5
        style = rope or "half"
        single = kind in ("single", "single_lse", "bwd_single")
        fwd = "flash_fwd_single_tile" if single else "flash_fwd"
        if kind in ("fwd", "fwd_lse", "single", "single_lse"):
            lse = kind.endswith("_lse")

            def fn():
                A._launch(fwd, q, k, v, scale, fixed, cos, sin, lse, style)
        else:
            _, lse = A._launch(fwd, q, k, v, scale, fixed, cos, sin, True,
                               style)
            di = torch.randn((B, H, S), generator=gen, device="cuda")
            kernels = {"dkv": ("flash_bwd_dkv",), "dq": ("flash_bwd_dq",),
                       "bwd_single": ("flash_bwd_single_tile",)}[kind]

            def fn():
                A._launch_backward(kernels, q, k, v, do, lse, di, scale, cos,
                                   sin, style)
        out[name] = _cuda_ms(fn, 5 if name == TRACKER else reps)
        print(f"[time_kernels] {name} {out[name]:.4f} ms", flush=True)
    return out


def compare(a1: dict, b1: dict, b2: dict, a2: dict) -> None:
    print(f"{'case':26s} {'A ms':>9s} {'B ms':>9s} {'B-A %':>7s} "
          f"{'A spread %':>10s} {'B spread %':>10s}")
    for name in a1:
        a, b = (a1[name] + a2[name]) / 2, (b1[name] + b2[name]) / 2
        print(f"{name:26s} {a:9.4f} {b:9.4f} {100 * (b - a) / a:7.2f} "
              f"{100 * abs(a1[name] - a2[name]) / a:10.2f} "
              f"{100 * abs(b1[name] - b2[name]) / b:10.2f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree")
    ap.add_argument("--out")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--compare", nargs=4, metavar="JSON")
    args = ap.parse_args(argv)
    if args.compare:
        compare(*(json.load(open(p)) for p in args.compare))
        return 0
    if not (args.tree and args.out):
        ap.error("--tree and --out, or --compare")
    res = time_tree(args.tree, args.reps)
    with open(args.out, "w") as f:
        json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
