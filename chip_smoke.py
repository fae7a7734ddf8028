"""Chip smoke test of skix_torch on one NVIDIA GPU (an H100 at full size).

    python3 chip_smoke.py

Phases, one line each (the last line is the JSON verdict):

1. device    the card's name and power limit (nvidia-smi);
2. build     every CUDA kernel of the main path, from skix_torch/ops/csrc,
             all nvcc processes started together;
3. kernel    K1 (flash_fwd) against its plain PyTorch version on the card at
             the main path's shapes, with its time (CUDA events), the plain
             version's, F.scaled_dot_product_attention's on the same pre-roped
             inputs (a yardstick only) and the bound of the card;
4. reference the VGGT stage at a small width in float32 on the card (kernel)
             and on the CPU (plain version), same weights, same records;
5. main      run_all's vggt stage at full VGGT-1B width (embed 1024, depth
             24, 16 heads, 518 px, bf16, seeded random weights) on two
             1080p records, launch counts reset just before and read just
             after; then the same run warm, and once under torch.profiler
             (device time by kernel, the device's idle share);
6. kernels   one JSON object per kernel of the path.

Any failed phase exits non-zero and prints no verdict. Without a CUDA
device, or without the skix_torch package beside this file, it exits 1.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12,         # dense tensor-core bf16
                  "float32": 67e12}           # f32 outside the tensor cores
KERNEL_SOURCE = "skix_torch/ops/csrc/flash_fwd.cu"
KERNEL_REPLACES = "skix/ops/attention.py:184"

FULL = dict(vggt_img_size=518, vggt_embed_dim=1024, vggt_depth=24,
            vggt_num_heads=16, vggt_taps=[4, 11, 17, 23])
MAIN_T, MAIN_STRIDE, MAIN_HW = 8, 2, (1080, 1920)
# a two-view rig as pose encodings [t(3), quat(4), fov_h, fov_w]: view 1
# turned 0.3 rad about y and moved one unit along x
RIG_POSES = [[0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 1.0],
             [-1.0, 0.0, 0.1, math.cos(-0.15), 0.0, math.sin(-0.15), 0.0,
              1.0, 1.0]]


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# --------------------------------------------------------------------------
# phase 3: the kernel against its plain version
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


def attention_bound_ms(shape_q, shape_k, dtype_name: str, rope: bool):
    """The least time the card needs: q, k, v read once, o written once
    (+ the f32 rope tables), against 4·B·H·Sq·Sk·D operations (QKᵀ and P·V)
    at the peak rate of the input type; the larger of the two."""
    B, H, Sq, D = shape_q
    Sk = shape_k[2]
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = item * (2 * B * H * Sq * D + 2 * B * H * Sk * D)
    if rope:
        nbytes += 2 * 4 * Sq * D
    ops = 4.0 * B * H * Sq * Sk * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernel(case, gen):
    import torch
    import torch.nn.functional as F

    from skix_torch.ops import attention as A

    shape, dtype, fixed_max, rope, atol = case
    B, H, S, D = shape
    dev = torch.device("cuda")
    q, k, v = (torch.randn(shape, generator=gen, device=dev) for _ in range(3))
    if fixed_max is not None:           # qk-normed, as the aggregator's
        q = F.layer_norm(q, (D,))
        k = F.layer_norm(k, (D,))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    cos = sin = None
    if rope:
        from skix_torch.models.layers import make_grid_positions

        grid = torch.as_tensor(make_grid_positions(37, 37) + 1, device=dev)
        pos = torch.cat([torch.zeros(5, 2, dtype=grid.dtype, device=dev), grid])
        cos, sin = A.rope_2d_tables(pos.repeat(-(-S // len(pos)), 1)[:S],
                                    D, 100.0)
    scale = 1.0 / math.sqrt(D)
    with torch.no_grad():
        out = A.flash_attention(q, k, v, fixed_max=fixed_max, rope_cos=cos,
                                rope_sin=sin)
        torch.cuda.synchronize()
        ref = A.attention_reference(q, k, v, scale, fixed_max, cos, sin)
        err = (out.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        ms = cuda_ms(lambda: A.flash_attention(q, k, v, fixed_max=fixed_max,
                                               rope_cos=cos, rope_sin=sin), 20)
        plain_ms = cuda_ms(lambda: A.attention_reference(
            q, k, v, scale, fixed_max, cos, sin), 5)
        qr = A.apply_rope_tables(q, cos, sin) if rope else q
        kr = A.apply_rope_tables(k, cos, sin) if rope else k
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qr, kr, v, scale=scale), 20)
    dname = str(dtype).split(".")[-1]
    bound, bound_by = attention_bound_ms(shape, shape, dname, rope)
    row = {"shape": list(shape), "dtype": dname, "fixed_max": fixed_max,
           "rope": rope, "max_abs_err": err, "tol": atol, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
           "bound_by": bound_by}
    say("kernel", name="flash_fwd", **{k: v for k, v in row.items()})
    if not finite or out.shape != q.shape or out.dtype != q.dtype:
        fail(f"flash_fwd {shape}: non-finite or misshapen output")
    if not err <= atol:
        fail(f"flash_fwd {shape} {dname}: max |kernel - plain| = {err} > {atol}")
    return row


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


def main() -> int:
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
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
    _build.build(["flash_fwd"])
    regs = [ln.strip() for ln in _build.build_log("flash_fwd").splitlines()
            if "registers" in ln or "spill" in ln]
    say("build", seconds=round(time.perf_counter() - t0, 2),
        ptxas=json.dumps(regs).replace(" ", ""))

    # 3. kernel against plain, at the main path's shapes
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # shape, dtype, fixed_max, rope, tolerance
        ((2, 16, 1374, 64), torch.bfloat16, 12.0, True, 4e-3),   # frame
        ((1, 16, 2748, 64), torch.bfloat16, 12.0, True, 4e-3),   # global
        ((1, 16, 2, 128), torch.bfloat16, None, False, 4e-3),    # camera trunk
        ((2, 3, 100, 64), torch.float32, None, True, 1e-5),      # ragged
    ]
    # bf16 tolerance: the output rounds to bf16 (a step of 2⁻⁸ relative)
    # after f32 sums taken in another order than the plain version's
    rows = [check_kernel(c, gen) for c in cases]

    with tempfile.TemporaryDirectory(prefix="skix_chip_smoke_") as tmpdir:
        tmp = Path(tmpdir)
        # 4. small-input reference
        reference_phase(tmp)
        # 5. main path, then warm and profiled reruns of it
        launches, cfg = main_phase(tmp)
        profile_phase(tmp, cfg)

    # 6. kernels line: times at the main path's largest attention (the
    # global block); every shape checked above passed its tolerance
    g = rows[1]
    kernels = {"kernels": [{
        "name": "flash_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches.get("flash_fwd", 0),
        "max_abs_err": max(r["max_abs_err"] for r in rows), "ms": g["ms"],
        "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": g["library_ms"],
        "shape": g["shape"], "dtype": g["dtype"],
        "checks": [{"shape": r["shape"], "dtype": r["dtype"],
                    "max_abs_err": r["max_abs_err"], "tol": r["tol"]}
                   for r in rows]}]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
