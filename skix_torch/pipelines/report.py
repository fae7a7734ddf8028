"""Stage CLI: exploratory artifact reports (the reference's ``analysis/``
notebooks as a reproducible stage). Port of ``skix/pipelines/report.py``.

The reference ships 12 ad-hoc notebooks (``analysis/*.ipynb`` — e.g.
``npz.ipynb``/``sam3d_body.ipynb``/``vggt.ipynb`` dump artifact schemas
and shapes, ``videopose3d.ipynb``/``vis.ipynb`` plot 3D skeleton frames,
``unity_sam3d_vs_GT.ipynb`` compares stage outputs against Unity GT,
``calibration.ipynb`` prints the calibration npz). This stage does the
same inspections headlessly and writes them down:

- **schema**: every ``.npz``/``.npy`` under the input root → key, shape,
  dtype, finite fraction, value range (the ``npz.ipynb`` loop);
- **pose summaries**: arrays recognisable as ``(T, J, 3)`` pose
  sequences (J ∈ {17, 70}) get GT-free regression metrics — temporal
  jitter/acceleration, bone-length CV, symmetry error
  (the port's ``metrics/evaluation.py`` on ``cfg.device``, default
  ``cuda``; reference true_data_compare.py);
- **GT comparison**: with ``unity_gt:`` set, MPJPE vs the Unity jsonl
  GT like ``unity_sam3d_vs_GT.ipynb`` (read by the port's
  ``pipelines/metrics.load_gt``);
- **plots** (``plot: true``): first/middle/last 3D skeleton frames per
  pose artifact via :class:`skix_torch.vis.skeleton.SkeletonVisualizer`
  (matplotlib on the host).

Outputs ``report.md`` (human) + ``report.json`` (machine) under
``paths.out_root``. Schema dumps, plots and files are host code; an
artifact that fails is recorded under ``error`` and skipped (as skix does).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch

from skix_torch.config import cli_main
from skix_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

_POSE_JOINTS = {17: "h36m", 70: "mhr70"}  # SkeletonVisualizer layouts


def _describe_array(a: np.ndarray) -> dict:
    d = {"shape": list(a.shape), "dtype": str(a.dtype)}
    if a.size and np.issubdtype(a.dtype, np.number):
        af = a.astype(np.float64, copy=False)
        finite = np.isfinite(af)
        d["finite_frac"] = float(finite.mean())
        if finite.any():
            d["min"] = float(af[finite].min())
            d["max"] = float(af[finite].max())
    return d


def describe_artifact(path: Path) -> dict:
    """Schema dump of one ``.npz``/``.npy`` (the ``npz.ipynb`` loop:
    ``for k, v in outputs.items(): print(k, v.shape)``)."""
    if path.suffix == ".npy":
        return {"__array__": _describe_array(np.load(path))}
    out = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            try:
                out[key] = _describe_array(np.asarray(z[key]))
            except Exception as e:  # noqa: BLE001 — non-numeric entries
                out[key] = {"error": f"{type(e).__name__}: {e}"}
    return out


def _pose_sequences(path: Path):
    """Yield (name, (T, J, 3) array) for pose-shaped entries."""
    def check(name, a):
        if (a.ndim == 3 and a.shape[-1] == 3
                and a.shape[1] in _POSE_JOINTS and a.shape[0] >= 2
                and np.issubdtype(a.dtype, np.floating)):
            return [(name, a)]
        return []

    if path.suffix == ".npy":
        return check("__array__", np.load(path))
    found = []
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            try:
                found += check(key, np.asarray(z[key]))
            except Exception:  # noqa: BLE001
                continue
    return found


def pose_summary(x: np.ndarray, device=None) -> dict:
    """GT-free regression metrics for one (T, J, 3) sequence
    (reference true_data_compare.py: jitter, accel, bone-length CV,
    symmetry), in float32 on ``device`` (default ``cuda``)."""
    from skix_torch.geometry.skeletons import (H36M_BONES,
                                               H36M_SYMMETRIC_BONES,
                                               MHR70_BODY_EDGES,
                                               MHR70_SYMMETRIC_BONES)
    from skix_torch.metrics.evaluation import (bone_length_cv,
                                               symmetry_error,
                                               temporal_metrics)

    layout = _POSE_JOINTS[x.shape[1]]
    bones = H36M_BONES if layout == "h36m" else MHR70_BODY_EDGES
    sym = (H36M_SYMMETRIC_BONES if layout == "h36m"
           else MHR70_SYMMETRIC_BONES)
    xj = torch.as_tensor(x, dtype=torch.float32,
                         device=resolve_device(device))
    out = {"layout": layout, "frames": int(x.shape[0])}
    out.update({k: float(v) for k, v in temporal_metrics(xj).items()})
    out["bone_cv"] = float(bone_length_cv(xj, bones))
    out["symmetry_error"] = float(symmetry_error(xj, sym))
    return out


def _plot_pose(x: np.ndarray, out_dir: Path, stem: str) -> list[str]:
    """First/middle/last 3D skeleton frames (videopose3d.ipynb /
    vis.ipynb plots, headless)."""
    from skix_torch.vis.skeleton import SkeletonVisualizer

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    viz = SkeletonVisualizer(layout=_POSE_JOINTS[x.shape[1]])
    written = []
    T = x.shape[0]
    for t in sorted({0, T // 2, T - 1}):
        img = viz.plot_3d_frame(x[t], title=f"{stem} frame {t}")
        p = out_dir / f"{stem}_frame{t:05d}.png"
        plt.imsave(p, img)
        written.append(p.name)
    return written


def _gt_mpjpe(x: np.ndarray, gt: np.ndarray) -> dict:
    """MPJPE vs GT on the overlapping frame range after root-centering
    (unity_sam3d_vs_GT.ipynb comparison; both sequences must share a
    joint layout)."""
    if gt.shape[1] != x.shape[1]:
        return {"skipped": f"joint mismatch gt={gt.shape[1]} "
                           f"pred={x.shape[1]}"}
    T = min(len(x), len(gt))
    a = x[:T] - x[:T, :1]
    b = gt[:T] - gt[:T, :1]
    return {"frames": T,
            "mpjpe_root_centered": float(
                np.linalg.norm(a - b, axis=-1).mean())}


def render_report(results: dict, out_path: Path) -> None:
    lines = ["# skix artifact report", ""]
    for name, r in results.items():
        lines.append(f"## {name}")
        lines.append("")
        lines.append("| key | shape | dtype | finite | range |")
        lines.append("|---|---|---|---|---|")
        for key, d in r.get("schema", {}).items():
            if "error" in d:
                lines.append(f"| {key} | — | — | — | {d['error']} |")
                continue
            rng = (f"[{d.get('min', float('nan')):.4g}, "
                   f"{d.get('max', float('nan')):.4g}]"
                   if "min" in d else "—")
            lines.append(
                f"| {key} | {tuple(d['shape'])} | {d['dtype']} | "
                f"{d.get('finite_frac', float('nan')):.3f} | {rng} |")
        for key, s in r.get("pose", {}).items():
            lines.append("")
            lines.append(f"**pose `{key}`** ({s['layout']}, "
                         f"{s['frames']} frames): " + ", ".join(
                             f"{k}={v:.5g}" for k, v in s.items()
                             if isinstance(v, float)))
        if "gt" in r:
            lines.append("")
            lines.append(f"**vs GT**: {json.dumps(r['gt'])}")
        if r.get("plots"):
            lines.append("")
            lines.append("plots: " + ", ".join(r["plots"]))
        lines.append("")
    out_path.write_text("\n".join(lines))


@cli_main("report")
def main(cfg):
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(cfg.get("device"))
    in_root = Path(cfg.paths.in_root)
    out_root = Path(cfg.paths.out_root)
    out_root.mkdir(parents=True, exist_ok=True)
    patterns = list(cfg.get("patterns", ["**/*.npz", "**/*.npy"]))
    limit = int(cfg.get("max_artifacts", 64))
    gt = None
    gt_path = cfg.get("unity_gt")
    if gt_path and Path(gt_path).exists():
        from skix_torch.pipelines.metrics import load_gt

        gt = np.asarray(load_gt(Path(gt_path)))
    files: list[Path] = []
    for pat in patterns:
        files += sorted(in_root.glob(pat))
    files = [f for f in dict.fromkeys(files) if f.is_file()][:limit]
    if not files:
        log.warning("no artifacts under %s", in_root)
    results = {}
    for f in files:
        name = str(f.relative_to(in_root))
        r: dict = {}
        try:
            r["schema"] = describe_artifact(f)
            poses = _pose_sequences(f)
            if poses:
                r["pose"] = {k: pose_summary(x, device) for k, x in poses}
                if gt is not None:
                    r["gt"] = _gt_mpjpe(poses[0][1], gt)
                if bool(cfg.get("plot", False)):
                    r["plots"] = _plot_pose(
                        poses[0][1], out_root,
                        name.replace("/", "_").rsplit(".", 1)[0])
        except Exception as e:  # noqa: BLE001 — per-artifact isolation
            r["error"] = f"{type(e).__name__}: {e}"
            log.warning("%s: %s", name, r["error"])
        results[name] = r
    (out_root / "report.json").write_text(json.dumps(results, indent=1))
    render_report(results, out_root / "report.md")
    log.info("report over %d artifacts → %s", len(results),
             out_root / "report.md")
    return results


if __name__ == "__main__":
    main()
