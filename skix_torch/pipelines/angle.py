"""Stage CLI: joint-angle biomechanics + turn reports.

Port of ``skix/pipelines/angle.py``. For every ``*_smoothed.npy`` under
``paths.fused_root``: the angle, tilt, torso–knee, knee-difference, elbow
and heading series (on ``cfg.device``, default ``cuda``) → ``angles.csv``,
the detected turns → ``turns.csv``, the largest frame-to-frame changes →
``changes.json``, with ``compare_prefusion`` the before/after-fusion
comparisons against the ``*_fused.npy`` twin, with ``plots`` a PNG per
series (skipped when matplotlib is absent, as in skix); and
``angle_summary.json``. A person that fails is logged and skipped.
"""

from __future__ import annotations

import csv
import json
import logging
from pathlib import Path

import numpy as np
import torch

from skix_torch.config import cli_main
from skix_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


def save_series_csv(path: Path, series: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    keys = list(series.keys())
    T = len(next(iter(series.values())))
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["frame", *keys])
        for t in range(T):
            w.writerow([t, *[f"{series[k][t]:.4f}" if np.isfinite(series[k][t])
                             else "" for k in keys]])


def save_turns_csv(path: Path, turns: list, series: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    metric_keys = [k for k in series if k != "heading_deg"]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["turn_id", "start_frame", "end_frame", "num_frames",
                    "heading_change_deg", "direction",
                    *[f"mean_{k}" for k in metric_keys]])
        for t in turns:
            s, e = int(t["start_frame"]), int(t["end_frame"])
            means = []
            for k in metric_keys:
                seg = series[k][s:e + 1]
                seg = seg[np.isfinite(seg)]
                means.append(f"{seg.mean():.4f}" if len(seg) else "")
            w.writerow([int(t["turn_id"]), s, e, int(t["num_frames"]),
                        f"{t['heading_change_deg']:.2f}",
                        int(t["direction"]), *means])


def save_change_report(path: Path, series: dict, top_k: int = 10) -> None:
    """Largest frame-to-frame metric changes (reference
    save_fullframe_change_reports :564)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    for k, v in series.items():
        d = np.abs(np.diff(v))
        d = np.where(np.isfinite(d), d, -np.inf)
        order = np.argsort(d)[::-1][:top_k]
        for i in order:
            if np.isfinite(d[i]):
                rows.append({"metric": k, "frame": int(i + 1),
                             "delta": float(d[i])})
    path.write_text(json.dumps(rows, indent=2))


def maybe_plot(out_dir: Path, series: dict) -> None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # pragma: no cover - headless fallback
        return
    for k, v in series.items():
        fig, ax = plt.subplots(figsize=(10, 3))
        ax.plot(v)
        ax.set_title(k)
        ax.set_xlabel("frame")
        fig.tight_layout()
        fig.savefig(out_dir / f"{k}.png", dpi=80)
        plt.close(fig)


def _series(npy_path: Path, up_axis, device):
    from skix_torch.angle.biomech import compute_all_series

    kpts = torch.as_tensor(np.load(npy_path).astype(np.float32),
                           device=resolve_device(device))
    return kpts.shape[0], *compute_all_series(kpts, up_axis=tuple(up_axis))


def process_npy(npy_path: Path, out_dir: Path, up_axis, make_plots: bool,
                compare_with: Path | None = None, device=None) -> dict:
    frames, series, turns = _series(npy_path, up_axis, device)
    out_dir.mkdir(parents=True, exist_ok=True)
    save_series_csv(out_dir / "angles.csv", series)
    save_turns_csv(out_dir / "turns.csv", turns, series)
    save_change_report(out_dir / "changes.json", series)
    if make_plots:
        maybe_plot(out_dir, series)
    summary = {"num_turns": len(turns),
               "frames": int(frames),
               "mean_abs_heading_change": float(np.mean(
                   [abs(t["heading_change_deg"]) for t in turns])) if turns else 0.0}
    if compare_with is not None and compare_with.exists():
        _, pre_series, _ = _series(compare_with, up_axis, device)
        comparison = {}
        for k in series:
            a, b = pre_series[k], series[k]
            ok = np.isfinite(a) & np.isfinite(b)
            if ok.any():
                comparison[k] = float(np.mean(np.abs(a[ok] - b[ok])))
        (out_dir / "before_after_comparison.json").write_text(
            json.dumps(comparison, indent=2))
        # turn-wise before/after comparison (reference
        # save_turn_comparison_report :580): per detected turn, mean metric
        # deltas between the pre-fusion and smoothed series
        turn_rows = []
        for t in turns:
            s, e = int(t["start_frame"]), int(t["end_frame"])
            row = {"turn_id": int(t["turn_id"]), "start": s, "end": e}
            for k in series:
                a = pre_series[k][s:e + 1]
                b = series[k][s:e + 1]
                ok = np.isfinite(a) & np.isfinite(b)
                if ok.any():
                    row[f"delta_{k}"] = float(np.mean(b[ok] - a[ok]))
            turn_rows.append(row)
        (out_dir / "turn_comparison.json").write_text(
            json.dumps(turn_rows, indent=2))
        summary["compared_with"] = str(compare_with)
    return summary


@cli_main("angle")
def main(cfg):
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(cfg.get("device"))
    root = Path(cfg.paths.fused_root)
    out_root = Path(cfg.paths.out_root)
    up_axis = cfg.get("up_axis", [0.0, 1.0, 0.0])
    make_plots = bool(cfg.get("plots", True))
    summaries = {}
    for npy in sorted(root.rglob("*_smoothed.npy")):
        person = npy.parent.name
        fused_twin = npy.with_name(npy.name.replace("_smoothed", "_fused"))
        try:
            summaries[person] = process_npy(
                npy, out_root / person, up_axis, make_plots,
                compare_with=fused_twin if bool(cfg.get("compare_prefusion", True)) else None,
                device=device)
        except Exception:  # noqa: BLE001 — per-person isolation, as in skix
            log.exception("person %s failed", person)
    out_root.mkdir(parents=True, exist_ok=True)
    (out_root / "angle_summary.json").write_text(json.dumps(summaries, indent=2))
    log.info("done: %d persons", len(summaries))


if __name__ == "__main__":
    main()
