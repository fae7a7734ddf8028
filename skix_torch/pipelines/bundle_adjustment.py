"""Stage CLI: bundle adjustment over a clip.

Port of ``skix/pipelines/bundle_adjustment.py``. Every npz under
``paths.in_root`` that holds ``X3d (T,J,3)``, ``R (C,3,3)``, ``t (C,3)``,
``K (3,3)|(C,3,3)``, ``x2d (T,C,J,2)`` (and optionally ``conf (T,C,J)``)
is refined by ``skix_torch.solvers.bundle_adjust`` (``method`` lm or
adam) into ``<out_root>/<parent>/<stem>_refined.npz`` with a loss
breakdown ``<stem>_ba_report.json``; ``ba_summary.json`` covers every
bundle. A bundle that fails is logged and skipped, as in skix. The solve
runs on ``cfg.device`` (default ``cuda``), in float32 as skix (JAX's x64
off) does; ``solve_ms`` ends with the host read of the result.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from skix_torch.config import cli_main
from skix_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


def refine_person(npz_path: Path, out_dir: Path, cfg, device=None) -> dict:
    from skix_torch.solvers import BAConfig, bundle_adjust

    device = resolve_device(device)
    with np.load(npz_path, allow_pickle=False) as z:
        data = {k: torch.as_tensor(np.asarray(z[k], np.float32), device=device)
                for k in z.files}
    ba_cfg = BAConfig(
        w_reproj=float(cfg.weights.reproj),
        w_cam_smooth=float(cfg.weights.cam_smooth),
        w_baseline=float(cfg.weights.baseline),
        w_bone=float(cfg.weights.bone),
        w_temporal=float(cfg.weights.temporal),
        mode=str(cfg.mode),
        method=str(cfg.method),
        max_steps=int(cfg.lm.max_steps),
        cg_iters=int(cfg.lm.cg_iters),
        adam_iters=int(cfg.adam.iters),
        adam_lr=float(cfg.adam.lr),
    )
    t0 = time.perf_counter()
    res = bundle_adjust(data["X3d"], data["R"], data["t"], data["K"],
                        data["x2d"], data.get("conf"), cfg=ba_cfg)
    X = res.X.cpu().numpy()
    dt_ms = (time.perf_counter() - t0) * 1e3

    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / f"{npz_path.stem}_refined.npz",
             X3d=X, R=res.R.cpu().numpy(), t=res.t.cpu().numpy())
    report = {
        "solve_ms": round(dt_ms, 2),
        "iterations": int(res.iterations),
        "initial_cost": float(res.initial_cost),
        "final_cost": float(res.final_cost),
        **{k: float(v) for k, v in res.losses.items()},
    }
    (out_dir / f"{npz_path.stem}_ba_report.json").write_text(
        json.dumps(report, indent=2))
    return report


@cli_main("bundle_adjustment")
def main(cfg):
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(cfg.get("device"))
    root = Path(cfg.paths.in_root)
    out_root = Path(cfg.paths.out_root)
    required = {"X3d", "R", "t", "K", "x2d"}
    reports = {}
    for npz in sorted(root.rglob("*.npz")):
        with np.load(npz, allow_pickle=False) as z:
            if not required <= set(z.keys()):
                continue  # not a BA input bundle (pose logs etc.)
        try:
            reports[npz.stem] = refine_person(npz, out_root / npz.parent.name,
                                              cfg, device)
            log.info("%s: %.1f ms, cost %.4g → %.4g", npz.stem,
                     reports[npz.stem]["solve_ms"],
                     reports[npz.stem]["initial_cost"],
                     reports[npz.stem]["final_cost"])
        except Exception:  # noqa: BLE001 — per-bundle isolation, as in skix
            log.exception("%s failed", npz)
    out_root.mkdir(parents=True, exist_ok=True)
    (out_root / "ba_summary.json").write_text(json.dumps(reports, indent=2))


if __name__ == "__main__":
    main()
