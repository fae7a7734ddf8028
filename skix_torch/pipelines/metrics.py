"""Stage CLI: evaluation against ground truth / GT-free regression metrics.

Port of ``skix/pipelines/metrics.py``. Per person directory of
``paths.in_root``: jitter, acceleration and bone-length CV of each fused,
smoothed, left and right sequence found; with ``gt_root`` (``<person>.npy``
or Unity jsonl, read by the copy of skix's reader in
``skix_torch.io.unity``) the MPJPE of each against GT and the fusion's
improvement; the smoothing's jitter reduction. Writes
``metrics_report.json``. The metrics run on ``cfg.device`` (default
``cuda``); a person that fails is logged and skipped, as in skix.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch

from skix_torch.config import cli_main, iter_person_dirs
from skix_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


def _load_any(p: Path):
    if p.suffix == ".npy":
        return np.load(p)
    with np.load(p, allow_pickle=False) as z:
        for key in ("fused", "kpts", "X3d", "pred_keypoints_3d"):
            if key in z:
                return np.asarray(z[key])
        return np.asarray(z[list(z.keys())[0]])


def load_gt(path: Path) -> np.ndarray:
    """GT 3D sequence from .npy/.npz or Unity jsonl (reference
    unity_data_compare GT path; jsonl harmonized via skix_torch.io.unity —
    expects a sibling ``*_2d.jsonl`` or duplicates the 3D file for the
    2D slot, which the 3D comparison ignores)."""
    if path.suffix == ".jsonl":
        from skix_torch.io.unity import load_unity_gt_jsonl

        p2 = path.with_name(path.name.replace("3d", "2d"))
        if not p2.exists():
            p2 = path
        _, gt3d, _ = load_unity_gt_jsonl(p2, path)
        return gt3d
    return _load_any(path)


def evaluate_person(person_dir: Path, bones, symmetric_bones, gt_path=None,
                    device=None) -> dict:
    from skix_torch.metrics.evaluation import (before_after_fusion_report,
                                               bone_length_cv,
                                               temporal_metrics)

    device = resolve_device(device)

    def as_f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    seqs = {}
    for name, pat in (("fused", "*_fused.np*"), ("smoothed", "*_smoothed.np*"),
                      ("left", "*left*.np*"), ("right", "*right*.np*")):
        hits = sorted(person_dir.glob(pat))
        if hits:
            seqs[name] = _load_any(hits[0])

    out: dict = {}
    for name, x in seqs.items():
        xj = as_f32(x)
        out[name] = {k: float(v) for k, v in temporal_metrics(xj).items()}
        out[name]["bone_cv"] = float(bone_length_cv(xj, bones))

    if gt_path is not None and Path(gt_path).exists():
        gt = load_gt(Path(gt_path))
        T = min(len(gt), *(len(s) for s in seqs.values())) if seqs else 0
        if T:
            rep = before_after_fusion_report(
                as_f32(gt[:T]),
                left=as_f32(seqs["left"][:T]) if "left" in seqs else None,
                right=as_f32(seqs["right"][:T]) if "right" in seqs else None,
                fused=as_f32(seqs["fused"][:T]) if "fused" in seqs else None,
                smoothed=as_f32(seqs["smoothed"][:T]) if "smoothed" in seqs else None,
            )
            out["vs_gt"] = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                            for k, v in rep.items()}
    # smoothing must reduce jitter (the reference's headline claim:
    # −30% jitter after EMA, doc/process_documentation.md:203)
    if "fused" in out and "smoothed" in out:
        jf, js = out["fused"]["jitter"], out["smoothed"]["jitter"]
        out["jitter_reduction_pct"] = 100.0 * (jf - js) / (jf + 1e-9)
    return out


@cli_main("metrics")
def main(cfg):
    logging.basicConfig(level=logging.INFO)
    from skix_torch.geometry.skeletons import (MHR70_BODY_EDGES,
                                               MHR70_SYMMETRIC_BONES)

    device = resolve_device(cfg.get("device"))

    root = Path(cfg.paths.in_root)
    out_root = Path(cfg.paths.out_root)
    gt_root = cfg.get("gt_root")
    results = {}
    for person_dir in iter_person_dirs(root, cfg):
        gt_path = None
        if gt_root:
            for cand in (f"{person_dir.name}.npy",
                         f"{person_dir.name}_3d.jsonl",
                         f"{person_dir.name}.jsonl"):
                p = Path(gt_root) / cand
                if p.exists():
                    gt_path = p
                    break
        try:
            results[person_dir.name] = evaluate_person(
                person_dir, MHR70_BODY_EDGES, MHR70_SYMMETRIC_BONES, gt_path,
                device)
        except Exception:  # noqa: BLE001 — per-person isolation, as in skix
            log.exception("person %s failed", person_dir.name)
    out_root.mkdir(parents=True, exist_ok=True)
    (out_root / "metrics_report.json").write_text(json.dumps(results, indent=2))
    log.info("wrote metrics for %d persons", len(results))


if __name__ == "__main__":
    main()
