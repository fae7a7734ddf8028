"""Stage CLI: offline re-validation of saved per-video records.

Port of ``skix/pipelines/validate_records.py`` (host code; reference
parity: prepare_dataset/validate_pt.py:224,253): walk a record root,
re-check every file against the pt_info shape contract of the port's
``io/contracts.py``, write ``validation_report.json`` (each record's
problems, an empty list for a good one); ``strict: true`` exits 1 when
any record has a problem.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

from skix_torch.config import cli_main
from skix_torch.io import check_pt_info_shapes, load_pt_info

log = logging.getLogger(__name__)


def validate_one(path: Path) -> list[str]:
    info = load_pt_info(path)
    return check_pt_info_shapes(info, strict=False)


@cli_main("validate_records")
def main(cfg):
    logging.basicConfig(level=logging.INFO)
    root = Path(cfg.paths.pt_root)
    report = {}
    n_ok = 0
    for rec in sorted(list(root.rglob("*.npz")) + list(root.rglob("*.pt"))):
        if rec.name.endswith(".detections.npz"):
            continue
        try:
            errs = validate_one(rec)
        except Exception as e:  # noqa: BLE001
            errs = [f"unreadable: {e}"]
        rel = str(rec.relative_to(root))
        report[rel] = errs
        if errs:
            log.warning("%s: %d problems", rel, len(errs))
        else:
            n_ok += 1
    out = Path(cfg.paths.get("report_path", root / "validation_report.json"))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    n_bad = sum(1 for v in report.values() if v)
    log.info("validated %d records: %d ok, %d with problems",
             len(report), n_ok, n_bad)
    if n_bad and bool(cfg.get("strict", False)):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
