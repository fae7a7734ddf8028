"""Stage CLI: the pipeline orchestrator with per-stage timing.

Port of ``skix/pipelines/run_all.py``. Two stages are ported: ``vggt``,
the VGGT multi-view reconstruction over the pt records, into
``<work_root>/vggt``; ``prepare_front_results``, the SAM3 front path over
the front videos under ``paths.video_root``, into ``<work_root>/front``
(skipped, as in skix, when ``paths.front_root`` is given or the video root
is missing). Beside skix's ``front_checkpoint`` and ``front_prompts`` the
front branch passes ``front_detector``, ``front_detector_checkpoint``,
``front_tracker``, ``front_tracker_checkpoint`` and ``front_clip`` through
to the stage's ``detector``, ``detector_checkpoint``, ``tracker``,
``tracker_checkpoint`` and ``clip`` (skix's branch leaves them at the
stage's defaults), so run_all runs the sam3 configuration with a CLIP
checkpoint. The orchestrator writes ``pipeline_timing.json`` and
``pipeline_summary.json`` into ``work_root`` as skix does. Each stage gets
its config as an in-memory mapping (skix writes it to
``generated_configs/<stage>.yaml`` first), so a run whose own config is a
mapping needs no PyYAML.

A requested stage that is not ported yet raises ``NotImplementedError``
naming it; nothing is skipped silently. ``device`` (default ``cuda``)
selects where the stages run.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

from skix_torch.config import Cfg, cli_main
from skix_torch.utils.profiling import StageTimer

log = logging.getLogger(__name__)

PORTED_STAGES = ("vggt", "prepare_front_results")
DEFAULT_STAGES = ["videopose3d", "triangulation", "bundle_adjustment", "fuse",
                  "angle", "metrics"]


def _plain(node) -> dict:
    """A config node as plain nested dicts (a stage's mapping config)."""
    return node.to_dict() if isinstance(node, Cfg) else dict(node or {})


@cli_main("run_all")
def main(cfg):
    logging.basicConfig(level=logging.INFO)
    work = Path(cfg.paths.work_root)
    pt_root = Path(cfg.paths.pt_root)
    stages = list(cfg.get("stages", DEFAULT_STAGES))
    missing = [s for s in stages if s not in PORTED_STAGES]
    if missing:
        raise NotImplementedError(
            f"run_all stages {missing} are not ported to skix_torch yet "
            f"(ported: {list(PORTED_STAGES)}); run them with skix.pipelines."
            "run_all")
    timer = StageTimer()
    summary = {}

    if "vggt" in stages:
        from skix_torch.pipelines.vggt import main as vggt

        stage_cfg = {
            "paths": {"pt_root": str(pt_root),
                      "out_root": str(work / "vggt")},
            "mode": "multi",
            "img_size": int(cfg.get("vggt_img_size", 518)),
            "embed_dim": int(cfg.get("vggt_embed_dim", 1024)),
            "depth": int(cfg.get("vggt_depth", 24)),
            "num_heads": int(cfg.get("vggt_num_heads", 16)),
            "intermediate_layer_idx":
                list(cfg.get("vggt_taps", [4, 11, 17, 23])),
            "frame_stride": int(cfg.get("vggt_frame_stride", 30)),
            "checkpoint": cfg.get("vggt_checkpoint"),
            "kpt_source": str(cfg.get("kpt_source", "detectron2")),
            "device": str(cfg.get("device", "cuda")),
        }
        with timer.span("vggt"):
            vggt(stage_cfg)
        summary["vggt"] = str(work / "vggt")

    front_root = cfg.paths.get("front_root")
    video_root = cfg.paths.get("video_root")
    if "prepare_front_results" in stages:
        if front_root:
            log.info("front_root provided — prepare_front_results skipped")
        elif not (video_root and Path(video_root).exists()):
            log.warning("prepare_front_results requested but video_root %r "
                        "missing — skipping", video_root)
        else:
            from skix_torch.pipelines.prepare_front_results import main as front

            front_root = work / "front"
            stage_cfg = {
                "paths": {"video_root": str(video_root),
                          "out_root": str(front_root)},
                "checkpoint": cfg.get("front_checkpoint"),
                "prompts": list(cfg.get("front_prompts",
                                        ["person", "snow"])),
                "max_frames": cfg.get("max_frames"),
                "detector": _plain(cfg.get("front_detector")),
                "detector_checkpoint": cfg.get("front_detector_checkpoint"),
                "tracker": _plain(cfg.get("front_tracker")),
                "tracker_checkpoint": cfg.get("front_tracker_checkpoint"),
                "clip": _plain(cfg.get("front_clip")),
                "device": str(cfg.get("device", "cuda")),
            }
            with timer.span("prepare_front_results"):
                front(stage_cfg)
            summary["prepare_front_results"] = str(front_root)

    timer.log_report()
    timer.save(work / "pipeline_timing.json")
    (work / "pipeline_summary.json").write_text(json.dumps(summary, indent=2))
    log.info("pipeline complete: %s", work / "pipeline_summary.json")


if __name__ == "__main__":
    main()
