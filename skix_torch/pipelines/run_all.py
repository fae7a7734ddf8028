"""Stage CLI: the pipeline orchestrator with per-stage timing.

Port of ``skix/pipelines/run_all.py``. Its stages, run in skix's order
over one dataset root, each into the directory skix uses under
``work_root`` (``prepare_dataset`` into ``paths.pt_root``): ``videopose3d`` (``videopose3d/``), ``triangulation``
(``joints_3d/``), ``vggt`` (``vggt/``), ``bundle_adjustment`` (``ba/``,
skipped with a warning when ``joints_3d`` does not exist),
``sam3d_body`` (``sam3d/``, run only when ``paths.sam3d_root`` is unset,
as in skix: it passes skix's ``sam3d_checkpoint``, ``sam3d_crop_size``,
``sam3d_embed_dim``, ``sam3d_depth``, ``sam3d_batch_size`` and
``sam3d_inference_type``, default ``full``), ``fuse`` (``fused/``, from
``paths.sam3d_root`` or the sam3d stage's output; skipped with a warning
when it is missing), ``prepare_front_results`` (``front/``, skipped, as in
skix, when ``paths.front_root`` is given or the video root is missing),
``front_side`` (``front_side/``, skipped when the front or side inputs
are missing), ``angle`` and ``metrics`` (``angle/``, ``metrics/``, skipped
when ``fused/`` does not exist). The default stages are skix's:
videopose3d, triangulation, bundle_adjustment, fuse, angle, metrics.
Beside skix's ``front_checkpoint`` and ``front_prompts`` the front branch
passes ``front_detector``, ``front_detector_checkpoint``,
``front_tracker``, ``front_tracker_checkpoint`` and ``front_clip``
through to the stage's ``detector``, ``detector_checkpoint``,
``tracker``, ``tracker_checkpoint`` and ``clip`` (skix's branch leaves
them at the stage's defaults), so run_all runs the sam3 configuration
with a CLIP checkpoint. The orchestrator writes ``pipeline_timing.json``
and ``pipeline_summary.json`` into ``work_root`` as skix does; each span
ends with ``torch.cuda.synchronize()`` on the card. Each stage gets its
config as an in-memory mapping (skix writes it to
``generated_configs/<stage>.yaml`` first), so a run whose own config is a
mapping needs no PyYAML.

``prepare_dataset`` runs first when requested, as in skix: videos from
``paths.video_root`` (required) into ``paths.pt_root`` with skix's keys
``backend`` (default ``precomputed``) and ``store_frames``; every other
key of the stage keeps the stage's default (skix passes no others).

Every run_all stage of skix is ported; a stage name run_all does not know
raises ``ValueError`` naming it (nothing is skipped silently). ``device``
(default ``cuda``) selects where the stages run.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

from skix_torch.config import Cfg, cli_main
from skix_torch.utils.device import resolve_device
from skix_torch.utils.profiling import StageTimer

log = logging.getLogger(__name__)

PORTED_STAGES = ("prepare_dataset", "videopose3d", "triangulation", "vggt",
                 "bundle_adjustment", "sam3d_body", "fuse",
                 "prepare_front_results", "front_side", "angle", "metrics")
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
    unknown = [s for s in stages if s not in PORTED_STAGES]
    if unknown:
        raise ValueError(f"unknown run_all stages {unknown} (stages: "
                         f"{list(PORTED_STAGES)})")
    device = str(cfg.get("device", "cuda"))
    sync = resolve_device(device).type == "cuda"
    timer = StageTimer()
    summary = {}

    if "prepare_dataset" in stages:
        from skix_torch.pipelines.prepare_dataset import main as prep

        video_root = cfg.paths.get("video_root")
        if not video_root:
            # the shipped default is null — str(None) would scan './None'
            raise ValueError("run_all with the prepare_dataset stage needs "
                             "paths.video_root set")
        with timer.span("prepare_dataset", sync):
            prep({"paths": {"video_root": str(video_root),
                            "out_root": str(pt_root)},
                  "backend": str(cfg.get("backend", "precomputed")),
                  "store_frames": bool(cfg.get("store_frames", False)),
                  "device": device})

    if "videopose3d" in stages:
        from skix_torch.pipelines.videopose3d import main as vp3d

        with timer.span("videopose3d", sync):
            vp3d({
                "paths": {"pt_root": str(pt_root),
                          "out_root": str(work / "videopose3d")},
                "checkpoint": cfg.get("lifter_checkpoint"),
                "filter_widths": list(cfg.get("filter_widths", [3, 3, 3])),
                "channels": int(cfg.get("channels", 128)),
                "kpt_source": str(cfg.get("kpt_source", "detectron2")),
                "device": device,
            })
        summary["videopose3d"] = str(work / "videopose3d")

    if "triangulation" in stages:
        from skix_torch.pipelines.triangulation import main as tri

        with timer.span("triangulation", sync):
            tri({
                "paths": {"pt_root": str(pt_root),
                          "out_root": str(work / "joints_3d")},
                "kpt_source": str(cfg.get("kpt_source", "detectron2")),
                "baseline_m": float(cfg.get("baseline_m", 20.0)),
                "methods": list(cfg.get("tri_methods", ["kpt"])),
                "dist": None,
                "single_view": bool(cfg.get("single_view", False)),
                "device": device,
            })
        summary["triangulation"] = str(work / "joints_3d")

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
            "device": device,
        }
        with timer.span("vggt", sync):
            vggt(stage_cfg)
        summary["vggt"] = str(work / "vggt")

    if "bundle_adjustment" in stages and not (work / "joints_3d").exists():
        log.warning("bundle_adjustment requested but %s does not exist "
                    "(run the triangulation stage first) — skipping",
                    work / "joints_3d")
    if "bundle_adjustment" in stages and (work / "joints_3d").exists():
        from skix_torch.pipelines.bundle_adjustment import main as ba

        with timer.span("bundle_adjustment", sync):
            ba({
                "paths": {"in_root": str(work / "joints_3d"),
                          "out_root": str(work / "ba")},
                "weights": {"reproj": 1.0, "cam_smooth": 0.1,
                            "baseline": 0.01, "bone": 0.1, "temporal": 0.1},
                "mode": str(cfg.get("ba_mode", "pose_only")),
                "method": str(cfg.get("ba_method", "lm")),
                "lm": {"max_steps": int(cfg.get("ba_max_steps", 30)),
                       "cg_iters": int(cfg.get("ba_cg_iters", 20))},
                "adam": {"iters": 200, "lr": 0.01},
                "device": device,
            })
        summary["bundle_adjustment"] = str(work / "ba")

    sam3d_root = cfg.paths.get("sam3d_root")
    if "sam3d_body" in stages and not sam3d_root:
        from skix_torch.pipelines.prepare_side_results import main as sam3d

        sam3d_root = work / "sam3d"
        with timer.span("sam3d_body", sync):
            sam3d({
                "paths": {"pt_root": str(pt_root),
                          "out_root": str(sam3d_root)},
                "checkpoint": cfg.get("sam3d_checkpoint"),
                "crop_size": int(cfg.get("sam3d_crop_size", 256)),
                "embed_dim": int(cfg.get("sam3d_embed_dim", 384)),
                "vit_depth": int(cfg.get("sam3d_depth", 8)),
                "batch_size": int(cfg.get("sam3d_batch_size", 8)),
                "inference_type": str(cfg.get("sam3d_inference_type",
                                              "full")),
                "device": device,
            })
        summary["sam3d_body"] = str(sam3d_root)

    fused_root = work / "fused"
    if "fuse" in stages:
        if sam3d_root and Path(sam3d_root).exists():
            from skix_torch.pipelines.fuse import main as fuse

            with timer.span("fuse", sync):
                fuse({"paths": {"in_root": str(sam3d_root),
                                "out_root": str(fused_root)},
                      "device": device})
            summary["fuse"] = str(fused_root)
        else:
            log.warning("fuse requested but sam3d_root %r missing — "
                        "skipping", sam3d_root)

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
                "device": device,
            }
            with timer.span("prepare_front_results", sync):
                front(stage_cfg)
            summary["prepare_front_results"] = str(front_root)

    if "front_side" in stages:
        ok_front = front_root and Path(front_root).exists()
        ok_side = sam3d_root and Path(sam3d_root).exists()
        if not (ok_front and ok_side):
            log.warning("front_side requested but inputs missing "
                        "(front_root=%r side=%r) — skipping",
                        front_root, sam3d_root)
        else:
            from skix_torch.pipelines.front_side import main as front_side

            with timer.span("front_side", sync):
                front_side({
                    "paths": {"side_root": str(sam3d_root),
                              "front_root": str(front_root),
                              "out_root": str(work / "front_side")},
                    "meters_per_pixel":
                        float(cfg.get("meters_per_pixel", 0.02)),
                    "render3d": bool(cfg.get("render3d",
                                             cfg.get("render_video", False))),
                    "device": device,
                })
            summary["front_side"] = str(work / "front_side")

    if ("angle" in stages or "metrics" in stages) and not fused_root.exists():
        log.warning("angle/metrics requested but %s does not exist — "
                    "skipping", fused_root)
    if fused_root.exists() and "angle" in stages:
        from skix_torch.pipelines.angle import main as angle

        with timer.span("angle", sync):
            angle({"paths": {"fused_root": str(fused_root),
                             "out_root": str(work / "angle")},
                   "plots": bool(cfg.get("plots", False)),
                   "device": device})
        summary["angle"] = str(work / "angle")
    if fused_root.exists() and "metrics" in stages:
        from skix_torch.pipelines.metrics import main as metrics

        with timer.span("metrics", sync):
            metrics({"paths": {"in_root": str(fused_root),
                               "out_root": str(work / "metrics")},
                     "gt_root": cfg.get("gt_root"),
                     "device": device})
        summary["metrics"] = str(work / "metrics")

    timer.log_report()
    timer.save(work / "pipeline_timing.json")
    (work / "pipeline_summary.json").write_text(json.dumps(summary, indent=2))
    log.info("pipeline complete: %s", work / "pipeline_summary.json")


if __name__ == "__main__":
    main()
