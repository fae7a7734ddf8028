"""Combined video-tracking evaluation suite (SA-Co VEval composition).

A numpy copy of ``skix/metrics/suite.py``.

Capability parity with the reference's video evaluation harness
(``sam3/eval/saco_veval_eval.py:17`` ``VEvalEvaluator``), which runs five
evaluators over one prediction set and merges their metric dicts:
YTVIS mAP, phrase AP, TETA, HOTA, and cgF1. Here the same five metric
families (all implemented in ``skix_torch.metrics``) run over per-frame
box/id/mask sequences for one video + concept, returning one flat dict —
the offline eval tail for the SAM3-style tracking pipeline.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def evaluate_tracking_suite(
    pred_boxes: Sequence[np.ndarray],   # per frame (Np, 4) xyxy
    pred_ids: Sequence[np.ndarray],
    pred_scores: Sequence[np.ndarray],
    gt_boxes: Sequence[np.ndarray],
    gt_ids: Sequence[np.ndarray],
    pred_masks: Sequence[np.ndarray] | None = None,  # per frame (Np, H, W)
    gt_masks: Sequence[np.ndarray] | None = None,
    score_threshold: float = 0.5,
) -> dict:
    """Returns {"HOTA", "DetA", "AssA", "MOTA", "TETA", "LocA", "AssocA",
    "ClsA", "cgF1", "IL_MCC", and (with masks) "mask_AP"} for a single
    video/concept pair — the reference's per-(video, category) result row
    (saco_veval_eval.py:39-48)."""
    from skix_torch.metrics.cgf1 import evaluate_cgf1
    from skix_torch.metrics.teta import evaluate_teta
    from skix_torch.metrics.tracking_eval import (evaluate_hota,
                                                  evaluate_tracking,
                                                  video_instance_ap)

    out: dict = {}
    hota = evaluate_hota(pred_boxes, pred_ids, gt_boxes, gt_ids)
    out["HOTA"] = hota["HOTA"]
    out["DetA"] = hota["DetA"]
    out["AssA"] = hota["AssA"]
    mota = evaluate_tracking(pred_boxes, pred_ids, gt_boxes, gt_ids)
    out["MOTA"] = mota["mota"]
    out["id_switches"] = mota["id_switches"]

    # single-class evaluation: every pred/gt carries class id 0
    cls0 = [np.zeros(len(np.asarray(i).reshape(-1)), np.int64)
            for i in pred_ids]
    gt_cls0 = [np.zeros(len(np.asarray(i).reshape(-1)), np.int64)
               for i in gt_ids]
    teta = evaluate_teta(pred_boxes, pred_ids, cls0,
                         gt_boxes, gt_ids, gt_cls0)
    out["TETA"] = teta["TETA"]
    out["LocA"] = teta["LocA"]
    out["AssocA"] = teta["AssocA"]
    out["ClsA"] = teta["ClsA"]

    cg = evaluate_cgf1(list(pred_boxes), list(pred_scores), list(gt_boxes),
                       threshold=score_threshold)
    out["cgF1"] = cg["cgF1"]
    out["IL_MCC"] = cg["IL_MCC"]
    out["pmF1"] = cg["positive_micro_F1"]

    if pred_masks is not None and gt_masks is not None:
        # video_instance_ap accepts per-frame score arrays directly and
        # averages them per track internally
        ap = video_instance_ap(pred_masks, pred_ids, list(pred_scores),
                               gt_masks, gt_ids)
        out["mask_AP"] = ap["mAP"]
    return out
