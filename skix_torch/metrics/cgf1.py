"""cgF1 — concept-grounding F1 for promptable (open-vocabulary) detection.

A numpy copy of ``skix/metrics/cgf1.py``.

Capability parity with the reference's cgF1 evaluator
(``sam3/eval/cgf1_eval.py``: CGF1Eval.evaluateImg:240, accumulate:342,
summarize:449). The metric scores a promptable detector per (image,
concept) query, class-agnostically (the reference asserts
``useCats=False``):

- per image, detections above a score ``threshold`` are Hungarian-matched
  to ground truths by IoU (maximize), then TP/FP/FN are counted at each
  IoU threshold;
- image-level (IL) presence classification: an image is IL_TP when both
  GTs and detections exist, IL_FP when only detections, IL_TN when
  neither, IL_FN when only GTs;
- ``cgF1 = positive_micro_F1 × IL_MCC``: box-level F1 on "positive"
  images (those with both GTs and detections), times the Matthews
  correlation of the presence decision — a detector is rewarded both for
  localizing the concept where it exists and for staying silent where it
  does not.

Host-side numpy (offline eval tail, like the HOTA/TETA evaluators).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment

from skix_torch.metrics.detection_eval import _iou_matrix

_COCO_IOU_THRS = np.linspace(0.5, 0.95, 10)


def _mask_iou_matrix(dt_masks: np.ndarray, gt_masks: np.ndarray) -> np.ndarray:
    """IoU between binary masks: dt (Nd, H, W) vs gt (Ng, H, W) → (Nd, Ng)."""
    d = dt_masks.reshape(len(dt_masks), -1).astype(bool)
    g = gt_masks.reshape(len(gt_masks), -1).astype(bool)
    inter = d.astype(np.float64) @ g.T.astype(np.float64)
    union = d.sum(-1)[:, None] + g.sum(-1)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _evaluate_image(dt_iou_gt: np.ndarray, n_dt: int, n_gt: int,
                    iou_thrs: np.ndarray) -> dict:
    """Reference evaluateImg (cgf1_eval.py:240) for one image; ``dt_iou_gt``
    is the (n_dt, n_gt) IoU matrix of score-thresholded detections vs
    non-ignored GTs."""
    T = len(iou_thrs)
    if n_gt == 0 and n_dt == 0:
        return {"IL_TP": 0, "IL_TN": 1, "IL_FP": 0, "IL_FN": 0, "num_dt": 0}
    if n_gt > 0 and n_dt == 0:
        return {"IL_TP": 0, "IL_TN": 0, "IL_FP": 0, "IL_FN": 1,
                "TPs": np.zeros(T, np.int64), "FPs": np.zeros(T, np.int64),
                "FNs": np.full(T, n_gt, np.int64),
                "local_F1s": np.zeros(T), "num_dt": 0}

    mdt, mgt = linear_sum_assignment(-dt_iou_gt)
    match_scores = dt_iou_gt[mdt, mgt]
    TPs = (match_scores[None, :] >= iou_thrs[:, None]).sum(axis=1)
    FPs = n_dt - TPs
    FNs = n_gt - TPs
    precision = TPs / (TPs + FPs + 1e-4)
    recall = TPs / (TPs + FNs + 1e-4)
    F1 = 2 * precision * recall / (precision + recall + 1e-4)
    res = {
        "TPs": TPs.astype(np.int64), "FPs": FPs.astype(np.int64),
        "FNs": FNs.astype(np.int64), "local_F1s": F1,
        "IL_TP": int(n_gt > 0 and n_dt > 0),
        "IL_FP": int(n_gt == 0 and n_dt > 0),
        "IL_TN": int(n_gt == 0 and n_dt == 0),
        "IL_FN": int(n_gt > 0 and n_dt == 0),
        "num_dt": n_dt,
    }
    if n_gt > 0 and n_dt > 0:
        res["local_positive_F1s"] = F1
    return res


def evaluate_cgf1(
    pred_boxes: Sequence[np.ndarray],    # per image (Nd, 4) xyxy (or masks)
    pred_scores: Sequence[np.ndarray],   # per image (Nd,)
    gt_boxes: Sequence[np.ndarray],      # per image (Ng, 4) xyxy (or masks)
    *,
    gt_ignore: Sequence[np.ndarray] | None = None,  # per image (Ng,) bool
    threshold: float = 0.5,
    iou_thrs: np.ndarray | None = None,
    use_masks: bool = False,
) -> dict:
    """Returns the reference's summary metrics. Array-valued (box-level)
    metrics are reported at their IoU-averaged value plus ``@0.5`` /
    ``@0.75`` entries (reference CGF1_METRICS table); image-level metrics
    (IL_*) are scalars. ``use_masks=True`` treats the box sequences as
    binary masks (iouType='segm')."""
    iou_thrs = _COCO_IOU_THRS if iou_thrs is None else np.asarray(iou_thrs)
    T = len(iou_thrs)

    TPs = np.zeros(T, np.int64)
    FPs = np.zeros(T, np.int64)
    pmFPs = np.zeros(T, np.int64)
    FNs = np.zeros(T, np.int64)
    local_F1s = np.zeros(T)
    IL = {"IL_TP": 0, "IL_FP": 0, "IL_TN": 0, "IL_FN": 0}
    valid_F1_count = 0

    for i, (db, ds, gb) in enumerate(zip(pred_boxes, pred_scores, gt_boxes)):
        ds = np.asarray(ds).reshape(-1)
        keep = ds >= threshold
        db = np.asarray(db)[keep]
        gb = np.asarray(gb)
        if gt_ignore is not None:
            gb = gb[~np.asarray(gt_ignore[i]).astype(bool)]
        n_dt, n_gt = len(db), len(gb)
        if n_dt > 0 and n_gt > 0:
            iou = (_mask_iou_matrix(db, gb) if use_masks
                   else _iou_matrix(db.reshape(-1, 4), gb.reshape(-1, 4)))
        else:
            iou = np.zeros((n_dt, n_gt))
        res = _evaluate_image(iou, n_dt, n_gt, iou_thrs)
        for k in IL:
            IL[k] += res[k]
        if "TPs" not in res:
            continue
        TPs += res["TPs"]
        FPs += res["FPs"]
        FNs += res["FNs"]
        if "local_positive_F1s" in res:
            local_F1s += res["local_positive_F1s"]
            pmFPs += res["FPs"]
            if res["num_dt"] > 0:
                valid_F1_count += 1

    precision = TPs / (TPs + FPs + 1e-4)
    positive_micro_precision = TPs / (TPs + pmFPs + 1e-4)
    recall = TPs / (TPs + FNs + 1e-4)
    F1 = 2 * precision * recall / (precision + recall + 1e-4)
    positive_micro_F1 = (2 * positive_micro_precision * recall
                         / (positive_micro_precision + recall + 1e-4))
    positive_macro_F1 = local_F1s / max(valid_F1_count, 1)

    IL_rec = IL["IL_TP"] / (IL["IL_TP"] + IL["IL_FN"] + 1e-6)
    IL_prec = IL["IL_TP"] / (IL["IL_TP"] + IL["IL_FP"] + 1e-6)
    IL_F1 = 2 * IL_prec * IL_rec / (IL_prec + IL_rec + 1e-6)
    IL_FPR = IL["IL_FP"] / (IL["IL_FP"] + IL["IL_TN"] + 1e-6)
    IL_MCC = float(IL["IL_TP"] * IL["IL_TN"] - IL["IL_FP"] * IL["IL_FN"]) / (
        (float(IL["IL_TP"] + IL["IL_FP"]) * float(IL["IL_TP"] + IL["IL_FN"])
         * float(IL["IL_TN"] + IL["IL_FP"])
         * float(IL["IL_TN"] + IL["IL_FN"])) ** 0.5 + 1e-6)

    cgF1 = positive_micro_F1 * IL_MCC

    out = {
        "IL_precision": IL_prec, "IL_recall": IL_rec, "IL_F1": IL_F1,
        "IL_FPR": IL_FPR, "IL_MCC": IL_MCC,
        "iou_thrs": iou_thrs,
    }
    arrays = {
        "cgF1": cgF1, "precision": precision, "recall": recall, "F1": F1,
        "positive_macro_F1": positive_macro_F1,
        "positive_micro_F1": positive_micro_F1,
        "positive_micro_precision": positive_micro_precision,
    }
    for name, arr in arrays.items():
        out[name] = float(np.mean(arr))        # IoU 0.50:0.95 average
        out[f"{name}_per_iou"] = np.asarray(arr)
        for thr in (0.5, 0.75):
            idx = np.where(np.isclose(iou_thrs, thr))[0]
            if len(idx):
                out[f"{name}@{thr:g}"] = float(np.asarray(arr)[idx[0]])
    return out
