"""TETA — Track Every Thing Accuracy (Li et al., ECCV 2022).

A numpy copy of ``skix/metrics/teta.py``.

Capability parity with the reference's vendored TETA metric core
(``sam3/eval/teta_eval_toolkit/metrics/teta.py``): TETA decomposes
tracking quality into Localization, Association, and Classification,
evaluated per class over a "local cluster" of tracker detections — any
tracker detection (regardless of predicted class) that overlaps a GT of
the target class participates in localization/association, so a tracker
is not punished on Loc/Assoc for classification mistakes.

The reference repo vendors only the metric core (its dataset
preprocessing lives outside the repo); here ``teta_core`` mirrors
``TETA.eval_sequence_single_thr`` exactly (parity-tested against the
imported reference class on toy data) and ``evaluate_teta`` adds the
standard cluster construction:

- per frame and class ``c``: the cluster is every tracker det with
  predicted class ``c`` plus every det whose IoU with some class-``c``
  GT is ≥ ``loc_thr``; the latter set are the FP candidates
  (``tk_overlap_ids``).
- Loc: Hungarian matching on ``global_alignment × IoU`` (HOTA-style),
  thresholded at each α in ``arange(0, 0.99, 0.05)``. Loc_FP counts only
  unmatched FP candidates.
- Assoc: HOTA-style Jaccard over accumulated match counts, averaged over
  matched detections.
- Cls: for α ≥ 0.5, matched detections score Cls_TP when the predicted
  class is correct; wrong predictions add Cls_FN here and Cls_FP to the
  predicted class.
- ``TETA = (LocA + AssocA + ClsA) / 3`` per α; scalars are α-averages.

Host-side numpy (offline eval tail, like HOTA in tracking_eval.py).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment

from skix_torch.metrics.detection_eval import _iou_matrix

EPS = np.finfo("float").eps
ALPHAS = np.arange(0.0, 0.99, 0.05)          # 20 thresholds
CLS_ALPHAS = np.arange(0.5, 0.99, 0.05)      # the α ≥ 0.5 tail (10)


def _global_alignment(gt_ids, tk_ids, sims, num_gt_ids, num_tk_ids):
    """Reference compute_global_alignment_score (teta.py:182)."""
    num_matches = np.zeros((num_gt_ids, num_tk_ids))
    gt_count = np.zeros((num_gt_ids, 1))
    tk_count = np.zeros((1, num_tk_ids))
    for g, k, sim in zip(gt_ids, tk_ids, sims):
        if len(g) and len(k):
            denom = sim.sum(0, keepdims=True) + sim.sum(1, keepdims=True) - sim
            sim_iou = np.zeros_like(sim)
            mask = denom > EPS
            sim_iou[mask] = sim[mask] / denom[mask]
            num_matches[g[:, None], k[None, :]] += sim_iou
        if len(g):
            gt_count[g] += 1
        if len(k):
            tk_count[0, k] += 1
    ga = num_matches / np.maximum(gt_count + tk_count - num_matches, EPS)
    return ga, gt_count, tk_count


def teta_core(
    gt_ids: Sequence[np.ndarray],        # per frame, canonical [0, num_gt_ids)
    tk_ids: Sequence[np.ndarray],        # per frame, canonical [0, num_tk_ids)
    sims: Sequence[np.ndarray],          # per frame (len(gt), len(tk)) IoU
    tk_overlap_ids: Sequence[np.ndarray],  # per frame: FP-candidate tk ids
    tk_classes: Sequence[np.ndarray],    # per frame predicted class per tk det
    gt_class: int,                       # the class under evaluation
    num_gt_ids: int,
    num_tk_ids: int,
    num_gt_dets: int,
    num_tk_overlap_dets: int,
    loc_thr: float = 0.5,
) -> tuple[dict, dict]:
    """Single-class, single-threshold TETA core — mirrors the reference
    ``eval_sequence_single_thr`` (teta.py:75). Returns ``(res,
    cls_fp_other)`` where ``cls_fp_other[c]`` is the per-α Cls_FP this
    class's matches charge to predicted class ``c``."""
    res = {
        "Loc_TP": np.zeros(len(ALPHAS)), "Loc_FN": np.zeros(len(ALPHAS)),
        "Loc_FP": np.zeros(len(ALPHAS)),
        "Cls_TP": np.zeros(len(CLS_ALPHAS)),
        "Cls_FN": np.zeros(len(CLS_ALPHAS)),
        "Cls_FP": np.zeros(len(CLS_ALPHAS)),
        "AssocA": np.zeros(len(ALPHAS)), "AssocRe": np.zeros(len(ALPHAS)),
        "AssocPr": np.zeros(len(ALPHAS)),
    }
    cls_fp_other: dict = {}
    if num_tk_overlap_dets == 0:
        res["Loc_FN"] = num_gt_dets * np.ones(len(ALPHAS))
        return _finalize(res), cls_fp_other
    if num_gt_dets == 0:
        return _finalize(res), cls_fp_other

    ga, gt_count, tk_count = _global_alignment(
        gt_ids, tk_ids, sims, num_gt_ids, num_tk_ids)
    matches_counts = [np.zeros_like(ga) for _ in ALPHAS]

    for g, k, sim, ov, kcls in zip(gt_ids, tk_ids, sims, tk_overlap_ids,
                                   tk_classes):
        if len(g) == 0:
            continue
        score = ga[g[:, None], k[None, :]] * sim
        mrow, mcol = linear_sum_assignment(-score)

        if len(ov) != 0:
            # columns of the overlap ids within this frame's tk_ids
            sorter = np.argsort(k)
            idx = sorter[np.searchsorted(k, ov, sorter=sorter)]
            fpl = ov[(sim[:, idx] >= loc_thr).any(axis=0)]
        else:
            fpl = np.asarray([], np.int64)

        for a, alpha in enumerate(ALPHAS):
            mask = sim[mrow, mcol] >= alpha - EPS
            row, col = mrow[mask], mcol[mask]
            num_matches = len(row)
            matched = set(int(t) for t in k[col])
            mcls = np.asarray(kcls)[col]
            wrong = mcls[mcls != gt_class]
            n_cls_ok = int(np.sum(mcls == gt_class))
            if alpha >= 0.5:
                ca = a - (len(ALPHAS) - len(CLS_ALPHAS))
                for cid in wrong:
                    arr = cls_fp_other.setdefault(
                        int(cid), np.zeros(len(CLS_ALPHAS)))
                    arr[ca] += 1
                res["Cls_TP"][ca] += n_cls_ok
                res["Cls_FN"][ca] += num_matches - n_cls_ok
            res["Loc_TP"][a] += num_matches
            res["Loc_FN"][a] += len(g) - num_matches
            res["Loc_FP"][a] += len(set(int(t) for t in fpl) - matched)
            if num_matches > 0:
                matches_counts[a][g[row], k[col]] += 1

    for a in range(len(ALPHAS)):
        mc = matches_counts[a]
        ass = mc / np.maximum(1, gt_count + tk_count - mc)
        res["AssocA"][a] = np.sum(mc * ass) / np.maximum(1, res["Loc_TP"][a])
        ass_re = mc / np.maximum(1, gt_count)
        res["AssocRe"][a] = np.sum(mc * ass_re) / np.maximum(
            1, res["Loc_TP"][a])
        ass_pr = mc / np.maximum(1, tk_count)
        res["AssocPr"][a] = np.sum(mc * ass_pr) / np.maximum(
            1, res["Loc_TP"][a])
    return _finalize(res), cls_fp_other


def _finalize(res: dict) -> dict:
    """Reference _compute_final_fields (teta.py:363)."""
    res["LocRe"] = res["Loc_TP"] / np.maximum(
        1, res["Loc_TP"] + res["Loc_FN"])
    res["LocPr"] = res["Loc_TP"] / np.maximum(
        1, res["Loc_TP"] + res["Loc_FP"])
    res["LocA"] = res["Loc_TP"] / np.maximum(
        1, res["Loc_TP"] + res["Loc_FN"] + res["Loc_FP"])
    cls_re = res["Cls_TP"] / np.maximum(1, res["Cls_TP"] + res["Cls_FN"])
    cls_pr = res["Cls_TP"] / np.maximum(1, res["Cls_TP"] + res["Cls_FP"])
    cls_a = res["Cls_TP"] / np.maximum(
        1, res["Cls_TP"] + res["Cls_FN"] + res["Cls_FP"])
    res["ClsRe"] = float(np.mean(cls_re))
    res["ClsPr"] = float(np.mean(cls_pr))
    res["ClsA"] = float(np.mean(cls_a))
    res["TETA"] = (res["LocA"] + res["AssocA"] + res["ClsA"]) / 3
    return res


def _canonical(ids_per_frame):
    """Map arbitrary ids to contiguous [0, n); returns (mapped, n)."""
    all_ids = sorted({int(i) for f in ids_per_frame for i in np.asarray(f)})
    lut = {i: j for j, i in enumerate(all_ids)}
    return ([np.asarray([lut[int(i)] for i in np.asarray(f)], np.int64)
             for f in ids_per_frame], len(all_ids))


def evaluate_teta(
    pred_boxes: Sequence[np.ndarray],    # per frame (Np, 4) xyxy
    pred_ids: Sequence[np.ndarray],
    pred_classes: Sequence[np.ndarray],
    gt_boxes: Sequence[np.ndarray],      # per frame (Ng, 4) xyxy
    gt_ids: Sequence[np.ndarray],
    gt_classes: Sequence[np.ndarray],
    class_list: Sequence[int] | None = None,
    loc_thr: float = 0.5,
) -> dict:
    """Evaluate one sequence. Returns ``{"per_class": {c: res}, "TETA",
    "LocA", "AssocA", "ClsA", ...}`` where the top-level scalars are
    class-averaged (over classes with any GT) and α-averaged."""
    T = len(pred_boxes)
    pred_boxes = [np.asarray(b).reshape(-1, 4) for b in pred_boxes]
    gt_boxes = [np.asarray(b).reshape(-1, 4) for b in gt_boxes]
    pred_classes = [np.asarray(c).reshape(-1) for c in pred_classes]
    gt_classes = [np.asarray(c).reshape(-1) for c in gt_classes]
    if class_list is None:
        class_list = sorted({int(c) for f in gt_classes for c in f})

    per_class: dict = {}
    cls_fp_pool: dict = {int(c): np.zeros(len(CLS_ALPHAS))
                         for c in class_list}
    for c in class_list:
        g_sel = [gc == c for gc in gt_classes]
        gids_c = [np.asarray(gi).reshape(-1)[s]
                  for gi, s in zip(gt_ids, g_sel)]
        gb_c = [b[s] for b, s in zip(gt_boxes, g_sel)]
        # cluster: predicted-class-c dets + any det overlapping a class-c GT
        k_sel, ov_flags = [], []
        for pb, pc, gb in zip(pred_boxes, pred_classes, gb_c):
            if len(pb) and len(gb):
                ov = _iou_matrix(pb, gb).max(axis=1) >= loc_thr
            else:
                ov = np.zeros(len(pb), bool)
            k_sel.append((pc == c) | ov)
            ov_flags.append(ov)
        kids_c = [np.asarray(pi).reshape(-1)[s]
                  for pi, s in zip(pred_ids, k_sel)]
        kcls_c = [pc[s] for pc, s in zip(pred_classes, k_sel)]
        ov_ids = []

        gids_c, n_gt = _canonical(gids_c)
        kids_c, n_tk = _canonical(kids_c)
        sims = []
        for t in range(T):
            pb = pred_boxes[t][k_sel[t]]
            gb = gb_c[t]
            sims.append(_iou_matrix(gb, pb) if len(gb) and len(pb)
                        else np.zeros((len(gb), len(pb))))
            ov_ids.append(kids_c[t][ov_flags[t][k_sel[t]]])
        num_gt_dets = int(sum(len(g) for g in gids_c))
        num_ov_dets = int(sum(len(o) for o in ov_ids))
        res, fp_other = teta_core(
            gids_c, kids_c, sims, ov_ids, kcls_c, c, n_gt, n_tk,
            num_gt_dets, num_ov_dets, loc_thr)
        per_class[int(c)] = res
        for cid, arr in fp_other.items():
            if cid in cls_fp_pool:
                cls_fp_pool[cid] += arr
    # charge cross-class classification FPs, then refinalize
    for c in class_list:
        per_class[int(c)]["Cls_FP"] = (per_class[int(c)]["Cls_FP"]
                                       + cls_fp_pool[int(c)])
        per_class[int(c)] = _finalize(per_class[int(c)])

    out = {"per_class": per_class, "alphas": ALPHAS}
    for field in ("TETA", "LocA", "AssocA", "LocRe", "LocPr",
                  "AssocRe", "AssocPr"):
        vals = [np.mean(per_class[int(c)][field]) for c in class_list]
        out[field] = float(np.mean(vals)) if vals else 0.0
    for field in ("ClsA", "ClsRe", "ClsPr"):
        vals = [per_class[int(c)][field] for c in class_list]
        out[field] = float(np.mean(vals)) if vals else 0.0
    return out
