"""Multi-object tracking evaluation (MOTA-family + ID switches).

A numpy copy of ``skix/metrics/tracking_eval.py``, so the port scores
tracker output without importing skix.

Capability parity with the reference's tracking eval toolkits at the
core-metric level (SURVEY.md §2.8: sam3/eval/ YTVIS/HOTA/TETA writers):
per-frame greedy IoU matching of predicted vs GT tracks, counting FP / FN
/ ID switches → MOTA, plus ID-consistency (IDF1-style) accounting.
Host-side numpy (offline tail).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from skix_torch.metrics.detection_eval import _iou_matrix


def evaluate_tracking(
    pred_boxes: Sequence[np.ndarray],   # per frame (Np, 4) xyxy
    pred_ids: Sequence[np.ndarray],     # per frame (Np,)
    gt_boxes: Sequence[np.ndarray],     # per frame (Ng, 4)
    gt_ids: Sequence[np.ndarray],       # per frame (Ng,)
    iou_threshold: float = 0.5,
) -> dict:
    """Returns {mota, fp, fn, id_switches, matches, precision, recall}."""
    fp = fn = idsw = matches = 0
    n_gt_total = 0
    last_match: dict = {}  # gt_id → pred_id last matched to it
    for pb, pid, gb, gid in zip(pred_boxes, pred_ids, gt_boxes, gt_ids):
        pb = np.asarray(pb).reshape(-1, 4)
        gb = np.asarray(gb).reshape(-1, 4)
        pid = np.asarray(pid).reshape(-1)
        gid = np.asarray(gid).reshape(-1)
        n_gt_total += len(gb)
        if len(pb) == 0:
            fn += len(gb)
            continue
        if len(gb) == 0:
            fp += len(pb)
            continue
        iou = _iou_matrix(gb, pb)
        taken_p = np.zeros(len(pb), bool)
        matched_g = np.zeros(len(gb), bool)
        # greedy best-IoU matching
        order = np.dstack(np.unravel_index(np.argsort(-iou, axis=None),
                                           iou.shape))[0]
        for gi, pi in order:
            if matched_g[gi] or taken_p[pi] or iou[gi, pi] < iou_threshold:
                continue
            matched_g[gi] = True
            taken_p[pi] = True
            matches += 1
            g_key = int(gid[gi])
            p_key = int(pid[pi])
            if g_key in last_match and last_match[g_key] != p_key:
                idsw += 1
            last_match[g_key] = p_key
        fn += int((~matched_g).sum())
        fp += int((~taken_p).sum())
    mota = 1.0 - (fp + fn + idsw) / max(n_gt_total, 1)
    n_pred_total = matches + fp
    return {
        "mota": float(mota),
        "fp": int(fp), "fn": int(fn), "id_switches": int(idsw),
        "matches": int(matches),
        "precision": matches / max(n_pred_total, 1),
        "recall": matches / max(n_gt_total, 1),
    }


def evaluate_hota(
    pred_boxes: Sequence[np.ndarray],
    pred_ids: Sequence[np.ndarray],
    gt_boxes: Sequence[np.ndarray],
    gt_ids: Sequence[np.ndarray],
    alphas: np.ndarray | None = None,
) -> dict:
    """HOTA (Luiten et al., IJCV 2021) — the reference ships it in
    sam3/eval/; semantics follow the canonical TrackEval implementation:

    per localization threshold α, detections are matched per frame by
    Hungarian assignment maximizing a global-alignment-biased similarity
    (so matching prefers consistent identity pairs); TPs/FNs/FPs give
    DetA, per-TP association scores A(c) = TPA/(TPA+FNA+FPA) give AssA,
    HOTA(α) = √(DetA·AssA); the final score averages over α ∈
    {0.05, …, 0.95}.

    Returns {"HOTA", "DetA", "AssA", per-α arrays}.
    """
    from scipy.optimize import linear_sum_assignment

    if alphas is None:
        alphas = np.arange(0.05, 0.96, 0.05)

    frames = []
    gt_all, pred_all = set(), set()
    for pb, pid, gb, gid in zip(pred_boxes, pred_ids, gt_boxes, gt_ids):
        pb = np.asarray(pb, np.float64).reshape(-1, 4)
        gb = np.asarray(gb, np.float64).reshape(-1, 4)
        pid = np.asarray(pid).reshape(-1)
        gid = np.asarray(gid).reshape(-1)
        sim = _iou_matrix(gb, pb) if len(gb) and len(pb) else \
            np.zeros((len(gb), len(pb)))
        frames.append((gid, pid, sim))
        gt_all.update(int(g) for g in gid)
        pred_all.update(int(p) for p in pid)
    gmap = {g: i for i, g in enumerate(sorted(gt_all))}
    pmap = {p: i for i, p in enumerate(sorted(pred_all))}
    nG, nP = len(gmap), len(pmap)

    # global potential-match statistics (TrackEval hota.py): similarity-
    # weighted counts of possible (gt, pred) id pairs
    pot = np.zeros((nG, nP))
    gt_cnt = np.zeros(nG)
    pr_cnt = np.zeros(nP)
    for gid, pid, sim in frames:
        if len(gid) and len(pid):
            denom = (sim.sum(0)[None, :] + sim.sum(1)[:, None] - sim)
            ious = np.where(denom > 0 + np.finfo(float).eps,
                            sim / np.maximum(denom, 1e-12), 0.0)
            gi = np.asarray([gmap[int(g)] for g in gid])
            pi = np.asarray([pmap[int(p)] for p in pid])
            np.add.at(pot, (gi[:, None], pi[None, :]), ious)
        for g in gid:
            gt_cnt[gmap[int(g)]] += 1
        for p in pid:
            pr_cnt[pmap[int(p)]] += 1
    glob_align = pot / np.maximum(
        gt_cnt[:, None] + pr_cnt[None, :] - pot, 1e-12)

    # per-frame Hungarian matching ONCE (the score is α-independent —
    # TrackEval matches once per timestep and thresholds per α)
    matched = []  # per frame: (gi_rows, pi_cols, sims)
    n_gt_total = n_pred_total = 0
    for gid, pid, sim in frames:
        n_gt_total += len(gid)
        n_pred_total += len(pid)
        if len(gid) == 0 or len(pid) == 0:
            matched.append((np.zeros(0, int), np.zeros(0, int),
                            np.zeros(0)))
            continue
        gi = np.asarray([gmap[int(g)] for g in gid])
        pi = np.asarray([pmap[int(p)] for p in pid])
        score = glob_align[gi[:, None], pi[None, :]] * sim
        rows, cols = linear_sum_assignment(-score)
        matched.append((gi[rows], pi[cols], sim[rows, cols]))

    hota_a, deta_a, assa_a = [], [], []
    for alpha in alphas:
        tp = 0
        match_cnt = np.zeros((nG, nP))
        for gi_m, pi_m, sims in matched:
            ok = sims >= alpha - np.finfo(float).eps
            tp += int(ok.sum())
            match_cnt[gi_m[ok], pi_m[ok]] += 1
        fn = n_gt_total - tp
        fp = n_pred_total - tp
        if tp + fn + fp == 0:
            hota_a.append(1.0)
            deta_a.append(1.0)
            assa_a.append(1.0)
            continue
        deta = tp / max(tp + fn + fp, 1)
        # A(c) = TPA / (gt-id dets + pred-id dets − TPA): the denominator
        # uses GLOBAL per-id detection counts (TrackEval hota.py), so
        # unmatched detections of either track count as FNA/FPA
        with np.errstate(divide="ignore", invalid="ignore"):
            ass = match_cnt / np.maximum(
                gt_cnt[:, None] + pr_cnt[None, :] - match_cnt, 1e-12)
        assa = float((ass * match_cnt).sum() / max(tp, 1))
        deta = float(deta)
        hota_a.append(float(np.sqrt(deta * assa)))
        deta_a.append(deta)
        assa_a.append(assa)
    return {
        "HOTA": float(np.mean(hota_a)),
        "DetA": float(np.mean(deta_a)),
        "AssA": float(np.mean(assa_a)),
        "HOTA_alpha": np.asarray(hota_a),
        "DetA_alpha": np.asarray(deta_a),
        "AssA_alpha": np.asarray(assa_a),
        "alphas": np.asarray(alphas),
    }


def spatiotemporal_mask_iou(pred_masks, pred_ids, gt_masks, gt_ids):
    """Track-level mask IoU (YTVIS convention): per (pred-track, gt-track)
    pair, IoU = Σ_t |P_t ∩ G_t| / Σ_t |P_t ∪ G_t| with empty frames
    counting as empty masks.

    ``pred_masks``/``gt_masks``: per-frame (N_t, H, W) bool arrays with
    matching id vectors. Returns (iou (P, G), pred_track_ids,
    gt_track_ids)."""
    p_ids = sorted({int(i) for ids in pred_ids for i in np.asarray(ids)})
    g_ids = sorted({int(i) for ids in gt_ids for i in np.asarray(ids)})
    pmap = {p: i for i, p in enumerate(p_ids)}
    gmap = {g: i for i, g in enumerate(g_ids)}
    inter = np.zeros((len(p_ids), len(g_ids)))
    union = np.zeros((len(p_ids), len(g_ids)))
    p_area = np.zeros(len(p_ids))
    g_area = np.zeros(len(g_ids))
    for pm, pid, gm, gid in zip(pred_masks, pred_ids, gt_masks, gt_ids):
        pm = np.asarray(pm, bool)
        gm = np.asarray(gm, bool)
        pid = np.asarray(pid).reshape(-1)
        gid = np.asarray(gid).reshape(-1)
        for a, i in zip(pm, pid):
            p_area[pmap[int(i)]] += a.sum()
        for b, j in zip(gm, gid):
            g_area[gmap[int(j)]] += b.sum()
        for a, i in zip(pm, pid):
            for b, j in zip(gm, gid):
                inter[pmap[int(i)], gmap[int(j)]] += np.logical_and(
                    a, b).sum()
    union = p_area[:, None] + g_area[None, :] - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    return iou, p_ids, g_ids


def video_instance_ap(pred_masks, pred_ids, pred_scores, gt_masks, gt_ids,
                      iou_thresholds=None) -> dict:
    """YTVIS-style video instance segmentation AP (single class): tracks
    matched by spatio-temporal mask IoU, score-ordered greedy matching,
    101-point interpolated AP per threshold, averaged over
    [.5:.95] (reference ships this in sam3/eval).

    ``pred_scores``: {track_id: score} or per-frame arrays (averaged)."""
    iou, p_ids, g_ids = spatiotemporal_mask_iou(pred_masks, pred_ids,
                                                gt_masks, gt_ids)
    if isinstance(pred_scores, dict):
        scores = np.asarray([pred_scores[p] for p in p_ids], float)
    else:  # per-frame score arrays → mean per track
        acc = {p: [] for p in p_ids}
        for sc, pid in zip(pred_scores, pred_ids):
            for s, i in zip(np.asarray(sc).reshape(-1),
                            np.asarray(pid).reshape(-1)):
                acc[int(i)].append(float(s))
        scores = np.asarray([np.mean(acc[p]) if acc[p] else 0.0
                             for p in p_ids])
    if iou_thresholds is None:
        iou_thresholds = np.arange(0.5, 1.0, 0.05)

    aps = {}
    n_gt = len(g_ids)
    for thr in iou_thresholds:
        order = np.argsort(-scores)
        taken = np.zeros(n_gt, bool)
        records = []
        for i in order:
            tp = False
            cand = np.where(~taken & (iou[i] >= thr))[0] if n_gt else []
            if len(cand):
                j = cand[np.argmax(iou[i][cand])]
                taken[j] = True
                tp = True
            records.append((scores[i], tp))
        if n_gt == 0:
            aps[f"AP{int(thr * 100)}"] = float("nan")
            continue
        tps = np.cumsum([r[1] for r in records])
        fps = np.cumsum([not r[1] for r in records])
        rec = tps / n_gt
        prec = tps / np.maximum(tps + fps, 1)
        ap = 0.0
        for r in np.linspace(0, 1, 101):
            p = prec[rec >= r]
            ap += (p.max() if len(p) else 0.0) / 101
        aps[f"AP{int(thr * 100)}"] = float(ap)
    vals = [v for v in aps.values() if not np.isnan(v)]
    return {"mAP": float(np.mean(vals)) if vals else float("nan"), **aps}
