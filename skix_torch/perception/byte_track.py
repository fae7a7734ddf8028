"""ByteTrack over the 2D-detection stream: fixed-slot Kalman tracking.

Port of ``skix/perception/byte_track.py``. ``max_tracks`` slots hold the
tracks as a struct of tensors (:class:`ByteTrackState`); each slot carries an
8-dim XYAH(+velocity) Kalman filter (position noise ∝ h/20, velocity
∝ h/160). A frame runs ByteTrack's three associations in order: high-score
detections against the tracked and lost pool on IoU cost, score-fused with
``fuse_score``, gate ``match_thresh``; low-score detections against the
remaining tracked slots, gate 0.5; the remaining high detections against
the unconfirmed tracks, gate 0.7. Matching is skix's greedy fixed-round
assignment, the best remaining pair first and the lowest flat index on a
tie. Lost tracks retire after ``track_buffer`` frames; a tracked/lost pair
above IoU 0.85 resolves to the older track. Only activated tracks emit
their id. :func:`track_sequence_ids` walks the clip frame by frame (skix's
``lax.scan``) with tensor ops only, so on the card it never waits on the
device.

``tracker_type: botsort`` adds skix's camera-motion compensation: an affine
warp per frame pair, least squares on the optical flow sampled on a stride-16
grid (:func:`motion_grid`, :func:`fit_global_motion`), applied to every
occupied slot's state before association (:func:`_apply_gmc`).

``exact_match: true`` solves every association stage exactly, as
ultralytics' ``lap.lapjv(1 − sim, extend_cost=True, cost_limit=1 − thresh)``
does, with skix's auction (:func:`_exact_match`,
``matcher.auction_assign``). The auction's host loop reads one flag a
round, so this option waits on the device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from skix_torch.ops.nms import box_iou
from skix_torch.tracking.matcher import auction_assign

_NEG = -1e9
_WP = 1.0 / 20      # Kalman position std weight (SORT/ByteTrack)
_WV = 1.0 / 160     # Kalman velocity std weight


@dataclasses.dataclass(frozen=True)
class ByteTrackConfig:
    """Defaults = skix's (configs/prepare_dataset.yaml's bytetrack block)."""

    max_tracks: int = 16
    track_high_thresh: float = 0.25
    track_low_thresh: float = 0.1
    new_track_thresh: float = 0.25
    track_buffer: int = 30
    match_thresh: float = 0.8
    fuse_score: bool = True
    second_match_thresh: float = 0.5
    unconfirmed_match_thresh: float = 0.7
    exact_match: bool = False


class ByteTrackState(NamedTuple):
    mean: torch.Tensor       # (K, 8) Kalman mean (xyah + velocities)
    cov: torch.Tensor        # (K, 8, 8)
    tracked: torch.Tensor    # (K,) bool: matched on the previous frame
    lost: torch.Tensor       # (K,) bool: unmatched but inside the buffer
    activated: torch.Tensor  # (K,) bool: emits its id
    missing: torch.Tensor    # (K,) frames since the last match
    age: torch.Tensor        # (K,) frames since activation
    score: torch.Tensor      # (K,)
    obj_id: torch.Tensor     # (K,) stable ids (−1 = free)
    next_id: torch.Tensor    # ()
    frame: torch.Tensor      # () frame counter


def xyxy_to_xyah(b):
    w = b[..., 2] - b[..., 0]
    h = b[..., 3] - b[..., 1]
    return torch.stack([(b[..., 0] + b[..., 2]) / 2,
                        (b[..., 1] + b[..., 3]) / 2,
                        w / torch.clamp(h, min=1e-6), h], -1)


def xyah_to_xyxy(m):
    h = m[..., 3]
    w = m[..., 2] * h
    return torch.stack([m[..., 0] - w / 2, m[..., 1] - h / 2,
                        m[..., 0] + w / 2, m[..., 1] + h / 2], -1)


def _diag(std):
    """(K, n) standard deviations → (K, n, n) diagonal variances."""
    return torch.diag_embed(std * std)


def _kalman_initiate(z):
    """Measurements (K, 4) xyah → (mean (K, 8), cov (K, 8, 8))."""
    h = z[:, 3]
    mean = torch.cat([z, torch.zeros_like(z)], -1)
    c = torch.full_like(h, 1e-2)
    v = torch.full_like(h, 1e-5)
    std = torch.stack([2 * _WP * h, 2 * _WP * h, c, 2 * _WP * h,
                       10 * _WV * h, 10 * _WV * h, v, 10 * _WV * h], -1)
    return mean, _diag(std)


_F = np.eye(8, dtype=np.float32)
_F[:4, 4:] = np.eye(4, dtype=np.float32)


def _kalman_predict(mean, cov):
    h = mean[:, 3]
    F = torch.as_tensor(_F, device=mean.device)
    c = torch.full_like(h, 1e-2)
    v = torch.full_like(h, 1e-5)
    std = torch.stack([_WP * h, _WP * h, c, _WP * h,
                       _WV * h, _WV * h, v, _WV * h], -1)
    return mean @ F.T, F @ cov @ F.T + _diag(std)


def _kalman_update(mean, cov, z):
    h = mean[:, 3]
    r = torch.stack([_WP * h, _WP * h, torch.full_like(h, 1e-1), _WP * h], -1)
    S = cov[:, :4, :4] + _diag(r)                       # H P Hᵀ, H = [I₄ 0]
    # solve_ex: no singularity check, so the card is not waited on
    gain = torch.linalg.solve_ex(S, cov[:, :4, :])[0].transpose(1, 2)
    mean2 = mean + (gain @ (z - mean[:, :4])[..., None])[..., 0]
    cov2 = cov - gain @ cov[:, :4, :]
    return mean2, cov2


def init_byte_track_state(cfg: ByteTrackConfig, device=None
                          ) -> ByteTrackState:
    K = cfg.max_tracks
    z = dict(device=device)
    return ByteTrackState(
        mean=torch.zeros((K, 8), **z),
        cov=torch.eye(8, **z).expand(K, 8, 8).clone(),
        tracked=torch.zeros(K, dtype=torch.bool, **z),
        lost=torch.zeros(K, dtype=torch.bool, **z),
        activated=torch.zeros(K, dtype=torch.bool, **z),
        missing=torch.zeros(K, dtype=torch.int32, **z),
        age=torch.zeros(K, dtype=torch.int32, **z),
        score=torch.zeros(K, **z),
        obj_id=torch.full((K,), -1, dtype=torch.int32, **z),
        next_id=torch.zeros((), dtype=torch.int32, **z),
        frame=torch.zeros((), dtype=torch.int32, **z))


def _greedy_match(sim, row_ok, col_ok, thresh, rounds: int):
    """Greedy max-similarity assignment → row→col index (int32) or −1."""
    K, N = sim.shape
    dev = sim.device
    masked = torch.where(row_ok[:, None] & col_ok[None, :], sim,
                         torch.full_like(sim, _NEG))
    assign = torch.full((K,), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(K, device=dev)
    cols = torch.arange(N, device=dev)
    for _ in range(rounds):
        flat = torch.argmax(masked.reshape(-1))
        ti, di = flat // N, flat % N
        take = masked.reshape(-1)[flat] >= thresh
        assign = torch.where(take & (rows == ti), di.to(torch.int32), assign)
        strike = take & ((rows[:, None] == ti) | (cols[None, :] == di))
        masked = torch.where(strike, torch.full_like(masked, _NEG), masked)
    return assign


def _exact_match(sim, row_ok, col_ok, thresh, rounds: int = 0):
    """Exact assignment with a cost limit, ``lap.lapjv(1 − sim,
    extend_cost=True, cost_limit=1 − thresh)``'s semantics, solved by the
    auction over ``[costᵀ; dummy]``: each track may instead take its own
    dummy row at cost ``1 − thresh``, so the optimum never matches a pair
    whose cost is above the limit. → row→col index (int32) or −1;
    ``rounds`` is unused (the signature of :func:`_greedy_match`)."""
    K, N = sim.shape
    dev = sim.device
    big = torch.full((), 2.0, device=dev)   # above any real cost or the gate
    cost = torch.where(col_ok[None, :], 1.0 - sim, big)           # (K, N)
    dummy = torch.where(torch.eye(K, dtype=torch.bool, device=dev),
                        1.0 - thresh, big)
    full = torch.cat([cost.T, dummy], 0)                           # (N+K, K)
    col_of_row = auction_assign(full, row_ok)                      # (N+K,)
    rows = torch.arange(N + K, device=dev)
    real = (col_of_row >= 0) & (rows < N)
    # invert row→track into track→det (each track holds at most one row)
    assign = torch.full((K,), -1, dtype=torch.int64, device=dev)
    assign = assign.scatter_reduce(0, col_of_row.clamp(min=0),
                                   torch.where(real, rows, -1), "amax")
    return assign.to(torch.int32)


def _det_taken(assign, N):
    safe = torch.clamp(assign, min=0).long()
    taken = torch.zeros(N, dtype=torch.int32, device=assign.device)
    return taken.scatter_reduce(0, safe, (assign >= 0).to(torch.int32),
                                "amax").to(torch.bool)


def motion_grid(H: int, W: int, stride: int = 16):
    """The (y_idx, x_idx) sample grid :func:`fit_global_motion` expects: the
    flow volume is subsampled on the host to ~1/stride² of it."""
    ys = np.clip(np.arange(0, H, stride) + stride // 2, 0, H - 1)
    xs = np.clip(np.arange(0, W, stride) + stride // 2, 0, W - 1)
    return np.meshgrid(ys, xs, indexing="ij")


def fit_global_motion(points, flows):
    """Least-squares affine fit: ``points (n, 2)`` full-resolution (x, y)
    sample coordinates, ``flows (T-1, n, 2)`` their (dx, dy) flow vectors →
    ``(T-1, 2, 3)`` affines ``M = [A | b]`` mapping frame-t coordinates to
    frame t+1."""
    points = torch.as_tensor(points, dtype=torch.float32)
    flows = torch.as_tensor(flows, dtype=torch.float32, device=points.device)
    P = torch.cat([points, torch.ones_like(points[:, :1])], -1)
    G = P.T @ P + 1e-6 * torch.eye(3, device=points.device)
    tgt = points[None] + flows                              # (T-1, n, 2)
    M = torch.linalg.solve(G.expand(len(flows), 3, 3), P.T @ tgt)
    return M.transpose(1, 2)


def _apply_gmc(mean, cov, warp):
    """BoT-SORT ``multi_gmc``: transform the Kalman state by the camera
    warp ``[A | b]``: positions and velocities by A, h scaled by √|det A|,
    the covariance conjugated by the same block map."""
    A = warp[:, :2]
    b = warp[:, 2]
    s = torch.sqrt(torch.abs(torch.linalg.det(A)))
    M = torch.zeros((8, 8), device=mean.device)
    M[0:2, 0:2] = A
    M[4:6, 4:6] = A
    M[2, 2] = M[6, 6] = 1.0
    M[3, 3] = M[7, 7] = s
    shift = torch.zeros(8, device=mean.device)
    shift[0:2] = b
    mean2 = torch.einsum("ij,kj->ki", M, mean) + shift[None]
    cov2 = torch.einsum("ij,kjl,ml->kim", M, cov, M)
    return mean2, cov2


def byte_track_step(state: ByteTrackState, boxes_xyxy, scores, valid,
                    cfg: ByteTrackConfig, warp=None):
    """One frame: ``boxes_xyxy (N, 4)``, ``scores (N,)``, ``valid (N,)``;
    ``warp (2, 3)`` optionally maps previous-frame coordinates into this
    frame. Returns ``(new_state, det_ids (N,) int32)``."""
    K = cfg.max_tracks
    dev = state.mean.device
    N = boxes_xyxy.shape[0]
    rounds = min(K, N)
    slot = torch.arange(K, device=dev)

    occupied = state.tracked | state.lost
    mean_in, cov_in = state.mean, state.cov
    if warp is not None:
        gmean, gcov = _apply_gmc(mean_in, cov_in, warp)
        mean_in = torch.where(occupied[:, None], gmean, mean_in)
        cov_in = torch.where(occupied[:, None, None], gcov, cov_in)
    # ByteTrack zeroes the vh velocity of non-tracked tracks pre-predict
    zeroed = mean_in.clone()
    zeroed[:, 7] = 0.0
    mean0 = torch.where((occupied & ~state.tracked)[:, None], zeroed, mean_in)
    pmean, pcov = _kalman_predict(mean0, cov_in)
    pmean = torch.where(occupied[:, None], pmean, mean_in)
    pcov = torch.where(occupied[:, None, None], pcov, cov_in)
    pred_boxes = xyah_to_xyxy(pmean[:, :4])

    high = valid & (scores >= cfg.track_high_thresh)
    low = valid & (scores >= cfg.track_low_thresh) & ~high

    iou = box_iou(pred_boxes, boxes_xyxy)                     # (K, N)

    # stage 1: activated tracked + lost vs high detections
    pool1 = (state.tracked & state.activated) | state.lost
    sim1 = iou * scores[None, :] if cfg.fuse_score else iou
    match = _exact_match if cfg.exact_match else _greedy_match
    a1 = match(sim1, pool1, high, 1.0 - cfg.match_thresh, rounds)
    taken = _det_taken(a1, N)
    # stage 2: remaining activated-tracked vs low detections (IoU only)
    rem = state.tracked & state.activated & (a1 < 0)
    a2 = match(iou, rem, low & ~taken,
                       1.0 - cfg.second_match_thresh, rounds)
    taken = taken | _det_taken(a2, N)
    # stage 3: unconfirmed tracks vs remaining high detections (fused)
    unconf = state.tracked & ~state.activated
    a3 = match(sim1, unconf, high & ~taken,
                       1.0 - cfg.unconfirmed_match_thresh, rounds)
    taken = taken | _det_taken(a3, N)

    assign = torch.where(a1 >= 0, a1, torch.where(a2 >= 0, a2, a3))
    matched = assign >= 0
    safe = torch.clamp(assign, min=0).long()

    z = xyxy_to_xyah(boxes_xyxy)[safe]
    umean, ucov = _kalman_update(pmean, pcov, z)
    mean = torch.where(matched[:, None], umean, pmean)
    cov = torch.where(matched[:, None, None], ucov, pcov)
    score = torch.where(matched, scores[safe], state.score)

    # lifecycle: matched → tracked(+activated); unmatched tracked → lost;
    # unmatched unconfirmed → removed; lost beyond the buffer → removed
    missing = torch.where(matched, torch.zeros_like(state.missing),
                          state.missing + occupied.to(torch.int32))
    still_lost = (occupied & ~matched & ~unconf
                  & (missing <= cfg.track_buffer))
    removed = occupied & ~matched & ~still_lost
    tracked = matched
    lost = still_lost
    activated = (state.activated | matched) & ~removed
    age = torch.where(occupied & ~removed, state.age + 1,
                      torch.zeros_like(state.age))

    # duplicate suppression between the tracked and lost lists only
    cur_boxes = xyah_to_xyxy(mean[:, :4])
    dup = box_iou(cur_boxes, cur_boxes) > 0.85
    both = ((tracked[:, None] & lost[None, :])
            | (lost[:, None] & tracked[None, :]))
    dup = dup & both & ~torch.eye(K, dtype=torch.bool, device=dev)
    younger = (age[:, None] < age[None, :]) | (
        (age[:, None] == age[None, :]) & (slot[:, None] > slot[None, :]))
    kill = (dup & younger).any(1)
    tracked = tracked & ~kill
    lost = lost & ~kill
    activated = activated & ~kill

    alive = tracked | lost
    obj_id = torch.where(alive, state.obj_id, torch.full_like(state.obj_id,
                                                              -1))

    # spawn: unmatched high detections above new_track_thresh into free
    # slots (activated at once only on the clip's first frame)
    spawnable = high & ~taken & (scores >= cfg.new_track_thresh)
    free = ~alive
    det_rank = torch.cumsum(spawnable.to(torch.int32), 0) - 1
    slot_rank = torch.where(free, torch.cumsum(free.to(torch.int32), 0) - 1,
                            torch.full_like(slot, K + 1, dtype=torch.int32))
    pair = (det_rank[None, :] == slot_rank[:, None]) & spawnable[None, :]
    det_for_slot = torch.argmax(pair.to(torch.int32), 1)
    spawn = free & pair.any(1)
    sd = det_for_slot
    smean, scov = _kalman_initiate(xyxy_to_xyah(boxes_xyxy)[sd])
    mean = torch.where(spawn[:, None], smean, mean)
    cov = torch.where(spawn[:, None, None], scov, cov)
    score = torch.where(spawn, scores[sd], score)
    tracked = tracked | spawn
    first_frame = state.frame == 0
    activated = torch.where(spawn, first_frame, activated)
    missing = torch.where(spawn, torch.zeros_like(missing), missing)
    age = torch.where(spawn, torch.ones_like(age), age)
    new_ids = state.next_id + torch.cumsum(spawn.to(torch.int32), 0) - 1
    obj_id = torch.where(spawn, new_ids.to(torch.int32), obj_id)

    # det→track-id emission: activated matches + first-frame spawns
    emit_id = torch.where(tracked & activated, obj_id,
                          torch.full_like(obj_id, -1))
    neg = torch.full_like(emit_id, -1)
    det_ids = torch.full((N,), -1, dtype=torch.int32, device=dev)
    det_ids = det_ids.scatter_reduce(0, safe, torch.where(matched, emit_id,
                                                          neg), "amax")
    det_ids = det_ids.scatter_reduce(0, sd, torch.where(spawn, emit_id, neg),
                                     "amax")

    new_state = ByteTrackState(
        mean=mean, cov=cov, tracked=tracked, lost=lost, activated=activated,
        missing=missing, age=age, score=score, obj_id=obj_id,
        next_id=state.next_id + spawn.to(torch.int32).sum().to(torch.int32),
        frame=state.frame + 1)
    return new_state, det_ids


def track_sequence_ids(boxes_xyxy, scores, valid,
                       cfg: ByteTrackConfig = ByteTrackConfig(),
                       motion=None):
    """Whole-clip tracking: ``boxes_xyxy (T, N, 4)``, ``scores (T, N)``,
    ``valid (T, N)`` → ``(T, N)`` int32 det→track-id map (−1 = no track),
    on the boxes' device. ``motion (T-1, 2, 3)``: optional per-pair camera
    warps (frame t → t+1), the BoT-SORT configuration."""
    boxes = torch.as_tensor(boxes_xyxy, dtype=torch.float32)
    dev = boxes.device
    scores = torch.as_tensor(scores, dtype=torch.float32, device=dev)
    valid = torch.as_tensor(valid, device=dev).to(torch.bool)
    T, N = boxes.shape[:2]
    warps = None
    if motion is not None:
        ident = torch.eye(2, 3, device=dev)[None]
        warps = torch.cat([ident, torch.as_tensor(
            motion, dtype=torch.float32, device=dev)], 0)[:T]
    state = init_byte_track_state(cfg, dev)
    ids = []
    for t in range(T):
        state, det_ids = byte_track_step(
            state, boxes[t], scores[t], valid[t], cfg,
            None if warps is None else warps[t])
        ids.append(det_ids)
    return (torch.stack(ids) if T
            else torch.zeros((0, N), dtype=torch.int32, device=dev))
