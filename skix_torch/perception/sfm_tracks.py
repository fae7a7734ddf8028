"""SfM track prediction: query keypoints → multi-frame point tracks.

Port of ``skix/perception/sfm_tracks.py`` (the reference's VGGSfM
``track_predict.py``/``vggsfm_utils.py`` semantics):

- ``initialize_feature_extractors``: a ``+``-joined method string →
  {name: extractor}, whose keypoints are unioned per query frame:
  ``aliked`` and ``sp`` (learned, need weights), ``sift`` (OpenCV) and
  ``shi_tomasi`` (weight-free, on the device, the fallback);
- ``rank_frames_by_similarity`` and ``farthest_point_sampling`` (numpy,
  copied);
- ``predict_tracks``: rank the query frames (frame 0 first), per query
  frame extract keypoints, shuffle them with a numpy generator seeded
  ``seed``, sample colors, gate by point-map confidence, swap the query
  frame to position 0 on the device, run the track head over fixed-size
  query chunks whose pads are masked out of its space attention, swap
  back; then ``_augment_non_visible_frames`` re-queries frames with too
  few visible tracks.

Discrete choices are deterministic, so that the card and the CPU pick the
same keypoints from the same score map: Shi–Tomasi's scores are made of
elementwise operations only (rounded alike on both), and every top-k
takes the lowest flat index among equal scores (:func:`top_k`), as
``jax.lax.top_k`` does. The track head's feature maps are made once per
query frame and shared by its chunks.
"""

from __future__ import annotations

import logging
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from skix_torch.utils.profiling import StageTimer

log = logging.getLogger(__name__)

_GRAY = (0.299, 0.587, 0.114)


# ---------------------------------------------------------------------------
# keypoint extraction
# ---------------------------------------------------------------------------
def top_k(values: torch.Tensor, k: int):
    """``jax.lax.top_k`` of a 1-D tensor: the ``k`` largest values, ties
    broken by the lowest index (a stable descending sort), on any device."""
    vals, idx = torch.sort(values, descending=True, stable=True)
    return vals[:k], idx[:k]


def to_gray(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) → (H, W) with the weights (0.299, 0.587, 0.114), as three
    elementwise products summed left to right."""
    return img[..., 0] * _GRAY[0] + img[..., 1] * _GRAY[1] + img[..., 2] * _GRAY[2]


def _window_sum(x: torch.Tensor, k: int, weights=None) -> torch.Tensor:
    """``VALID`` correlation of ``x (H + k − 1, W + k − 1)`` with a k×k
    kernel (``weights`` a nested list, else all ones) as a sum of shifted
    slices, row-major: elementwise operations, so every device rounds it
    alike."""
    H, W = x.shape[0] - k + 1, x.shape[1] - k + 1
    out = None
    for i in range(k):
        for j in range(k):
            w = 1.0 if weights is None else weights[i][j]
            if w == 0.0:
                continue
            term = x[i:i + H, j:j + W] * w
            out = term if out is None else out + term
    return out


def _shi_tomasi_core(gray: torch.Tensor, max_pts: int, nms_radius: int,
                     det_thres: float):
    """gray (H, W) f32 → (xy (max_pts, 2), score (max_pts,), valid)."""
    H, W = gray.shape
    kx = [[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]]
    ky = [list(r) for r in zip(*kx)]
    pad = F.pad(gray[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    ix = _window_sum(pad, 3, kx)
    iy = _window_sum(pad, 3, ky)
    box = np.float32(1.0 / 25.0)

    def smooth(img):
        p = F.pad(img[None, None], (2, 2, 2, 2), mode="replicate")[0, 0]
        return _window_sum(p, 5, [[float(box)] * 5] * 5)

    a, b, c = smooth(ix * ix), smooth(ix * iy), smooth(iy * iy)
    tr = 0.5 * (a + c)
    score = tr - torch.sqrt(torch.clamp((0.5 * (a - c)) ** 2 + b * b, min=0.0))

    k = 2 * nms_radius + 1
    local_max = F.max_pool2d(score[None, None], k, 1, nms_radius)[0, 0]
    peak = (score >= local_max) & (score > det_thres * score.max())
    yy = torch.arange(H, device=gray.device)[:, None]
    xx = torch.arange(W, device=gray.device)[None, :]
    interior = (xx >= 4) & (xx < W - 4) & (yy >= 4) & (yy < H - 4)
    masked = torch.where(peak & interior, score,
                         torch.full_like(score, -float("inf")))
    top, idx = top_k(masked.reshape(-1), max_pts)
    valid = top > -float("inf")
    xy = torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)
    return xy, torch.where(valid, top, torch.zeros_like(top)), valid


def _as_image(image, device=None) -> torch.Tensor:
    img = torch.as_tensor(np.asarray(image) if not isinstance(
        image, torch.Tensor) else image, device=device)
    return img.to(torch.float32)


def shi_tomasi_keypoints(image, max_pts: int = 512, det_thres: float = 0.005,
                         nms_radius: int = 2):
    """Fixed-shape corner detector (minimum eigenvalue of the 5×5 box-
    smoothed structure tensor of Sobel gradients, local-max NMS, a 4-px
    border), on the image's device. ``image`` (H, W) or (H, W, 3) in [0,
    1] → ``(xy (max_pts, 2), score (max_pts,), valid (max_pts,))``, (x, y)
    pixels sorted by decreasing corner strength."""
    img = _as_image(image)
    if img.dim() == 3:
        img = to_gray(img)
    return _shi_tomasi_core(img, max_pts, nms_radius, det_thres)


def sift_keypoints(image, max_pts: int = 512):
    """OpenCV SIFT keypoints (the reference's ``sift`` extractor), on the
    host: ``(xy (max_pts, 2) f32, score (max_pts,) f32, valid bool)``
    numpy slots, the strongest responses first."""
    import cv2

    img = (image.detach().cpu().numpy() if isinstance(image, torch.Tensor)
           else np.asarray(image))
    was_uint8 = img.dtype == np.uint8
    if img.ndim == 3:
        img = img.astype(np.float32) @ np.array(_GRAY, np.float32)
    if was_uint8:
        img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    elif img.dtype != np.uint8:
        img = np.clip(img * 255.0 if img.max() <= 1.0 + 1e-6 else img,
                      0, 255).astype(np.uint8)
    kps = cv2.SIFT_create(nfeatures=int(max_pts)).detect(img, None)
    kps = sorted(kps, key=lambda k: -k.response)[:max_pts]
    xy = np.zeros((max_pts, 2), np.float32)
    score = np.zeros((max_pts,), np.float32)
    valid = np.zeros((max_pts,), bool)
    for i, kp in enumerate(kps):
        xy[i] = kp.pt
        score[i] = kp.response
        valid[i] = True
    return xy, score, valid


def initialize_feature_extractors(max_query_pts: int = 512,
                                  det_thres: float = 0.005,
                                  extractor_method: str = "shi_tomasi",
                                  superpoint=None, aliked=None) -> dict:
    """``+``-joined method string → {name: extractor(image) → (xy, score,
    valid)}: ``aliked`` (needs an ``ALIKED`` model), ``sp``/``superpoint``
    (needs a ``SuperPoint`` model), ``sift`` and ``shi_tomasi``. A method
    without its weights, or unknown, warns and is dropped; an empty result
    falls back to shi_tomasi."""
    extractors = {}
    for method in str(extractor_method).lower().split("+"):
        method = method.strip()
        if method == "aliked":
            if aliked is None:
                log.warning("aliked extractor requested but no weights "
                            "provided — ignoring")
                continue
            from skix_torch.perception.aliked import aliked_keypoints

            extractors["aliked"] = partial(aliked_keypoints, aliked,
                                           max_pts=max_query_pts,
                                           det_thres=det_thres)
        elif method in ("sp", "superpoint"):
            if superpoint is None:
                log.warning("superpoint extractor requested but no weights "
                            "provided — ignoring")
                continue
            from skix_torch.perception.superpoint import superpoint_keypoints

            extractors["sp"] = partial(superpoint_keypoints, superpoint,
                                       max_pts=max_query_pts,
                                       det_thres=det_thres)
        elif method == "sift":
            extractors["sift"] = partial(sift_keypoints, max_pts=max_query_pts)
        elif method == "shi_tomasi":
            extractors["shi_tomasi"] = partial(
                shi_tomasi_keypoints, max_pts=max_query_pts,
                det_thres=det_thres)
        else:
            log.warning("unknown feature extractor %r, ignoring", method)
    if not extractors:
        extractors["shi_tomasi"] = partial(
            shi_tomasi_keypoints, max_pts=max_query_pts, det_thres=det_thres)
    return extractors


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def extract_keypoints(image, extractors: dict) -> np.ndarray:
    """The union of every extractor's valid keypoints on one image, rounded
    to pixels: ``(N, 2)`` float32 on the host, N data-dependent."""
    parts = []
    for fn in extractors.values():
        xy, _score, valid = fn(image)
        parts.append(np.round(_np(xy)[_np(valid)]))
    return (np.concatenate(parts, axis=0).astype(np.float32)
            if parts else np.zeros((0, 2), np.float32))


# ---------------------------------------------------------------------------
# query-frame ranking
# ---------------------------------------------------------------------------
def farthest_point_sampling(distance_matrix, num_samples: int,
                            start_index: int = 0) -> list[int]:
    """The reference's farthest-point sampling over a frame distance
    matrix (argmax: the lowest index on ties)."""
    dm = np.maximum(np.asarray(distance_matrix, np.float64), 0.0)
    n = dm.shape[0]
    selected = [int(start_index)]
    check = dm[selected].reshape(-1)
    while len(selected) < num_samples:
        farthest = int(np.argmax(check))
        selected.append(farthest)
        check = dm[farthest].copy()
        check[selected] = 0.0
        if len(selected) == n:
            break
    return selected


def rank_frames_by_similarity(feats, query_frame_num: int,
                              spatial_similarity: bool = False) -> list[int]:
    """``query_frame_num`` frame indices: the most-connected frame first,
    then farthest-point samples. ``feats`` (S, D) per-frame descriptors, or
    (S, P, D) patch tokens with ``spatial_similarity`` (normalized over the
    token axis, as the reference does)."""
    f = np.asarray(feats, np.float64)
    if spatial_similarity:
        fn = f / (np.linalg.norm(f, axis=1, keepdims=True) + 1e-12)
        sim = np.einsum("spd,tpd->pst", fn, fn).mean(axis=0)
    else:
        fn = f / (np.linalg.norm(f, axis=-1, keepdims=True) + 1e-12)
        sim = fn @ fn.T
    distance = 100.0 - sim
    sim = sim.copy()
    np.fill_diagonal(sim, -100.0)
    most_common = int(np.argmax(sim.sum(axis=1)))
    return farthest_point_sampling(distance, query_frame_num, most_common)


def calculate_index_mappings(query_index: int, n: int) -> np.ndarray:
    """The order that swaps [query_index] and [0] (its own inverse)."""
    order = np.arange(n)
    order[0] = query_index
    order[query_index] = 0
    return order


# ---------------------------------------------------------------------------
# track prediction
# ---------------------------------------------------------------------------
class SfmTracks(NamedTuple):
    tracks: np.ndarray        # (S, P, 2) pixel positions
    vis_scores: np.ndarray    # (S, P) in [0, 1]
    confs: Optional[np.ndarray]      # (P,) point-map confidence at query
    points_3d: Optional[np.ndarray]  # (P, 3) unprojected points at query
    colors: np.ndarray        # (P, 3) uint8


def _tracks_for_query(track_model, images, images_np, features, query_index,
                      *, extractors, chunk, conf=None, points_3d=None,
                      conf_thresh=1.2, min_conf_keep=512, rng=None,
                      timer=None):
    """One query frame → (tracks (S, Nq, 2), vis, confs, p3d, colors)."""
    timer = timer or StageTimer()
    S, H, W = images_np.shape[:3]
    xy = extract_keypoints(images[query_index], extractors)
    if len(xy) == 0:
        return None
    if rng is not None:
        xy = xy[rng.permutation(len(xy))]

    ixy = np.clip(np.round(xy).astype(np.int64), 0, [W - 1, H - 1])
    colors = (images_np[query_index][ixy[:, 1], ixy[:, 0]]
              * 255.0).astype(np.uint8)
    if colors.ndim == 1:  # grayscale input
        colors = np.repeat(colors[:, None], 3, axis=1)

    q_conf = q_p3d = None
    if conf is not None and points_3d is not None:
        cmap = np.asarray(conf)
        if cmap.ndim == 4:      # (S, 1, H, W) reference layout
            cmap = cmap[:, 0]
        pmap = np.asarray(points_3d)
        ch, cw = cmap.shape[-2:]
        sx, sy = cw / W, ch / H
        qx = np.clip(np.round(xy[:, 0] * sx).astype(np.int64), 0, cw - 1)
        qy = np.clip(np.round(xy[:, 1] * sy).astype(np.int64), 0, ch - 1)
        q_conf = cmap[query_index][qy, qx]
        q_p3d = pmap[query_index][qy, qx]
        keep = q_conf > conf_thresh
        if keep.sum() > min_conf_keep:
            xy, colors = xy[keep], colors[keep]
            q_conf, q_p3d = q_conf[keep], q_p3d[keep]

    # the query frame to position 0, on the device, so that the head's t=0
    # anchor is the query
    order = calculate_index_mappings(query_index, S)
    dev = features[0].device
    order_idx = torch.as_tensor(order, device=dev)
    taps = tuple(f.index_select(0, order_idx)[None] for f in features)
    with timer.span("track_features", dev.type == "cuda"), torch.no_grad():
        fmaps = track_model.features(taps)

    # fixed-size chunks; query_valid keeps the pads out of the space attention
    n = len(xy)
    tracks_parts, vis_parts = [], []
    for s in range(0, n, chunk):
        part = xy[s:s + chunk]
        m = len(part)
        q = torch.as_tensor(np.concatenate(
            [part, np.zeros((chunk - m, 2), np.float32)], 0), device=dev)[None]
        qv = torch.as_tensor(np.arange(chunk) < m, device=dev)[None]
        with timer.span("track_chunk", dev.type == "cuda"), torch.no_grad():
            coords_list, vis, _conf = track_model.track(fmaps, q, qv)
            tracks_parts.append(_np(coords_list[-1][0])[:, :m])
            vis_parts.append(_np(vis[0])[:, :m])
    tracks = np.concatenate(tracks_parts, axis=1)   # (S, n, 2)
    vis = np.concatenate(vis_parts, axis=1)
    return tracks[order], vis[order], q_conf, q_p3d, colors


def predict_tracks(track_model, images, features, *, conf=None,
                   points_3d=None, max_query_pts: int = 512,
                   query_frame_num: int = 3, chunk: int = 256,
                   det_thres: float = 0.005, conf_thresh: float = 1.2,
                   min_conf_keep: int = 512, complete_non_vis: bool = True,
                   min_vis: int = 500, non_vis_thresh: float = 0.1,
                   final_max_pts: int = 2048, seed: int = 0,
                   frame_rank_feats=None, extractor_method: str = "shi_tomasi",
                   superpoint=None, aliked=None,
                   timer: StageTimer | None = None) -> SfmTracks:
    """Point tracks across a clip (the reference's track_predict).

    ``images`` (S, H, W[, 3]) in [0, 1], a tensor on the track head's
    device (or numpy); ``features`` the 4 aggregator tap tensors ``(S, P,
    C)`` on that device (VGGT's ``return_taps``, special tokens included;
    a stacked ``(4, S, P, C)`` tensor works as well). ``frame_rank_feats``
    overrides the per-frame descriptors that rank the query frames (default:
    the token mean of the last tap). ``superpoint``/``aliked`` are port
    models for ``extractor_method``'s learned members. ``timer`` collects
    the spans ``track_features`` (per query frame) and ``track_chunk``."""
    features = tuple(features)
    dev = features[0].device
    images = _as_image(images, dev)
    images_np = _np(images)
    S = images_np.shape[0]
    rng = np.random.default_rng(seed)

    rank_feats = (np.asarray(frame_rank_feats) if frame_rank_feats is not None
                  else _np(features[-1].mean(dim=1)))
    query_frames = rank_frames_by_similarity(rank_feats,
                                             min(query_frame_num, S))
    if 0 in query_frames:
        query_frames.remove(0)
    query_frames = [0, *query_frames]

    extractors = initialize_feature_extractors(
        max_query_pts, det_thres, extractor_method, superpoint, aliked=aliked)
    kw = dict(extractors=extractors, chunk=chunk, conf=conf,
              points_3d=points_3d, conf_thresh=conf_thresh,
              min_conf_keep=min_conf_keep, rng=rng, timer=timer)
    tracks_l, vis_l, conf_l, p3d_l, color_l = [], [], [], [], []
    for q in query_frames:
        out = _tracks_for_query(track_model, images, images_np, features, q,
                                **kw)
        if out is None:
            continue
        t, v, c, p, col = out
        tracks_l.append(t); vis_l.append(v); color_l.append(col)
        if c is not None:
            conf_l.append(c); p3d_l.append(p)

    if complete_non_vis and tracks_l:
        _augment_non_visible_frames(
            track_model, images, images_np, features, tracks_l, vis_l,
            conf_l, p3d_l, color_l, base_kw=kw, min_vis=min_vis,
            non_vis_thresh=non_vis_thresh,
            final_extractors=partial(
                initialize_feature_extractors, final_max_pts, det_thres,
                extractor_method, superpoint, aliked=aliked))

    if not tracks_l:
        # no query frame gave a keypoint (a flat clip): an empty result
        return SfmTracks(np.zeros((S, 0, 2), np.float32),
                         np.zeros((S, 0), np.float32), None, None,
                         np.zeros((0, 3), np.uint8))
    return SfmTracks(np.concatenate(tracks_l, axis=1),
                     np.concatenate(vis_l, axis=1),
                     np.concatenate(conf_l, axis=0) if conf_l else None,
                     np.concatenate(p3d_l, axis=0) if p3d_l else None,
                     np.concatenate(color_l, axis=0))


def _augment_non_visible_frames(track_model, images, images_np, features,
                                tracks_l, vis_l, conf_l, p3d_l, color_l, *,
                                base_kw, min_vis, non_vis_thresh,
                                final_extractors):
    """Re-query low-visibility frames one at a time; if the same frame
    fails twice, one final all-in trial with the bigger keypoint budget,
    then stop (the reference's track_predict semantics)."""
    last_query = -1
    final_trial = False
    kw = dict(base_kw)
    while True:
        vis_array = np.concatenate(vis_l, axis=1)
        sufficient = (vis_array > non_vis_thresh).sum(axis=-1)
        non_vis = np.where(sufficient < min_vis)[0].tolist()
        if not non_vis:
            break
        if non_vis[0] == last_query:
            final_trial = True
            kw = dict(base_kw, extractors=final_extractors())
            query_list = non_vis
        else:
            query_list = [non_vis[0]]
        last_query = non_vis[0]
        for q in query_list:
            out = _tracks_for_query(track_model, images, images_np, features,
                                    q, **kw)
            if out is None:
                continue
            t, v, c, p, col = out
            tracks_l.append(t); vis_l.append(v); color_l.append(col)
            if c is not None:
                conf_l.append(c); p3d_l.append(p)
        if final_trial:
            break
