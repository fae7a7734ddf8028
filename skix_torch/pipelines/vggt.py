"""Stage CLI: VGGT reconstruction, modes ``single``, ``multi`` and ``sfm``.

Port of ``skix/pipelines/vggt.py``:

- ``single`` (the default): every ``frame_stride``-th frame of each
  person's videos through one VGGT forward → per-frame cameras at the
  video's size, ``<out_root>/<person>/<video>_multi_view_3d_info.npz``;
- ``multi``: for each person directory of pt records, every
  ``frame_stride``-th frame pair (left, right) through VGGT; the medianed
  cameras give the relative pose, the 2D keypoints are triangulated with
  DLT and refined by LM bundle adjustment →
  ``<out_root>/<person>/multi_view_refined.npz``;
- ``sfm``: the first ``sfm_max_frames`` strided frames through one VGGT
  forward with both DPT heads, tokens and taps; point tracks from the
  track head over query keypoints (``perception.sfm_tracks``); a COLMAP
  reconstruction gated by visibility, refined by LM bundle adjustment of
  the points and the cameras (``full``, no bones), written as text →
  ``<video>_sfm_tracks.npz`` and ``<video>_sparse/{cameras,images,
  points3D}.txt``.

Single and multi turn the DPT heads off, as skix does. Every mode writes
``vggt_summary.json`` over its items and ``vggt_timing.json`` with the
stage's spans (``vggt_forward``, ending with the host read of its
outputs; ``triangulate``, ``bundle_adjust``; sfm's ``predict_tracks``,
``track_features``, ``track_chunk`` and ``write_colmap``). An item that
fails is logged and skipped, as in skix; callers that need the result
check the files.

The models run on ``cfg.device`` (default ``cuda``; ``cpu`` for the
tests). Weights: ``checkpoint`` (a skix variables npz, else seeded random
weights), ``track_checkpoint`` (a reference ``.pt`` state dict through
``models.vggt_convert.convert_track_head``, or a skix npz, else seeded),
``sfm_superpoint_checkpoint`` and ``sfm_aliked_checkpoint`` (the
reference layouts, ``.pth``/``.pt`` read with ``weights_only=True``, or an
npz of the same keys; without one the extractor is dropped with a
warning, as in skix).

Every numpy → torch boundary casts to float32: skix runs with JAX's x64
off, so its float64 inputs (``np.eye(3)``, the medianed cameras) become
float32 there too.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch

from skix_torch.config import cli_main, iter_person_dirs
from skix_torch.utils.device import resolve_device
from skix_torch.utils.image import bilinear_weights as _resize_weights
from skix_torch.utils.profiling import StageTimer

log = logging.getLogger(__name__)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def build_model(cfg, device, heads: bool = True):
    """The configured VGGT, parameters allocated on ``device`` and not yet
    initialized; its DPT heads as ``cfg.enable_depth``/``enable_point``
    (skix's default: on) unless ``heads`` is False."""
    from skix_torch.models.vggt import VGGT

    dtype = (torch.bfloat16 if str(cfg.get("dtype", "bfloat16")) == "bfloat16"
             else torch.float32)
    with torch.device("meta"):
        model = VGGT(
            img_size=int(cfg.get("img_size", 518)),
            patch_size=int(cfg.get("patch_size", 14)),
            embed_dim=int(cfg.get("embed_dim", 1024)),
            depth=int(cfg.get("depth", 24)),
            num_heads=int(cfg.get("num_heads", 16)),
            intermediate_layer_idx=tuple(cfg.get("intermediate_layer_idx",
                                                 (4, 11, 17, 23))),
            enable_depth=heads and bool(cfg.get("enable_depth", True)),
            enable_point=heads and bool(cfg.get("enable_point", True)),
            dtype=dtype)
    return model.to_empty(device=device)


def load_or_init_variables(model, cfg):
    """Load the skix checkpoint npz named by ``cfg.checkpoint`` into
    ``model``, or, with none, draw random weights in flax's init
    distributions from a generator seeded 0 (smoke mode). Returns the
    model, in eval mode, with its bf16 weights stored in bf16."""
    from skix_torch.convert import flax_to_state_dict, load_into
    from skix_torch.models.layers import cast_to_compute_dtype
    from skix_torch.pipelines.videopose3d import load_checkpoint

    ckpt = cfg.get("checkpoint")
    dev = next(model.parameters()).device
    if ckpt and Path(ckpt).exists():
        with torch.no_grad():
            load_into(model, flax_to_state_dict(load_checkpoint(ckpt)))
    else:
        log.warning("no VGGT checkpoint configured — random init (smoke mode)")
        model.init_weights(torch.Generator(device=dev).manual_seed(0))
    return cast_to_compute_dtype(model).eval()


def preprocess_frames(frames_u8: np.ndarray, img_size: int,
                      device=None) -> torch.Tensor:
    """Resize + [0,1] normalize a ``(S, H, W, 3)`` uint8 frame set for VGGT:
    ``(S, img_size, img_size, 3)`` float32 on ``device`` (the card unless
    the caller asks for another, :func:`resolve_device`), as
    ``jax.image.resize(x / 255, ..., "bilinear")`` (two separable
    products with its weight matrices, ``skix_torch.utils.image``; an axis
    already at ``img_size`` is left as it is)."""
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(frames_u8), device=device).to(torch.float32)
    x = x / 255.0
    H, W = x.shape[1], x.shape[2]
    if H != img_size:
        x = torch.einsum("shwc,hy->sywc", x,
                         _f32(_resize_weights(H, img_size), device))
    if W != img_size:
        x = torch.einsum("shwc,wx->shxc", x,
                         _f32(_resize_weights(W, img_size), device))
    return x


def cameras_from_pose_enc(pose_enc: torch.Tensor, image_hw) -> dict:
    """``pose_enc (S, 9)`` → dict of float32 numpy ``extrinsic``,
    ``intrinsic``, ``R``, ``t``, ``C``."""
    from skix_torch.models.vggt import pose_encoding_to_extri_intri
    from skix_torch.solvers.ba import camera_centers

    extr, K = pose_encoding_to_extri_intri(pose_enc.to(torch.float32)[None],
                                           image_hw)
    extr, K = extr[0], K[0]
    R, t = extr[:, :3, :3], extr[:, :3, 3]
    out = {"extrinsic": extr, "intrinsic": K, "R": R, "t": t,
           "C": camera_centers(R, t)}
    return {k: v.cpu().numpy() for k, v in out.items()}


def process_multi_view(model, rec_left, rec_right, out_dir: Path, cfg,
                       timer: StageTimer | None = None) -> dict:
    """Two-view reconstruction: VGGT cameras per frame pair + DLT of the 2D
    keypoints + LM bundle adjustment; spans go to ``timer``."""
    from skix_torch.geometry.triangulate import triangulate_sequence
    from skix_torch.io.contracts import load_pt_info
    from skix_torch.pipelines.videopose3d import load_2d_keypoints
    from skix_torch.solvers import BAConfig, bundle_adjust

    timer = timer or StageTimer()
    dev = next(model.parameters()).device
    size = int(cfg.get("img_size", 518))
    stride = int(cfg.get("frame_stride", 30))
    src = cfg.get("kpt_source", "detectron2")
    kpts_l, score_l, (H, W) = load_2d_keypoints(str(rec_left), src)
    kpts_r, score_r, (H_r, W_r) = load_2d_keypoints(str(rec_right), src)
    T = min(len(kpts_l), len(kpts_r))
    idxs = np.arange(0, T, stride)

    info_l = load_pt_info(rec_left)
    info_r = load_pt_info(rec_right)
    if info_l.frames is None or info_r.frames is None:
        raise ValueError("multi-view VGGT needs frames stored in the records")

    Rs, ts, Ks = [], [], []
    for i in idxs:
        with timer.span("vggt_forward"), torch.no_grad():
            pair = torch.cat([preprocess_frames(info_l.frames[i][None], size, dev),
                              preprocess_frames(info_r.frames[i][None], size, dev)])
            out = model(pair[None])
            cams = cameras_from_pose_enc(out["pose_enc"][0], (size, size))
        # intrinsics from the VGGT input size to each video's own size
        K = cams["intrinsic"].copy()
        K[0, 0, :] *= W / size
        K[0, 1, :] *= H / size
        K[1, 0, :] *= W_r / size
        K[1, 1, :] *= H_r / size
        Rs.append(cams["R"])
        ts.append(cams["t"])
        Ks.append(K)
    R = np.median(np.stack(Rs), axis=0)    # robust static-camera estimate
    # nearest rotation to the medianed matrices (SVD, det sign corrected)
    u, _, vt = np.linalg.svd(R)
    det = np.linalg.det(u @ vt)
    u[:, :, -1] *= np.sign(det)[:, None]
    R = u @ vt
    t = np.median(np.stack(ts), axis=0)
    K = np.median(np.stack(Ks), axis=0).astype(np.float32)

    # relative pose right w.r.t. left: P_l = K_l [I|0], P_r = K_r [R|t]
    R_rel = (R[1] @ R[0].T).astype(np.float32)
    t_rel = (t[1] - R_rel @ t[0]).astype(np.float32)
    with timer.span("triangulate"):
        X = triangulate_sequence(
            _f32(kpts_l[:T], dev), _f32(kpts_r[:T], dev), _f32(K[0], dev),
            _f32(R_rel, dev), _f32(t_rel, dev), w_a=_f32(score_l[:T], dev),
            w_b=_f32(score_r[:T], dev), K_b=_f32(K[1], dev))

    ba_cfg = BAConfig(mode=str(cfg.get("ba_mode", "pose_only")), method="lm",
                      max_steps=int(cfg.get("ba_max_steps", 30)))
    x2d = np.stack([kpts_l[:T], kpts_r[:T]], axis=1)
    conf = np.stack([score_l[:T], score_r[:T]], axis=1)
    R_pair = np.stack([np.eye(3), R_rel])
    t_pair = np.stack([np.zeros(3), t_rel])
    with timer.span("bundle_adjust"):
        res = bundle_adjust(X, _f32(R_pair, dev), _f32(t_pair, dev),
                            _f32(K, dev), _f32(x2d, dev), _f32(conf, dev),
                            cfg=ba_cfg)
        initial_cost, final_cost = float(res.initial_cost), float(res.final_cost)

    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / "multi_view_refined.npz",
             X3d=res.X.cpu().numpy(), R=res.R.cpu().numpy(),
             t=res.t.cpu().numpy(), K=K[0], K_right=K[1],
             initial_cost=initial_cost, final_cost=final_cost)
    return {"frames": int(T), "vggt_pairs": int(len(idxs)),
            "ba_initial_cost": initial_cost, "ba_final_cost": final_cost}


def _strided_frames(video_path: Path, stride: int, max_frames=None,
                    limit=None) -> tuple[np.ndarray, tuple]:
    """Every ``stride``-th frame of the first ``max_frames`` of a video (at
    most ``limit`` of them), decoded in chunks (the clip is never held
    whole), and the video's (H, W)."""
    from skix_torch.io.video import read_video_chunks

    sel, seen, hw = [], 0, (0, 0)
    for chunk in read_video_chunks(video_path, 64, max_frames):
        hw = chunk.shape[1:3]
        first = (-seen) % stride
        sel.extend(chunk[first::stride])
        seen += len(chunk)
        if limit is not None and len(sel) >= limit:
            break
    sel = sel[:limit] if limit is not None else sel
    return (np.stack(sel) if sel else np.zeros((0, 0, 0, 3), np.uint8)), hw


def process_single_view(model, video_path: Path, out_dir: Path, cfg,
                        timer: StageTimer | None = None) -> dict:
    """Every Nth frame batched through VGGT → per-frame cameras npz, the
    intrinsics rescaled from the VGGT input to the video's size."""
    timer = timer or StageTimer()
    dev = next(model.parameters()).device
    stride = int(cfg.get("frame_stride", 30))
    size = int(cfg.get("img_size", 518))
    sel, (H, W) = _strided_frames(video_path, stride, cfg.get("max_frames"))
    if len(sel) == 0:
        raise ValueError(f"no frames in {video_path}")
    with timer.span("vggt_forward"), torch.no_grad():
        out = model(preprocess_frames(sel, size, dev)[None])
        cams = cameras_from_pose_enc(out["pose_enc"][0], (size, size))
    K = cams["intrinsic"].copy()
    K[:, 0, :] *= W / size
    K[:, 1, :] *= H / size
    cams["intrinsic"] = K
    out_dir.mkdir(parents=True, exist_ok=True)
    npz_path = out_dir / f"{video_path.stem}_multi_view_3d_info.npz"
    np.savez(npz_path, frame_indices=np.arange(len(sel)) * stride, **cams)
    return {"frames_processed": int(len(sel)), "npz": str(npz_path)}


def build_track_head(cfg, dim_in: int, patch_start_idx: int, device):
    """The sfm mode's track head (``track_dim``, ``track_iters``,
    ``track_hidden``, ``track_corr_levels`` capped so that the correlation
    pyramid does not collapse below 1 px), allocated on ``device``."""
    from skix_torch.models.track_head import TrackHead

    size = int(cfg.get("img_size", 518))
    max_levels = max(1, int(np.floor(np.log2(max(size // 2, 1)))) + 1)
    with torch.device("meta"):
        head = TrackHead(
            dim_in=dim_in, patch_size=int(cfg.get("patch_size", 14)),
            features=int(cfg.get("track_dim", 128)),
            iters=int(cfg.get("track_iters", 4)),
            hidden_size=int(cfg.get("track_hidden", 384)),
            corr_levels=min(int(cfg.get("track_corr_levels", 7)), max_levels),
            img_hw=(size, size), patch_start_idx=patch_start_idx)
    return head.to_empty(device=device)


def _torch_state(path) -> dict:
    """A reference checkpoint's state dict: ``.pt``/``.pth`` with
    ``weights_only=True`` (a ``state_dict`` entry if it has one), else an
    npz of the same keys."""
    p = str(path)
    if p.endswith((".pt", ".pth")):
        sd = torch.load(p, map_location="cpu", weights_only=True)
        return sd.get("state_dict", sd) if isinstance(sd, dict) else sd
    with np.load(p) as z:
        return {k: z[k] for k in z.files}


def _load_into_new(model, variables, device):
    from skix_torch.convert import flax_to_state_dict, load_into

    model = model.to(device)
    load_into(model, flax_to_state_dict(variables))
    return model.eval()


def _load_superpoint(ckpt, device):
    """The port's ``SuperPoint`` from a magicleap/lightglue checkpoint, or
    None without one (the extractor is then dropped with a warning)."""
    if not ckpt or not Path(ckpt).exists():
        return None
    from skix_torch.perception.superpoint import SuperPoint, convert_superpoint

    return _load_into_new(SuperPoint(), convert_superpoint(_torch_state(ckpt)),
                          device)


def _load_aliked(ckpt, model_name="aliked-n16", device="cpu"):
    """The port's ``ALIKED`` backbone from a lightglue-layout checkpoint, or
    None without one."""
    if not ckpt or not Path(ckpt).exists():
        return None
    from skix_torch.perception.aliked import ALIKED, convert_aliked

    backbone, _sddh = convert_aliked(_torch_state(ckpt), model_name)
    return _load_into_new(ALIKED(model_name), backbone, device)


def load_or_init_track_head(head, cfg):
    """Reference track-head weights (a ``.pt`` state dict: the
    ``track_head.*`` slice of a VGGT-1B checkpoint, or the tracker's own)
    or a skix npz when ``track_checkpoint`` names one; else flax's init
    distributions from a generator seeded 0 on the head's device."""
    from skix_torch.convert import flax_to_state_dict, load_into
    from skix_torch.pipelines.videopose3d import load_checkpoint

    ckpt = cfg.get("track_checkpoint")
    if ckpt and Path(ckpt).exists():
        with torch.no_grad():
            if str(ckpt).endswith((".pt", ".pth")):
                from skix_torch.models.vggt_convert import load_track_head

                sd = _torch_state(ckpt)
                prefix = ("track_head." if any(k.startswith("track_head.")
                                               for k in sd) else "")
                load_track_head(head, sd, prefix)
            else:
                load_into(head, flax_to_state_dict(load_checkpoint(ckpt)))
    else:
        dev = next(head.parameters()).device
        head.init_weights(torch.Generator(device=dev).manual_seed(0))
    return head.eval()


def process_sfm_tracks(model, video_path: Path, out_dir: Path, cfg,
                       timer: StageTimer | None = None) -> dict:
    """Feed-forward SfM: VGGT cameras and point maps + track-head tracks →
    a COLMAP sparse reconstruction refined by bundle adjustment."""
    from skix_torch.io.colmap_export import (build_reconstruction,
                                             write_reconstruction_text)
    from skix_torch.perception.sfm_tracks import predict_tracks
    from skix_torch.solvers import BAConfig, bundle_adjust

    timer = timer or StageTimer()
    dev = next(model.parameters()).device
    sync = dev.type == "cuda"
    size = int(cfg.get("img_size", 518))
    sel, _hw = _strided_frames(video_path, int(cfg.get("frame_stride", 30)),
                               cfg.get("max_frames"),
                               int(cfg.get("sfm_max_frames", 8)))
    if len(sel) < 2:
        raise ValueError(f"need ≥2 frames for SfM, got {len(sel)}")
    model.return_tokens = model.return_taps = True
    try:
        with timer.span("vggt_forward", sync), torch.no_grad():
            x = preprocess_frames(sel, size, dev)
            out = model(x[None])
            cams = cameras_from_pose_enc(out["pose_enc"][0], (size, size))
            taps = tuple(t[0] for t in out["taps"])          # 4 × (S, P, 2E)
            rank_feats = out["tokens"][0].mean(dim=(1, 2)).cpu().numpy()
            conf = out["world_points_conf"][0].cpu().numpy()
            p3d_map = out["world_points"][0][..., :3].cpu().numpy()
    finally:
        model.return_tokens = model.return_taps = False
    del out

    head = load_or_init_track_head(build_track_head(
        cfg, taps[0].shape[-1], model.aggregator.patch_start_idx, dev), cfg)
    with timer.span("predict_tracks", sync):
        tracks = predict_tracks(
            head, x, taps, conf=conf, points_3d=p3d_map,
            frame_rank_feats=rank_feats,
            max_query_pts=int(cfg.get("sfm_max_query_pts", 512)),
            query_frame_num=int(cfg.get("sfm_query_frames", 3)),
            conf_thresh=float(cfg.get("sfm_conf_thresh", 1.2)),
            min_vis=int(cfg.get("sfm_min_vis", 500)),
            extractor_method=str(cfg.get("sfm_extractor", "sp")),
            superpoint=_load_superpoint(cfg.get("sfm_superpoint_checkpoint"),
                                        dev),
            aliked=_load_aliked(cfg.get("sfm_aliked_checkpoint"),
                                str(cfg.get("sfm_aliked_model", "aliked-n16")),
                                dev),
            timer=timer)
    del taps, x

    extr = np.concatenate([cams["R"], cams["t"][..., None]], axis=-1)
    masks = tracks.vis_scores > float(cfg.get("sfm_vis_thresh", 0.05))
    points3d = (tracks.points_3d if tracks.points_3d is not None
                else np.zeros((tracks.tracks.shape[1], 3)))
    recon_kw = dict(
        image_size=(size, size), masks=masks,
        max_reproj_error=cfg.get("sfm_max_reproj_error"),
        shared_camera=bool(cfg.get("sfm_shared_camera", False)),
        camera_type=str(cfg.get("sfm_camera_type", "SIMPLE_PINHOLE")),
        min_inlier_per_frame=int(cfg.get("sfm_min_inlier_per_frame", 8)),
        points_rgb=tracks.colors)
    recon, valid = build_reconstruction(points3d, extr, cams["intrinsic"],
                                        tracks.tracks, **recon_kw)

    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / f"{video_path.stem}_sfm_tracks.npz",
             tracks=tracks.tracks, vis=tracks.vis_scores,
             colors=tracks.colors, R=cams["R"], t=cams["t"],
             K=cams["intrinsic"],
             **({"points_3d": tracks.points_3d}
                if tracks.points_3d is not None else {}))
    report = {"frames": int(len(sel)),
              "num_tracks": int(tracks.tracks.shape[1]),
              "reconstruction": recon is not None}
    if recon is not None and bool(cfg.get("sfm_ba", True)) and valid.any():
        # LM bundle adjustment of the points and the cameras against the
        # track observations (pycolmap's role in the reference flow)
        ba_cfg = BAConfig(mode=str(cfg.get("sfm_ba_mode", "full")),
                          method="lm", bones=(),
                          max_steps=int(cfg.get("ba_max_steps", 30)))
        with timer.span("bundle_adjust", sync):
            res = bundle_adjust(
                _f32(points3d[valid][None], dev), _f32(extr[:, :, :3], dev),
                _f32(extr[:, :, 3], dev), _f32(cams["intrinsic"], dev),
                _f32(tracks.tracks[:, valid][None], dev),
                _f32(masks[:, valid][None], dev), cfg=ba_cfg)
            pts_ref = points3d.copy()
            pts_ref[valid] = res.X[0].cpu().numpy()
            extr_ref = np.concatenate([res.R.cpu().numpy(),
                                       res.t.cpu().numpy()[..., None]], -1)
            report["ba_initial_cost"] = float(res.initial_cost)
            report["ba_final_cost"] = float(res.final_cost)
        recon, valid = build_reconstruction(pts_ref, extr_ref,
                                            cams["intrinsic"], tracks.tracks,
                                            **recon_kw)
    # refined poses can drop a frame below min_inlier_per_frame
    report["reconstruction"] = recon is not None
    if recon is not None:
        with timer.span("write_colmap"):
            sparse_dir = write_reconstruction_text(
                recon, out_dir / f"{video_path.stem}_sparse")
        report["sparse_dir"] = str(sparse_dir)
        report["valid_tracks"] = int(np.asarray(valid).sum())
    return report


@cli_main("vggt")
def main(cfg):
    logging.basicConfig(level=logging.INFO)
    mode = str(cfg.get("mode", "single"))
    if mode not in ("single", "multi", "sfm"):
        raise ValueError(f"unknown vggt mode {mode!r} — expected "
                         "'single', 'multi', or 'sfm'")
    device = resolve_device(cfg.get("device"))
    # single and multi read only the pose encoding: no DPT heads
    model = load_or_init_variables(
        build_model(cfg, device, heads=mode == "sfm"), cfg)
    out_root = Path(cfg.paths.out_root)
    timer = StageTimer()
    reports = {}
    if mode in ("single", "sfm"):
        fn = process_single_view if mode == "single" else process_sfm_tracks
        for person_dir in iter_person_dirs(Path(cfg.paths.video_root), cfg):
            for video in sorted(person_dir.glob("*.mp4")):
                try:
                    reports[f"{person_dir.name}/{video.stem}"] = fn(
                        model, video, out_root / person_dir.name, cfg, timer)
                except Exception:  # noqa: BLE001
                    log.exception("%s failed", video)
    else:
        for person_dir in iter_person_dirs(Path(cfg.paths.pt_root), cfg):
            recs = (sorted(person_dir.glob("*.npz"))
                    + sorted(person_dir.glob("*.pt")))
            if len(recs) < 2:
                continue
            try:
                reports[person_dir.name] = process_multi_view(
                    model, recs[0], recs[1], out_root / person_dir.name, cfg,
                    timer)
            except Exception:  # noqa: BLE001
                log.exception("person %s failed", person_dir.name)
    out_root.mkdir(parents=True, exist_ok=True)
    (out_root / "vggt_summary.json").write_text(json.dumps(reports, indent=2))
    timer.save(out_root / "vggt_timing.json")
    log.info("vggt %s mode: %d items", mode, len(reports))


if __name__ == "__main__":
    main()
