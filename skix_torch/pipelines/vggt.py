"""Stage CLI: VGGT multi-view reconstruction (mode ``multi``).

Port of ``skix/pipelines/vggt.py``. For each person directory of pt
records, every ``frame_stride``-th frame pair (left, right) goes through
VGGT (aggregator + camera head; the DPT heads are off in this mode); the
medianed cameras give the relative pose, the 2D keypoints are triangulated
with DLT and refined by LM bundle adjustment, and
``<out_root>/<person>/multi_view_refined.npz`` is written, with
``vggt_summary.json`` over all persons, and ``vggt_timing.json`` with the
stage's spans (``vggt_forward`` per pair, ending with the host read of the
pose encoding; ``triangulate``; ``bundle_adjust``). A person that fails is
logged and skipped, as in skix; callers that need the result check the
files.

The model runs on ``cfg.device`` (default ``cuda``; ``cpu`` for the tests).
Modes ``single`` and ``sfm`` come with the sfm slice of the port.

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


def build_model(cfg, device):
    """The multi-mode VGGT (no DPT heads), parameters allocated on
    ``device`` and not yet initialized."""
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
                      device="cpu") -> torch.Tensor:
    """Resize + [0,1] normalize a ``(S, H, W, 3)`` uint8 frame set for VGGT:
    ``(S, img_size, img_size, 3)`` float32 on ``device``, as
    ``jax.image.resize(x / 255, ..., "bilinear")`` (two separable
    products with its weight matrices, ``skix_torch.utils.image``; an axis
    already at ``img_size`` is left as it is)."""
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


@cli_main("vggt")
def main(cfg):
    logging.basicConfig(level=logging.INFO)
    mode = str(cfg.get("mode", "single"))
    if mode not in ("single", "multi", "sfm"):
        raise ValueError(f"unknown vggt mode {mode!r} — expected "
                         "'single', 'multi', or 'sfm'")
    if mode != "multi":
        raise NotImplementedError(
            f"vggt mode {mode!r} comes with the sfm slice of the port; "
            "mode 'multi' is ported")
    device = resolve_device(cfg.get("device"))
    model = load_or_init_variables(build_model(cfg, device), cfg)
    out_root = Path(cfg.paths.out_root)
    timer = StageTimer()
    reports = {}
    for person_dir in iter_person_dirs(Path(cfg.paths.pt_root), cfg):
        recs = sorted(person_dir.glob("*.npz")) + sorted(person_dir.glob("*.pt"))
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
