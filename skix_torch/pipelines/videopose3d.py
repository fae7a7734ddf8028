"""Stage CLI: 2D→3D lifting + no-extrinsics two-view fusion.

Port of ``skix/pipelines/videopose3d.py``. Per person: both views' COCO
keypoints are lifted by the temporal-conv lifter (the whole clip in one
batch, with its flipped copy), written as ``<record>_<left|right>.npy``,
fused by ``fuse_pose_no_extrinsics`` into ``<person>_fused.npz`` and
reported in ``<person>_metrics.json``; ``summary.json`` covers every
person. A person that fails is logged and skipped, as in skix: callers
that need the result check the files.

Weights: a skix ``.npz`` (flax variables, ``save_checkpoint``'s layout) or
the reference's torch ``.bin/.pth/.pt`` (``model_pos``); with no
checkpoint the lifter is initialized from a CPU ``torch.Generator``
seeded 0 (skix inits from ``PRNGKey(0)``: these weights differ by design).
The lifter runs on ``cfg.device`` (default ``cuda``).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch

from skix_torch.config import cli_main, iter_person_dirs
from skix_torch.io.contracts import load_pt_info
from skix_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


def load_2d_keypoints(path: str, source: str = "detectron2"):
    """Load (T,17,2) COCO keypoints, (T,17) scores and (H, W) from a record
    file; all float32."""
    info = load_pt_info(path)
    if source == "detectron2":
        kpts, score = info.d2_keypoints, info.d2_keypoints_score
    else:
        kpts, score = info.yolo_keypoints, info.yolo_keypoints_score
    if kpts is None:
        raise ValueError(f"{path} has no {source} keypoints")
    if kpts.shape[-1] == 3 and score is None:
        score = kpts[..., 2]
    kpts = kpts[..., :2]
    if score is None:
        score = np.ones(kpts.shape[:-1], np.float32)
    H, W = info.img_shape
    return np.asarray(kpts, np.float32), np.asarray(score, np.float32), (H, W)


def load_checkpoint(path: str | Path) -> dict:
    """A checkpoint → skix's variables as nested dicts of numpy arrays: a
    skix npz (flat ``"params/a/b/kernel"`` keys, as ``save_checkpoint``
    writes; read with numpy only), or the reference's torch lifter
    checkpoint (``model_pos``, or the state dict itself), loaded with
    ``weights_only=True`` and converted to the lifter's flax layout."""
    from skix_torch.convert import load_flat_npz

    p = Path(path)
    if p.suffix in (".bin", ".pth", ".pt"):
        from skix_torch.convert import state_dict_to_flax
        from skix_torch.models.videopose3d import convert_reference_state_dict

        ckpt = torch.load(p, map_location="cpu", weights_only=True)
        state = ckpt.get("model_pos", ckpt)
        blocks = len({k.split(".")[1] for k in state
                      if k.startswith("layers_conv.")}) // 2
        return state_dict_to_flax(convert_reference_state_dict(
            state, filter_widths=(3,) * (blocks + 1)))
    out: dict = {}
    for k, v in load_flat_npz(p).items():
        node = out
        parts = k.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return out


def save_checkpoint(path: str | Path, variables) -> None:
    """Write nested dicts of arrays (numpy or torch) as the flat
    ``"params/a/b/kernel"`` npz of skix's ``save_checkpoint``: skix's
    ``load_checkpoint`` reads what this writes, and :func:`load_checkpoint`
    reads what skix writes."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        elif hasattr(node, "detach"):
            flat[prefix] = node.detach().cpu().numpy()
        else:
            flat[prefix] = np.asarray(node)

    walk("", variables)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)


def init_lifter(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Seeded initialization, drawn on the CPU so every device gets the same
    weights: convolution kernels normal with variance 1/fan_in (flax's
    lecun normal, untruncated), biases 0, BatchNorm scale 1, bias 0, mean 0,
    variance 1."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 3:
                w = torch.randn(p.shape, generator=g) / np.sqrt(p[0].numel())
                p.copy_(w)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.zero_()
            elif name.endswith("running_var"):
                b.fill_(1.0)
    return model


def build_lifter(cfg, device) -> torch.nn.Module:
    """The stage's lifter (``filter_widths``, ``channels``) in eval mode on
    ``device``, from ``cfg.checkpoint`` or seeded."""
    from skix_torch.convert import flax_to_state_dict, load_into
    from skix_torch.models.videopose3d import TemporalLifter

    model = TemporalLifter(
        filter_widths=tuple(cfg.get("filter_widths", (3, 3, 3, 3, 3))),
        channels=int(cfg.get("channels", 1024)))
    ckpt = cfg.get("checkpoint")
    if ckpt:
        load_into(model, flax_to_state_dict(load_checkpoint(ckpt)))
    else:
        log.warning("no checkpoint configured — seeded init (smoke mode)")
        init_lifter(model)
    return model.to(device).eval()


def lift_clip(kpts_coco_2d: torch.Tensor, img_wh, model,
              flip_augment: bool = True) -> torch.Tensor:
    """COCO-2D pixels ``(T, 17, 2)`` → H36M-3D camera space ``(T, 17, 3)``."""
    from skix_torch.geometry.camera import normalize_screen_coordinates
    from skix_torch.geometry.skeletons import coco_to_h36m
    from skix_torch.models.videopose3d import infer_sequence

    w, h = img_wh
    norm = normalize_screen_coordinates(coco_to_h36m(kpts_coco_2d), w, h)
    return infer_sequence(model, norm, flip_augment=flip_augment)


def run_one_person(cfg, person_dir: Path, out_dir: Path, model):
    from skix_torch.fuse.fuse import fuse_pose_no_extrinsics
    from skix_torch.geometry.skeletons import H36M_BONES, H36M_SYMMETRIC_BONES
    from skix_torch.metrics.evaluation import eval_fused_sequence

    records = sorted(person_dir.glob("*.npz")) + sorted(person_dir.glob("*.pt"))
    if len(records) < 2:
        log.warning("person %s: need 2 views, found %d — skipping",
                    person_dir.name, len(records))
        return None
    device = next(model.parameters()).device
    preds = {}
    for name, p in (("left", records[0]), ("right", records[1])):
        kpts, _, (H, W) = load_2d_keypoints(str(p), cfg.get("kpt_source",
                                                           "detectron2"))
        preds[name] = lift_clip(
            torch.as_tensor(kpts, device=device), (W, H), model,
            flip_augment=bool(cfg.get("test_time_augmentation", True)))
        np.save(out_dir / f"{p.stem}_{name}.npy", preds[name].cpu().numpy())

    T = min(preds["left"].shape[0], preds["right"].shape[0])
    left, right = preds["left"][:T], preds["right"][:T]
    fused, diag = fuse_pose_no_extrinsics(left, right,
                                          tau=float(cfg.get("fuse_tau", 0.08)))
    np.savez(out_dir / f"{person_dir.name}_fused.npz",
             fused=fused.cpu().numpy(),
             mean_disagreement=float(diag["mean_disagreement"]))
    report = eval_fused_sequence(fused, left, right, H36M_BONES,
                                 H36M_SYMMETRIC_BONES)
    report = {k: float(v) for k, v in report.items()}
    (out_dir / f"{person_dir.name}_metrics.json").write_text(
        json.dumps(report, indent=2))
    return report


@cli_main("videopose3d")
def main(cfg):
    logging.basicConfig(level=logging.INFO)
    model = build_lifter(cfg, resolve_device(cfg.get("device")))
    root = Path(cfg.paths.pt_root)
    out_root = Path(cfg.paths.out_root)
    results = {}
    for person_dir in iter_person_dirs(root, cfg):
        out_dir = out_root / person_dir.name
        out_dir.mkdir(parents=True, exist_ok=True)
        try:
            rep = run_one_person(cfg, person_dir, out_dir, model)
            if rep:
                results[person_dir.name] = rep
        except Exception:  # noqa: BLE001 — per-person isolation, as in skix
            log.exception("person %s failed", person_dir.name)
    out_root.mkdir(parents=True, exist_ok=True)
    (out_root / "summary.json").write_text(json.dumps(results, indent=2))
    log.info("done: %d persons", len(results))


if __name__ == "__main__":
    main()
