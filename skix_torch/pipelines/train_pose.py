"""Stage CLI: train the YOLO-class pose detector on COCO-format keypoints.

Port of ``skix/pipelines/train_pose.py`` over ``configs/train_pose.yaml``
(YOLOv8, scale ``s``, 640 px, batch 8 by default): the fixed-shape COCO
loader (:mod:`skix_torch.data`), the detector's training-mode forward (batch
statistics, flax's running-statistics update), ``pose_detection_loss``
(:mod:`skix_torch.models.yolo_loss`), then global-norm clipping and AdamW
with a cosine-decayed learning rate (alpha 0.05) as optax computes them
(:class:`~skix_torch.models.optim.ClippedAdamW`). ``init_checkpoint`` is an
ultralytics ``.pt`` (through ``yolo_pose.convert_ultralytics_pose``) or a
skix ``.npz``; without one the weights are seeded. It writes skix's files:
``yolo_pose_NNNNNN.npz`` (``params`` and ``batch_stats``, which
prepare_dataset's ``yolo_checkpoint`` reads) and ``final_eval.txt``, the
mean keypoint error in pixels.

Run: ``python -m skix_torch.pipelines.train_pose coco_json=...
image_root=...`` (the card), or ``main({... "device": "cpu"})``.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from skix_torch.config import cli_main
from skix_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


def build_model(cfg, device):
    """The configured ``YoloPose`` on ``device`` with the weights of
    ``init_checkpoint`` (an ultralytics ``.pt/.pth``, loaded with
    ``weights_only=True``, or a skix npz), else seeded from ``seed`` with
    flax's distributions."""
    from skix_torch.convert import flax_to_state_dict, load_into
    from skix_torch.models.layers import init_like_flax
    from skix_torch.models.yolo_pose import YoloPose, convert_ultralytics_pose

    scale, version = str(cfg.get("scale", "s")), int(cfg.get("version", 8))
    model = YoloPose(scale=scale, num_classes=int(cfg.get("num_classes", 1)),
                     version=version)
    init_ckpt = cfg.get("init_checkpoint")
    if init_ckpt and Path(init_ckpt).exists():
        if str(init_ckpt).endswith((".pt", ".pth")):
            sd = torch.load(init_ckpt, map_location="cpu", weights_only=True)
            sd = sd.get("model", sd)
            sd = sd.state_dict() if hasattr(sd, "state_dict") else sd
            state = convert_ultralytics_pose(sd, scale=scale, version=version)
            log.info("initialized from ultralytics checkpoint %s", init_ckpt)
        else:
            state = flax_to_state_dict(init_ckpt)
        with torch.no_grad():
            load_into(model, state)
    else:
        init_like_flax(model, torch.Generator().manual_seed(
            int(cfg.get("seed", 0))))
    return model.to(device)


def build_train_step(model, optimizer):
    """skix's jitted step: ``batch`` (dict of tensors on the model's device)
    → ``(loss, terms)``; the model's parameters and statistics are updated
    in place. The backward's convolutions run in full float32, as the
    forward's (cuDNN's TF32 off)."""
    from skix_torch.models.yolo_loss import pose_detection_loss
    from skix_torch.utils.device import full_float32_convs

    def step(batch):
        images = batch["images"].to(torch.float32) / 255.0
        raw, _ = model.train_forward(images)
        total, aux = pose_detection_loss(raw, batch["boxes"],
                                         batch["keypoints"], batch["valid"],
                                         gt_cls=batch["cls"])
        optimizer.zero_grad()
        with full_float32_convs():
            total.backward()
        optimizer.step()
        return total.detach(), {k: v.detach() for k, v in aux.items()}

    return step


def evaluate_keypoint_error(model, loader, max_batches: int = 8) -> float:
    """Mean pixel error of the best-scoring detection's keypoints against
    the largest gt object, over eval batches (augmentation off)."""
    from skix_torch.models.yolo_pose import detect

    dev = next(model.parameters()).device
    model.eval()
    errs = []
    for bi, batch in enumerate(loader.epoch()):
        if bi >= max_batches:
            break
        with torch.no_grad():
            raw = model(torch.as_tensor(batch["images"], device=dev).to(
                torch.float32) / 255.0)
            det = detect(raw, top_k=4, score_threshold=0.0)
        kp = det.keypoints.cpu().numpy()        # (B, K, 17, 3)
        sc = det.scores.cpu().numpy()
        for b in range(kp.shape[0]):
            if not batch["valid"][b, 0]:
                continue
            gt = batch["keypoints"][b, 0]       # the largest object first
            vis = gt[:, 2] > 0
            if not vis.any():
                continue
            best = int(np.argmax(sc[b]))
            d = np.linalg.norm(kp[b, best, :, :2] - gt[:, :2], axis=-1)
            errs.append(float(d[vis].mean()))
    return float(np.mean(errs)) if errs else float("nan")


class PoseRun(NamedTuple):
    model: torch.nn.Module     # the trained detector
    steps: list                # per step: seconds (device work synced), loss
    final_error: float         # final_eval.txt's number (nan without it)


@cli_main("train_pose")
def main(cfg) -> PoseRun:
    logging.basicConfig(level=logging.INFO)
    from skix_torch.convert import state_dict_to_flax
    from skix_torch.data import CocoDataset, CocoLoader
    from skix_torch.models.optim import ClippedAdamW, cosine_decay_schedule
    from skix_torch.pipelines.videopose3d import save_checkpoint

    device = resolve_device(cfg.get("device"))
    ds = CocoDataset(cfg.coco_json, image_root=cfg.get("image_root"))
    size = int(cfg.get("image_size", 640))
    loader = CocoLoader(
        ds, batch_size=int(cfg.get("batch_size", 8)), image_size=size,
        max_objects=int(cfg.get("max_objects", 16)),
        augment=bool(cfg.get("augment", True)),
        scale_range=tuple(cfg.get("scale_range", (0.6, 1.4))),
        seed=int(cfg.get("seed", 0)))
    model = build_model(cfg, device)

    steps = int(cfg.get("steps", 1000))
    optimizer = ClippedAdamW([{
        "params": list(model.parameters()),
        "lr": cosine_decay_schedule(float(cfg.get("lr", 1e-3)), steps, 0.05),
        "weight_decay": float(cfg.get("weight_decay", 5e-4))}],
        float(cfg.get("grad_clip", 10.0)))
    step = build_train_step(model, optimizer)

    def clock():
        if device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    ckpt_dir = Path(cfg.paths.checkpoint_dir)
    t0 = time.time()
    it = iter(loader)
    per_step = []
    for i in range(steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(it).items()}
        ta = clock()
        loss, aux = step(batch)
        per_step.append({"step_s": clock() - ta, "loss": loss.item()})
        if i % int(cfg.get("log_every", 50)) == 0 or i == steps - 1:
            log.info("step %d loss %.4f %s (%.1fs)", i, loss.item(),
                     {k: round(v.item(), 4) for k, v in aux.items()},
                     time.time() - t0)
        if (i + 1) % int(cfg.get("ckpt_every", 500)) == 0 or i == steps - 1:
            out = ckpt_dir / f"yolo_pose_{i + 1:06d}.npz"
            save_checkpoint(out, state_dict_to_flax(model.state_dict()))
            log.info("saved %s", out)

    err = float("nan")
    if bool(cfg.get("final_eval", True)):
        eval_loader = CocoLoader(ds, batch_size=loader.batch_size,
                                 image_size=size,
                                 max_objects=loader.max_objects,
                                 augment=False)
        err = evaluate_keypoint_error(model, eval_loader)
        log.info("final mean keypoint error: %.2f px", err)
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        (ckpt_dir / "final_eval.txt").write_text(f"{err}\n")
    return PoseRun(model, per_step, err)


if __name__ == "__main__":
    main()
