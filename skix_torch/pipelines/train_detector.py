"""Stage CLI: train the SAM3 promptable detector on COCO-format data.

Port of ``skix/pipelines/train_detector.py``: the fixed-shape COCO loader
(:mod:`skix_torch.data`), the detector with its DAC one-to-many queries and
per-layer aux scores, the matched losses (``sam3_detection_loss`` with the
IoU-aware BCE and presence terms, ``sam3_mask_loss`` on the full grid), and
the ``simple`` optimizer scheme: global-norm clipping, then AdamW with a
cosine-decayed learning rate, as optax computes them. It writes the same
files: ``sam3_detector_{step:06d}.npz`` (skix's flat flax ``params`` npz,
through the inverse weight bridge) and ``final_eval.json``.

On the card every attention call that skix sends to a Pallas kernel
launches a Hopper kernel, forward and backward: the 28 window blocks K2
and K5, the 4 global blocks and the 6 fusion-encoder self-attentions K1
(with its lse output) and K3 + K4.

Run: ``python -m skix_torch.pipelines.train_detector coco_json=...`` (the
card), or ``main({... "device": "cpu"})`` with ``preset: tiny``.

Still to port, each raising ``NotImplementedError``: the ``sam3`` optimizer
scheme (``skix/models/optim.py``), exact matching (``loss.exact_match``)
and the PointRend mask loss (``loss.mask_points``).
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from skix_torch.config import cli_main
from skix_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

_SAM3_OPTIM_SLICE = ("optim.scheme=sam3 (skix/models/optim.py: inverse-sqrt "
                     "LR, backbone LR, layer decay) comes with a later "
                     "training slice of the port")


def build_detector(cfg, device=None):
    """The configured ``Sam3Detector`` (``preset`` full or tiny, ``model``
    overrides) on ``device``, uninitialised. It has the ``null_prompt``
    token: skix's stage initialises and trains the detector without a text
    prompt."""
    from skix_torch.tracking.sam3_detector import Sam3Detector

    preset = str(cfg.get("preset", "tiny"))
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in dict(cfg.get("model", {}) or {}).items()}
    ctor = Sam3Detector.full_size if preset == "full" else Sam3Detector.tiny
    with torch.device("meta"):
        model = ctor(null_prompt=True, **kw)
    return model.to_empty(device=device or "cpu")


def evaluate_train_ap(model, loader, max_batches: int = 8,
                      iou_threshold: float = 0.5) -> float:
    """Class-agnostic box AP@iou on (deterministic) loader batches."""
    from skix_torch.metrics.detection_eval import average_precision
    from skix_torch.tracking.matcher import cxcywh_to_xyxy

    dev = next(model.parameters()).device
    S = loader.image_size
    pb, ps, gb = [], [], []
    with torch.no_grad():
        for bi, batch in enumerate(loader.epoch()):
            if bi >= max_batches:
                break
            imgs = torch.as_tensor(batch["images"], device=dev).to(
                torch.float32) / 255.0
            out = model(imgs)
            boxes = cxcywh_to_xyxy(out.boxes_cxcywh).cpu().numpy() * S
            scores = 1 / (1 + np.exp(-out.scores.cpu().numpy()))
            for b in range(imgs.shape[0]):
                pb.append(boxes[b])
                ps.append(scores[b])
                gb.append(batch["boxes"][b][batch["valid"][b]])
    return float(average_precision(pb, ps, gb, iou_threshold=iou_threshold))


def cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0):
    """``optax.cosine_decay_schedule``: the learning rate at update count
    ``count`` (the count before the update), in float32 as optax computes
    it."""
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(min(count, decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay_steps),
                                             dtype=f32))
        return float(f32(init_value) * ((f32(1) - f32(alpha)) * cosine
                                        + f32(alpha)))

    return schedule


class SimpleOptimizer:
    """skix's ``simple`` scheme, ``optax.chain(clip_by_global_norm(clip),
    adamw(cosine_decay_schedule(lr, steps, alpha=0.05), weight_decay=wd))``,
    on a module's parameters.

    Clipping is written by hand, as optax does it: the gradients become
    ``g / norm * clip`` only when the global norm is at least ``clip``
    (``torch.nn.utils.clip_grad_norm_`` scales by ``clip / (norm + 1e-6)``
    whenever it clips). ``torch.optim.AdamW`` given the schedule's rate at
    each step is optax's adamw: eps 1e-8 outside the square root, weight
    decay on every parameter, its ``p·(1 − lr·wd)`` being optax's
    ``−lr·wd·p``."""

    def __init__(self, params, lr: float, steps: int, weight_decay: float,
                 clip: float):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = cosine_decay(lr, steps, alpha=0.05)
        self.clip = clip
        self.count = 0
        self.opt = torch.optim.AdamW(self.params, lr=self.schedule(0),
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=weight_decay)

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def step(self):
        # a parameter the loss does not reach (the neck's 0.5× level) has a
        # zero gradient in jax, and optax still decays it
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = float(torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads))))
        if not norm < self.clip:
            torch._foreach_div_(grads, norm)
            torch._foreach_mul_(grads, self.clip)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1
        return norm


def build_optimizer(cfg, model, steps: int) -> SimpleOptimizer:
    """The configured optimizer; only ``optim.scheme: simple`` is ported."""
    ocfg = dict(cfg.get("optim", {}) or {})
    clip = float(cfg.get("grad_clip", ocfg.get("grad_clip", 1.0)))
    if str(ocfg.get("scheme", "simple")) == "sam3":
        raise NotImplementedError(_SAM3_OPTIM_SLICE)
    return SimpleOptimizer(model.parameters(), float(cfg.get("lr", 1e-4)),
                           steps, float(cfg.get("weight_decay", 1e-4)), clip)


def make_loss_fn(model, cfg, size: int):
    """skix's ``loss_fn``: ``batch`` (dict of tensors on the model's device)
    → ``(loss, det, msk)``."""
    from skix_torch.tracking.matcher import sam3_detection_loss, sam3_mask_loss

    apply_dac = bool(cfg.get("dac", True))
    mask_w = float(cfg.get("mask_weight", 1.0))
    lcfg = dict(cfg.get("loss", {}) or {})
    cls_kind = str(lcfg.get("cls", "focal"))
    w_class = float(lcfg.get("w_class", 20.0 if cls_kind == "iabce" else 1.0))
    w_presence = float(lcfg.get("w_presence",
                                20.0 if cls_kind == "iabce" else 0.0))
    exact = bool(lcfg.get("exact_match", False))
    mask_points = lcfg.get("mask_points")
    mask_points = int(mask_points) if mask_points else None

    def loss_fn(batch):
        imgs = batch["images"].to(torch.float32) / 255.0
        out = model(imgs, apply_dac=apply_dac, with_aux_scores=True)
        b = batch["boxes"]
        gt = torch.stack([(b[..., 0] + b[..., 2]) / 2,
                          (b[..., 1] + b[..., 3]) / 2,
                          b[..., 2] - b[..., 0],
                          b[..., 3] - b[..., 1]], -1) / size
        det = sam3_detection_loss(out, gt, batch["valid"], exact=exact,
                                  cls=cls_kind, w_class=w_class,
                                  w_presence=w_presence)
        msk = sam3_mask_loss(out, gt, batch["masks"], batch["valid"],
                             exact=exact, num_sample_points=mask_points)
        return det + mask_w * msk, det, msk

    return loss_fn


def batch_to(batch: dict, device) -> dict:
    """A collated numpy batch as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


class TrainRun(NamedTuple):
    model: torch.nn.Module   # the trained detector
    result: dict             # what final_eval.json holds
    steps: list              # per step: seconds of data, forward, backward,
    #                          optimizer (device work synchronised), loss


@cli_main("train_detector")
def main(cfg) -> TrainRun:
    logging.basicConfig(level=logging.INFO)
    from skix_torch.convert import (flax_to_state_dict, load_into,
                                    state_dict_to_flax)
    from skix_torch.data import CocoDataset, CocoLoader
    from skix_torch.pipelines.videopose3d import save_checkpoint

    device = resolve_device(cfg.get("device"))
    on_card = device.type == "cuda"
    model = build_detector(cfg, device)
    size = model.img_size
    ds = CocoDataset(cfg.coco_json, image_root=cfg.get("image_root"))
    mask_stride = int(cfg.get("mask_stride", 4))
    loader = CocoLoader(
        ds, batch_size=int(cfg.get("batch_size", 4)), image_size=size,
        max_objects=int(cfg.get("max_objects", 8)), mask_stride=mask_stride,
        augment=bool(cfg.get("augment", True)),
        scale_range=tuple(cfg.get("scale_range", (0.6, 1.4))),
        seed=int(cfg.get("seed", 0)))

    init_ckpt = cfg.get("init_checkpoint")
    if init_ckpt and Path(init_ckpt).exists():
        with torch.no_grad():
            load_into(model, flax_to_state_dict(init_ckpt))
    else:
        model.init_weights(torch.Generator(device=device).manual_seed(
            int(cfg.get("seed", 0))))

    steps = int(cfg.get("steps", 1000))
    optimizer = build_optimizer(cfg, model, steps)
    loss_fn = make_loss_fn(model, cfg, size)

    ckpt_dir = Path(cfg.paths.checkpoint_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    eval_loader = CocoLoader(ds, batch_size=loader.batch_size,
                             image_size=size, max_objects=loader.max_objects,
                             mask_stride=mask_stride, augment=False)
    ap0 = (evaluate_train_ap(model, eval_loader)
           if bool(cfg.get("eval_ap", True)) else None)
    if ap0 is not None:
        log.info("AP@0.5 before training: %.4f", ap0)

    def clock():
        if on_card:
            torch.cuda.synchronize()
        return time.perf_counter()

    t0 = time.time()
    it = iter(loader)
    loss = torch.tensor(float("nan"))
    per_step = []
    for i in range(steps):
        ta = clock()
        batch = batch_to(next(it), device)
        tb = clock()
        loss, det, msk = loss_fn(batch)
        tc = clock()
        optimizer.zero_grad()
        loss.backward()
        td = clock()
        optimizer.step()
        te = clock()
        per_step.append({"data_s": tb - ta, "forward_s": tc - tb,
                         "backward_s": td - tc, "optimizer_s": te - td})
        if i % int(cfg.get("log_every", 50)) == 0 or i == steps - 1:
            log.info("step %d loss %.4f (det %.4f mask %.4f) %.1fs", i,
                     loss.item(), det.item(), msk.item(), time.time() - t0)
        if (i + 1) % int(cfg.get("ckpt_every", 500)) == 0 or i == steps - 1:
            out_path = ckpt_dir / f"sam3_detector_{i + 1:06d}.npz"
            save_checkpoint(out_path, state_dict_to_flax(model.state_dict()))
            log.info("saved %s", out_path)

    result = {"final_loss": loss.item()}
    if ap0 is not None:
        ap1 = evaluate_train_ap(model, eval_loader)
        log.info("AP@0.5 after training: %.4f (was %.4f)", ap1, ap0)
        result.update({"ap_before": ap0, "ap_after": ap1})
    (ckpt_dir / "final_eval.json").write_text(json.dumps(result))
    return TrainRun(model, result, per_step)


if __name__ == "__main__":
    main()
