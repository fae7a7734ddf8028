"""Stage CLI: supervised training of the 2D→3D lifter, with checkpoints
and resume.

Port of ``skix/pipelines/train_lifter.py`` (the reference VideoPose3D
``run.py:489-948``) over ``configs/train_lifter.yaml``: Adam with the
per-epoch exponential decay, the MPJPE objective, chunked flip-augmented
batches (:class:`~skix_torch.models.generators.ChunkedGenerator`), a
checkpoint every epoch carrying the optimizer and the generator's RNG
state, and ``resume`` restoring all of it.

The one file that differs from skix's: skix writes the parameter part of
a checkpoint with orbax (a directory ``epoch_NNNN``); the port writes
``epoch_NNNN.npz`` in the flat flax-path layout of
``pipelines.videopose3d.save_checkpoint``: ``params/...``,
``batch_stats/...``, Adam's moments ``opt_state/mu/...`` and
``opt_state/nu/...``, ``opt_state/count`` and ``step``. It resumes from
that file. ``epoch_NNNN_meta.json`` (the epoch and the generator's RNG
state) is skix's.

Run: ``python -m skix_torch.pipelines.train_lifter paths.data_root=...
paths.checkpoint_dir=...`` (the card), or ``main({... "device": "cpu"})``.
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


def _encode_rng(state: dict) -> dict:
    out = dict(state)
    st = dict(out.get("state", {}))
    for k, v in st.items():
        if isinstance(v, np.ndarray):
            st[k] = v.tolist()
    out["state"] = st
    return out


def _decode_rng(state: dict) -> dict:
    out = dict(state)
    st = dict(out.get("state", {}))
    if "key" in st and isinstance(st["key"], list):
        st["key"] = np.asarray(st["key"], np.uint32)
    out["state"] = st
    return out


def _param_tree(model, tensors) -> dict:
    """``tensors`` (one per parameter of ``model``, in order) as the flax
    tree of the parameters' paths."""
    from skix_torch.convert import state_dict_to_flax

    names = [n for n, _ in model.named_parameters()]
    return state_dict_to_flax(dict(zip(names, tensors)))["params"]


def save_checkpoint(ckpt_dir: Path, epoch: int, state, gen_rng_state) -> Path:
    """``epoch_NNNN.npz`` (parameters, BatchNorm statistics, Adam's moments
    and count, the step) and ``epoch_NNNN_meta.json``."""
    from skix_torch.convert import state_dict_to_flax
    from skix_torch.pipelines.videopose3d import save_checkpoint as save_npz

    ckpt_dir.mkdir(parents=True, exist_ok=True)
    mu, nu = state.optimizer.state()
    path = ckpt_dir / f"epoch_{epoch:04d}.npz"
    save_npz(path, {
        **state_dict_to_flax(state.model.state_dict()),
        "opt_state": {"mu": _param_tree(state.model, mu),
                      "nu": _param_tree(state.model, nu),
                      "count": np.int32(state.optimizer.count)},
        "step": np.int32(state.step)})
    (ckpt_dir / f"epoch_{epoch:04d}_meta.json").write_text(json.dumps({
        "epoch": epoch, "gen_rng_state": _encode_rng(gen_rng_state)}))
    return path


def latest_checkpoint(ckpt_dir: Path):
    """``(npz path, meta)`` of the newest epoch, or None."""
    metas = sorted(ckpt_dir.glob("epoch_*_meta.json"))
    if not metas:
        return None
    meta = json.loads(metas[-1].read_text())
    return metas[-1].with_name(metas[-1].name.replace("_meta.json", ".npz")), \
        meta


def restore_checkpoint(path: Path, state):
    """The model's weights and statistics, the optimizer's moments and
    count, and the step from ``path`` into ``state``."""
    from skix_torch.convert import flax_to_state_dict, load_into
    from skix_torch.pipelines.videopose3d import load_checkpoint

    tree = load_checkpoint(path)
    model = state.model
    with torch.no_grad():
        load_into(model, flax_to_state_dict(
            {"params": tree["params"], "batch_stats": tree["batch_stats"]}))
    names = [n for n, _ in model.named_parameters()]
    mu = flax_to_state_dict({"params": tree["opt_state"]["mu"]})
    nu = flax_to_state_dict({"params": tree["opt_state"]["nu"]})
    state.optimizer.load_state([mu[n] for n in names], [nu[n] for n in names],
                               int(tree["opt_state"]["count"]))
    return state._replace(step=int(tree["step"]))


def load_training_data(data_root: Path):
    """Per-clip normalized 2D and 3D pairs from ``<clip>.npz`` files holding
    ``pose_2d (T, 17, 2)`` and ``pose_3d (T, 17, 3)``."""
    p2, p3 = [], []
    for f in sorted(data_root.rglob("*.npz")):
        with np.load(f, allow_pickle=False) as z:
            if "pose_2d" in z and "pose_3d" in z:
                p2.append(np.asarray(z["pose_2d"], np.float32))
                p3.append(np.asarray(z["pose_3d"], np.float32))
    return p2, p3


class LifterRun(NamedTuple):
    state: object           # the final TrainState
    epochs: list            # per epoch run: epoch, mpjpe, steps, seconds


@cli_main("train_lifter")
def main(cfg) -> LifterRun:
    logging.basicConfig(level=logging.INFO)
    from skix_torch.models.generators import ChunkedGenerator
    from skix_torch.models.train import init_state, make_optimizer, train_step
    from skix_torch.models.videopose3d import TemporalLifter

    device = resolve_device(cfg.get("device"))
    p2, p3 = load_training_data(Path(cfg.paths.data_root))
    if not p2:
        raise SystemExit(f"no training clips under {cfg.paths.data_root}")
    model = TemporalLifter(
        filter_widths=tuple(cfg.get("filter_widths", (3, 3, 3, 3, 3))),
        channels=int(cfg.get("channels", 1024)),
        strided=bool(cfg.get("strided", True))).to(device)
    gen = ChunkedGenerator(
        p2, p3, receptive_field=model.rf,
        batch_size=int(cfg.get("batch_size", 128)),
        chunk_length=int(cfg.get("chunk_length", 1)),
        augment=bool(cfg.get("augment", True)),
        seed=int(cfg.get("seed", 0)))
    optimizer = make_optimizer(model.parameters(),
                               lr=float(cfg.get("lr", 1e-3)),
                               lr_decay=float(cfg.get("lr_decay", 0.95)),
                               steps_per_epoch=max(len(gen), 1))
    state = init_state(model, int(cfg.get("seed", 0)), optimizer)

    ckpt_dir = Path(cfg.paths.checkpoint_dir)
    start_epoch = 0
    if bool(cfg.get("resume", False)):
        found = latest_checkpoint(ckpt_dir)
        if found:
            path, meta = found
            state = restore_checkpoint(path, state)
            gen.rng_state = _decode_rng(meta["gen_rng_state"])
            start_epoch = meta["epoch"] + 1
            log.info("resumed from %s (epoch %d)", path, start_epoch)

    def clock():
        if device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    epochs = int(cfg.get("epochs", 60))
    generator = torch.Generator(device=device).manual_seed(1234)
    report = []
    for epoch in range(start_epoch, epochs):
        t0 = clock()
        losses = []
        for x, y in gen.epoch():
            state, loss = train_step(
                state, torch.as_tensor(x, device=device),
                torch.as_tensor(y, device=device), generator)
            losses.append(loss)
        mean_loss = (torch.stack(losses).mean().item() if losses
                     else float("nan"))
        seconds = clock() - t0
        log.info("epoch %d: mpjpe %.4f", epoch, mean_loss)
        save_checkpoint(ckpt_dir, epoch, state, gen.rng_state)
        report.append({"epoch": epoch, "mpjpe": mean_loss,
                       "steps": len(losses), "seconds": seconds})
    log.info("training done (%d epochs)", epochs)
    return LifterRun(state, report)


if __name__ == "__main__":
    main()
