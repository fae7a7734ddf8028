"""Stage CLI: post-hoc 3D skeleton visualization videos.

Port of ``skix/pipelines/vis_3d_kpt.py`` (reference entry:
vis_3d_kpt/main.py:22, ``--mode fused|prefusion``): per fused
``*_smoothed.npy`` (else every ``*.npy``) under ``paths.in_root``, or per
directory of per-frame SAM-3D-Body results (prefusion, read by
``pipelines/fuse.load_sam3d_sequence``), an mp4 of the 3D skeleton every
``stride``-th frame, drawn by matplotlib on the host
(``vis.SceneVisualizer``). A sequence that fails is logged and skipped,
as in skix: check the videos, not the exit code.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from skix_torch.config import cli_main

log = logging.getLogger(__name__)


def render_fused(npy_path: Path, out_dir: Path, layout: str, fps: float,
                 stride: int) -> None:
    from skix_torch.vis import SceneVisualizer

    kpts = np.load(npy_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    SceneVisualizer(layout).render_sequence(
        kpts, out_dir / f"{npy_path.stem}_3d.mp4", fps=fps, stride=stride)


def render_prefusion(results_dir: Path, out_dir: Path, layout: str,
                     fps: float, stride: int) -> None:
    from skix_torch.pipelines.fuse import load_sam3d_sequence
    from skix_torch.vis import SceneVisualizer

    k3, _ = load_sam3d_sequence(results_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    SceneVisualizer(layout).render_sequence(
        k3, out_dir / f"{results_dir.name}_prefusion_3d.mp4", fps=fps,
        stride=stride)


@cli_main("vis_3d_kpt")
def main(cfg):
    logging.basicConfig(level=logging.INFO)
    mode = str(cfg.get("mode", "fused"))
    root = Path(cfg.paths.in_root)
    out_root = Path(cfg.paths.out_root)
    layout = str(cfg.get("layout", "mhr70"))
    fps = float(cfg.get("fps", 30.0))
    stride = int(cfg.get("stride", 1))
    n = 0
    if mode == "fused":
        for npy in sorted(root.rglob("*_smoothed.npy")) or sorted(root.rglob("*.npy")):
            try:
                render_fused(npy, out_root / npy.parent.name, layout, fps,
                             stride)
                n += 1
            except Exception:  # noqa: BLE001
                log.exception("%s failed", npy)
    elif mode == "prefusion":
        for d in sorted(p for p in root.iterdir() if p.is_dir()):
            try:
                render_prefusion(d, out_root / d.name, layout, fps, stride)
                n += 1
            except Exception:  # noqa: BLE001
                log.exception("%s failed", d)
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    log.info("rendered %d sequences", n)


if __name__ == "__main__":
    main()
