"""3D scene rendering: skeleton + camera frusta + frame panels.

Host code (matplotlib on numpy arrays), a copy of ``skix/vis/scene.py``;
nothing of it runs on the card.

Capability parity with the reference's ``SceneVisualizer``
(bundle_adjustment/visualization/scene_visualizer.py and duplicates) and
the camera-geometry plots (triangulation/vis/camera.py).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from skix_torch.vis.skeleton import SkeletonVisualizer, _equalize_3d


def frustum_corners(K: np.ndarray, R: np.ndarray, t: np.ndarray,
                    image_hw, depth: float = 1.0) -> np.ndarray:
    """World-space corners of a camera frustum at the given depth; rows =
    [center, tl, tr, br, bl]."""
    H, W = image_hw
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    corners_px = np.array([[0, 0], [W, 0], [W, H], [0, H]], float)
    rays = np.stack([(corners_px[:, 0] - cx) / fx,
                     (corners_px[:, 1] - cy) / fy,
                     np.ones(4)], axis=-1) * depth
    C = -R.T @ t
    world = (rays - t) @ R  # R.T @ (x - t) for each row
    return np.concatenate([C[None], world], axis=0)


class SceneVisualizer:
    """Composes skeletons and cameras into one 3D plot / video frames."""

    def __init__(self, layout: str = "mhr70"):
        self.skel = SkeletonVisualizer(layout)

    def plot_scene(
        self,
        skeletons: Sequence[np.ndarray],
        cameras: Sequence[dict] = (),
        colors: Optional[Sequence[str]] = None,
        labels: Optional[Sequence[str]] = None,
        image_hw=(1080, 1920),
        title: str = "",
    ) -> np.ndarray:
        """``skeletons``: list of (J,3); ``cameras``: dicts with K,R,t.
        Returns an RGB image."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(7, 7))
        ax = fig.add_subplot(111, projection="3d")
        palette = colors or ["tab:blue", "tab:orange", "tab:green",
                             "tab:red", "tab:purple"]
        allpts = []
        for i, sk in enumerate(skeletons):
            self.skel.draw_3d(ax, sk, color=palette[i % len(palette)],
                              label=None if labels is None else labels[i])
            allpts.append(np.asarray(sk))
        for i, cam in enumerate(cameras):
            fr = frustum_corners(np.asarray(cam["K"]), np.asarray(cam["R"]),
                                 np.asarray(cam["t"]), image_hw,
                                 depth=float(cam.get("depth", 1.0)))
            C = fr[0]
            for corner in fr[1:]:
                ax.plot(*np.stack([C, corner]).T, c="gray", lw=0.8)
            loop = np.concatenate([fr[1:], fr[1:2]], axis=0)
            ax.plot(loop[:, 0], loop[:, 1], loop[:, 2], c="gray", lw=0.8)
            ax.scatter(*C, c="black", marker="^", s=30)
            allpts.append(fr)
        if labels:
            ax.legend(loc="upper right", fontsize=8)
        ax.set_title(title)
        if allpts:
            _equalize_3d(ax, np.concatenate([p.reshape(-1, 3) for p in allpts]))
        fig.canvas.draw()
        img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
        plt.close(fig)
        return img

    def render_sequence(self, kpts_seq: np.ndarray, out_path: str | Path,
                        cameras: Sequence[dict] = (), fps: float = 30.0,
                        stride: int = 1) -> None:
        from skix_torch.io.video import write_video

        frames = [self.plot_scene([kpts_seq[t]], cameras,
                                  title=f"frame {t}")
                  for t in range(0, len(kpts_seq), stride)]
        write_video(out_path, np.stack(frames), fps)
