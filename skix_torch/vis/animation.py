"""2D input + 3D prediction side-by-side animation.

Host code (matplotlib on numpy arrays), a copy of
``skix/vis/animation.py``; nothing of it runs on the card.

Capability parity with reference VideoPose3D/visualization.py:74
``render_animation`` (matplotlib FuncAnimation 2D+3D panel video) and :312
``save_coco3d_gif_multi_view`` — rendered frame-by-frame to mp4 via cv2
(no FuncAnimation dependency, safely headless).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from skix_torch.vis.skeleton import SkeletonVisualizer, _equalize_3d


def render_animation(
    kpts_2d: np.ndarray,          # (T, J, 2) pixel coords
    pred_3d: np.ndarray,          # (T, J, 3)
    out_path: str | Path,
    frames: Optional[np.ndarray] = None,  # (T, H, W, 3) background
    layout: str = "h36m",
    fps: float = 30.0,
    stride: int = 1,
    elev: float = 15.0,
    azim: float = -70.0,
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from skix_torch.io.video import write_video

    skel = SkeletonVisualizer(layout)
    T = len(pred_3d)
    out_frames = []
    for t in range(0, T, stride):
        fig = plt.figure(figsize=(10, 5))
        ax2 = fig.add_subplot(121)
        ax3 = fig.add_subplot(122, projection="3d")
        if frames is not None:
            ax2.imshow(frames[t])
        k2 = np.asarray(kpts_2d[t])
        for a, b in skel.edges:
            if a < len(k2) and b < len(k2):
                ax2.plot([k2[a, 0], k2[b, 0]], [k2[a, 1], k2[b, 1]],
                         c="tab:orange", lw=1.5)
        ax2.scatter(k2[:, 0], k2[:, 1], s=6, c="white",
                    edgecolors="black", linewidths=0.3)
        if frames is None:
            ax2.invert_yaxis()
        ax2.set_title("2D input")
        ax2.axis("off")
        skel.draw_3d(ax3, pred_3d[t])
        ax3.view_init(elev=elev, azim=azim)
        _equalize_3d(ax3, pred_3d[t])
        ax3.set_title("3D prediction")
        fig.tight_layout()
        fig.canvas.draw()
        out_frames.append(np.asarray(fig.canvas.buffer_rgba())[..., :3].copy())
        plt.close(fig)
    write_video(out_path, np.stack(out_frames), fps=fps / stride)
