"""Host-side visualization: skeletons, scenes, animations, reprojection
panels, masklet overlays and the 3D BEV renderer (its rasterizer runs on
the tensors' device)."""

from skix_torch.vis.skeleton import SkeletonVisualizer  # noqa: F401
from skix_torch.vis.scene import SceneVisualizer  # noqa: F401
from skix_torch.vis.animation import render_animation  # noqa: F401
from skix_torch.vis.render3d import (  # noqa: F401
    BevVideoRenderer, BevView, Open3DBevVideoRenderer, render_frame)
from skix_torch.vis.masklet import (  # noqa: F401
    masklet_outputs_from_session, render_masklet_frame,
    save_masklet_image, save_masklet_video)
