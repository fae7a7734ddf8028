"""skix_torch's side-view crop pipeline and hand-refinement helpers against
skix's, on the CPU: the crop against ``jax.image.scale_and_translate`` at
1e-5 (downscale, upscale, a box across the frame's edge, a padded batch
row), the box, gate and blend helpers, the athlete pick.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_parity import close_scaled

from skix.models import sam3d_body as S
from skix_torch.models import sam3d_body as P

rng = np.random.default_rng(4242)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _close(got, want, tol):
    close_scaled(got, want, tol)


# --------------------------------------------------------------------------
# the crop pipeline
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["downscale", "upscale", "edge_crossing",
                                  "padded_row"])
def test_crop_resize_matches_scale_and_translate(case):
    """Per-frame crops against skix's ``crop_resize``: a box larger than the
    crop (antialiased downscale), a small box (upsampling), a padded square
    box that crosses the frame's edge (renormalized over the in-range
    samples), and a padded batch row (zero frame, center 0, scale 1)."""
    H, W, out = 60, 90, 24
    frames = rng.random((2, H, W, 3)).astype(np.float32)
    boxes = {"downscale": [[10, 5, 70, 55], [0, 0, 90, 60]],
             "upscale": [[40, 20, 52, 30], [5, 5, 13, 17]],
             "edge_crossing": [[-15, -8, 30, 40], [60, 30, 100, 70]]}
    if case == "padded_row":
        frames[1] = 0.0
        c = np.array([[45.0, 30.0], [0.0, 0.0]], np.float32)
        s = np.array([[50.0, 50.0], [1.0, 1.0]], np.float32)
    else:
        c, s = (np.asarray(a) for a in S.bbox_center_scale(
            jnp.asarray(boxes[case], jnp.float32)))
    want = np.stack([np.asarray(S.crop_resize(jnp.asarray(frames[i]), c[i],
                                              s[i], out)) for i in range(2)])
    got = P.crop_resize(_t(frames), _t(c), _t(s), out)
    assert np.isfinite(got.numpy()).all()
    _close(got, want, 1e-5)


def test_center_scale_and_inverse_mapping():
    boxes = rng.uniform(0, 200, (5, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    c, s = S.bbox_center_scale(jnp.asarray(boxes), padding=0.9)
    cp, sp = P.bbox_center_scale(_t(boxes), padding=0.9)
    _close(cp, c, 1e-6)
    _close(sp, s, 1e-6)
    pts = rng.uniform(0, 32, (5, 70, 2)).astype(np.float32)
    want = jax.vmap(S.crop_to_image_coords, in_axes=(0, 0, 0, None))(
        jnp.asarray(pts), c, s, 32)
    _close(P.crop_to_image_coords(_t(pts), cp[:, None], sp[:, None], 32),
           want, 1e-6)


def test_hand_boxes_gate_and_refine():
    from skix.models import mhr as M

    j2 = rng.uniform(0, 256, (3, 70, 2)).astype(np.float32)
    for a, b in zip(S.hand_boxes_from_keypoints(jnp.asarray(j2)),
                    P.hand_boxes_from_keypoints(_t(j2))):
        _close(b, a, 1e-6)
    eul = rng.uniform(-2, 2, (2, 3, 70, 3)).astype(np.float32)
    rots = np.array(M.euler_xyz_to_matrix(jnp.asarray(eul)))
    rots[1, :, 62] = rots[0, :, 62]        # an accepted left wrist
    want = S.wrist_angle_gate(jnp.asarray(rots[0]), jnp.asarray(rots[1]))
    got = P.wrist_angle_gate(_t(rots[0]), _t(rots[1]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:, 0].all()
    body, branch = (rng.normal(size=(3, 108)).astype(np.float32)
                    for _ in range(2))
    acc_l, acc_r = np.array([1, 0, 1], bool), np.array([0, 1, 1], bool)
    _close(P.refine_hands_params(_t(body), _t(branch), torch.tensor(acc_l),
                                 torch.tensor(acc_r)),
           S.refine_hands_params(body, branch, acc_l, acc_r), 0.0)


def test_select_closest_person():
    outs = [{"pred_cam_t": np.array([0.0, 0.0, z], np.float32)}
            for z in (5.0, 3.0, 4.0)]
    for prev in (None, {"pred_cam_t": np.array([0.0, 0.0, 4.1])}):
        assert (P.select_closest_person(outs, prev)
                is outs[[o is S.select_closest_person(outs, prev)
                         for o in outs].index(True)])
    assert P.select_closest_person([]) is None
