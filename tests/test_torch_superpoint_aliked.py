"""skix_torch's SuperPoint and ALIKED against skix's, on the CPU.

``deform_conv2d`` (with and without the modulation mask), the
align-corners upsample, both forwards and both keypoint extractors, DKD,
SDDH, ``simple_nms`` and ``sample_descriptors``, and both converters on
random state dicts in the reference layouts (trees equal to skix's, and
loaded through ``skix_torch.convert``). float32; limits 1e-5 on maps and
descriptors; keypoints equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_parity import close_scaled, jit0

from skix_torch.convert import flax_to_state_dict, flatten_tree, load_into

rng = np.random.default_rng(777)
# one image and one keypoint budget for every extractor call, so that skix
# compiles each extractor once for the file
IMG = np.kron(rng.random((8, 8, 3)), np.ones((8, 8, 1))).astype(np.float32)
MAX_PTS, DET = 32, 0.005


def _random_state_dict(spec, scale=0.3):
    """Random tensors in a reference layout's shapes; BatchNorm variances
    positive."""
    sd = {}
    for k, shape in spec.items():
        a = rng.normal(size=shape).astype(np.float32)
        if k.endswith("running_var"):
            a = np.abs(a) + 0.5
        elif k.endswith(".weight") and len(shape) == 4:
            a = a / np.sqrt(np.prod(shape[1:])) * (1 / scale)
        sd[k] = torch.as_tensor((a * scale).astype(np.float32))
    return sd


def _same_tree(got, want):
    g, w = flatten_tree(got), flatten_tree(jax.tree.map(np.asarray, want))
    assert g.keys() == w.keys()
    for k in g:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
def test_deform_conv2d(masked):
    from skix.perception.aliked import deform_conv2d as skix_dc
    from skix_torch.perception.aliked import deform_conv2d

    x = rng.normal(size=(2, 6, 7, 3)).astype(np.float32)
    off = (rng.normal(size=(2, 6, 7, 18)) * 1.5).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 4)).astype(np.float32)
    mask = rng.random((2, 6, 7, 9)).astype(np.float32) if masked else None
    want = jit0(lambda *a: skix_dc(*a[:3], mask=a[3]))(x, off, w, mask)
    got = deform_conv2d(torch.as_tensor(x), torch.as_tensor(off),
                        torch.as_tensor(w),
                        mask=None if mask is None else torch.as_tensor(mask))
    close_scaled(got, want, 1e-5)


def test_upsample_align_corners():
    from skix.perception.aliked import upsample_align_corners as skix_up
    from skix_torch.perception.aliked import upsample_align_corners

    x = rng.normal(size=(1, 4, 5, 3)).astype(np.float32)
    close_scaled(upsample_align_corners(torch.as_tensor(x), 9, 11),
                 skix_up(jnp.asarray(x), 9, 11), 1e-6)


@pytest.fixture(scope="module")
def superpoint_pair():
    from skix.perception.superpoint import SuperPoint as SkixSP
    from skix.perception.superpoint import convert_superpoint as skix_conv
    from skix.perception.superpoint import reference_superpoint_spec
    from skix_torch.perception.superpoint import (SuperPoint,
                                                  convert_superpoint)

    sd = _random_state_dict(reference_superpoint_spec())
    tree = convert_superpoint(sd)
    _same_tree(tree, skix_conv(sd))
    model = SuperPoint()
    assert load_into(model, flax_to_state_dict(tree)) == []
    return SkixSP(), tree, model.eval()


def test_superpoint_forward_and_keypoints(superpoint_pair):
    from skix.perception.superpoint import superpoint_keypoints as skix_kp
    from skix_torch.perception.superpoint import superpoint_keypoints

    smodel, tree, model = superpoint_pair
    img = IMG
    scores, desc = jit0(smodel.apply)(tree, jnp.asarray(img)[None])
    with torch.no_grad():
        gs, gd = model(torch.as_tensor(img)[None])
    close_scaled(gs, scores, 1e-5)
    close_scaled(gd, desc, 1e-5)
    want = [np.asarray(a) for a in skix_kp(smodel, tree, img, max_pts=MAX_PTS,
                                           det_thres=DET)]
    got = [a.numpy() for a in superpoint_keypoints(model, img, max_pts=MAX_PTS,
                                                   det_thres=DET)]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[0], want[0])
    close_scaled(got[1], want[1], 1e-5)


def test_simple_nms_and_sample_descriptors():
    from skix.perception.superpoint import sample_descriptors as skix_sd
    from skix.perception.superpoint import simple_nms as skix_nms
    from skix_torch.perception.superpoint import (sample_descriptors,
                                                  simple_nms)

    s = np.round(rng.random((20, 24)), 1).astype(np.float32)   # ties
    np.testing.assert_array_equal(simple_nms(torch.as_tensor(s), 2).numpy(),
                                  np.asarray(skix_nms(jnp.asarray(s), 2)))
    d = rng.normal(size=(5, 6, 16)).astype(np.float32)
    xy = rng.uniform(0, 47, (9, 2)).astype(np.float32)
    close_scaled(sample_descriptors(torch.as_tensor(d), xy),
                 skix_sd(jnp.asarray(d), jnp.asarray(xy)), 1e-5)


@pytest.fixture(scope="module")
def aliked_pair():
    from skix.perception.aliked import ALIKED as SkixALIKED
    from skix.perception.aliked import convert_aliked as skix_conv
    from skix.perception.aliked import reference_aliked_spec
    from skix_torch.perception.aliked import ALIKED, convert_aliked

    name = "aliked-t16"
    sd = _random_state_dict(reference_aliked_spec(name))
    backbone, sddh = convert_aliked(sd, name)
    want_b, want_s = skix_conv(sd, name)
    _same_tree(backbone, want_b)
    _same_tree(sddh, want_s)
    model = ALIKED(name)
    assert load_into(model, flax_to_state_dict(backbone)) == []
    return SkixALIKED(model_name=name), backbone, sddh, model.eval()


def test_aliked_forward_and_keypoints(aliked_pair):
    from skix.perception.aliked import aliked_keypoints as skix_kp
    from skix_torch.perception.aliked import aliked_keypoints

    smodel, backbone, _sddh, model = aliked_pair
    img = IMG
    feat, score = jit0(smodel.apply)(backbone, jnp.asarray(img)[None])
    with torch.no_grad():
        gf, gs = model(torch.as_tensor(img)[None])
    close_scaled(gf, feat, 1e-5)
    close_scaled(gs, score, 1e-5)
    want = [np.asarray(a) for a in skix_kp(smodel, backbone, img,
                                           max_pts=MAX_PTS, det_thres=DET)]
    got = [a.numpy() for a in aliked_keypoints(model, img, max_pts=MAX_PTS,
                                               det_thres=DET)]
    np.testing.assert_array_equal(got[2], want[2])
    close_scaled(got[0], want[0], 1e-4)
    close_scaled(got[1], want[1], 1e-5)


def test_dkd_and_sddh(aliked_pair):
    from skix.perception.aliked import SDDH as SkixSDDH
    from skix.perception.aliked import dkd_detect as skix_dkd
    from skix_torch.perception.aliked import SDDH, dkd_detect

    _smodel, _backbone, sddh, _model = aliked_pair
    s = rng.random((24, 28)).astype(np.float32)
    want = jit0(lambda m: skix_dkd(m, 20, 0.5))(s)
    got = dkd_detect(torch.as_tensor(s), 20, 0.5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    close_scaled(got[0], want[0], 1e-5)
    close_scaled(got[1], want[1], 1e-5)

    fmap = rng.normal(size=(12, 14, 64)).astype(np.float32)
    kp = rng.uniform(0, 13, (7, 2)).astype(np.float32)
    want = jit0(SkixSDDH(64).apply)(sddh, fmap, kp)
    head = SDDH(64)
    assert load_into(head, flax_to_state_dict(sddh)) == []
    with torch.no_grad():
        close_scaled(head(torch.as_tensor(fmap), torch.as_tensor(kp)), want,
                     1e-5)


def test_extractor_union_with_learned_models(superpoint_pair, aliked_pair):
    """``sp+aliked+shi_tomasi``: the union of the three extractors'
    keypoints, the port's as skix's."""
    from skix.perception.sfm_tracks import extract_keypoints as skix_ek
    from skix.perception.sfm_tracks import (
        initialize_feature_extractors as skix_init)
    from skix_torch.perception.sfm_tracks import (
        extract_keypoints, initialize_feature_extractors)

    ssp, sp_tree, sp, = superpoint_pair
    sal, al_tree, _, al = aliked_pair
    method = "sp+aliked+shi_tomasi"
    want = skix_ek(IMG, skix_init(MAX_PTS, DET, method, (ssp, sp_tree),
                                  aliked=(sal, al_tree)))
    got = extract_keypoints(IMG, initialize_feature_extractors(
        MAX_PTS, DET, method, sp, aliked=al))
    np.testing.assert_array_equal(got, want)
