"""skix_torch's YOLO pose, detect and seg models against skix's, on the CPU
at ultralytics' ``n`` scale and 64 × 64 images, generations 8 and 11.

Each port model draws its weights (``_torch_parity.port_variables``) and
hands skix the same values as flax variables; skix's apply and decode run
as one jitted function per model, compiled once for the file. Limits:
raw heads 1e-4 (absolute, relative to the largest element above 1), the
decoded detections equal in their picks and within 1e-4 (pixels scaled),
the masks' probabilities 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from _torch_parity import close_scaled, compile_once, port_variables

from skix.models import yolo_pose as J
from skix_torch.models import yolo_pose as P

rng = np.random.default_rng(2024)
IMGS = rng.random((1, 64, 64, 3)).astype(np.float32)
KW = dict(top_k=6, score_threshold=0.3, pre_nms_k=40)
_CASES = {}


def _case(kind, version):
    """(port model, skix outputs (raw, detections)) of one model."""
    key = (kind, version)
    if key in _CASES:
        return _CASES[key]
    if kind == "pose":
        jm, pm = J.YoloPose("n", version=version), P.YoloPose("n",
                                                             version=version)
        dec = lambda r: J.detect(r, **KW)                      # noqa: E731
    elif kind == "detect":
        jm = J.YoloDetect("n", num_classes=5, version=version)
        pm = P.YoloDetect("n", num_classes=5, version=version)
        dec = lambda r: J.detect_boxes(r, classes=(0, 2), **KW)  # noqa: E731
    else:
        jm, pm = J.YoloSeg("n", version=version), P.YoloSeg("n",
                                                           version=version)
        dec = lambda r: J.detect_seg(r, **KW)                  # noqa: E731
    variables = port_variables(pm, seed=7 * version + len(kind))

    def run(v, x):
        raw = jm.apply(v, x)
        return raw, dec(raw)

    x = jnp.asarray(IMGS)
    _CASES[key] = (pm.eval(), compile_once(run, variables, x)(variables, x))
    return _CASES[key]


def _port_decode(kind, raw):
    if kind == "pose":
        return P.detect(raw, **KW)
    if kind == "detect":
        return P.detect_boxes(raw, classes=(0, 2), **KW)
    return P.detect_seg(raw, **KW)


@pytest.mark.parametrize("version", [8, 11])
@pytest.mark.parametrize("kind", ["pose", "detect", "seg"])
def test_raw_heads_and_detections_match_skix(kind, version):
    model, (want_raw, want) = _case(kind, version)
    with torch.no_grad():
        raw = model(torch.as_tensor(IMGS))
    for name in want_raw._fields:
        close_scaled(getattr(raw, name).numpy(), getattr(want_raw, name),
                     1e-4)
    got = _port_decode(kind, raw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.any()
    for name in want._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            close_scaled(g, w, 1e-5 if name == "masks" else 1e-4)


@pytest.mark.parametrize("scale,version", [("n", 11), ("s", 11), ("m", 11),
                                           ("s", 8)])
def test_widths_and_heads_match_skix(scale, version):
    """The channel plans and repeat counts (C2PSA heads c // 64, C3k2's
    c3k switch), and the seg proto width, of the published scales."""
    assert P._widths(scale, version) == J._widths(scale, version)
    assert (P.YoloSeg(scale, version=version).proto_channels()
            == J.YoloSeg(scale, version=version).proto_channels())
