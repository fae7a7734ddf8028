"""skix_torch's reference-checkpoint converters of the prepare_dataset models
against skix's, on random reference-layout state dicts (numpy only:
nothing is traced or compiled).

Each reference state dict follows skix's ``reference_state_dict_spec*``
(ultralytics YOLO pose/detect/seg at v8 and v11, detectron2's Keypoint
R-CNN) or HuggingFace DPT's layout for a tiny config, every tensor filled
with distinct values (a running count from a random start, so that a
transposed, flipped or swapped tensor shows); skix's converter gives flax
variables, which ``skix_torch.convert`` turns into a ``state_dict``; the
port's converter must give that ``state_dict`` exactly, and the port's
model (built on the meta device: no memory, no init) must have exactly
its keys and shapes.
"""

import numpy as np
import pytest
import torch

from skix_torch.convert import flax_to_state_dict

rng = np.random.default_rng(5150)


def _draw(spec):
    out = {}
    for k, shape in spec.items():
        n = int(np.prod(shape))
        start = rng.integers(0, 1 << 20)
        out[k] = torch.as_tensor(((np.arange(n) + start) % 65521).astype(
            np.float32).reshape(shape))
    return out


def _assert_fits(model_cls, got, *args, **kw):
    with torch.device("meta"):
        model = model_cls(*args, **kw)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in got.items()} == want


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("version", [8, 11])
@pytest.mark.parametrize("kind", ["pose", "detect", "seg"])
def test_ultralytics_converters_match_skix(kind, version):
    from skix.models import yolo_pose as J
    from skix_torch.models import yolo_pose as P

    spec_fn = {"pose": J.reference_state_dict_spec,
               "detect": J.reference_state_dict_spec_detect,
               "seg": J.reference_state_dict_spec_seg}[kind]
    port_spec = {"pose": P.reference_state_dict_spec,
                 "detect": P.reference_state_dict_spec_detect,
                 "seg": P.reference_state_dict_spec_seg}[kind]
    spec = spec_fn(scale="n", version=version)
    assert port_spec(scale="n", version=version) == spec
    sd = _draw(spec)
    want = flax_to_state_dict(getattr(J, f"convert_ultralytics_{kind}")(
        sd, scale="n", version=version))
    got = getattr(P, f"convert_ultralytics_{kind}")(sd, scale="n",
                                                    version=version)
    _assert_same(got, want)
    _assert_fits({"pose": P.YoloPose, "detect": P.YoloDetect,
                  "seg": P.YoloSeg}[kind], got, "n", version=version)


def test_detectron2_converter_matches_skix():
    from skix.models import keypoint_rcnn as J
    from skix_torch.models import keypoint_rcnn as P

    spec = J.reference_state_dict_spec()
    assert P.reference_state_dict_spec() == spec
    sd = _draw(spec)
    want = flax_to_state_dict(J.convert_detectron2_keypoint_rcnn(sd))
    got = P.convert_detectron2_keypoint_rcnn(sd)
    _assert_same(got, want)
    _assert_fits(P.KeypointRCNN, got)


def _hf_dpt_spec(hidden=32, layers=4, inter=128, neck=(8, 16, 24, 24),
                 fusion=16, patch=16, tokens=31):
    """HuggingFace ``DPTForDepthEstimation``'s state-dict entries → shapes
    for a tiny ViT config (readout ``project``)."""
    spec = {"dpt.embeddings.cls_token": (1, 1, hidden),
            "dpt.embeddings.position_embeddings": (1, tokens, hidden),
            "dpt.embeddings.patch_embeddings.projection.weight":
                (hidden, 3, patch, patch),
            "dpt.embeddings.patch_embeddings.projection.bias": (hidden,)}

    def lin(pre, i, o):
        spec[f"{pre}.weight"], spec[f"{pre}.bias"] = (o, i), (o,)

    def conv(pre, i, o, k, bias=True, transpose=False):
        spec[f"{pre}.weight"] = (i, o, k, k) if transpose else (o, i, k, k)
        if bias:
            spec[f"{pre}.bias"] = (o,)

    for i in range(layers):
        pre = f"dpt.encoder.layer.{i}"
        for n in ("query", "key", "value"):
            lin(f"{pre}.attention.attention.{n}", hidden, hidden)
        lin(f"{pre}.attention.output.dense", hidden, hidden)
        lin(f"{pre}.intermediate.dense", hidden, inter)
        lin(f"{pre}.output.dense", inter, hidden)
        for n in ("layernorm_before", "layernorm_after"):
            spec[f"{pre}.{n}.weight"] = spec[f"{pre}.{n}.bias"] = (hidden,)
    for i, c in enumerate(neck):
        lin(f"neck.reassemble_stage.readout_projects.{i}.0", 2 * hidden,
            hidden)
        conv(f"neck.reassemble_stage.layers.{i}.projection", hidden, c, 1)
        if i < 2:
            conv(f"neck.reassemble_stage.layers.{i}.resize", c, c, 4 // (i + 1),
                 transpose=True)
        elif i == 3:
            conv(f"neck.reassemble_stage.layers.{i}.resize", c, c, 3)
        conv(f"neck.convs.{i}", c, fusion, 3, bias=False)
        pre = f"neck.fusion_stage.layers.{i}"
        conv(f"{pre}.projection", fusion, fusion, 1)
        for r in (("residual_layer2",) if i == 0
                  else ("residual_layer1", "residual_layer2")):
            for n in ("convolution1", "convolution2"):
                conv(f"{pre}.{r}.{n}", fusion, fusion, 3)
    conv("head.head.0", fusion, fusion // 2, 3)
    conv("head.head.2", fusion // 2, 32, 3)
    conv("head.head.4", 32, 1, 1)
    return spec


def test_hf_dpt_converter_matches_skix():
    from skix.models import dpt as J
    from skix_torch.models import dpt as P

    kw = dict(patch_size=16, embed_dim=32, depth=4, num_heads=2,
              taps=(0, 1, 2, 3), features=16, out_channels=(8, 16, 24, 24))
    sd = _draw(_hf_dpt_spec())
    want = flax_to_state_dict(J.convert_hf_dpt_checkpoint(
        sd, J.MonocularDepth(**kw)))
    got = P.convert_hf_dpt_checkpoint(sd, depth=4)
    _assert_same(got, want)
    _assert_fits(P.MonocularDepth, got, image_hw=(80, 96), **kw)
