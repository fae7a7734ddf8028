"""skix_torch.data (a numpy copy of skix.data.coco) yields skix's batches:
the same COCO fixture and seed give the same collated arrays, byte for
byte, with the augmentations on."""

import json

import numpy as np
import pytest

from skix.data import CocoDataset as SkixDataset
from skix.data import CocoLoader as SkixLoader
from skix_torch.data import CocoDataset, CocoLoader


@pytest.fixture(scope="module")
def fixture_json(tmp_path_factory):
    """skix's COCO keypoints fixture plus one object given as an
    uncompressed RLE mask."""
    from tests.test_yolo_pose import _write_coco_fixture

    root = tmp_path_factory.mktemp("coco")
    jp, _ = _write_coco_fixture(root, n_images=5, size=96)
    d = json.loads(jp.read_text())
    m = np.zeros((96, 96), bool)
    m[30:60, 20:50] = True
    flat = m.T.ravel()
    change = np.flatnonzero(np.diff(flat.astype(np.int8))) + 1
    runs = np.diff(np.r_[0, change, flat.size]).tolist()
    d["annotations"].append({"id": 99, "image_id": 0, "category_id": 1,
                             "bbox": [20, 30, 30, 30], "iscrowd": 0,
                             "segmentation": {"size": [96, 96],
                                              "counts": runs}})
    jp.write_text(json.dumps(d))
    return root, jp


@pytest.mark.parametrize("kw", [
    dict(augment=True),
    dict(augment=True, photometric=True, p_mosaic=0.5, scale_range=(0.5, 1.5)),
    dict(augment=False),
], ids=["geometric", "photometric_mosaic", "eval"])
def test_loader_batches_match_skix(fixture_json, kw):
    root, jp = fixture_json
    common = dict(batch_size=3, image_size=112, max_objects=4, mask_stride=4,
                  seed=5, **kw)
    got = CocoLoader(CocoDataset(jp, image_root=root), **common)
    want = SkixLoader(SkixDataset(jp, image_root=root), **common)
    n = 0
    for _, a, b in zip(range(4), got, want):
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        n += int(b["valid"].sum())
    assert n > 0


def test_rle_annotation_decodes_as_skix(fixture_json):
    root, jp = fixture_json
    a = CocoDataset(jp, image_root=root).example(0)
    b = SkixDataset(jp, image_root=root).example(0)
    assert len(b["masks"]) == 2 and b["masks"][1].sum() == 900
    for k in ("boxes", "cls", "keypoints", "masks"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
