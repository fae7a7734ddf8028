"""Grounding datapoint schema + query-filter training transforms.

Capability parity with the reference SAM3 train-data query machinery
(prepare_front_results/sam3/train/data/sam3_image_dataset.py
Datapoint/FindQuery/Object and
train/transforms/filter_query_transforms.py — the full filter family
applied by FlexibleFilterFindGetQueries:337, whose remap step keeps
query_processing_order contiguous, drops now-unreferenced objects with
output-id remapping, and drops unreferenced images).

A copy of ``skix/data/grounding.py``: host-side dataclasses + numpy; the
fixed-slot collation to device arrays stays in ``data/coco.py`` and
``video.py``. Randomized transforms take an explicit
``np.random.Generator`` (repo convention) instead of the reference's
global ``random``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# Schema (sam3_image_dataset.py Datapoint / FindQuery / Object analog)
# ---------------------------------------------------------------------------

@dataclass
class GroundingObject:
    bbox: np.ndarray                 # (4,) xyxy pixels
    mask: Optional[np.ndarray] = None  # (H, W) bool
    area: float = 0.0
    is_crowd: bool = False


@dataclass
class GroundingImage:
    objects: List[GroundingObject] = field(default_factory=list)
    data: Optional[np.ndarray] = None  # (H, W, 3) pixels (optional)


@dataclass
class FindQuery:
    query_text: str
    image_id: int = 0
    object_ids_output: List[int] = field(default_factory=list)
    input_bbox: Optional[np.ndarray] = None     # (4,) xyxy geometric prompt
    input_bbox_label: Optional[np.ndarray] = None
    input_points: Optional[np.ndarray] = None
    is_exhaustive: bool = True
    is_pixel_exhaustive: Optional[bool] = None
    query_processing_order: int = 0


@dataclass
class Datapoint:
    images: List[GroundingImage]
    find_queries: List[FindQuery]


def datapoint_from_coco(record: dict, query_text: str = "object") -> Datapoint:
    """Bridge a ``skix_torch.data.coco`` record (image/boxes/cls/masks) to a
    one-query grounding datapoint."""
    objs = []
    n = len(record["boxes"])
    for i in range(n):
        mask = (record["masks"][i] if record.get("masks") is not None
                and len(record["masks"]) == n else None)
        box = np.asarray(record["boxes"][i], np.float32)
        area = (float(mask.sum()) if mask is not None else
                float(max(box[2] - box[0], 0) * max(box[3] - box[1], 0)))
        objs.append(GroundingObject(bbox=box, mask=mask, area=area))
    img = GroundingImage(objects=objs, data=record.get("image"))
    return Datapoint(images=[img],
                     find_queries=[FindQuery(query_text=query_text,
                                             object_ids_output=list(range(n)))])


# ---------------------------------------------------------------------------
# Filters (filter_query_transforms.py)
# ---------------------------------------------------------------------------

class FilterDataPointQueries:
    """Base: subclasses fill ``find_ids_to_filter`` (query indices to drop)
    and ``obj_ids_to_filter`` ({(img_id, obj_id)} to drop)."""

    find_ids_to_filter: set = None
    obj_ids_to_filter: set = None

    def identify_queries_to_filter(self, datapoint: Datapoint) -> None:
        raise NotImplementedError


class FilterQueryWithText(FilterDataPointQueries):
    """Drop find queries whose text is in the exclusion list (:31)."""

    def __init__(self, exclude_find_keys=None):
        self.find_filter_keys = list(exclude_find_keys or [])

    def identify_queries_to_filter(self, datapoint):
        self.obj_ids_to_filter = set()
        self.find_ids_to_filter = {
            i for i, q in enumerate(datapoint.find_queries)
            if q.query_text in self.find_filter_keys}


class KeepMaxNumFindQueries(FilterDataPointQueries):
    """Random down-sampling to ``max_num_find_queries`` (:53); with
    ``retain_positive_queries`` positives are kept first and remaining
    slots filled with negatives (reference :75-99 branch structure)."""

    def __init__(self, max_num_find_queries: int,
                 retain_positive_queries: bool = False, rng=None):
        self.max_num_find_queries = max_num_find_queries
        self.retain_positive_queries = retain_positive_queries
        self.rng = rng or np.random.default_rng(0)

    def _sample(self, ids, k):
        return [ids[j] for j in
                self.rng.choice(len(ids), size=k, replace=False)] if k else []

    def identify_queries_to_filter(self, datapoint):
        self.obj_ids_to_filter = set()
        n = len(datapoint.find_queries)
        if n <= self.max_num_find_queries:
            self.find_ids_to_filter = set()
            return
        if not self.retain_positive_queries:
            drop = self._sample(list(range(n)), n - self.max_num_find_queries)
        else:
            pos = [i for i, q in enumerate(datapoint.find_queries)
                   if len(q.object_ids_output) > 0]
            neg = [i for i, q in enumerate(datapoint.find_queries)
                   if len(q.object_ids_output) == 0]
            if len(pos) >= self.max_num_find_queries:
                drop = self._sample(pos, len(pos) - self.max_num_find_queries)
                drop.extend(neg)
            else:
                drop = self._sample(neg, n - self.max_num_find_queries)
        assert len(drop) == n - self.max_num_find_queries
        self.find_ids_to_filter = set(drop)


class KeepSemanticFindQueriesOnly(FilterDataPointQueries):
    """Drop geometric find queries (input_bbox set, :195)."""

    def identify_queries_to_filter(self, datapoint):
        self.obj_ids_to_filter = set()
        self.find_ids_to_filter = {
            i for i, q in enumerate(datapoint.find_queries)
            if q.input_bbox is not None}


class FilterZeroBoxQueries(FilterDataPointQueries):
    """Drop find queries predicting any zero-area box (:213; single-image
    datapoints, like the reference assumes)."""

    @staticmethod
    def _is_zero_area(obj: GroundingObject) -> bool:
        b = np.asarray(obj.bbox, np.float64)
        return (b[3] - b[1]) == 0 or (b[2] - b[0]) == 0

    def identify_queries_to_filter(self, datapoint):
        self.obj_ids_to_filter = set()
        bad = {i for i, o in enumerate(datapoint.images[0].objects)
               if self._is_zero_area(o)}
        self.find_ids_to_filter = {
            i for i, q in enumerate(datapoint.find_queries)
            if bad & set(q.object_ids_output)}


class FilterFindQueriesWithTooManyOut(FilterDataPointQueries):
    """Drop find queries with > max_num_objects outputs (:249)."""

    def __init__(self, max_num_objects: int):
        self.max_num_objects = max_num_objects

    def identify_queries_to_filter(self, datapoint):
        self.obj_ids_to_filter = set()
        self.find_ids_to_filter = {
            i for i, q in enumerate(datapoint.find_queries)
            if len(q.object_ids_output) > self.max_num_objects}


class FilterEmptyTargets(FilterDataPointQueries):
    """Drop zero-area target objects everywhere (:269)."""

    def identify_queries_to_filter(self, datapoint):
        self.obj_ids_to_filter = {
            (img_id, obj_id)
            for img_id, img in enumerate(datapoint.images)
            for obj_id, obj in enumerate(img.objects)
            if obj.area < 1e-6}
        self.find_ids_to_filter = set()


class FilterNonExhaustiveFindQueries(FilterDataPointQueries):
    """Drop non-exhaustive find queries (:284); 'instance' checks
    is_exhaustive, 'pixel' checks is_pixel_exhaustive (None = keep)."""

    def __init__(self, exhaustivity_type: str):
        assert exhaustivity_type in ("pixel", "instance")
        self.exhaustivity_type = exhaustivity_type

    def identify_queries_to_filter(self, datapoint):
        self.obj_ids_to_filter = set()
        drop = set()
        for i, q in enumerate(datapoint.find_queries):
            if self.exhaustivity_type == "instance":
                if not q.is_exhaustive:
                    drop.add(i)
            elif (q.is_pixel_exhaustive is not None
                  and not q.is_pixel_exhaustive):
                drop.add(i)
        self.find_ids_to_filter = drop


class FilterInvalidGeometricQueries(FilterDataPointQueries):
    """Drop 'geometric' queries whose outputs got deleted, e.g. by crop
    augmentation (:320)."""

    def identify_queries_to_filter(self, datapoint):
        self.obj_ids_to_filter = set()
        self.find_ids_to_filter = {
            i for i, q in enumerate(datapoint.find_queries)
            if q.input_bbox is not None and q.query_text == "geometric"
            and len(q.object_ids_output) == 0}


class FilterCrowds(FilterDataPointQueries):
    """Drop is_crowd target objects (:518)."""

    def identify_queries_to_filter(self, datapoint):
        self.find_ids_to_filter = set()
        self.obj_ids_to_filter = {
            (img_id, obj_id)
            for img_id, img in enumerate(datapoint.images)
            for obj_id, obj in enumerate(img.objects) if obj.is_crowd}


class FlexibleFilterFindGetQueries:
    """Apply a filter and re-normalize the datapoint (:337): drop the
    selected queries (≥1 must survive), make query_processing_order
    contiguous again, drop objects no longer referenced by any query (plus
    the filter's explicit obj drops) remapping every query's output ids,
    then drop images no longer referenced by any query."""

    def __init__(self, query_filter: FilterDataPointQueries,
                 enabled: bool = True):
        self.query_filter = query_filter
        self.enabled = enabled

    def __call__(self, datapoint: Datapoint, **kwargs) -> Datapoint:
        if not self.enabled:
            return datapoint
        f = self.query_filter
        f.identify_queries_to_filter(datapoint)

        new_queries = [q for i, q in enumerate(datapoint.find_queries)
                       if i not in f.find_ids_to_filter]
        if not new_queries:
            raise ValueError("No find queries left in datapoint")
        if all(q.query_processing_order != 0 for q in new_queries):
            raise AssertionError(
                "Invalid Find queries, they need to start at "
                "query_processing_order = 0")
        datapoint.find_queries = new_queries

        stages = sorted({q.query_processing_order
                         for q in datapoint.find_queries})
        stage_map = {s: i for i, s in enumerate(stages)}
        for q in datapoint.find_queries:
            q.query_processing_order = stage_map[q.query_processing_order]

        for img_id in range(len(datapoint.images)):
            used = {oid for q in datapoint.find_queries
                    if q.image_id == img_id for oid in q.object_ids_output}
            unused = set(range(len(datapoint.images[img_id].objects))) - used
            unused |= {oid for iid, oid in f.obj_ids_to_filter
                       if iid == img_id}
            if not unused:
                continue
            old = datapoint.images[img_id].objects
            old_to_new, new_objs = {}, []
            for i, o in enumerate(old):
                if i not in unused:
                    old_to_new[i] = len(new_objs)
                    new_objs.append(o)
            datapoint.images[img_id].objects = new_objs
            for q in datapoint.find_queries:
                if q.image_id == img_id:
                    q.object_ids_output = [old_to_new[oid]
                                           for oid in q.object_ids_output
                                           if oid not in unused]

        keep_imgs = {q.image_id for q in datapoint.find_queries}
        img_map, new_images = {}, []
        for img_id, img in enumerate(datapoint.images):
            if img_id in keep_imgs:
                img_map[img_id] = len(new_images)
                new_images.append(img)
        datapoint.images = new_images
        for q in datapoint.find_queries:
            q.image_id = img_map[q.image_id]
        return datapoint


# ---------------------------------------------------------------------------
# Text/visual query rewrites (:465-607)
# ---------------------------------------------------------------------------

class AddPrefixSuffixToFindText:
    """Prefix/suffix find-query text, optionally only for texts in a
    condition list; 'geometric' queries are skipped (:465)."""

    def __init__(self, prefix=None, suffix=None, condition_on_text=False,
                 condition_text_list=None, enabled=True):
        self.prefix = prefix
        self.suffix = suffix
        self.condition_on_text = condition_on_text
        if condition_on_text:
            assert condition_text_list is not None
            self.condition_text_set = {s.lower().strip()
                                       for s in condition_text_list}
        self.enabled = enabled

    def __call__(self, datapoint: Datapoint, **kwargs) -> Datapoint:
        if not self.enabled:
            return datapoint
        for q in datapoint.find_queries:
            if q.query_text == "geometric":
                continue
            if (self.condition_on_text and q.query_text.lower().strip()
                    not in self.condition_text_set):
                continue
            if self.prefix is not None:
                q.query_text = self.prefix + q.query_text
            if self.suffix is not None:
                q.query_text = q.query_text + self.suffix
        return datapoint


class TextQueryToVisual:
    """With some probability, turn a first-stage text query into a visual
    (exemplar-box) query using one of its own targets as the prompt
    (:532)."""

    def __init__(self, probability: float, keep_text_queries: bool = False,
                 rng=None):
        assert 0 <= probability <= 1
        self.probability = probability
        self.keep_text_queries = keep_text_queries
        self.rng = rng or np.random.default_rng(0)

    def __call__(self, datapoint: Datapoint, **kwargs) -> Datapoint:
        for q in datapoint.find_queries:
            if q.input_bbox is not None or q.input_points is not None:
                continue
            if not q.object_ids_output or q.query_processing_order > 0:
                continue
            if self.rng.random() > self.probability:
                continue
            sel = int(self.rng.choice(q.object_ids_output))
            q.input_bbox = datapoint.images[q.image_id].objects[sel].bbox
            q.input_bbox_label = np.ones(1, bool)
            if not self.keep_text_queries:
                q.query_text = "visual"
        return datapoint


class RemoveInputBoxes:
    """Strip geometric input boxes from find queries (:569)."""

    def __call__(self, datapoint: Datapoint, **kwargs) -> Datapoint:
        for q in datapoint.find_queries:
            q.input_bbox = None
        return datapoint


class OverwriteTextQuery:
    """With some probability, replace the query text (:590)."""

    def __init__(self, target_text: str, probability: float = 1.0, rng=None):
        assert 0 <= probability <= 1
        self.target_text = target_text
        self.probability = probability
        self.rng = rng or np.random.default_rng(0)

    def __call__(self, datapoint: Datapoint, **kwargs) -> Datapoint:
        for q in datapoint.find_queries:
            if self.rng.random() <= self.probability:
                q.query_text = self.target_text
        return datapoint
