"""Skeleton definitions the port needs so far (from ``skix/geometry/skeletons.py``)."""

# the reference's 12 bones for the length-consistency loss
# (bundle_adjustment/loss.py:118), COCO-17 indices
COCO_BONES_12 = (
    (5, 7), (7, 9), (6, 8), (8, 10),      # arms
    (11, 13), (13, 15), (12, 14), (14, 16),  # legs
    (5, 11), (6, 12), (5, 6), (11, 12),   # torso
)
