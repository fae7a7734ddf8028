"""Host-side training data: COCO-format datasets, augmentation and
fixed-shape collation, the YTVIS video clips and the grounding datapoints
with their query filters (copies of skix's numpy data layer)."""

from skix_torch.data.coco import (CocoDataset, CocoLoader, collate_fixed,
                                  color_jitter_record, grayscale_record,
                                  hflip_record, mosaic_record,
                                  motion_blur_record, random_resize_crop,
                                  resize_pad_to)
from skix_torch.data.video import (VideoDataset, collate_clips,
                                   sample_clip_frames, tile_image_clip)
from skix_torch.data.grounding import (Datapoint, FindQuery,
                                       FlexibleFilterFindGetQueries,
                                       GroundingImage, GroundingObject,
                                       datapoint_from_coco)

__all__ = ["CocoDataset", "CocoLoader", "collate_fixed",
           "color_jitter_record", "grayscale_record", "hflip_record",
           "mosaic_record", "motion_blur_record", "random_resize_crop",
           "resize_pad_to", "VideoDataset", "collate_clips",
           "sample_clip_frames", "tile_image_clip",
           "Datapoint", "FindQuery", "FlexibleFilterFindGetQueries",
           "GroundingImage", "GroundingObject", "datapoint_from_coco"]
