"""Host-side training data: COCO-format datasets, augmentation and
fixed-shape collation (a copy of skix's numpy data layer)."""

from skix_torch.data.coco import (CocoDataset, CocoLoader, collate_fixed,
                                  hflip_record, random_resize_crop,
                                  resize_pad_to)

__all__ = ["CocoDataset", "CocoLoader", "collate_fixed", "hflip_record",
           "random_resize_crop", "resize_pad_to"]
