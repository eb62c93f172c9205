"""Frame decoding, the YouTube-VIS and COCO annotation accessors, frame
and batch preparation (training frames on the host, eval frames and
batches on the device), the training augmentations, the clip loader and
its prefetch thread, and a synthetic YouTube-VIS writer."""

from .coco import COCOAsVideos, COCODataset  # noqa: F401
