"""COCO image-level dataset (port of ``stmask_tpu/data/coco.py``; the
reference's YOLACT-style COCO path, README.md:128-141).

The COCO instance JSON is parsed directly (no pycocotools): boxes from
``bbox`` (xywh), RLE or polygon masks through ``data/ytvis.py``'s
``_segm_to_mask``, the sparse category ids mapped to contiguous labels
from 1.  ``COCOAsVideos`` shows the images to the video eval as one-frame
videos (``python -m stmask_torch.eval --coco``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from .ytvis import FrameAnnots, _segm_to_mask


class COCODataset:
    def __init__(self, ann_file: str, img_prefix: str,
                 has_annotations: bool = True):
        self.img_prefix = img_prefix
        with open(ann_file) as f:
            data = json.load(f)
        self.images = data['images']
        self.img_index = {im['id']: im for im in self.images}
        self.categories = sorted(c['id'] for c in data.get('categories', []))
        # contiguous 1-based label mapping (COCO ids are sparse)
        self.cat_to_label = {c: i + 1 for i, c in enumerate(self.categories)}
        self.annots_by_img: Dict[int, List[dict]] = {}
        if has_annotations:
            for ann in data.get('annotations', []):
                self.annots_by_img.setdefault(ann['image_id'],
                                              []).append(ann)

    def image_ids(self) -> List[int]:
        return [im['id'] for im in self.images]

    def image_path(self, img_id: int) -> str:
        return os.path.join(self.img_prefix,
                            self.img_index[img_id]['file_name'])

    def image_size(self, img_id: int) -> Tuple[int, int]:
        im = self.img_index[img_id]
        return im['height'], im['width']

    def image_annots(self, img_id: int,
                     include_crowd: bool = False) -> FrameAnnots:
        """``include_crowd``: crowds as regular gt (debug only);
        default routes iscrowd regions into ``crowd_boxes`` so the matcher
        neutralizes overlapping negatives (reference box_utils.py:119)."""
        h, w = self.image_size(img_id)
        boxes, labels, ids, masks = [], [], [], []
        crowd = []
        for ann in self.annots_by_img.get(img_id, []):
            x, y, bw, bh = ann['bbox']
            if ann.get('iscrowd', 0) and not include_crowd:
                crowd.append([x, y, x + bw, y + bh])
                continue
            m = _segm_to_mask(ann.get('segmentation'), h, w)
            boxes.append([x, y, x + bw, y + bh])
            labels.append(self.cat_to_label[ann['category_id']])
            ids.append(ann['id'])
            masks.append(m)
        crowd_arr = (np.asarray(crowd, np.float32) if crowd
                     else np.zeros((0, 4), np.float32))
        if not boxes:
            return FrameAnnots(np.zeros((0, 4), np.float32),
                               np.zeros((0,), np.int32),
                               np.zeros((0,), np.int32),
                               np.zeros((0, h, w), np.uint8),
                               crowd_boxes=crowd_arr)
        return FrameAnnots(np.asarray(boxes, np.float32),
                           np.asarray(labels, np.int32),
                           np.asarray(ids, np.int32),
                           np.stack(masks).astype(np.uint8),
                           crowd_boxes=crowd_arr)

    def train_index(self) -> List[int]:
        return [i for i in self.image_ids() if self.annots_by_img.get(i)]


class COCOAsVideos:
    """Adapter: expose a COCO image dataset through the video-dataset
    interface (each image = a 1-frame video, ``is_first`` always set), so
    the image-level COCO path (reference README.md:128-141, 550x550
    YOLACT-style) reuses the streaming eval machinery unchanged."""

    def __init__(self, coco: COCODataset):
        self.coco = coco

    def video_ids(self) -> List[int]:
        return self.coco.image_ids()

    def num_frames(self, vid: int) -> int:
        return 1

    def frame_path(self, vid: int, frame_id: int) -> str:
        return self.coco.image_path(vid)

    def frame_size(self, vid: int) -> Tuple[int, int]:
        return self.coco.image_size(vid)

    def frame_annots(self, vid: int, frame_id: int):
        return self.coco.image_annots(vid)

    def to_ytvis_gt(self) -> Dict:
        """Ground truth in YTVIS schema (1-frame videos) so the track-mAP
        evaluator doubles as the COCO image-mAP evaluator."""
        from ..utils import rle as rle_util
        videos, annotations = [], []
        aid = 1
        for img_id in self.coco.image_ids():
            h, w = self.coco.image_size(img_id)
            videos.append({'id': img_id, 'file_names': ['0'],
                           'height': h, 'width': w})
            ann = self.coco.image_annots(img_id)
            for i in range(len(ann.labels)):
                annotations.append({
                    'id': aid, 'video_id': img_id,
                    'category_id': int(ann.labels[i]),
                    'segmentations': [rle_util.encode(ann.masks[i])],
                })
                aid += 1
        cats = [{'id': i + 1, 'name': str(i + 1)}
                for i in range(len(self.coco.categories))]
        return {'videos': videos, 'annotations': annotations,
                'categories': cats}
