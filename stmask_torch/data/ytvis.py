"""YouTube-VIS / OVIS annotation file (port of ``stmask_tpu/data/ytvis.py``).

The annotation JSON is parsed directly (no cocoapi); per-frame masks come
from RLE (``utils.rle``) or polygons (``cv2.fillPoly``).  Training samples
are two-frame clips: a key frame and a reference frame within
±2·clip_frames (reference ``ytvos.py:177-193``); eval steps through each
video in order.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..utils import rle as rle_util


@dataclass
class FrameAnnots:
    boxes: np.ndarray    # [n, 4] absolute pixel xyxy
    labels: np.ndarray   # [n]
    ids: np.ndarray      # [n] globally unique instance ids (1-based)
    masks: np.ndarray    # [n, h, w] uint8
    # crowd regions (iscrowd=1): kept apart and neutral in matching
    # (reference box_utils.py:119), never trained as gt
    crowd_boxes: np.ndarray = None

    def __post_init__(self):
        if self.crowd_boxes is None:
            self.crowd_boxes = np.zeros((0, 4), np.float32)


def _segm_to_mask(segm, h: int, w: int) -> np.ndarray:
    """An RLE dict or a polygon list -> uint8 [h, w]; None -> zeros."""
    if segm is None:
        return np.zeros((h, w), np.uint8)
    if isinstance(segm, dict):
        return rle_util.decode(segm)
    import cv2
    mask = np.zeros((h, w), np.uint8)
    polys = [np.asarray(p, np.float64).reshape(-1, 2).astype(np.int32)
             for p in segm if len(p) >= 6]
    cv2.fillPoly(mask, polys, 1)
    return mask


class YTVISDataset:
    """COCO-style video dataset over a YTVIS-format annotation JSON."""

    def __init__(self, ann_file: str, img_prefix: str,
                 has_annotations: bool = True):
        self.img_prefix = img_prefix
        with open(ann_file) as f:
            data = json.load(f)
        self.videos = data['videos']
        self.categories = {c['id']: c['name']
                           for c in data.get('categories', [])}
        self.vid_index = {v['id']: v for v in self.videos}
        self.annots_by_vid: Dict[int, List[dict]] = {}
        if has_annotations:
            for ann in data.get('annotations', []):
                self.annots_by_vid.setdefault(ann['video_id'], []).append(ann)

    def video_ids(self) -> List[int]:
        return [v['id'] for v in self.videos]

    def num_frames(self, vid: int) -> int:
        return len(self.vid_index[vid]['file_names'])

    def frame_path(self, vid: int, frame_id: int) -> str:
        return os.path.join(self.img_prefix,
                            self.vid_index[vid]['file_names'][frame_id])

    def frame_size(self, vid: int) -> Tuple[int, int]:
        v = self.vid_index[vid]
        return v['height'], v['width']

    def frame_annots(self, vid: int, frame_id: int) -> FrameAnnots:
        """One frame's instances: boxes from ``bboxes`` (xywh), else from
        the mask's extent; crowd regions apart."""
        h, w = self.frame_size(vid)
        boxes, labels, ids, masks = [], [], [], []
        crowd = []
        for ann in self.annots_by_vid.get(vid, []):
            segms = ann.get('segmentations')
            bboxes = ann.get('bboxes')
            segm = segms[frame_id] if segms and frame_id < len(segms) else None
            bbox = bboxes[frame_id] if bboxes and frame_id < len(bboxes) \
                else None
            if segm is None and bbox is None:
                continue
            m = _segm_to_mask(segm, h, w)
            if bbox is not None:
                x, y, bw, bh = bbox
                box = [x, y, x + bw, y + bh]
            else:
                ys, xs = np.nonzero(m)
                if xs.size == 0:
                    continue
                box = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
            if ann.get('iscrowd', 0):
                crowd.append(box)
                continue
            boxes.append(box)
            labels.append(ann['category_id'])
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

    def train_index(self) -> List[Tuple[int, int]]:
        """(video_id, frame_id) pairs with at least one annotated
        instance."""
        index = []
        for vid in self.video_ids():
            anns = self.annots_by_vid.get(vid, [])
            for f in range(self.num_frames(vid)):
                if any(a.get('segmentations') and f < len(a['segmentations'])
                       and a['segmentations'][f] is not None for a in anns):
                    index.append((vid, f))
        return index

    def sample_ref_frame(self, vid: int, frame_id: int,
                         rng: np.random.RandomState,
                         clip_frames: int = 1) -> int:
        """A reference frame within ±2·clip_frames, not the key frame
        (reference ``ytvos.py:177-193``)."""
        nf = self.num_frames(vid)
        lo = max(0, frame_id - 2 * clip_frames)
        hi = min(nf - 1, frame_id + 2 * clip_frames)
        cands = [f for f in range(lo, hi + 1) if f != frame_id]
        if not cands:
            return frame_id
        return int(cands[rng.randint(len(cands))])
