"""YouTube-VIS / OVIS annotation file, the accessors the eval CLI uses
(port of ``stmask_tpu/data/ytvis.py:57-90``).

The annotation JSON is parsed directly (no cocoapi).  ``frame_annots``,
``train_index`` and ``sample_ref_frame`` belong to the training data path,
which is not ported yet (ROADMAP A.8).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple


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
