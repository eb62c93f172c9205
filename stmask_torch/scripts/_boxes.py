"""Training-box sizes for the anchor scripts: the port's copy of
``collect_boxes`` and ``load_whs`` from the JAX package's
``scripts/cluster_bbox_sizes.py``."""

from __future__ import annotations

import json

import numpy as np


def collect_boxes(ann_file: str) -> np.ndarray:
    """[N, 2] (w, h) of every gt box of a YouTube-VIS or COCO annotation
    file, normalized by its video's or image's size."""
    with open(ann_file) as f:
        data = json.load(f)
    sizes = {v['id']: (v['height'], v['width']) for v in data['videos']} \
        if 'videos' in data else \
        {im['id']: (im['height'], im['width']) for im in data['images']}
    whs = []
    for ann in data.get('annotations', []):
        key = ann.get('video_id', ann.get('image_id'))
        h, w = sizes[key]
        bboxes = ann.get('bboxes') or [ann.get('bbox')]
        for bb in bboxes:
            if bb is None:
                continue
            whs.append((bb[2] / w, bb[3] / h))
    return np.asarray(whs, np.float64)


def load_whs(args) -> np.ndarray:
    """Box (w, h) source: --ann_file json, or --box_file pickle (either the
    normalized xyxy output of augment_bbox.py or save_bboxes.py rows)."""
    if args.box_file:
        import pickle
        with open(args.box_file, 'rb') as f:
            rows = np.asarray(pickle.load(f), np.float64)
        if rows.shape[1] == 4:        # augmented normalized xyxy
            return np.stack([rows[:, 2] - rows[:, 0],
                             rows[:, 3] - rows[:, 1]], axis=1)
        return np.stack([rows[:, 4] / rows[:, 0],
                         rows[:, 5] / rows[:, 1]], axis=1)
    if not args.ann_file:
        raise SystemExit('need --ann_file or --box_file')
    return collect_boxes(args.ann_file)
