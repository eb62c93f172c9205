"""A synthetic YouTube-VIS-format video set, written from a seed: PNG (or
JPEG) frames and an annotation JSON with per-frame RLE masks; and a
COCO-format image set made of one-frame videos.  Used by the tests and by
``chip_smoke.py``, since the repository holds no dataset.

Each video has a smooth random background with mild noise and 1 to 3
objects (filled ellipses of a flat colour) that move a few pixels a frame;
the annotation gives each object's category, per-frame box and mask, and
the area of the mask in each frame.

The eval CLI (the JAX package's ``eval.py`` and the port's alike) writes its
masks
at the model's input size (img_h, img_w), not at the frame's, so a set
meant for ``--eval_metrics`` with frames of another size draws its gt at
that size (``gt_hw``); a set meant for training keeps its gt at the
frame's size, where the boxes are.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from ..utils import rle
from .image_io import write_png


def _frame_background(rng: np.random.RandomState, h: int, w: int
                      ) -> np.ndarray:
    coarse = rng.rand(h // 64 + 2, w // 64 + 2, 3)
    base = np.kron(coarse, np.ones((64, 64, 1)))[:h, :w] * 180.0 + 30.0
    return base.astype(np.float32)


N_CLASSES = 40          # YouTube-VIS 2019's categories
NOISE = 8.0             # std of the per-frame pixel noise


def write_ytvis_set(root: str, n_videos: int, n_frames: int, height: int,
                    width: int, seed: int = 0,
                    gt_hw: Optional[Tuple[int, int]] = None,
                    ext: str = '.png') -> Tuple[str, str]:
    """Write ``n_videos`` videos of ``n_frames`` frames of ``height`` x
    ``width`` under ``root``, with gt masks of ``gt_hw`` (default the
    frame's size); returns (annotation file, image prefix).  Frames are
    PNG, or JPEG through cv2 with ``ext='.jpg'`` (YouTube-VIS's format)."""
    rng = np.random.RandomState(seed)
    img_prefix = os.path.join(root, 'JPEGImages')
    videos, annotations = [], []
    yy, xx = np.mgrid[:height, :width]
    gh, gw = gt_hw or (height, width)
    # gt pixel centres in frame coordinates
    gy = (np.arange(gh)[:, None] + 0.5) * height / gh - 0.5
    gx = (np.arange(gw)[None, :] + 0.5) * width / gw - 0.5
    ann_id = 1
    for v in range(n_videos):
        vid = v + 1
        name = f'video{vid:03d}'
        os.makedirs(os.path.join(img_prefix, name), exist_ok=True)
        background = _frame_background(rng, height, width)
        objs = []
        for _ in range(rng.randint(1, 4)):
            ry, rx = rng.uniform(0.08, 0.25) * height, rng.uniform(
                0.08, 0.25) * width
            cy, cx = rng.uniform(ry, height - ry), rng.uniform(rx, width - rx)
            vy, vx = rng.uniform(-0.01, 0.01, 2) * (height, width)
            objs.append(dict(ry=ry, rx=rx, cy=cy, cx=cx, vy=vy, vx=vx,
                             color=rng.randint(0, 256, 3),
                             cat=int(rng.randint(1, N_CLASSES + 1)),
                             segs=[], boxes=[], areas=[]))
        files = []
        for f in range(n_frames):
            img = background + rng.randn(height, width, 3).astype(
                np.float32) * NOISE
            for o in objs:
                cy, cx = o['cy'] + o['vy'] * f, o['cx'] + o['vx'] * f
                img[((yy - cy) / o['ry']) ** 2 + ((xx - cx) / o['rx']) ** 2
                    <= 1.0] = o['color']
                m = ((gy - cy) / o['ry']) ** 2 + ((gx - cx) / o['rx']) ** 2 \
                    <= 1.0
                ys, xs = np.nonzero(m)
                if len(ys):
                    o['segs'].append(rle.encode(m.astype(np.uint8)))
                    o['boxes'].append([float(xs.min()), float(ys.min()),
                                       float(xs.max() - xs.min() + 1),
                                       float(ys.max() - ys.min() + 1)])
                    o['areas'].append(float(m.sum()))
                else:
                    o['segs'].append(None)
                    o['boxes'].append(None)
                    o['areas'].append(None)
            fname = f'{name}/{f:05d}{ext}'
            img = np.clip(img, 0, 255).astype(np.uint8)
            if ext == '.png':
                write_png(os.path.join(img_prefix, fname), img)
            else:
                import cv2
                cv2.imwrite(os.path.join(img_prefix, fname),
                            cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            files.append(fname)
        videos.append({'id': vid, 'width': width, 'height': height,
                       'length': n_frames, 'file_names': files})
        for o in objs:
            annotations.append({'id': ann_id, 'video_id': vid,
                                'category_id': o['cat'], 'iscrowd': 0,
                                'segmentations': o['segs'],
                                'bboxes': o['boxes'], 'areas': o['areas'],
                                'height': gh, 'width': gw})
            ann_id += 1
    ann_file = os.path.join(root, 'annotations.json')
    with open(ann_file, 'w') as fh:
        json.dump({'videos': videos, 'annotations': annotations,
                   'categories': [{'id': i, 'name': f'class{i}'}
                                  for i in range(1, N_CLASSES + 1)]}, fh)
    return ann_file, img_prefix


def write_coco_set(root: str, n_images: int, height: int, width: int,
                   seed: int = 0, gt_hw: Optional[Tuple[int, int]] = None
                   ) -> Tuple[str, str]:
    """A COCO instance set of ``n_images`` PNG images (the first frames of
    ``write_ytvis_set``'s videos): one annotation per object with its
    ``bbox`` (xywh at ``gt_hw``) and RLE ``segmentation``, and sparse
    category ids (2c + 1 for the video set's class c), as COCO's are;
    returns (annotation file, image prefix)."""
    ann_file, img_prefix = write_ytvis_set(root, n_images, 1, height, width,
                                           seed=seed, gt_hw=gt_hw)
    with open(ann_file) as fh:
        vis = json.load(fh)
    images = [{'id': v['id'], 'file_name': v['file_names'][0],
               'height': height, 'width': width} for v in vis['videos']]
    annotations = [{'id': a['id'], 'image_id': a['video_id'],
                    'category_id': 2 * a['category_id'] + 1,
                    'bbox': a['bboxes'][0], 'area': a['areas'][0],
                    'iscrowd': 0, 'segmentation': a['segmentations'][0]}
                   for a in vis['annotations']
                   if a['segmentations'][0] is not None]
    categories = [{'id': 2 * c['id'] + 1, 'name': c['name']}
                  for c in vis['categories']]
    coco_file = os.path.join(root, 'instances.json')
    with open(coco_file, 'w') as fh:
        json.dump({'images': images, 'annotations': annotations,
                   'categories': categories}, fh)
    return coco_file, img_prefix
