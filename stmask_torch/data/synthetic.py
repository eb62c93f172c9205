"""A synthetic YouTube-VIS-format video set, written from a seed: PNG frames
and an annotation JSON with per-frame RLE masks.  Used by the tests and by
``chip_smoke.py``, since the repository holds no dataset.

Each video has a smooth random background with mild noise and 1 to 3
objects (filled ellipses of a flat colour) that move a few pixels a frame;
the annotation gives each object's category, per-frame box and mask, and
the area of the mask in each frame.

The eval CLI (the JAX package's ``eval.py`` and the port's alike) writes its
masks
at the model's input size (img_h, img_w), not at the frame's, so a set
meant for ``--eval_metrics`` with frames of another size draws its gt at
that size (``gt_hw``).
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
                    gt_hw: Optional[Tuple[int, int]] = None
                    ) -> Tuple[str, str]:
    """Write ``n_videos`` videos of ``n_frames`` PNG frames of ``height`` x
    ``width`` under ``root``, with gt masks of ``gt_hw`` (default the
    frame's size); returns (annotation file, image prefix)."""
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
            fname = f'{name}/{f:05d}.png'
            write_png(os.path.join(img_prefix, fname),
                      np.clip(img, 0, 255).astype(np.uint8))
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
