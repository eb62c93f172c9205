"""Postprocessing + YTVIS-format results writer (port of
``stmask_tpu/inference/postprocess.py``; reference
``layers/output_utils.py:16-133`` and ``layers/eval_utils.py:15-106``).

Only the kept rows leave the device: their masks are cropped to the
un-padded region, upsampled to the image size with ``F.interpolate``
(bilinear, ``align_corners=False``) and binarized on the device, then
RLE-encoded on the host.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import STMaskConfig
from ..utils import rle as rle_util
from .tracker import FrameOutput


def postprocess_frame(cfg: STMaskConfig, frame_out: FrameOutput,
                      img_meta: Dict, score_threshold: float = 0.0) -> Dict:
    """FrameOutput (tensors on any device) -> per-frame results dict keyed
    by obj_id (schema of reference eval_utils.bbox2result_with_id)."""
    img_h, img_w = img_meta['img_shape'][:2]
    pad_h, pad_w = img_meta.get('pad_shape', (cfg.pad_h, cfg.pad_w))[:2]
    results = {'video_id': img_meta['video_id'],
               'frame_id': img_meta['frame_id']}
    idx = torch.nonzero(frame_out.keep).flatten()     # one device sync
    if score_threshold > 0:
        idx = idx[frame_out.score[idx] > score_threshold]
    if idx.numel() == 0:
        return results

    masks = upsampled_masks(frame_out.mask[idx], (img_h, img_w),
                            (pad_h, pad_w))
    masks = (masks > 0.5).to(torch.uint8).cpu().numpy()
    boxes = frame_out.box[idx].cpu().numpy()
    scores = frame_out.score[idx].cpu().numpy()
    classes = frame_out.cls[idx].cpu().numpy()
    obj_ids = frame_out.obj_id[idx].cpu().numpy()

    for m, b, s, c, oid in zip(masks, boxes, scores, classes, obj_ids):
        # undo pad normalization -> pixel coords, clamp to image
        x1, x2 = sorted((b[0] * pad_w, b[2] * pad_w))
        y1, y2 = sorted((b[1] * pad_h, b[3] * pad_h))
        results[int(oid)] = {
            'bbox': np.asarray([max(0, x1), max(0, y1), min(img_w, x2),
                                min(img_h, y2)], np.float32),
            'label': int(c),
            'score': float(s),
            'segm': rle_util.encode(m),
            'category': cfg.classes[int(c) - 1],
        }
    return results


def upsampled_masks(masks: torch.Tensor, img_hw, pad_hw) -> torch.Tensor:
    """Masks [n, Hp, Wp] cropped to the un-padded region and upsampled to
    the image size, in fp32 before the 0.5 threshold: [n, img_h, img_w]."""
    (img_h, img_w), (pad_h, pad_w) = img_hw[:2], pad_hw[:2]
    hp, wp = masks.shape[1:]
    crop_h = int(img_h / pad_h * hp)
    crop_w = int(img_w / pad_w * wp)
    masks = masks[:, :crop_h, :crop_w].float()
    return F.interpolate(masks[:, None], size=(img_h, img_w),
                         mode='bilinear', align_corners=False)[:, 0]


def results2json_videoseg(results: List[Dict],
                          out_file: Optional[str] = None) -> List[Dict]:
    """Group per-frame results into per-video object tracks (reference
    eval_utils.py:53-106): per-object mean score, majority-vote category,
    per-frame segmentation list with None gaps."""
    json_results = []
    vid_objs: Dict[int, Dict] = {}
    size = len(results)

    for idx in range(size):
        vid_id, frame_id = results[idx]['video_id'], results[idx]['frame_id']
        is_last = (idx == size - 1 or
                   results[idx + 1]['video_id'] != vid_id)

        for obj_id, obj in results[idx].items():
            if obj_id in ('video_id', 'frame_id'):
                continue
            entry = vid_objs.setdefault(
                obj_id, {'scores': [], 'cats': [], 'segms': {}})
            entry['scores'].append(obj['score'])
            entry['cats'].append(obj['label'])
            entry['segms'][frame_id] = obj['segm']
        if is_last:
            for obj in vid_objs.values():
                json_results.append({
                    'video_id': vid_id,
                    'score': float(np.mean(obj['scores'])),
                    'category_id': int(np.bincount(
                        np.asarray(obj['cats'])).argmax()),
                    'segmentations': [obj['segms'].get(fid)
                                      for fid in range(frame_id + 1)],
                })
            vid_objs = {}

    if out_file is not None:
        os.makedirs(os.path.dirname(out_file) or '.', exist_ok=True)
        with open(out_file, 'w') as f:
            json.dump(json_results, f)
    return json_results
