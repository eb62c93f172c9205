"""YTVIS video-instance-segmentation mAP evaluator, self-contained (the
port's copy of ``stmask_tpu/utils/ytvis_eval.py``, numpy on the port's
``utils/rle.py``).

Replaces the reference's YTVOS/YTVOSeval C-API dependency
(``layers/eval_utils.py:109-144``): COCO-style AP over *video tracks* with
spatio-temporal mask IoU (sum of per-frame intersections over sum of
per-frame unions, absent frames contributing zero — the youtubevos cocoapi
definition).  IoU thresholds 0.50:0.95:0.05, 101-point recall
interpolation, AP averaged over categories present in the ground truth.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import rle as rle_util

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
REC_THRS = np.linspace(0.0, 1.0, 101)


def _track_iou(track_a: List[Optional[dict]],
               track_b: List[Optional[dict]],
               iscrowd: bool = False) -> float:
    """Spatio-temporal IoU of two RLE tracks (lists per frame, None = no
    mask that frame).  ``iscrowd``: track_b is a crowd region — the union is
    just track_a's area (cocoapi crowd IoU semantics)."""
    n = max(len(track_a), len(track_b))
    inter = 0.0
    union = 0.0
    for f in range(n):
        a = track_a[f] if f < len(track_a) else None
        b = track_b[f] if f < len(track_b) else None
        if a is None and b is None:
            continue
        if a is None:
            if not iscrowd:
                union += rle_util.area(b)
            continue
        if b is None:
            union += rle_util.area(a)
            continue
        ma = rle_util.decode(a).astype(bool)
        mb = rle_util.decode(b).astype(bool)
        i = np.logical_and(ma, mb).sum()
        inter += i
        union += ma.sum() if iscrowd else np.logical_or(ma, mb).sum()
    return inter / union if union > 0 else 0.0


def _gt_tracks_from_annotations(gt: dict) -> Dict[int, List[dict]]:
    """Group gt annotations by video: list of {category_id, segmentations}."""
    by_vid = defaultdict(list)
    for ann in gt.get('annotations', []):
        by_vid[ann['video_id']].append(ann)
    return by_vid


def evaluate_ytvis(gt_json, dt_json, max_dets: int = 100) -> Dict[str, float]:
    """Compute mask-track AP metrics.

    Args:
      gt_json: YTVIS annotation dict or path.
      dt_json: results list (schema of results2json_videoseg) or path.
    Returns:
      dict with mAP (0.50:0.95), AP50, AP75, AR@max_dets.
    """
    if isinstance(gt_json, str):
        with open(gt_json) as f:
            gt_json = json.load(f)
    if isinstance(dt_json, str):
        with open(dt_json) as f:
            dt_json = json.load(f)

    gt_by_vid = _gt_tracks_from_annotations(gt_json)
    cat_ids = sorted({a['category_id']
                      for anns in gt_by_vid.values() for a in anns})
    vid_ids = [v['id'] for v in gt_json['videos']]

    dt_by_vid = defaultdict(list)
    for det in dt_json:
        dt_by_vid[det['video_id']].append(det)

    t = len(IOU_THRS)
    ap_per_cat = []
    ar_per_cat = []
    for cat in cat_ids:
        # gather per-video matches (cocoeval evaluateImg semantics with
        # iscrowd gts ignored: they can absorb detections without counting
        # as TP or FP, and never count toward n_gt)
        scores_all = []
        matched_all = []   # [t, n_dets] bools aligned with scores
        ignored_all = []   # [t, n_dets] det matched an ignored (crowd) gt
        n_gt = 0
        for vid in vid_ids:
            gts = [a for a in gt_by_vid.get(vid, [])
                   if a['category_id'] == cat]
            # sort non-ignored gt first (cocoeval gtind order)
            gts = sorted(gts, key=lambda g: bool(g.get('iscrowd', 0)))
            gt_ig = np.asarray([bool(g.get('iscrowd', 0)) for g in gts])
            dts = sorted([d for d in dt_by_vid.get(vid, [])
                          if d['category_id'] == cat],
                         key=lambda d: -d['score'])[:max_dets]
            n_gt += int((~gt_ig).sum()) if len(gts) else 0
            if not dts:
                continue
            iou = np.zeros((len(dts), len(gts)))
            for i, d in enumerate(dts):
                for j, g in enumerate(gts):
                    iou[i, j] = _track_iou(d['segmentations'],
                                           g['segmentations'],
                                           iscrowd=bool(gt_ig[j]))
            matched = np.zeros((t, len(dts)), bool)
            ignored = np.zeros((t, len(dts)), bool)
            for ti, thr in enumerate(IOU_THRS):
                used = np.zeros(len(gts), bool)
                for i in range(len(dts)):
                    best, bj = min(thr, 1 - 1e-10), -1
                    for j in range(len(gts)):
                        # crowd gts may be matched repeatedly
                        if used[j] and not gt_ig[j]:
                            continue
                        # once matched to a real gt, never trade it for an
                        # ignored one (gts are sorted non-ignored first)
                        if bj >= 0 and not gt_ig[bj] and gt_ig[j]:
                            break
                        if iou[i, j] >= best:
                            best, bj = iou[i, j], j
                    if bj >= 0:
                        used[bj] = True
                        if gt_ig[bj]:
                            ignored[ti, i] = True
                        else:
                            matched[ti, i] = True
            scores_all.extend(d['score'] for d in dts)
            matched_all.append(matched)
            ignored_all.append(ignored)

        if n_gt == 0:
            continue
        if not scores_all:
            ap_per_cat.append(np.zeros(t))
            ar_per_cat.append(np.zeros(t))
            continue

        scores = np.asarray(scores_all)
        matched = np.concatenate(matched_all, axis=1)
        ignored = np.concatenate(ignored_all, axis=1)
        order = np.argsort(-scores, kind='mergesort')
        matched = matched[:, order]
        ignored = ignored[:, order]

        tp = np.cumsum(matched, axis=1)
        fp = np.cumsum(~matched & ~ignored, axis=1)
        rec = tp / n_gt
        prec = tp / np.maximum(tp + fp, 1e-12)

        ap_t = np.zeros(t)
        for ti in range(t):
            # precision envelope + 101-point interpolation (cocoeval)
            p = prec[ti].copy()
            for i in range(len(p) - 1, 0, -1):
                p[i - 1] = max(p[i - 1], p[i])
            inds = np.searchsorted(rec[ti], REC_THRS, side='left')
            q = np.zeros(len(REC_THRS))
            valid = inds < len(p)
            q[valid] = p[inds[valid]]
            ap_t[ti] = q.mean()
        ap_per_cat.append(ap_t)
        ar_per_cat.append(rec[:, -1] if rec.shape[1] else np.zeros(t))

    if not ap_per_cat:
        return {'mAP': 0.0, 'AP50': 0.0, 'AP75': 0.0, 'AR': 0.0}
    ap = np.stack(ap_per_cat)      # [cats, t]
    ar = np.stack(ar_per_cat)
    return {
        'mAP': float(ap.mean()),
        'AP50': float(ap[:, 0].mean()),
        'AP75': float(ap[:, IOU_THRS.tolist().index(0.75)].mean()),
        'AR': float(ar.mean()),
    }
