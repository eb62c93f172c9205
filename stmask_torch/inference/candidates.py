"""Per-frame candidate generation + NMS with fixed capacities (port of
``stmask_tpu/inference/candidates.py::detect_frame``).

Conf pre-filter and decode (reference ``TF_utils.py:54-82``), then the NMS
family of ``cfg.eval_nms_method``: invalid priors get ``NEG_INF`` scores
and a stable top-k yields a sorted, fixed-size candidate set with a
validity mask.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..config import STMaskConfig
from ..ops.boxes import decode
from ..ops.masks import generate_mask
from ..ops.nms import (NEG_INF, _top_k_padded, cc_fast_nms, fast_nms,
                       greedy_nms_per_class)


class Detections(NamedTuple):
    """Fixed-capacity per-frame detections, score-sorted."""
    box: torch.Tensor         # [D, 4] point form, normalized
    score: torch.Tensor       # [D] max-class prob x centerness
    cls: torch.Tensor         # [D] 1-based class id
    mask_coeff: torch.Tensor  # [D, 32] raw coefficients
    track: torch.Tensor       # [D, E] L2-normalized embedding
    centerness: torch.Tensor  # [D]
    valid: torch.Tensor       # [D] bool


def rescore_maskiou(cfg: STMaskConfig, maskiou_fn: Callable,
                    det: Detections, proto: torch.Tensor) -> Detections:
    """Mask re-scoring by FastMaskIoUNet (``candidates.py:35-48``; the
    reference's eval.py:291,467, commented out of its main path): each
    valid detection's score times the predicted mask IoU of its class.
    Runs behind ``use_maskiou`` with ``rescore_mask`` or ``rescore_bbox``."""
    soft = generate_mask(proto, det.mask_coeff, det.box)      # [D, Hp, Wp]
    iou_p = maskiou_fn(soft[..., None])                       # [D, C-1]
    lbl = torch.clamp(det.cls - 1, min=0).long()
    per = torch.gather(iou_p, 1, lbl[:, None])[:, 0].to(det.score.dtype)
    return det._replace(score=torch.where(det.valid, det.score * per,
                                          det.score))


def detect_frame(cfg: STMaskConfig, preds: dict, priors: torch.Tensor,
                 proto: Optional[torch.Tensor] = None) -> Detections:
    """Decode + threshold + NMS for one frame.

    The NMS family is picked by ``cfg.eval_nms_method``:
      * ``'cc'``: cross-class fast NMS over score x centerness (the mAP
        column; detection.py:139-187), with the mask-IoU blend when
        ``cfg.nms_as_miou`` and ``proto`` is given (detection.py:154-158);
      * ``'per_class'``: per-class fast NMS (the mAP* column;
        detection.py:211-263);
      * ``'greedy'``: exact per-class greedy NMS with Cython's +1-pixel
        areas (detection.py:265-312), kernel B5 on the card.

    Args:
      preds: eval outputs of one frame (batch dim stripped): loc [P, 4],
        conf [P, C] softmaxed, mask_coeff [P, 32], track [P, E],
        centerness [P, 1].
      priors: [P, 4] in [cx, cy, w, h].
      proto: [Hp, Wp, 32] prototypes (used by ``nms_as_miou`` only).
    """
    boxes = decode(preds['loc'], priors)                        # [P, 4]
    fg = preds['conf'][:, 1:]                                   # [P, C-1]
    centerness = preds['centerness'][:, 0]
    d = min(cfg.det_capacity, cfg.nms_top_k)
    method = cfg.eval_nms_method

    if method in ('per_class', 'greedy'):
        # TF models run Detect_TF.fast_nms, which weights the per-class
        # scores by centerness before the sort and reports the weighted
        # score (detection_TF.py:140-143); greedy (detection.py only) and
        # every no-TF model take the raw class scores.
        weighted = (method == 'per_class' and cfg.temporal_fusion_module
                    and cfg.train_centerness)
        scores_c = (fg * centerness[:, None]).T if weighted else fg.T
        if method == 'per_class':
            res = fast_nms(boxes, scores_c, cfg.nms_thresh, cfg.nms_top_k,
                           conf_thresh=cfg.nms_conf_thresh, max_dets=d)
        else:
            res = greedy_nms_per_class(
                boxes, scores_c, cfg.nms_thresh, cfg.nms_conf_thresh,
                cfg.nms_top_k, max_dets=d,
                scale=float(max(cfg.pad_w, cfg.pad_h)))
        idx = res.idx
        return Detections(box=boxes[idx], score=res.scores, cls=res.classes,
                          mask_coeff=preds['mask_coeff'][idx],
                          track=preds['track'][idx],
                          centerness=centerness[idx], valid=res.valid)

    conf_max = fg.max(dim=-1).values
    classes = torch.argmax(fg, dim=-1) + 1      # first index among ties
    passed = conf_max > cfg.eval_conf_thresh
    nms_scores = torch.where(passed, conf_max * centerness, NEG_INF)
    mask_fn = None
    if cfg.nms_as_miou and proto is not None:
        def mask_fn(idx):
            soft = generate_mask(proto, preds['mask_coeff'][idx], boxes[idx])
            return (soft > 0.5).float()
    res = cc_fast_nms(boxes, nms_scores, cfg.nms_thresh, cfg.nms_top_k,
                      mask_fn=mask_fn)

    # compact the NMS survivors into det_capacity score-sorted slots
    surv_scores = torch.where(res.valid, res.scores, NEG_INF)
    top_s, top_i = _top_k_padded(surv_scores, d)
    idx = res.idx[top_i]
    return Detections(
        box=boxes[idx],
        score=top_s,
        cls=classes[idx],
        mask_coeff=preds['mask_coeff'][idx],
        track=preds['track'][idx],
        centerness=centerness[idx],
        valid=top_s > NEG_INF / 2,
    )
