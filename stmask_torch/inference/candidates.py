"""Per-frame candidate generation + NMS with fixed capacities (port of
``stmask_tpu/inference/candidates.py::detect_frame``).

Conf pre-filter and decode (reference ``TF_utils.py:54-82``), then the NMS
family of ``cfg.eval_nms_method``: invalid priors get ``NEG_INF`` scores
and a stable top-k yields a sorted, fixed-size candidate set with a
validity mask.

The lane axis is written out: ``detect_frame_lanes`` and
``rescore_maskiou_lanes`` take every tensor with a leading [B] (the
lockstep streams the JAX package ``vmap``s) and run once over all of them.
``detect_frame`` and ``rescore_maskiou`` keep the JAX package's per-frame
signature: they add a lane axis of 1 and drop it again.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..config import STMaskConfig
from ..ops.boxes import decode
from ..ops.masks import generate_mask
from ..ops.nms import (NEG_INF, _top_k_padded, cc_fast_nms, fast_nms,
                       greedy_nms_per_class, take_rows)


def _map(fn, x):
    """``fn`` on every tensor of ``x`` (a tensor, a tuple, a NamedTuple or
    a dict of them; anything else as it is)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        vals = [_map(fn, v) for v in x]
        return type(x)(*vals) if hasattr(x, '_fields') else tuple(vals)
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    return x


def add_lane(x):
    """``x`` with a lane axis of 1 in front of every tensor."""
    return _map(lambda t: t[None], x)


def drop_lane(x):
    """The inverse of ``add_lane``: lane 0 of every tensor."""
    return _map(lambda t: t[0], x)


class Detections(NamedTuple):
    """Fixed-capacity detections, score-sorted; lane-stacked ones lead
    every field with [B]."""
    box: torch.Tensor         # [D, 4] point form, normalized
    score: torch.Tensor       # [D] max-class prob x centerness
    cls: torch.Tensor         # [D] 1-based class id
    mask_coeff: torch.Tensor  # [D, 32] raw coefficients
    track: torch.Tensor       # [D, E] L2-normalized embedding
    centerness: torch.Tensor  # [D]
    valid: torch.Tensor       # [D] bool


def rescore_maskiou_lanes(cfg: STMaskConfig, maskiou_fn: Callable,
                          det: Detections, proto: torch.Tensor
                          ) -> Detections:
    """Mask re-scoring by FastMaskIoUNet (``candidates.py:35-48``; the
    reference's eval.py:291,467, commented out of its main path): each
    valid detection's score times the predicted mask IoU of its class.
    Runs behind ``use_maskiou`` with ``rescore_mask`` or ``rescore_bbox``,
    the net once over all lanes' detections ([B*D, Hp, Wp, 1]).

    Args:
      det: lane-stacked detections [B, D, ...]; proto: [B, Hp, Wp, 32].
    """
    soft = generate_mask(proto, det.mask_coeff, det.box)     # [B, D, Hp, Wp]
    b, d = soft.shape[:2]
    iou_p = maskiou_fn(soft.reshape(b * d, *soft.shape[2:], 1)
                       ).reshape(b, d, -1)                    # [B, D, C-1]
    lbl = torch.clamp(det.cls - 1, min=0).long()
    per = torch.gather(iou_p, -1, lbl[..., None])[..., 0].to(det.score.dtype)
    return det._replace(score=torch.where(det.valid, det.score * per,
                                          det.score))


def rescore_maskiou(cfg: STMaskConfig, maskiou_fn: Callable,
                    det: Detections, proto: torch.Tensor) -> Detections:
    """``rescore_maskiou_lanes`` for one frame's detections [D, ...] and
    proto [Hp, Wp, 32]."""
    return drop_lane(rescore_maskiou_lanes(cfg, maskiou_fn, add_lane(det),
                                           add_lane(proto)))


def detect_frame_lanes(cfg: STMaskConfig, preds: dict, priors: torch.Tensor,
                       proto: Optional[torch.Tensor] = None) -> Detections:
    """Decode + threshold + NMS for one frame of each of B lanes.

    The NMS family is picked by ``cfg.eval_nms_method``:
      * ``'cc'``: cross-class fast NMS over score x centerness (the mAP
        column; detection.py:139-187), with the mask-IoU blend when
        ``cfg.nms_as_miou`` and ``proto`` is given (detection.py:154-158);
      * ``'per_class'``: per-class fast NMS (the mAP* column;
        detection.py:211-263);
      * ``'greedy'``: exact per-class greedy NMS with Cython's +1-pixel
        areas (detection.py:265-312), kernel B5 on the card, one launch
        for every class of every lane.

    Args:
      preds: eval outputs: loc [B, P, 4], conf [B, P, C] softmaxed,
        mask_coeff [B, P, 32], track [B, P, E], centerness [B, P, 1].
      priors: [P, 4] in [cx, cy, w, h].
      proto: [B, Hp, Wp, 32] prototypes (used by ``nms_as_miou`` only).
    """
    boxes = decode(preds['loc'], priors)                        # [B, P, 4]
    fg = preds['conf'][..., 1:]                                 # [B, P, C-1]
    centerness = preds['centerness'][..., 0]                    # [B, P]
    d = min(cfg.det_capacity, cfg.nms_top_k)
    method = cfg.eval_nms_method

    def pick(idx, score, cls, valid):
        return Detections(box=take_rows(boxes, idx), score=score, cls=cls,
                          mask_coeff=take_rows(preds['mask_coeff'], idx),
                          track=take_rows(preds['track'], idx),
                          centerness=take_rows(centerness, idx), valid=valid)

    if method in ('per_class', 'greedy'):
        # TF models run Detect_TF.fast_nms, which weights the per-class
        # scores by centerness before the sort and reports the weighted
        # score (detection_TF.py:140-143); greedy (detection.py only) and
        # every no-TF model take the raw class scores.
        weighted = (method == 'per_class' and cfg.temporal_fusion_module
                    and cfg.train_centerness)
        scores_c = (fg * centerness[..., None] if weighted else fg
                    ).transpose(-1, -2)                         # [B, C-1, P]
        if method == 'per_class':
            res = fast_nms(boxes, scores_c, cfg.nms_thresh, cfg.nms_top_k,
                           conf_thresh=cfg.nms_conf_thresh, max_dets=d)
        else:
            res = greedy_nms_per_class(
                boxes, scores_c, cfg.nms_thresh, cfg.nms_conf_thresh,
                cfg.nms_top_k, max_dets=d,
                scale=float(max(cfg.pad_w, cfg.pad_h)))
        return pick(res.idx, res.scores, res.classes, res.valid)

    conf_max = fg.max(dim=-1).values
    classes = torch.argmax(fg, dim=-1) + 1      # first index among ties
    passed = conf_max > cfg.eval_conf_thresh
    nms_scores = torch.where(passed, conf_max * centerness, NEG_INF)
    mask_fn = None
    if cfg.nms_as_miou and proto is not None:
        def mask_fn(idx):
            soft = generate_mask(proto, take_rows(preds['mask_coeff'], idx),
                                 take_rows(boxes, idx))
            return (soft > 0.5).float()
    res = cc_fast_nms(boxes, nms_scores, cfg.nms_thresh, cfg.nms_top_k,
                      mask_fn=mask_fn)

    # compact the NMS survivors into det_capacity score-sorted slots
    surv_scores = torch.where(res.valid, res.scores, NEG_INF)
    top_s, top_i = _top_k_padded(surv_scores, d)
    idx = torch.gather(res.idx, -1, top_i)
    return pick(idx, top_s, torch.gather(classes, -1, idx),
                top_s > NEG_INF / 2)


def detect_frame(cfg: STMaskConfig, preds: dict, priors: torch.Tensor,
                 proto: Optional[torch.Tensor] = None) -> Detections:
    """``detect_frame_lanes`` for one frame: ``preds`` without the batch
    dim (loc [P, 4], conf [P, C], mask_coeff [P, 32], track [P, E],
    centerness [P, 1]), ``proto`` [Hp, Wp, 32]."""
    return drop_lane(detect_frame_lanes(cfg, add_lane(preds), priors,
                                        add_lane(proto)))
