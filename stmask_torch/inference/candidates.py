"""Per-frame candidate generation + NMS with fixed capacities (port of
``stmask_tpu/inference/candidates.py::detect_frame``, the ``'cc'`` branch).

Conf pre-filter and decode (reference ``TF_utils.py:54-82``), then
cross-class fast NMS over score x centerness (``detection_TF.py:56-83``):
invalid priors get ``NEG_INF`` scores and a stable top-k yields a sorted,
fixed-size candidate set with a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import STMaskConfig
from ..ops.boxes import decode
from ..ops.nms import NEG_INF, _top_k_padded, cc_fast_nms


class Detections(NamedTuple):
    """Fixed-capacity per-frame detections, score-sorted."""
    box: torch.Tensor         # [D, 4] point form, normalized
    score: torch.Tensor       # [D] max-class prob x centerness
    cls: torch.Tensor         # [D] 1-based class id
    mask_coeff: torch.Tensor  # [D, 32] raw coefficients
    track: torch.Tensor       # [D, E] L2-normalized embedding
    centerness: torch.Tensor  # [D]
    valid: torch.Tensor       # [D] bool


def detect_frame(cfg: STMaskConfig, preds: dict,
                 priors: torch.Tensor) -> Detections:
    """Decode + threshold + cross-class NMS for one frame.

    Args:
      preds: eval outputs of one frame (batch dim stripped): loc [P, 4],
        conf [P, C] softmaxed, mask_coeff [P, 32], track [P, E],
        centerness [P, 1].
      priors: [P, 4] in [cx, cy, w, h].
    """
    if cfg.eval_nms_method != 'cc' or cfg.nms_as_miou:
        raise NotImplementedError(
            f'eval_nms_method {cfg.eval_nms_method!r} / nms_as_miou: only '
            'box cross-class fast NMS is ported (ROADMAP A.11)')
    boxes = decode(preds['loc'], priors)                        # [P, 4]
    fg = preds['conf'][:, 1:]                                   # [P, C-1]
    conf_max = fg.max(dim=-1).values
    classes = torch.argmax(fg, dim=-1) + 1      # first index among ties
    centerness = preds['centerness'][:, 0]
    d = min(cfg.det_capacity, cfg.nms_top_k)

    passed = conf_max > cfg.eval_conf_thresh
    nms_scores = torch.where(passed, conf_max * centerness, NEG_INF)
    res = cc_fast_nms(boxes, nms_scores, cfg.nms_thresh, cfg.nms_top_k)

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
