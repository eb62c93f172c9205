"""Cross-class fast NMS with fixed capacities (port of
``stmask_tpu/ops/nms.py``: ``_top_k_padded`` and ``cc_fast_nms``).

Invalid slots carry score ``NEG_INF`` and a ``valid`` mask rides along
instead of shrinking tensors.  Top-k is a stable descending sort, so tied
scores keep the lower index first, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .boxes import jaccard

NEG_INF = -1e10


def _top_k_padded(scores: torch.Tensor, k: int):
    """Top ``k`` along the last axis, ties broken by lower index, clamped to
    the axis size and padded back to ``k`` (scores NEG_INF, indices 0)."""
    n = scores.shape[-1]
    kk = min(k, n)
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :kk], idx[..., :kk]
    if kk < k:
        vals = F.pad(vals, (0, k - kk), value=NEG_INF)
        idx = F.pad(idx, (0, k - kk))
    return vals, idx


class NMSResult(NamedTuple):
    idx: torch.Tensor      # [K] indices into the input boxes (score-sorted)
    valid: torch.Tensor    # [K] bool: survived threshold + suppression
    scores: torch.Tensor   # [K] sorted scores


def cc_fast_nms(boxes: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float = 0.5, top_k: int = 200) -> NMSResult:
    """Cross-class fast NMS (reference detection.py:139-187).

    Args:
      boxes: [P, 4] decoded point-form boxes.
      scores: [P] combined scores; entries that failed the confidence
        pre-filter must already be ``NEG_INF``.
    """
    top_scores, idx = _top_k_padded(scores, top_k)
    boxes_k = boxes[idx]
    iou = torch.triu(jaccard(boxes_k, boxes_k), diagonal=1)
    iou_max = iou.max(dim=0).values
    valid = (iou_max <= iou_threshold) & (top_scores > NEG_INF / 2)
    return NMSResult(idx, valid, top_scores)
