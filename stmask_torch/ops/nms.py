"""Static-shape NMS family with fixed capacities (port of
``stmask_tpu/ops/nms.py``): cross-class fast NMS (the mAP column, with the
optional mask-IoU blend), per-class fast NMS and exact per-class greedy NMS
(the mAP* column).

Invalid slots carry score ``NEG_INF`` and a ``valid`` mask rides along
instead of shrinking tensors.  Top-k is a stable descending sort, so tied
scores keep the lower index first, as ``jax.lax.top_k`` does.  Every
function takes optional leading dims (the eval path's lane axis, which the
JAX package ``vmap``s) in front of a frame's shapes.  The greedy scan is
kernel B5 on the card (``kernels/greedy_nms.py``), one launch for all the
classes of all the lanes; ``greedy_nms_per_class`` hands it the boxes, and
it forms their +1-pixel IoUs itself.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels.greedy_nms import greedy_nms_keep, greedy_nms_plus_one_keep
from ..kernels.greedy_nms import plus_one_iou as _plus_one_iou
from .boxes import jaccard

NEG_INF = -1e10


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, ...]`` lane by lane: x [..., P, *rest] at idx [..., K]
    (the same leading dims) -> [..., K, *rest]; one gather."""
    lead = idx.dim() - 1
    rest = x.shape[lead + 1:]
    return torch.gather(x, lead, idx.reshape(*idx.shape, *(1,) * len(rest))
                        .expand(*idx.shape, *rest))


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
    idx: torch.Tensor      # [..., K] indices into the input boxes (sorted)
    valid: torch.Tensor    # [..., K] bool: survived threshold + suppression
    scores: torch.Tensor   # [..., K] sorted scores


def cc_fast_nms(boxes: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float = 0.5, top_k: int = 200,
                mask_fn: Optional[Callable] = None) -> NMSResult:
    """Cross-class fast NMS (reference detection.py:139-187).

    Args:
      boxes: [..., P, 4] decoded point-form boxes.
      scores: [..., P] combined scores; entries that failed the confidence
        pre-filter must already be ``NEG_INF``.
      mask_fn: optional ``idx [..., K] -> [..., K, Hm, Wm]`` binarized
        masks of the top-k candidates; suppression then uses ``0.5 *
        (box_iou + mask_iou)`` (``nms_as_miou``, detection.py:154-158).
    """
    top_scores, idx = _top_k_padded(scores, top_k)
    boxes_k = take_rows(boxes, idx)
    iou = jaccard(boxes_k, boxes_k)
    if mask_fn is not None:
        miou = mask_iou_matrix(mask_fn(idx).flatten(-2))
        iou = 0.5 * (iou + miou)
    iou_max = torch.triu(iou, diagonal=1).max(dim=-2).values
    valid = (iou_max <= iou_threshold) & (top_scores > NEG_INF / 2)
    return NMSResult(idx, valid, top_scores)


def mask_iou_matrix(flat_masks: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of [..., N, H*W] binarized masks (one matmul, reference
    box_utils.py:435-447); exact integer counts with TF32 off."""
    inter = flat_masks @ flat_masks.transpose(-1, -2)         # [..., N, N]
    area = flat_masks.sum(dim=-1)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-6)


class ClassNMSResult(NamedTuple):
    idx: torch.Tensor      # [..., D] indices into input priors
    classes: torch.Tensor  # [..., D] 1-based class ids
    scores: torch.Tensor   # [..., D]
    valid: torch.Tensor    # [..., D]


def _best_over_classes(keep: torch.Tensor, top_scores: torch.Tensor,
                       idx: torch.Tensor, max_dets: int) -> ClassNMSResult:
    """The global score sort of the per-class survivors, capped at
    ``max_dets`` (classes [..., C-1, K] flattened class-major)."""
    num_fg, top_k = idx.shape[-2:]
    flat_scores = torch.where(keep, top_scores, NEG_INF).flatten(-2)
    cls_ids = torch.arange(num_fg, device=idx.device).repeat_interleave(top_k)
    best_scores, order = _top_k_padded(flat_scores, max_dets)
    return ClassNMSResult(torch.gather(idx.flatten(-2), -1, order),
                          cls_ids[order] + 1, best_scores,
                          best_scores > NEG_INF / 2)


def fast_nms(boxes: torch.Tensor, scores_c: torch.Tensor,
             iou_threshold: float = 0.5, top_k: int = 200,
             conf_thresh: float = 0.05, max_dets: int = 100
             ) -> ClassNMSResult:
    """Per-class fast NMS (reference detection.py:211-263), the mAP* path.

    Args:
      boxes: [..., P, 4]; scores_c: [..., C-1, P] per-class scores (no
        background).
    """
    top_scores, idx = _top_k_padded(scores_c, top_k)          # [.., C-1, K]
    boxes_k = take_rows(boxes, idx.flatten(-2)).reshape(*idx.shape, 4)
    iou = torch.triu(jaccard(boxes_k, boxes_k), diagonal=1)   # [.., C-1, K, K]
    iou_max = iou.max(dim=-2).values                          # [.., C-1, K]
    keep = (iou_max <= iou_threshold) & (top_scores > conf_thresh)
    return _best_over_classes(keep, top_scores, idx, max_dets)


def greedy_nms_mask(boxes: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float = 0.5,
                    iou: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact sequential greedy NMS over *score-sorted* boxes [..., K, 4]
    with a valid mask [..., K]: a box is suppressed only by an earlier
    *kept* box.  ``iou`` [..., K, K] overrides the pairwise overlap (e.g.
    ``_plus_one_iou``).  Every leading index is one group of one launch of
    kernel B5 on the card; CPU tensors take its plain version."""
    if iou is None:
        iou = jaccard(boxes, boxes)
    k = valid.shape[-1]
    keep = greedy_nms_keep(iou.reshape(-1, k, k).contiguous(),
                           valid.reshape(-1, k).contiguous(), iou_threshold)
    return keep.reshape(valid.shape)


def greedy_nms_per_class(boxes: torch.Tensor, scores_c: torch.Tensor,
                         iou_threshold: float = 0.5,
                         conf_thresh: float = 0.05, top_k: int = 200,
                         max_dets: int = 100,
                         scale: float = 640.0) -> ClassNMSResult:
    """Exact per-class greedy NMS (reference ``traditional_nms``,
    detection.py:265-312): Cython greedy semantics per class, with the
    boxes scaled by ``scale`` (``cfg.max_size``) and +1-pixel areas, then
    a global score sort capped at ``max_dets``.  All classes of all lanes
    go through one launch of kernel B5's boxes entry on the card, which
    gathers and scales the boxes and forms their IoUs (``_plus_one_iou``'s)
    itself: the lanes' boxes stacked [L * P, 4], G = L x (C-1) groups, and
    lane l's candidate indices offset by l * P.

    Args:
      boxes: [..., P, 4] normalized point form; scores_c: [..., C-1, P].
    """
    masked = torch.where(scores_c > conf_thresh, scores_c, NEG_INF)
    top_scores, idx = _top_k_padded(masked, top_k)            # [.., C-1, K]
    p = boxes.shape[-2]
    lead = boxes.shape[:-2]
    off = torch.arange(lead.numel(), device=idx.device).reshape(
        *lead, 1, 1) * p
    k = idx.shape[-1]
    keep = greedy_nms_plus_one_keep(
        boxes.reshape(-1, 4), (idx + off).reshape(-1, k),
        (top_scores > NEG_INF / 2).reshape(-1, k), scale, iou_threshold)
    return _best_over_classes(keep.reshape(idx.shape), top_scores, idx,
                              max_dets)
