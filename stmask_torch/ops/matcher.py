"""Anchor-to-gt matching with STMask's three refinements (port of
``stmask_tpu/ops/matcher.py::match``; reference ``layers/box_utils.py:
119-197``).

A pure function over a *padded* gt set (``gt_valid`` marks real rows),
written for a leading batch of frames so that one call matches a whole
training batch.  The refinements are kept exactly:

  1. multi-instance anchor veto (``box_utils.py:150-151``);
  2. classification-score-adjusted thresholds (``box_utils.py:154-161``);
  3. forced best-anchor-per-gt greedy loop (``box_utils.py:166-184``), a
     Python loop over the padded gt dimension, vectorized over frames, with
     a validity guard so padded rows never claim an anchor.

``argmax`` takes the first index on ties, as ``jnp.argmax`` does.  Label
conventions: conf_t > 0 positive class id, 0 background, -1 neutral; ids_t
is the gt instance id (0 for non-positive).  Nothing here is
differentiated: the caller runs it without gradients.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .boxes import encode, jaccard, point_form


class MatchResult(NamedTuple):
    loc_t: torch.Tensor       # [F, P, 4] encoded regression targets
    conf_t: torch.Tensor      # [F, P] int32: class id, 0 bg, -1 neutral
    idx_t: torch.Tensor       # [F, P] int32: index of the matched gt row
    ids_t: torch.Tensor       # [F, P] int32: matched gt id (0 if not pos)
    pos_thresh: torch.Tensor  # [F] effective (cla-adjusted) threshold


def match(pos_thresh: float, neg_thresh: float, gt_boxes: torch.Tensor,
          gt_labels: torch.Tensor, gt_ids: torch.Tensor,
          gt_valid: torch.Tensor, priors: torch.Tensor,
          conf_data: torch.Tensor,
          crowd_boxes: Optional[torch.Tensor] = None,
          crowd_valid: Optional[torch.Tensor] = None,
          crowd_iou_threshold: float = 0.7) -> MatchResult:
    """Match priors to (padded) ground truth for F frames.

    Args:
      gt_boxes: [F, G, 4] point form, zero rows where ~gt_valid.
      gt_labels / gt_ids: [F, G] ints; gt_valid: [F, G] bool.
      priors: [P, 4] cxcywh.
      conf_data: [F, P, C] raw class logits.
      crowd_boxes / crowd_valid: optional [F, Gc, 4] / [F, Gc]; a
        non-positive anchor whose crowd IoA exceeds ``crowd_iou_threshold``
        becomes neutral.
    """
    nf, num_gt = gt_boxes.shape[:2]
    frames = torch.arange(nf, device=gt_boxes.device)
    decoded_priors = point_form(priors)

    overlaps = jaccard(gt_boxes, decoded_priors)                 # [F, G, P]
    overlaps = torch.where(gt_valid[..., None], overlaps,
                           overlaps.new_tensor(-1.0))
    best_truth_overlap = overlaps.max(dim=1).values              # [F, P]
    best_truth_idx = overlaps.argmax(dim=1)                      # first max

    # (1) veto anchors that contain >1 instance with near-positive IoU
    multi_instance = ((overlaps > pos_thresh - 0.1)
                      & gt_valid[..., None]).sum(dim=1) > 1
    best_truth_overlap = torch.where(
        multi_instance, best_truth_overlap.new_tensor(
            (pos_thresh + neg_thresh) / 2), best_truth_overlap)

    # (2) classification-score threshold adjustment
    keep_cla = best_truth_overlap > pos_thresh
    labels_for_prior = torch.gather(gt_labels.long(), 1, best_truth_idx)
    ce = (torch.logsumexp(conf_data, dim=-1)
          - torch.gather(conf_data, 2, labels_for_prior[..., None])[..., 0])
    cla_score = 2.0 * torch.sigmoid(-ce)
    best_truth_overlap = torch.where(keep_cla,
                                     best_truth_overlap + cla_score,
                                     best_truth_overlap)
    n_keep = keep_cla.sum(dim=1)
    cla_sum = torch.where(keep_cla, cla_score,
                          cla_score.new_zeros(())).sum(dim=1)
    cla_thresh = torch.where(n_keep > 0,
                             cla_sum / torch.clamp(n_keep, min=1),
                             cla_sum.new_zeros(()))
    pos_t = pos_thresh + cla_thresh                              # [F]
    neg_t = neg_thresh + cla_thresh

    # (3) force the best anchor for every (valid) gt, greedily by overlap
    ov = overlaps.clone()
    for _ in range(num_gt):
        best_prior_overlap = ov.max(dim=2).values                # [F, G]
        j = best_prior_overlap.argmax(dim=1)                     # [F]
        i = ov[frames, j].argmax(dim=1)                          # [F]
        valid = best_prior_overlap[frames, j] >= 0.0             # [F]
        col = torch.where(valid[:, None, None],
                          ov.new_tensor(-1.0), ov[frames, :, i][:, :, None])
        ov.scatter_(2, i[:, None, None].expand(-1, num_gt, 1), col)
        row = torch.where(valid[:, None], ov.new_tensor(-1.0), ov[frames, j])
        ov[frames, j] = row
        best_truth_overlap[frames, i] = torch.where(
            valid, best_truth_overlap.new_tensor(2.0),
            best_truth_overlap[frames, i])
        best_truth_idx[frames, i] = torch.where(valid, j,
                                                best_truth_idx[frames, i])

    matches = torch.gather(gt_boxes, 1,
                           best_truth_idx[..., None].expand(-1, -1, 4))
    below_pos = best_truth_overlap < pos_t[:, None]
    below_neg = best_truth_overlap < neg_t[:, None]
    conf = torch.gather(gt_labels, 1, best_truth_idx).int()
    conf = torch.where(below_pos, conf.new_tensor(-1), conf)
    conf = torch.where(below_neg, conf.new_tensor(0), conf)
    ids = torch.gather(gt_ids, 1, best_truth_idx).int()
    ids = torch.where(below_pos, ids.new_tensor(0), ids)

    if crowd_boxes is not None:
        # IoA of each prior against crowd regions (iscrowd: crowd in b)
        ioa = jaccard(decoded_priors, crowd_boxes, iscrowd=True)  # [F,P,Gc]
        if crowd_valid is not None:
            ioa = torch.where(crowd_valid[:, None, :], ioa,
                              ioa.new_zeros(()))
        in_crowd = ioa.max(dim=2).values > crowd_iou_threshold
        conf = torch.where((conf <= 0) & in_crowd, conf.new_tensor(-1),
                           conf)

    loc = encode(matches, priors)
    return MatchResult(loc, conf, best_truth_idx.int(), ids, pos_t)
