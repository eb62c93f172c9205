"""MultiBox + tracking + temporal-shift losses (port of
``stmask_tpu/train/losses.py``).

The JAX package's padded, masked formulation, with ``vmap`` written out as
a leading frame (or clip) dimension.  Keys: BIoU (DIoU box; B, smooth-L1,
when ``use_boxiou_loss`` is off), C (OHEM conf, or the sigmoid focal loss
under ``use_sigmoid_focal_loss``, which drops ``center``), center
(centerness), M (lincomb mask BCE), MIoU (direct mask IoU, no gradient),
D (coefficient diversity), P (prototype regularization, ``l1`` or
``disj``), I (the mask-IoU net), E (class existence), T (track
contrastive), B_shift / M_shift (temporal fusion), S (semantic
segmentation).  ``focal_conf_loss`` (softmax focal) is reached by no
configuration, in JAX alike; it is kept and tested.

Normalization as in the JAX package (``losses.py:644-651``): the functions
below are frame sums with per-frame positive weights, and
``compute_losses`` divides all but T / B_shift / M_shift by the frame
count F.  Tie orders follow JAX: the OHEM rank is a stable sort
(``jnp.argsort``), and the positive caps take the lower index first
(``lax.top_k``).  ``stop_gradient`` becomes ``.detach()``.

Data-parallel training (``stmask_torch.parallel``): under W processes that
each hold F / W frames, every function returns this rank's share of the
batch-global value, so that the shares sum to the single-process value
over the rank-ordered concatenation of the shards, and so do their
gradients.  The batch-global parts (F and the clip count, OHEM's
positive count and hard-negative rank, the sigmoid focal loss's kept
count, P's mean, T's pairs and normalizer) come from detached values
gathered over the ranks; per-frame terms stay local.  In a single process
the collectives are the identity.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..config import STMaskConfig
from ..ops.anchors import check_anchor_count
from ..ops.boxes import (center_size, decode, elemwise_diou, encode,
                         point_form, sanitize_coordinates_hw)
from ..ops.masks import generate_mask
from ..ops.matcher import match
from ..ops.roi_align import roi_align
from ..parallel.collectives import (all_gather_cat, all_reduce_sum, rank,
                                    world_size)

EPS = 1e-10


def smooth_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = torch.abs(x - y)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def _bce(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """BCE on probabilities with torch's ``F.binary_cross_entropy`` -100
    clamp of each log term, written as the JAX package writes it
    (``losses.py:57-79``): the log argument floored at a normal fp32 value
    and the -100 branch a ``where``, so no infinite gradient leaks."""
    tiny = 1e-37
    lp = torch.where(pred < tiny, -100.0,
                     torch.log(torch.maximum(pred, pred.new_tensor(tiny))))
    q = 1.0 - pred
    lq = torch.where(q < tiny, -100.0,
                     torch.log(torch.maximum(q, q.new_tensor(tiny))))
    return -(target * lp + (1.0 - target) * lq)


class MatchedTargets(NamedTuple):
    loc_t: torch.Tensor      # [F, P, 4]
    conf_t: torch.Tensor     # [F, P]
    idx_t: torch.Tensor      # [F, P]
    ids_t: torch.Tensor      # [F, P]
    gt_box_t: torch.Tensor   # [F, P, 4]
    pos: torch.Tensor        # [F, P] bool
    pos_w: torch.Tensor      # [F, P] per-frame normalized positive weights


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[f, idx[f]]`` for every f: t [F, N, ...], idx [F, M] -> [F, M,
    ...]."""
    return t[torch.arange(t.shape[0], device=t.device)[:, None], idx.long()]


def match_batch(cfg: STMaskConfig, priors: torch.Tensor, preds: Dict,
                gt: Dict) -> MatchedTargets:
    """The matcher over all frames (``losses.py:92-123``); no gradient."""
    with torch.no_grad():
        res = match(cfg.positive_iou_threshold, cfg.negative_iou_threshold,
                    gt['boxes'], gt['labels'], gt['ids'], gt['valid'],
                    priors, preds['conf'].detach(),
                    crowd_boxes=gt.get('crowd_boxes'),
                    crowd_valid=gt.get('crowd_valid'),
                    crowd_iou_threshold=cfg.crowd_iou_threshold)
    gt_box_t = _rows(gt['boxes'], res.idx_t)
    pos = res.conf_t > 0
    n_pos = pos.sum(dim=1, keepdim=True)
    pos_w = pos.float() / torch.clamp(n_pos, min=1)
    return MatchedTargets(res.loc_t, res.conf_t, res.idx_t, res.ids_t,
                          gt_box_t, pos, pos_w)


def box_loss(cfg: STMaskConfig, priors: torch.Tensor, preds: Dict,
             t: MatchedTargets) -> torch.Tensor:
    """DIoU box loss, or smooth-L1 (``losses.py:126-140``); frame sum."""
    if cfg.use_boxiou_loss:
        diou = elemwise_diou(decode(preds['loc'], priors[None]), t.gt_box_t)
        return (t.pos_w * (1.0 - diou)).sum() * cfg.bboxiou_alpha
    per = t.pos_w[..., None] * smooth_l1(preds['loc'], t.loc_t)
    return per.sum() * cfg.bbox_alpha


def _hard_negatives(cfg: STMaskConfig, loss_c: torch.Tensor,
                    conf_t: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """OHEM's selection over the whole batch: this rank's hard-negative
    mask and the batch's negative count.  ``loss_c`` (detached margins,
    zero at positives and neutrals) and ``conf_t`` are this rank's
    flattened anchors; the rank is the stable descending order of every
    rank's margins, and the count of negatives is 3 x the batch's
    positives, at most all anchors but one."""
    n = loss_c.shape[0]
    loss_all = all_gather_cat(loss_c.detach())
    conf_all = all_gather_cat(conf_t)
    pos = conf_all > 0
    neutral = conf_all < 0
    num_neg = torch.clamp(cfg.ohem_negpos_ratio * pos.sum(),
                          max=loss_all.shape[0] - 1)
    order = torch.sort(-loss_all, stable=True).indices
    rank_all = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.shape[0], device=order.device))
    neg = (rank_all < num_neg) & ~pos & ~neutral
    off = rank() * n
    return neg[off:off + n], neg.sum()


def ohem_conf_loss(cfg: STMaskConfig, preds: Dict,
                   t: MatchedTargets) -> torch.Tensor:
    """OHEM cross-entropy over the flattened batch (``losses.py:143-172``):
    3:1 hard negatives by background margin."""
    f, p, c = preds['conf'].shape
    conf = preds['conf'].reshape(-1, c)
    conf_t = t.conf_t.reshape(-1)
    pos = conf_t > 0
    neutral = conf_t < 0
    lse = torch.logsumexp(conf, dim=-1)

    loss_c = torch.where(pos | neutral, 0.0, (lse - conf[:, 0]).detach())
    neg, n_neg = _hard_negatives(cfg, loss_c, conf_t)

    tgt = torch.clamp(conf_t, min=0).long()
    ce = lse - torch.gather(conf, 1, tgt[:, None])[:, 0]
    w = t.pos_w.reshape(-1)
    neg_w = torch.where(neg, 1.0 / torch.clamp(n_neg, min=1)
                        * cfg.ohem_negpos_ratio * f * world_size(), 0.0)
    weights = torch.where(pos, w, neg_w)
    total = (weights * ce).sum() / (cfg.ohem_negpos_ratio + 1)
    return cfg.conf_alpha * total


def focal_conf_sigmoid_loss(cfg: STMaskConfig, preds: Dict,
                            t: MatchedTargets) -> torch.Tensor:
    """Sigmoid focal loss (``losses.py:175-197``): one-vs-all per class with
    alpha weighting, the background class's alpha zeroed, neutral anchors
    left out; the sum over kept anchors / their count x F."""
    f, p, ncls = preds['conf'].shape
    conf = preds['conf'].reshape(-1, ncls)
    conf_t = t.conf_t.reshape(-1)
    keep = (conf_t >= 0).float()
    one_hot = F.one_hot(torch.clamp(conf_t, min=0).long(), ncls).float()
    logpt = F.logsigmoid(conf * (one_hot * 2.0 - 1.0))
    pt = torch.exp(logpt)
    at = cfg.focal_loss_alpha * one_hot \
        + (1 - cfg.focal_loss_alpha) * (1 - one_hot)
    at[:, 0] = 0.0
    loss = -at * (1 - pt) ** cfg.focal_loss_gamma * logpt
    loss = keep * loss.sum(dim=-1)
    denom = torch.clamp(all_reduce_sum(keep.sum()), min=1.0)
    return cfg.conf_alpha * loss.sum() / denom * (f * world_size())


def focal_conf_loss(cfg: STMaskConfig, preds: Dict,
                    t: MatchedTargets) -> torch.Tensor:
    """Softmax focal loss over OHEM-selected samples (``losses.py:200-237``).
    The reference defines it and never dispatches it; ``compute_losses``
    does not either, as in JAX."""
    f, p, ncls = preds['conf'].shape
    conf = preds['conf'].reshape(-1, ncls)
    conf_t = t.conf_t.reshape(-1)
    pos = conf_t > 0
    neutral = conf_t < 0
    loss_c = torch.logsumexp(conf, dim=-1) - conf[:, 0]
    loss_c = torch.where(pos | neutral, 0.0, loss_c)
    neg, _ = _hard_negatives(cfg, loss_c, conf_t)
    keep = pos | neg
    tgt = torch.clamp(conf_t, min=0).long()
    logpt = torch.gather(torch.log_softmax(conf, dim=-1), 1,
                         tgt[:, None])[:, 0]
    pt = torch.exp(logpt)
    at = (1 - cfg.focal_loss_alpha) * pos.float() \
        + cfg.focal_loss_alpha * neg.float()
    loss = -at * (1 - pt) ** cfg.focal_loss_gamma * logpt
    return cfg.conf_alpha * torch.where(keep, loss, 0.0).sum()


def coeff_diversity_loss(cfg: STMaskConfig, preds: Dict,
                         t: MatchedTargets) -> torch.Tensor:
    """Contrastive diversity over mask coefficients within each 2-frame
    clip (``losses.py:240-274``): same-instance coefficients pulled
    together, different instances pushed apart, weighted by the outer
    product of the per-frame positive weights."""
    cap = cfg.masks_to_train
    idx, valid = _top_pos_indices(t.pos, cap)               # [F, cap]
    co = _rows(preds['mask_coeff'], idx)
    ids = torch.gather(t.ids_t, 1, idx)
    w = torch.gather(t.pos_w, 1, idx) * valid
    b = co.shape[0] // 2               # frames are clip-major [B, 2]
    co = co.reshape(b, 2 * cap, co.shape[-1])
    ids = ids.reshape(b, 2 * cap)
    w = w.reshape(b, 2 * cap)
    norm = co / torch.clamp(torch.linalg.vector_norm(co, dim=-1,
                                                     keepdim=True),
                            min=1e-12)
    cos = (norm @ norm.transpose(1, 2) + 1.0) / 2.0
    inst_eq = ((ids[:, :, None] == ids[:, None, :])
               & (ids[:, :, None] > 0)).float()
    loss = -(torch.log(torch.clamp(cos, min=EPS)) * inst_eq
             + torch.log(torch.clamp(1.0 - cos, min=EPS)) * (1.0 - inst_eq))
    lw = w[:, :, None] * w[:, None, :]
    return cfg.mask_proto_coeff_diversity_alpha * (loss * lw).sum()


def proto_loss(cfg: STMaskConfig, preds: Dict) -> torch.Tensor:
    """Prototype regularization 'P' (``losses.py:277-292``): ``l1``, the
    mean |proto| over the reference's expected area x 0.1; ``disj``,
    -mean(max over prototypes of log_softmax(proto))."""
    proto = preds['proto']
    w = world_size()              # the batch's mean: equal shards
    if cfg.mask_proto_loss == 'l1':
        l1_expected_area = 20 * 20 / 70 / 70
        return proto.abs().mean() / w / l1_expected_area * 0.1
    if cfg.mask_proto_loss == 'disj':
        return -torch.log_softmax(proto, dim=-1).amax(dim=-1).mean() / w
    raise ValueError(f'unknown mask_proto_loss {cfg.mask_proto_loss!r}')


def _binary_iou_parts(pred: torch.Tensor, mask_t: torch.Tensor):
    """Intersection, predicted area and gt area of the masks binarized at
    0.5 (no gradient: the reference's ``.gt(0.5).float()``)."""
    pred_bin = (pred.detach() > 0.5).float()
    return ((pred_bin * mask_t).sum(dim=(2, 3)), pred_bin.sum(dim=(2, 3)),
            mask_t.sum(dim=(2, 3)))


def maskiou_direct_loss(cfg: STMaskConfig, priors: torch.Tensor,
                        preds: Dict, t: MatchedTargets,
                        gt_masks: torch.Tensor) -> torch.Tensor:
    """Direct mask-IoU loss 'MIoU' (``losses.py:295-320``): the sum of
    1 - IoU of each positive's binarized soft mask against its gt.  It
    carries no gradient, as in the reference."""
    _, valid, _, pred, mask_t = _mask_pred_frame(cfg, priors, preds, t,
                                                 gt_masks)
    inter, area_p, area_g = _binary_iou_parts(pred, mask_t)
    per = 1.0 - inter / torch.clamp(area_p + area_g - inter, min=EPS)
    return cfg.maskiou_alpha * torch.where(valid, per, 0.0).sum()


def _class_onehot(labels: torch.Tensor, ncls: int) -> torch.Tensor:
    """``jax.nn.one_hot(labels - 1, ncls)``: label 0 (a padded slot) gives
    a zero row."""
    return (labels[..., None].long() - 1 == torch.arange(
        ncls, device=labels.device)).float()


def _bce_logits(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """BCE with logits as the JAX package writes it: max(x, 0) - x t +
    log1p(exp(-|x|)) (``torch.maximum`` splits a tie's gradient, as
    ``jnp.maximum`` does)."""
    return (torch.maximum(x, torch.zeros_like(x)) - x * target
            + torch.log1p(torch.exp(-x.abs())))


def class_existence_loss(cfg: STMaskConfig, class_logits: torch.Tensor,
                         gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                         alpha: float = 1.0) -> torch.Tensor:
    """Image-level class-existence BCE 'E' (``losses.py:323-338``; the
    reference computes the logits and defines no loss for them: this is
    the JAX package's completion), a frame sum."""
    onehot = _class_onehot(gt_labels, class_logits.shape[1]) \
        * gt_valid[..., None].float()
    target = torch.clamp(onehot.sum(dim=1), max=1.0)        # [F, C-1]
    return alpha * _bce_logits(class_logits, target).sum()


def maskiou_loss(cfg: STMaskConfig, maskiou_fn: Callable,
                 priors: torch.Tensor, preds: Dict, t: MatchedTargets,
                 gt_masks: torch.Tensor) -> torch.Tensor:
    """FastMaskIoUNet's training loss 'I' (``losses.py:405-449``): the net
    predicts each assembled soft mask's IoU with its gt for the gt's
    class; smooth-L1 against the binarized masks' IoU, samples whose gt
    area is at most ``discard_mask_area`` left out.  The net's input is
    detached, so 'I' trains the net alone (the intended Mask-Scoring
    target; the reference's is shape-invalid, see the JAX docstring)."""
    f = t.pos.shape[0]
    idx, valid, _, pred, mask_t = _mask_pred_frame(cfg, priors, preds, t,
                                                   gt_masks)
    pred = pred.detach()
    inter, area_p, area_g = _binary_iou_parts(pred, mask_t)
    iou_t = inter / torch.clamp(area_p + area_g - inter, min=1e-6)
    keep = valid & (area_g > cfg.discard_mask_area)
    labels = torch.gather(t.conf_t, 1, idx)                  # [F, cap]
    n, hp, wp = pred.shape[1:]
    iou_p = maskiou_fn(pred.reshape(f * n, hp, wp, 1))       # [F*cap, C-1]
    lbl = torch.clamp(labels.reshape(-1) - 1, min=0).long()
    iou_p = torch.gather(iou_p, 1, lbl[:, None])[:, 0]
    per = smooth_l1(iou_p, iou_t.reshape(-1))
    return cfg.maskiou_alpha * torch.where(keep.reshape(-1), per, 0.0).sum()


def semantic_segmentation_loss(cfg: STMaskConfig, segm: torch.Tensor,
                               gt_masks_p3: torch.Tensor,
                               gt_labels: torch.Tensor,
                               gt_valid: torch.Tensor) -> torch.Tensor:
    """Per-class semantic targets (the max over a class's objects) and BCE
    with logits 'S' (``losses.py:577-592``); segm [F, H3, W3, C-1] from P3,
    gt_masks_p3 [F, G, H3, W3] binary."""
    _, h3, w3, ncls = segm.shape
    m = gt_masks_p3.float() * gt_valid[..., None, None].float()
    seg_t = torch.einsum('fghw,fgc->fhwc', m, _class_onehot(gt_labels, ncls))
    seg_t = torch.clamp(seg_t, max=1.0)
    return (_bce_logits(segm, seg_t).sum() / h3 / w3
            * cfg.semantic_segmentation_alpha)


def centerness_loss(cfg: STMaskConfig, priors: torch.Tensor, preds: Dict,
                    t: MatchedTargets) -> torch.Tensor:
    """Centerness target = DIoU of the decoded box vs its gt
    (``losses.py:341-349``)."""
    diou = elemwise_diou(decode(preds['loc'], priors[None]), t.gt_box_t)
    per = smooth_l1(preds['centerness'][..., 0], diou)
    return cfg.center_alpha * (t.pos_w * per).sum()


def _top_pos_indices(pos: torch.Tensor, cap: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First ``cap`` positive indices of [..., P] masks, then the first
    non-positives (``lax.top_k`` of the 0/1 mask: lower index first)."""
    idx = torch.sort(pos.float(), dim=-1, descending=True,
                     stable=True).indices[..., :cap]
    return idx, torch.gather(pos, -1, idx)


def _masks_of(proto: torch.Tensor, coeff: torch.Tensor,
              boxes: torch.Tensor) -> torch.Tensor:
    """``generate_mask`` per frame: proto [F, Hp, Wp, 32], coeff [F, N, 32],
    boxes [F, N, 4] -> [F, N, Hp, Wp]."""
    return torch.stack([generate_mask(proto[i], coeff[i], boxes[i])
                        for i in range(proto.shape[0])])


def _mask_pred_frame(cfg: STMaskConfig, priors: torch.Tensor, preds: Dict,
                     t: MatchedTargets, gt_masks: torch.Tensor):
    """Top ``masks_to_train`` positives of every frame, their pred-box crop
    (expanded 1.2x) soft masks and gt targets (``losses.py:360-376``)."""
    idx, valid = _top_pos_indices(t.pos, cfg.masks_to_train)   # [F, cap]
    coeff = _rows(preds['mask_coeff'], idx)
    box = decode(_rows(preds['loc'], idx), priors[idx]).detach()
    cs = center_size(box)
    cs = torch.cat([cs[..., :2], cs[..., 2:] * 1.2], dim=-1)
    box = torch.clamp(point_form(cs), 1e-5, 1.0)
    pred = _masks_of(preds['proto'], coeff, box)
    mask_t = _rows(gt_masks, torch.gather(t.idx_t, 1, idx)).float()
    return idx, valid, box, pred, mask_t


def lincomb_mask_loss(cfg: STMaskConfig, priors: torch.Tensor, preds: Dict,
                      t: MatchedTargets,
                      gt_masks: torch.Tensor) -> torch.Tensor:
    """Lincomb mask BCE with pred-box crop (``losses.py:379-402``);
    gt_masks [F, G, Hp, Wp]."""
    hp, wp = gt_masks.shape[2:]
    idx, valid, box, pred, mask_t = _mask_pred_frame(cfg, priors, preds, t,
                                                     gt_masks)
    csize = center_size(box)
    bw = torch.clamp(csize[..., 2] * wp, min=1.0)
    bh = torch.clamp(csize[..., 3] * hp, min=1.0)
    per = _bce(pred, mask_t).sum(dim=(2, 3)) / bw / bh
    w = torch.gather(t.pos_w, 1, idx) * valid
    return cfg.mask_alpha * (w * per).sum()


def track_loss(cfg: STMaskConfig, preds: Dict,
               t: MatchedTargets) -> torch.Tensor:
    """Pairwise contrastive embedding loss over all positives in the batch
    (``losses.py:452-478``)."""
    idx, valid = _top_pos_indices(t.pos, cfg.masks_to_train)
    emb = _rows(preds['track'], idx)
    emb = emb.reshape(-1, emb.shape[-1])                     # [F*cap, E]
    ids = torch.gather(t.ids_t, 1, idx).reshape(-1)
    w = (torch.gather(t.pos_w, 1, idx) * valid).reshape(-1)
    if world_size() == 1:
        return cfg.track_alpha * _pair_loss(emb, ids, w)
    # the batch's pairs: the value from every rank's rows (detached, the
    # same on every rank), the gradient from this rank's rows against all
    # others; each pair's loss is symmetric, so the derivative of
    # sum_{i<j} l(e_i, e_j) by a row e_i is sum_{j != i} of the first
    # argument's derivative of l(e_i, e_j)
    emb_all, ids_all = all_gather_cat(emb.detach()), all_gather_cat(ids)
    w_all = all_gather_cat(w)
    value = _pair_loss(emb_all, ids_all, w_all)
    n = emb.shape[0]
    mine = torch.arange(n, device=emb.device) + rank() * n
    other = (torch.arange(emb_all.shape[0], device=emb.device)[None, :]
             != mine[:, None])
    lw = w[:, None] * w_all[None, :] * other
    grad = (_pair_terms(emb @ emb_all.T, ids, ids_all) * lw).sum() \
        / torch.clamp(torch.triu(w_all[:, None] * w_all[None, :],
                                 diagonal=1).sum(), min=EPS)
    return cfg.track_alpha * (grad - grad.detach() + value / world_size())


def _pair_terms(dot: torch.Tensor, ids_a: torch.Tensor,
                ids_b: torch.Tensor) -> torch.Tensor:
    """The contrastive loss of each pair of embeddings from their dot
    products: -log of the cosine similarity mapped to [0, 1] for the same
    instance, -log of its complement otherwise."""
    cos = (dot + 1.0) / 2.0
    inst_eq = ((ids_a[:, None] == ids_b[None, :])
               & (ids_a[:, None] > 0)).float()
    eps = cos.new_tensor(EPS)
    return -(inst_eq * torch.log(torch.maximum(cos, eps))
             + (1.0 - inst_eq) * torch.log(torch.maximum(1.0 - cos, eps)))


def _pair_loss(emb: torch.Tensor, ids: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """T over the pairs i < j of ``emb`` [N, E], weighted by w_i w_j and
    normalized by the weights' sum (``losses.py:452-478``)."""
    lw = torch.triu(w[:, None] * w[None, :], diagonal=1)
    terms = torch.triu(_pair_terms(emb @ emb.T, ids, ids), diagonal=1)
    return (terms * lw).sum() / torch.clamp(lw.sum(), min=EPS)


def track_to_segment_loss(cfg: STMaskConfig,
                          temporal_net_fn: Callable, preds: Dict,
                          t: MatchedTargets, gt: Dict,
                          gt_masks: torch.Tensor, priors: torch.Tensor,
                          shift_cap: int = 32) -> Dict[str, torch.Tensor]:
    """Temporal-fusion training loss (``losses.py:481-574``), vectorized
    over clips: anchors positive in the ref frame whose instance persists
    into the next frame regress the gt box shift through TemporalNet over
    RoIAligned ``T2S_concat_feat``, plus BCE of the shifted masks against
    the next frame's gt masks."""
    concat = preds['T2S_concat_feat']                        # [B, H4, W4, C]
    b, h4, w4, _ = concat.shape
    n_mask = cfg.mask_proto_n
    loc_ref = preds['loc'].reshape(b, 2, -1, 4)[:, 0].detach()
    coeff_ref = preds['mask_coeff'].reshape(b, 2, -1, n_mask)[:, 0].detach()
    proto_next = preds['proto'].reshape(
        (b, 2) + preds['proto'].shape[1:])[:, 1].detach()
    ids_t_ref = t.ids_t.reshape(b, 2, -1)[:, 0]              # [B, P]
    g = gt['boxes'].shape[1]
    gt_boxes = gt['boxes'].reshape(b, 2, g, 4)
    gt_ids = gt['ids'].reshape(b, 2, g)
    gt_valid = gt['valid'].reshape(b, 2, g)
    gmasks_next = gt_masks.reshape((b, 2, g) + gt_masks.shape[2:])[:, 1]
    hp, wp = gt_masks.shape[2:]

    ids_ref, ids_next = gt_ids[:, 0], gt_ids[:, 1]
    val_ref, val_next = gt_valid[:, 0], gt_valid[:, 1]
    same = ((ids_ref[:, :, None] == ids_next[:, None, :])
            & val_ref[:, :, None] & val_next[:, None, :])    # [B, G, G]
    persists = same.any(dim=2)
    next_idx = same.byte().argmax(dim=2)                     # first match
    anchor_gt = ((ids_t_ref[:, :, None] == ids_ref[:, None, :])
                 & val_ref[:, None, :] & (ids_t_ref[:, :, None] > 0))
    anchor_row = anchor_gt.byte().argmax(dim=2)              # [B, P]
    pos = anchor_gt.any(dim=2) & torch.gather(persists, 1, anchor_row)

    # padded gt rows are zero-size boxes and the ref box is the encode
    # prior (a divisor): a unit box there keeps masked lanes finite
    unit = gt_boxes.new_tensor([0.0, 0.0, 1.0, 1.0])
    box_ref_g = torch.where(val_ref[..., None], gt_boxes[:, 0], unit)
    box_next_g = torch.where((val_ref & persists)[..., None],
                             _rows(gt_boxes[:, 1], next_idx), unit)
    reg_g = encode(box_next_g, center_size(box_ref_g))        # [B, G, 4]

    idx, valid = _top_pos_indices(pos, shift_cap)            # [B, cap]
    rows = torch.gather(anchor_row, 1, idx)
    n_pos = torch.clamp(valid.sum(dim=1), min=1)

    boxes_p = decode(_rows(loc_ref, idx), priors[idx])        # [B, cap, 4]
    boxes_feat = sanitize_coordinates_hw(boxes_p, h4, w4)
    pooled = torch.cat([roi_align(concat[i], boxes_feat[i], 7)
                        for i in range(b)])                  # [B*cap,7,7,C]
    bbox_reg, shift_coeff = temporal_net_fn(pooled)
    bbox_reg = bbox_reg.reshape(b, shift_cap, 4)
    shift_coeff = shift_coeff.reshape(b, shift_cap, n_mask)

    pre_b = smooth_l1(bbox_reg, _rows(reg_g, rows)).sum(dim=-1)
    loss_b = torch.where(valid, pre_b, 0.0).sum(dim=1) / n_pos

    tar_coeff = _rows(coeff_ref, idx) + shift_coeff
    box_next_p = _rows(box_next_g, rows)
    pred = _masks_of(proto_next, tar_coeff, box_next_p)
    mask_t = _rows(gmasks_next, torch.gather(next_idx, 1, rows)).float()
    csize = center_size(box_next_p)
    bw = torch.clamp(csize[..., 2] * wp, min=1.0)
    bh = torch.clamp(csize[..., 3] * hp, min=1.0)
    per = _bce(pred, mask_t).sum(dim=(2, 3)) / bw / bh
    loss_m = torch.where(valid, per, 0.0).sum(dim=1) / n_pos
    has_pos = valid.any(dim=1).float()
    nb = b * world_size()                     # the batch's clip count
    out = {'B_shift': (loss_b * has_pos).sum() / nb * cfg.boxshift_alpha}
    if cfg.maskshift_loss:
        out['M_shift'] = (loss_m * has_pos).sum() / nb * cfg.maskshift_alpha
    return out


def compute_losses(cfg: STMaskConfig, preds: Dict, gt: Dict,
                   priors: torch.Tensor,
                   temporal_net_fn: Callable = None,
                   maskiou_fn: Callable = None
                   ) -> Dict[str, torch.Tensor]:
    """All training losses for one flattened frame batch
    (``losses.py:595-651``); under W processes, this rank's shares of the
    losses of the batch of every rank (see the module's docstring).

    Args:
      preds: model train outputs (frames flattened [F = 2B, ...]).
      gt: boxes [F, G, 4], labels / ids [F, G], valid [F, G], masks_proto
        [F, G, Hp, Wp] (binary, prototype resolution), optionally
        crowd_boxes [F, Gc, 4] / crowd_valid [F, Gc], and masks_p3
        [F, G, H3, W3] for S (no loader makes it, in JAX alike).
      temporal_net_fn / maskiou_fn: the model's TemporalNet (B_shift,
        M_shift) and mask-IoU net (I); a key is left out without its net.

    Raises ``ValueError`` when the head's anchor count is not the prior
    count (``STMask_vgg16``: ROADMAP C.8), before the match.
    """
    check_anchor_count(cfg, preds['loc'].shape[1], priors.shape[0])
    t = match_batch(cfg, priors, preds, gt)
    losses = {}
    if cfg.train_boxes:
        key = 'BIoU' if cfg.use_boxiou_loss else 'B'
        losses[key] = box_loss(cfg, priors, preds, t)
    if cfg.train_class:
        losses['C'] = (focal_conf_sigmoid_loss(cfg, preds, t)
                       if cfg.use_sigmoid_focal_loss
                       else ohem_conf_loss(cfg, preds, t))
    # the reference computes 'center' inside its OHEM conf loss: the
    # sigmoid focal branch never emits it (losses.py:615-618)
    if cfg.train_centerness and not cfg.use_sigmoid_focal_loss:
        losses['center'] = centerness_loss(cfg, priors, preds, t)
    if cfg.train_masks:
        losses['M'] = lincomb_mask_loss(cfg, priors, preds, t,
                                        gt['masks_proto'])
        if cfg.use_maskiou_loss:
            losses['MIoU'] = maskiou_direct_loss(cfg, priors, preds, t,
                                                 gt['masks_proto'])
        if cfg.mask_proto_coeff_diversity_loss:
            losses['D'] = coeff_diversity_loss(cfg, preds, t)
        if cfg.mask_proto_loss is not None:
            losses['P'] = proto_loss(cfg, preds)
    if cfg.use_maskiou and maskiou_fn is not None:
        losses['I'] = maskiou_loss(cfg, maskiou_fn, priors, preds, t,
                                   gt['masks_proto'])
    if cfg.use_class_existence_loss and 'classes' in preds:
        losses['E'] = class_existence_loss(
            cfg, preds['classes'], gt['labels'], gt['valid'],
            alpha=cfg.class_existence_alpha)
    if cfg.train_track:
        losses['T'] = track_loss(cfg, preds, t)
    if cfg.temporal_fusion_module and temporal_net_fn is not None:
        losses.update(track_to_segment_loss(
            cfg, temporal_net_fn, preds, t, gt, gt['masks_proto'], priors))
    if cfg.use_semantic_segmentation_loss and 'segm' in preds:
        losses['S'] = semantic_segmentation_loss(
            cfg, preds['segm'], gt['masks_p3'], gt['labels'], gt['valid'])
    f = t.pos.shape[0] * world_size()          # the batch's frame count
    exempt = ('T', 'B_shift', 'M_shift')
    return {k: (v if k in exempt else v / f) for k, v in losses.items()}
