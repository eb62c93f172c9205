"""MultiBox + tracking + temporal-shift losses of the flagship (port of
``stmask_tpu/train/losses.py``).

The JAX package's padded, masked formulation, with ``vmap`` written out as
a leading frame (or clip) dimension.  Keys: BIoU (DIoU box; B, smooth-L1,
when ``use_boxiou_loss`` is off), C (OHEM conf), center (centerness), M
(lincomb mask BCE), T (track contrastive), B_shift / M_shift (temporal
fusion).  The other keys of the JAX package (sigmoid focal C, D, P, MIoU,
I, E, S) raise ``NotImplementedError`` (ROADMAP A.12).

Normalization as in the JAX package (``losses.py:644-651``): the functions
below are frame sums with per-frame positive weights, and
``compute_losses`` divides all but T / B_shift / M_shift by the frame
count F.  Tie orders follow JAX: the OHEM rank is a stable sort
(``jnp.argsort``), and the positive caps take the lower index first
(``lax.top_k``).  ``stop_gradient`` becomes ``.detach()``.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from ..config import STMaskConfig
from ..ops.boxes import (center_size, decode, elemwise_diou, encode,
                         point_form, sanitize_coordinates_hw)
from ..ops.masks import generate_mask
from ..ops.matcher import match
from ..ops.roi_align import roi_align

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
    num_pos = pos.sum()
    num_neg = torch.clamp(cfg.ohem_negpos_ratio * num_pos, max=f * p - 1)
    order = torch.sort(-loss_c, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(f * p, device=order.device))
    neg = (rank < num_neg) & ~pos & ~neutral

    tgt = torch.clamp(conf_t, min=0).long()
    ce = lse - torch.gather(conf, 1, tgt[:, None])[:, 0]
    w = t.pos_w.reshape(-1)
    neg_w = torch.where(neg, 1.0 / torch.clamp(neg.sum(), min=1)
                        * cfg.ohem_negpos_ratio * f, 0.0)
    weights = torch.where(pos, w, neg_w)
    total = (weights * ce).sum() / (cfg.ohem_negpos_ratio + 1)
    return cfg.conf_alpha * total


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

    cos = (emb @ emb.T + 1.0) / 2.0
    inst_eq = ((ids[:, None] == ids[None, :]) & (ids[:, None] > 0)).float()
    lw = torch.triu(w[:, None] * w[None, :], diagonal=1)
    cos = torch.triu(cos, diagonal=1)
    eps = cos.new_tensor(EPS)
    loss_m = -(inst_eq * torch.log(torch.maximum(cos, eps))
               + (1.0 - inst_eq) * torch.log(torch.maximum(1.0 - cos, eps)))
    loss_m = torch.triu(loss_m, diagonal=1)
    denom = torch.maximum(lw.sum(), eps)
    return cfg.track_alpha * (loss_m * lw).sum() / denom


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
    out = {'B_shift': (loss_b * has_pos).sum() / b * cfg.boxshift_alpha}
    if cfg.maskshift_loss:
        out['M_shift'] = (loss_m * has_pos).sum() / b * cfg.maskshift_alpha
    return out


def _unported_keys(cfg: STMaskConfig):
    keys = []
    if cfg.train_class and cfg.use_sigmoid_focal_loss:
        keys.append('C (sigmoid focal)')
    if cfg.train_masks and cfg.use_maskiou_loss:
        keys.append('MIoU')
    if cfg.train_masks and cfg.mask_proto_coeff_diversity_loss:
        keys.append('D')
    if cfg.train_masks and cfg.mask_proto_loss is not None:
        keys.append('P')
    if cfg.use_maskiou:
        keys.append('I')
    if cfg.use_class_existence_loss:
        keys.append('E')
    if cfg.use_semantic_segmentation_loss:
        keys.append('S')
    return keys


def compute_losses(cfg: STMaskConfig, preds: Dict, gt: Dict,
                   priors: torch.Tensor,
                   temporal_net_fn: Callable = None
                   ) -> Dict[str, torch.Tensor]:
    """All training losses for one flattened frame batch
    (``losses.py:595-651``).

    Args:
      preds: model train outputs (frames flattened [F = 2B, ...]).
      gt: boxes [F, G, 4], labels / ids [F, G], valid [F, G], masks_proto
        [F, G, Hp, Wp] (binary, prototype resolution), optionally
        crowd_boxes [F, Gc, 4] / crowd_valid [F, Gc].
    """
    unported = _unported_keys(cfg)
    if unported:
        raise NotImplementedError(
            f'{cfg.name}: loss keys {", ".join(unported)} are not ported '
            '(ROADMAP A.12)')
    t = match_batch(cfg, priors, preds, gt)
    losses = {}
    if cfg.train_boxes:
        key = 'BIoU' if cfg.use_boxiou_loss else 'B'
        losses[key] = box_loss(cfg, priors, preds, t)
    if cfg.train_class:
        losses['C'] = ohem_conf_loss(cfg, preds, t)
    if cfg.train_centerness:
        losses['center'] = centerness_loss(cfg, priors, preds, t)
    if cfg.train_masks:
        losses['M'] = lincomb_mask_loss(cfg, priors, preds, t,
                                        gt['masks_proto'])
    if cfg.train_track:
        losses['T'] = track_loss(cfg, preds, t)
    if cfg.temporal_fusion_module and temporal_net_fn is not None:
        losses.update(track_to_segment_loss(
            cfg, temporal_net_fn, preds, t, gt, gt['masks_proto'], priors))
    f = t.pos.shape[0]
    exempt = ('T', 'B_shift', 'M_shift')
    return {k: (v if k in exempt else v / f) for k, v in losses.items()}
