"""Fixed-capacity video instance tracker (port of
``stmask_tpu/inference/tracker.py``): the TF variant (reference
``track_TF.py:50-181``) and the simple one of models without TF
(reference ``track.py:56-180``).

TF: previous tracks are shifted onto the current frame by the TemporalNet
(CandidateShift, ``TF_utils.py:12-51``), then matched against new
detections with a mixed score (embedding cosine + mask IoU + box IoU,
``TF_utils.py:99-120``).  Simple: no shift, the same match, the memory
update gated by a mask-overlap test, and the detections as output.  The
state is a fixed bank of ``track_capacity``
slots with a validity mask and a global id counter; the sequential greedy
id assignment is resolved in closed form (``resolve_assignment``).  Every
branch runs every frame and is blended with ``torch.where``, so a frame
needs no host synchronisation.

Tie rules follow the JAX package: top-k by stable descending sort (lower
index first), ``argmax`` returns the first maximum, scatter-max/min via
``scatter_reduce``.

The lane axis is written out: the ``*_lanes`` functions take a
``TrackState`` whose fields lead with [B] (the lockstep streams the JAX
package ``vmap``s), and one call steps every lane, with a per-lane
``is_first``: one correlation launch and one TemporalNet call over
[B * S] pooled boxes a step.  ``candidate_shift``, ``resolve_assignment``,
``assign_ids``, ``track_step_tf`` and ``track_step_simple`` keep the JAX
package's per-lane signature: they add a lane axis of 1 and drop it again.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import STMaskConfig
from ..ops.boxes import (center_size, decode, jaccard, mask_iou,
                         sanitize_coordinates_hw)
from ..ops.correlation import correlate
from ..ops.masks import generate_mask
from ..ops.nms import _top_k_padded, take_rows
from ..ops.roi_align import roi_align
from .candidates import Detections, add_lane, drop_lane

NEG = -1e10

TemporalNetFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


class TrackState(NamedTuple):
    """Per-video persistent state (all fixed capacity T); a lane-stacked
    state leads every field with [B] (``next_id`` is then [B])."""
    box: torch.Tensor          # [T, 4]
    score: torch.Tensor        # [T]
    cls: torch.Tensor          # [T] int64
    mask_coeff: torch.Tensor   # [T, 32]
    track: torch.Tensor        # [T, E]
    centerness: torch.Tensor   # [T]
    mask: torch.Tensor         # [T, Hp, Wp] soft masks on current frame
    age: torch.Tensor          # [T] int64 frames since last detection
    valid: torch.Tensor        # [T] bool slot in use
    obj_id: torch.Tensor       # [T] int64 global instance id (0-based)
    next_id: torch.Tensor      # [] int64
    # previous-frame features for the temporal shift
    fpn_feat: torch.Tensor     # [H4, W4, C]
    t2s_feat: torch.Tensor     # [H4, W4, C]


def init_state(cfg: STMaskConfig, feat_shape: Tuple[int, int],
               proto_shape: Tuple[int, int], feat_ch: int = 256,
               embed_dim: int | None = None,
               device: torch.device | str = 'cpu',
               feat_dtype: torch.dtype = torch.float32,
               lanes: Optional[int] = None) -> TrackState:
    """An empty bank (every field zero / False); the previous-frame
    features in ``feat_dtype`` (the compute dtype, ``tracker.py:66-80``).
    ``lanes=B`` gives B banks stacked on a leading axis."""
    t = cfg.track_capacity
    e = embed_dim or cfg.embed_dim
    b = () if lanes is None else (lanes,)
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.long, device=device)
    return TrackState(
        box=torch.zeros((*b, t, 4), **f32),
        score=torch.zeros((*b, t), **f32),
        cls=torch.zeros((*b, t), **i64),
        mask_coeff=torch.zeros((*b, t, cfg.mask_proto_n), **f32),
        track=torch.zeros((*b, t, e), **f32),
        centerness=torch.zeros((*b, t), **f32),
        mask=torch.zeros((*b, t, *proto_shape), **f32),
        age=torch.zeros((*b, t), **i64),
        valid=torch.zeros((*b, t), dtype=torch.bool, device=device),
        obj_id=torch.zeros((*b, t), **i64),
        next_id=torch.zeros(b, **i64),
        fpn_feat=torch.zeros((*b, *feat_shape, feat_ch), dtype=feat_dtype,
                             device=device),
        t2s_feat=torch.zeros((*b, *feat_shape, feat_ch), dtype=feat_dtype,
                             device=device))


def _per_lane(cond: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A [B] condition shaped to broadcast against [B, ...] ``x``."""
    return cond.reshape(-1, *(1,) * (x.dim() - 1))


def _blend(cond: torch.Tensor, a: TrackState, b: TrackState) -> TrackState:
    """Field-wise ``where(cond, a, b)``, lane by lane for a [B] ``cond``."""
    return TrackState(*(torch.where(_per_lane(cond, x), x, y)
                        for x, y in zip(a, b)))


def _first(is_first, dev) -> torch.Tensor:
    """A scalar ``is_first`` (bool or 0-dim tensor) as a [1] lane flag."""
    return torch.as_tensor(is_first, dtype=torch.bool, device=dev).reshape(1)


def candidate_shift_lanes(cfg: STMaskConfig, temporal_net_fn: TemporalNetFn,
                          state: TrackState, cur_fpn_feat: torch.Tensor,
                          cur_t2s_feat: torch.Tensor,
                          cur_proto: torch.Tensor) -> TrackState:
    """Shift track boxes/coeffs/masks to the current frame (reference
    TF_utils.py:12-51), every lane at once: one correlation of the [B,
    H4, W4, C] maps, one TemporalNet call over [B * S] pooled boxes.  The
    TemporalNet runs on the first ``shift_capacity`` *active* slots of each
    lane only; decay and aging apply to all.

    With bf16 features the correlation (bf16 in, fp32 out, as the TPU's
    Pallas kernel) promotes the concatenation to fp32, so RoIAlign and the
    TemporalNet run in fp32, as ``jnp.concatenate`` promotes in the JAX
    package."""
    b, h4, w4, _ = cur_fpn_feat.shape
    x_corr = correlate(state.fpn_feat.contiguous(), cur_fpn_feat.contiguous(),
                       patch_size=cfg.correlation_patch_size)
    concat = F.relu(torch.cat([x_corr, state.t2s_feat.to(x_corr.dtype),
                               cur_t2s_feat.to(x_corr.dtype)], dim=-1))

    s_cap = min(cfg.shift_capacity, cfg.track_capacity)
    active = state.valid & ~((state.score <= cfg.eval_conf_thresh)
                             & (state.age > cfg.max_tracked_mask_age))
    _, sel = _top_k_padded(active.float(), s_cap)   # ties: lower slot first
    sel_valid = torch.gather(active, 1, sel)                      # [B, S]

    boxes_sel = take_rows(state.box, sel)                         # [B, S, 4]
    boxes_feat = sanitize_coordinates_hw(boxes_sel, h4, w4)
    pooled = roi_align(concat, boxes_feat, pool_size=7)     # [B, S, 7, 7, C]
    loc_shift, coeff_shift = temporal_net_fn(pooled.flatten(0, 1))
    loc_shift = loc_shift.reshape(b, s_cap, -1)
    coeff_shift = coeff_shift.reshape(b, s_cap, -1)

    box_shift_sel = decode(loc_shift, center_size(boxes_sel))
    coeff_old = take_rows(state.mask_coeff, sel)
    coeff_sel = coeff_old + coeff_shift

    # the selected slots are distinct within a lane: a plain scatter
    pred = sel_valid[..., None]
    box = state.box.scatter(1, sel[..., None].expand(-1, -1, 4),
                            torch.where(pred, box_shift_sel, boxes_sel))
    coeff = state.mask_coeff.scatter(
        1, sel[..., None].expand_as(coeff_sel),
        torch.where(pred, coeff_sel, coeff_old))
    masks = generate_mask(cur_proto, coeff, box)               # [B,T,Hp,Wp]
    return state._replace(box=box, score=state.score * cfg.score_decay,
                          mask_coeff=coeff, mask=masks, age=state.age + 1)


def candidate_shift(cfg: STMaskConfig, temporal_net_fn: TemporalNetFn,
                    state: TrackState, cur_fpn_feat: torch.Tensor,
                    cur_t2s_feat: torch.Tensor,
                    cur_proto: torch.Tensor) -> TrackState:
    """``candidate_shift_lanes`` for one lane's state and [H4, W4, C] maps."""
    return drop_lane(candidate_shift_lanes(
        cfg, temporal_net_fn, add_lane(state), add_lane(cur_fpn_feat),
        add_lane(cur_t2s_feat), add_lane(cur_proto)))


def _comp_scores(cfg: STMaskConfig, det: Detections, det_masks: torch.Tensor,
                 state: TrackState) -> torch.Tensor:
    """Mixed matching score matrix [B, D, T+1]; column 0 is the new-object
    dummy (reference TF_utils.py:99-120 compute_comp_scores)."""
    b, d = det.track.shape[:2]
    dev = det.track.device
    cos = det.track @ state.track.transpose(-1, -2)              # [B, D, T]
    cos = torch.cat([torch.zeros((b, d, 1), device=dev), cos], dim=-1)
    cos = (cos + 1.0) / 2.0

    bbox_ious = jaccard(det.box, state.box)                      # [B, D, T]
    prev_masks = (state.mask > 0.5).float()
    mask_ious = mask_iou(det_masks, prev_masks)                  # [B, D, T]
    label_delta = (state.cls[:, None, :] == det.cls[:, :, None]).float()

    dummy = torch.full((b, d, 1), cfg.bbox_dummy_iou, device=dev)
    bbox_ious = torch.cat([dummy, bbox_ious], dim=-1)
    mask_ious = torch.cat([dummy, mask_ious], dim=-1)
    label_delta = torch.cat([torch.ones((b, d, 1), device=dev), label_delta],
                            dim=-1)

    c = cfg.match_coeff
    comp = (cos + c[0] * det.score[..., None] + c[1] * mask_ious
            + c[2] * bbox_ious + c[3] * label_delta)
    # invalid track slots can never be matched
    col_valid = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev),
                           state.valid], dim=-1)
    return torch.where(col_valid[:, None, :], comp, NEG)


def _free_slots(cfg: STMaskConfig, state: TrackState) -> torch.Tensor:
    """Slots reusable for new tracks: unused, or permanently un-outputtable."""
    dead = (state.score <= cfg.eval_conf_thresh) & \
           (state.age > cfg.max_tracked_mask_age)
    return ~state.valid | dead


class Assignment(NamedTuple):
    """Vectorized resolution of the greedy det->track assignment (each
    field with a leading [B] when lane-stacked)."""
    has_winner: torch.Tensor   # [T] slot receives a matched detection
    winner_src: torch.Tensor   # [T] det index feeding the slot (clamped)
    alloc_slot: torch.Tensor   # [D] slot each det would allocate (clamped)
    can_alloc: torch.Tensor    # [D] det actually allocates a new track
    new_rank: torch.Tensor     # [D] rank among allocating dets
    det_slot: torch.Tensor     # [D] slot of this det's track (-1 if none)
    num_new: torch.Tensor      # [] number of allocated tracks


def resolve_assignment_lanes(cfg: STMaskConfig, match_ids: torch.Tensor,
                             det_valid: torch.Tensor,
                             det_scores: torch.Tensor,
                             state: TrackState) -> Assignment:
    """Closed-form equivalent of the reference's sequential greedy loop
    (track_TF.py:132-156), lane by lane over [B, D] detections and a [B,
    T] bank: each track keeps the earliest-index detection attaining its
    best score; displaced dets get no id and never allocate; new-track
    slots follow cumulative rank over the free-slot order."""
    b, d = match_ids.shape
    t = state.valid.shape[-1]
    dev = match_ids.device
    det_idx = torch.arange(d, device=dev)
    big = d + 1

    is_match = det_valid & (match_ids > 0)
    slot_of_det = torch.where(is_match, match_ids - 1, 0)
    best = torch.full((b, t), float('-inf'), device=dev).scatter_reduce(
        1, slot_of_det, torch.where(is_match, det_scores, float('-inf')),
        'amax', include_self=True)
    is_best = is_match & (det_scores == torch.gather(best, 1, slot_of_det))
    key = torch.where(is_best, det_idx, big)
    winner = torch.full((b, t), big, dtype=torch.long, device=dev
                        ).scatter_reduce(1, slot_of_det, key, 'amin',
                                         include_self=True)
    has_winner = winner < big
    winner_src = torch.clamp(winner, max=d - 1)

    # new-track allocation: free slots ordered (never-used first, then
    # recyclable), excluding slots just refreshed by a match
    is_new = det_valid & (match_ids == 0)
    free = _free_slots(cfg, state) & ~has_winner
    prio = free.long() + (free & ~state.valid).long()
    slot_order = torch.argsort(-prio, dim=-1, stable=True)  # [B, T] best 1st
    num_free = free.sum(dim=-1, keepdim=True)
    rank = torch.cumsum(is_new.long(), dim=-1) - 1          # [B, D]
    rank = torch.where(is_new, rank, 0)
    alloc_slot = torch.gather(slot_order, 1, torch.clamp(rank, max=t - 1))
    can_alloc = is_new & (rank < num_free)

    det_slot = torch.where(can_alloc, alloc_slot, -1)
    det_is_winner = is_match & (torch.gather(winner, 1, slot_of_det)
                                == det_idx)
    det_slot = torch.where(det_is_winner, slot_of_det, det_slot)
    return Assignment(has_winner, winner_src, alloc_slot, can_alloc, rank,
                      det_slot, can_alloc.sum(dim=-1))


def resolve_assignment(cfg: STMaskConfig, match_ids: torch.Tensor,
                       det_valid: torch.Tensor, det_scores: torch.Tensor,
                       state: TrackState) -> Assignment:
    """``resolve_assignment_lanes`` for one lane's [D] detections and
    bank."""
    return drop_lane(resolve_assignment_lanes(
        cfg, add_lane(match_ids), add_lane(det_valid), add_lane(det_scores),
        add_lane(state)))


def _scatter_drop(field: torch.Tensor, slot: torch.Tensor,
                  values) -> torch.Tensor:
    """``field.at[slot].set(values, mode='drop')`` lane by lane for [B, D]
    slots in [0, T] of a [B, T, ...] field: rows written to index T
    (non-allocating dets) are dropped."""
    buf = torch.cat([field, field[:, :1]], dim=1)
    lane = torch.arange(buf.shape[0], device=buf.device)[:, None]
    buf[lane, slot] = torch.as_tensor(values, dtype=buf.dtype,
                                      device=buf.device)
    return buf[:, :-1]


def _apply_assignment(state: TrackState, det: Detections,
                      det_masks: torch.Tensor, asn: Assignment,
                      update_winners: torch.Tensor) -> TrackState:
    """Bulk-apply matched refreshes + new-track writes."""
    uw = update_winners
    t = state.valid.shape[-1]
    safe_slot = torch.where(asn.can_alloc, asn.alloc_slot, t)

    def upd(field_state, field_det):
        cond = uw.reshape(*uw.shape, *(1,) * (field_state.dim() - 2))
        out = torch.where(cond, take_rows(field_det, asn.winner_src),
                          field_state)
        return _scatter_drop(out, safe_slot, field_det)

    new_age = _scatter_drop(torch.where(uw, 0, state.age), safe_slot, 0)
    new_valid = _scatter_drop(state.valid, safe_slot, True)
    new_ids = _scatter_drop(state.obj_id, safe_slot,
                            state.next_id[:, None] + asn.new_rank)
    return state._replace(
        box=upd(state.box, det.box),
        score=upd(state.score, det.score),
        cls=upd(state.cls, det.cls),
        mask_coeff=upd(state.mask_coeff, det.mask_coeff),
        track=upd(state.track, det.track),
        centerness=upd(state.centerness, det.centerness),
        mask=upd(state.mask, det_masks),
        age=new_age, valid=new_valid, obj_id=new_ids,
        next_id=state.next_id + asn.num_new)


def assign_ids_lanes(cfg: STMaskConfig, det: Detections,
                     det_masks_match: torch.Tensor,
                     det_masks_bank: torch.Tensor,
                     state: TrackState) -> TrackState:
    """Greedy detection->track assignment with conflict resolution
    (reference track_TF.py:125-156), every lane at once.  Match scoring
    uses the binarized det masks; the bank stores the soft ones."""
    comp = _comp_scores(cfg, det, det_masks_match, state)     # [B, D, T+1]
    match_ids = torch.argmax(comp, dim=-1)         # first maximum on ties
    asn = resolve_assignment_lanes(cfg, match_ids, det.valid, det.score,
                                   state)
    return _apply_assignment(state, det, det_masks_bank, asn, asn.has_winner)


def assign_ids(cfg: STMaskConfig, det: Detections,
               det_masks_match: torch.Tensor, det_masks_bank: torch.Tensor,
               state: TrackState) -> TrackState:
    """``assign_ids_lanes`` for one lane."""
    return drop_lane(assign_ids_lanes(
        cfg, add_lane(det), add_lane(det_masks_match),
        add_lane(det_masks_bank), add_lane(state)))


class FrameOutput(NamedTuple):
    """Per-frame tracked detections (fixed capacity T, masked by keep; the
    simple tracker gives this frame's D detections and binarized masks).
    Lane-stacked outputs lead with [B], a chunk's with [K] or [K, B]."""
    box: torch.Tensor       # [T, 4] normalized point form
    score: torch.Tensor     # [T]
    cls: torch.Tensor       # [T]
    mask: torch.Tensor      # [T, Hp, Wp] soft masks at proto resolution
    obj_id: torch.Tensor    # [T]
    keep: torch.Tensor      # [T] bool


def track_step_tf_lanes(cfg: STMaskConfig, temporal_net_fn: TemporalNetFn,
                        state: TrackState, det: Detections,
                        cur_proto: torch.Tensor, cur_fpn_feat: torch.Tensor,
                        cur_t2s_feat: torch.Tensor, is_first: torch.Tensor,
                        record: Optional[dict] = None
                        ) -> Tuple[TrackState, FrameOutput]:
    """One frame of Track_TF (reference track_TF.py:50-181) in each of B
    lanes: a lane-stacked state, detections [B, D, ...], cur_proto [B, Hp,
    Wp, 32], features [B, H4, W4, C].

    ``is_first`` [B] bool resets a lane's bank on the first frame of its
    video.  The shift always runs (one correlation launch a step for all
    the lanes) and a lane keeps it only when its bank had a valid
    track.  A ``record`` dict receives what the step decides on:
    ``state_in`` (the bank after the reset), ``shifted`` (after the
    shift), ``det_masks_soft`` and ``comp``, the match scores [B, D, T+1]
    (``inference/decisions.py`` reads them)."""
    dev = cur_proto.device
    is_first = torch.as_tensor(is_first, dtype=torch.bool, device=dev)
    empty = TrackState(*(torch.zeros_like(s) for s in state))
    state = _blend(is_first, empty, state)

    shifted = candidate_shift_lanes(cfg, temporal_net_fn, state,
                                    cur_fpn_feat, cur_t2s_feat, cur_proto)
    state_in, state = state, _blend(state.valid.any(dim=-1), shifted, state)

    det_masks_soft = generate_mask(cur_proto, det.mask_coeff, det.box)
    det_masks = (det_masks_soft > 0.5).float()
    if record is not None:
        record.update(state_in=state_in, shifted=state,
                      det_masks_soft=det_masks_soft,
                      comp=_comp_scores(cfg, det, det_masks, state))
    state = assign_ids_lanes(cfg, det, det_masks, det_masks_soft, state)

    # output keep conditions (reference track_TF.py:158-165)
    mask_area = (state.mask > 0.5).sum(dim=(-2, -1))
    keep = ((state.age <= cfg.max_tracked_mask_age) & (mask_area > 1)
            & (state.score > cfg.eval_conf_thresh) & state.valid)
    out = FrameOutput(box=state.box, score=state.score, cls=state.cls,
                      mask=state.mask, obj_id=state.obj_id, keep=keep)
    state = state._replace(fpn_feat=cur_fpn_feat, t2s_feat=cur_t2s_feat)
    return state, out


def track_step_tf(cfg: STMaskConfig, temporal_net_fn: TemporalNetFn,
                  state: TrackState, det: Detections,
                  cur_proto: torch.Tensor, cur_fpn_feat: torch.Tensor,
                  cur_t2s_feat: torch.Tensor, is_first
                  ) -> Tuple[TrackState, FrameOutput]:
    """``track_step_tf_lanes`` for one lane; ``is_first`` a bool (scalar
    tensor or Python bool)."""
    return drop_lane(track_step_tf_lanes(
        cfg, temporal_net_fn, add_lane(state), add_lane(det),
        add_lane(cur_proto), add_lane(cur_fpn_feat), add_lane(cur_t2s_feat),
        _first(is_first, cur_proto.device)))


def track_step_simple_lanes(cfg: STMaskConfig, state: TrackState,
                            det: Detections, cur_proto: torch.Tensor,
                            is_first: torch.Tensor
                            ) -> Tuple[TrackState, FrameOutput]:
    """One frame of the no-TF tracker (reference track.py:56-180;
    ``tracker.py:367-410``) in each of B lanes, ``is_first`` [B].

    No shift: the bank keeps each track's box and mask from its last
    detection.  A matched track is refreshed only when its detection
    overlaps fewer than two valid tracks' masks at IoU > 0.3
    (track.py:162).  The output is this frame's detections [B, D] with
    the ids read before the update and their binarized masks
    (track.py:90-91).
    """
    dev = cur_proto.device
    is_first = torch.as_tensor(is_first, dtype=torch.bool, device=dev)
    state = _blend(is_first, TrackState(*(torch.zeros_like(s)
                                          for s in state)), state)

    det_masks_soft = generate_mask(cur_proto, det.mask_coeff, det.box)
    det_masks = (det_masks_soft > 0.5).float()
    comp = _comp_scores(cfg, det, det_masks, state)
    match_ids = torch.argmax(comp, dim=-1)         # first maximum on ties

    # mask-overlap gate for the memory update: det overlaps >= 2 tracks
    mious = mask_iou(det_masks, (state.mask > 0.5).float())     # [B, D, T]
    mious = torch.where(state.valid[:, None, :], mious, 0.0)
    overlap_many = (mious > 0.3).sum(dim=-1) >= 2               # [B, D]

    asn = resolve_assignment_lanes(cfg, match_ids, det.valid, det.score,
                                   state)
    # track ids before the update (a matched slot keeps its id)
    det_ids = torch.where(
        asn.det_slot >= 0,
        torch.gather(state.obj_id, 1, torch.clamp(asn.det_slot, min=0)), -1)
    det_ids = torch.where(asn.can_alloc,
                          state.next_id[:, None] + asn.new_rank, det_ids)
    update_winners = asn.has_winner & ~torch.gather(overlap_many, 1,
                                                    asn.winner_src)
    state = _apply_assignment(state, det, det_masks, asn, update_winners)

    keep = det.valid & (det_ids >= 0)
    out = FrameOutput(box=det.box, score=det.score, cls=det.cls,
                      mask=det_masks, obj_id=det_ids, keep=keep)
    return state, out


def track_step_simple(cfg: STMaskConfig, state: TrackState, det: Detections,
                      cur_proto: torch.Tensor, is_first
                      ) -> Tuple[TrackState, FrameOutput]:
    """``track_step_simple_lanes`` for one lane; ``is_first`` a bool."""
    return drop_lane(track_step_simple_lanes(
        cfg, add_lane(state), add_lane(det), add_lane(cur_proto),
        _first(is_first, cur_proto.device)))
