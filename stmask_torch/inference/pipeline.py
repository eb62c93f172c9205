"""The video steps (port of ``stmask_tpu/inference/pipeline.py``:
``build_video_step``, ``build_video_step_batched``, ``build_video_scan``
and ``cast_params``).

    video_step(state, frame, is_first) -> (state, FrameOutput)
    video_chunk(states, frames[K, B], is_first[K, B])
        -> (states, FrameOutput[K, B])
    video_scan(state, frames[K], is_first[K]) -> (state, FrameOutput[K])

run the forward pass, decode, NMS, the mask-IoU re-scoring (under
``use_maskiou`` with ``rescore_mask`` or ``rescore_bbox``), temporal
shift and tracking (the simple tracker for models without TF) on the
device, with the model and weights there too.  The lockstep streams are a
lane axis written out (the JAX package ``vmap``s them): a step runs the
network, ``detect_frame_lanes`` and the tracker once over all B lanes, and
the B states are one ``TrackState`` whose fields lead with [B].  The
single-stream step runs the same functions at B = 1.  Nothing in a step
waits for the device: the caller reads the small per-frame outputs when it
needs them (``inference.fetch``, ``inference.postprocess``).

Compute dtype: ``compute_dtype=torch.bfloat16`` rounds the weights and the
frozen-BN statistics to bf16 (``cast_model``, as ``cast_params`` does) and
runs the network on the bf16 frame; the decode-side outputs come back in
fp32 and the tracker keeps the bf16 features (``init_state(feat_dtype)``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config import MEANS, STD, STMaskConfig
from ..models.stmask import STMask
from ..ops.anchors import all_priors, check_anchor_count
from ..utils.device import resolve_device
from .candidates import (Detections, add_lane, detect_frame_lanes,
                         drop_lane, rescore_maskiou_lanes)
from .tracker import (FrameOutput, TrackState, init_state,
                      track_step_simple_lanes, track_step_tf_lanes)

_DECODE_KEYS = ('loc', 'conf', 'mask_coeff', 'track', 'centerness')


def normalize_pad(cfg: STMaskConfig, img: torch.Tensor) -> torch.Tensor:
    """uint8/float [..., img_h, img_w, 3] -> normalized, zero-padded float32
    [..., pad_h, pad_w, 3] (``data/transforms.py:150-166``)."""
    mean = torch.tensor(MEANS, dtype=torch.float32, device=img.device)
    std = torch.tensor(STD, dtype=torch.float32, device=img.device)
    x = (img.float() - mean) / std
    return F.pad(x, (0, 0, 0, cfg.pad_w - cfg.img_w, 0, cfg.pad_h - cfg.img_h))


def cast_model(model: STMask, dtype: torch.dtype) -> STMask:
    """Round every floating parameter and buffer to ``dtype`` in place (the
    frozen-BN statistics are buffers here and parameters in the JAX
    package, whose ``cast_params``, ``pipeline.py:234-245``, casts them
    alike).  ``FrozenBatchNorm`` folds in fp32 from the rounded statistics;
    ``TemporalNet`` computes in its input's dtype on the rounded weights."""
    return model.to(dtype=dtype)


def detect_and_rescore(cfg: STMaskConfig, model: STMask, preds: dict,
                       priors: torch.Tensor) -> Detections:
    """Every lane of a forward's outputs through ``detect_frame_lanes``
    and, when the config asks for it, ``rescore_maskiou_lanes``
    (``pipeline.py:144-150``): [B, D, ...] detections."""
    proto = preds['proto']
    det = detect_frame_lanes(cfg, {k: preds[k] for k in _DECODE_KEYS},
                             priors, proto=proto)
    if cfg.use_maskiou and (cfg.rescore_mask or cfg.rescore_bbox):
        det = rescore_maskiou_lanes(cfg, model.maskiou, det, proto)
    return det


def _track(cfg: STMaskConfig, model: STMask, state: TrackState,
           det: Detections, preds: dict, is_first: torch.Tensor,
           record: Optional[dict] = None
           ) -> Tuple[TrackState, FrameOutput]:
    """The tracker of the config over every lane: TF, or the simple one
    (which records nothing)."""
    if cfg.temporal_fusion_module:
        return track_step_tf_lanes(cfg, model.temporal_shift, state, det,
                                   preds['proto'], preds['fpn_feat'],
                                   preds['T2S_feat'], is_first,
                                   record=record)
    return track_step_simple_lanes(cfg, state, det, preds['proto'],
                                   is_first)


def _prepare(cfg: STMaskConfig, model: STMask, device, compute_dtype):
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'compute dtype {compute_dtype}: float32 or '
                         'bfloat16')
    dev = resolve_device(device)
    model = cast_model(model.to(device=dev, memory_format=torch.channels_last),
                       compute_dtype).eval()
    priors = torch.as_tensor(all_priors(cfg), device=dev)

    def make_init_state(lanes: Optional[int] = None) -> TrackState:
        return init_state(cfg, cfg.feature_shapes()[
            cfg.correlation_selected_layer], (cfg.pad_h // 4, cfg.pad_w // 4),
            cfg.fpn.num_features, cfg.embed_dim, device=dev,
            feat_dtype=compute_dtype, lanes=lanes)

    return dev, model, priors, make_init_state


def build_video_step(cfg: STMaskConfig, model: STMask,
                     uint8_input: bool = False, debug: bool = False,
                     device: torch.device | str = 'cuda',
                     compute_dtype: torch.dtype = torch.float32,
                     debug_fpn: bool = False
                     ) -> Tuple[Callable, Callable[[], TrackState]]:
    """Returns (video_step, make_init_state).

    ``video_step(state, frame[H, W, 3], is_first)`` takes the already
    normalized padded image as float — or, with ``uint8_input=True``, a
    resized uint8 [img_h, img_w, 3] frame (numpy or tensor) normalized and
    padded on the device, then cast to ``compute_dtype``.  ``debug=True``
    additionally returns {'proto', 'mask_coeff', 'det_valid'} of the
    pre-tracking detections (the ``--display_lincomb`` surface);
    ``debug_fpn=True`` returns that dict too, with ``fpn_outs``, the frame's
    P3..P7 as NHWC [h, w, C] maps (``--display_fpn_outs``).  The model is
    moved to ``device`` (default ``cuda``; raises when there is no GPU) and
    cast to ``compute_dtype``; fp32 runs with TF32 off.  The step is the
    lane-axis step at B = 1 on a per-lane state.
    """
    dev, model, priors, make_init_state = _prepare(cfg, model, device,
                                                   compute_dtype)

    @torch.inference_mode()
    def video_step(state: TrackState, frame, is_first
                   ) -> Tuple[TrackState, FrameOutput]:
        frame = torch.as_tensor(frame).to(dev, non_blocking=True)
        frame = normalize_pad(cfg, frame) if uint8_input else frame.float()
        first = torch.as_tensor(is_first, dtype=torch.bool).to(
            dev, non_blocking=True).reshape(1)
        preds = model(frame[None].to(compute_dtype),
                      return_fpn_outs=debug_fpn)
        check_anchor_count(cfg, preds['loc'].shape[1], priors.shape[0])
        det = detect_and_rescore(cfg, model, preds, priors)
        state, out = drop_lane(_track(cfg, model, add_lane(state), det, preds,
                                      first))
        if debug or debug_fpn:
            dbg = {'proto': preds['proto'][0],
                   'mask_coeff': det.mask_coeff[0], 'det_valid': det.valid[0]}
            if debug_fpn:
                dbg['fpn_outs'] = tuple(f[0] for f in preds['fpn_outs'])
            return state, out, dbg
        return state, out

    return video_step, make_init_state


def _stack(outs: Sequence[FrameOutput]) -> FrameOutput:
    return FrameOutput(*(torch.stack(f) for f in zip(*outs)))


def build_video_step_batched(cfg: STMaskConfig, model: STMask,
                             n_videos: int, chunk_size: int = 4,
                             uint8_input: bool = False,
                             device: torch.device | str = 'cuda',
                             compute_dtype: torch.dtype = torch.float32
                             ) -> Tuple[Callable, Callable[[], TrackState]]:
    """Step ``n_videos`` independent video streams in lockstep,
    ``chunk_size`` frames a call (``pipeline.py:111-196``).

    Returns (video_chunk, make_init_states):
      video_chunk(states, frames [K, B, H, W, 3], is_first [K, B])
        -> (states, FrameOutput with leading [K, B])
    where ``states`` is one ``TrackState`` whose fields lead with [B].

    Each of the K steps runs the network, ``detect_frame_lanes`` (and the
    mask-IoU re-scoring) and the tracker once on all B lanes, as the JAX
    package's ``vmap`` does: one correlation launch a step, and under
    greedy NMS one launch of B5 for every class of every lane.
    ``is_first[k, b]`` resets lane b's tracker at step k, so a lane starts
    its next video mid-chunk; a lane with no video steps on a zero frame
    and its outputs are the caller's to drop.  ``uint8_input=True`` takes
    frames as uint8 [K, B, img_h, img_w, 3] (resized, not normalized) and
    normalizes and pads them on the device.  ``video_chunk(..., record=[])``
    appends one dict a step: the forward's outputs (``preds``), the
    detections (``det``), what the TF tracker records
    (``track_step_tf_lanes``) and the new ``state`` and ``out``, for
    ``inference/decisions.py`` to hold against another run.
    """
    dev, model, priors, make_init_state = _prepare(cfg, model, device,
                                                   compute_dtype)

    @torch.inference_mode()
    def video_chunk(states: TrackState, frames, is_first,
                    record: Optional[list] = None
                    ) -> Tuple[TrackState, FrameOutput]:
        frames = torch.as_tensor(frames).to(dev, non_blocking=True)
        first = torch.as_tensor(is_first, dtype=torch.bool).to(
            dev, non_blocking=True)
        if tuple(first.shape) != (chunk_size, n_videos) or \
                tuple(frames.shape[:2]) != (chunk_size, n_videos):
            raise ValueError(
                f'video_chunk: frames {tuple(frames.shape)} and is_first '
                f'{tuple(first.shape)} must lead with ({chunk_size}, '
                f'{n_videos})')
        x = normalize_pad(cfg, frames) if uint8_input else frames.float()
        steps = []
        for k in range(chunk_size):
            preds = model(x[k].to(compute_dtype))
            check_anchor_count(cfg, preds['loc'].shape[1], priors.shape[0])
            det = detect_and_rescore(cfg, model, preds, priors)
            rec = None if record is None else {'preds': preds, 'det': det}
            states, out = _track(cfg, model, states, det, preds, first[k],
                                 rec)
            if rec is not None:
                record.append(dict(rec, state=states, out=out))
            steps.append(out)
        return states, _stack(steps)

    def make_init_states() -> TrackState:
        return make_init_state(lanes=n_videos)

    return video_chunk, make_init_states


def build_video_scan(cfg: STMaskConfig, model: STMask, chunk_size: int = 8,
                     uint8_input: bool = False,
                     device: torch.device | str = 'cuda',
                     compute_dtype: torch.dtype = torch.float32
                     ) -> Tuple[Callable, Callable[[], TrackState]]:
    """Chunked streaming of one video stream, ``chunk_size`` frames a call
    (``pipeline.py:199-231``; the JAX package's ``lax.scan`` is a loop
    over ``build_video_step``'s step here).

    ``is_first`` flags ride along per frame, so a chunk may span video
    boundaries (the tracker state resets mid-chunk).

    Returns (video_chunk, make_init_state):
      video_chunk(state, frames [K, H, W, 3], is_first [K])
        -> (state, FrameOutput with leading K axis)
    with frames as ``build_video_step`` takes them (``uint8_input``); a K
    other than ``chunk_size`` raises ``ValueError``.
    """
    video_step, make_init_state = build_video_step(
        cfg, model, uint8_input=uint8_input, device=device,
        compute_dtype=compute_dtype)

    def video_chunk(state: TrackState, frames, is_first
                    ) -> Tuple[TrackState, FrameOutput]:
        frames = torch.as_tensor(frames)
        first = torch.as_tensor(is_first, dtype=torch.bool)
        if tuple(first.shape) != (chunk_size,) or \
                frames.shape[0] != chunk_size:
            raise ValueError(
                f'video_chunk: frames {tuple(frames.shape)} and is_first '
                f'{tuple(first.shape)} must lead with {chunk_size}')
        outs = []
        for k in range(chunk_size):
            state, out = video_step(state, frames[k], first[k])
            outs.append(out)
        return state, _stack(outs)

    return video_chunk, make_init_state
